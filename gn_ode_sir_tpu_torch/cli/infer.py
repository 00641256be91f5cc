"""Serving entry point: score what-if scenarios with trained GN-ODE, GCN or
GIN params (port of ``gn_ode_sir_tpu.cli.infer``).

  python -m gn_ode_sir_tpu_torch.cli.infer --device cuda \
      --ckpt <dir holding serve.pt> \
      --dataset ./real_graphs/karate --model ode_nn --hidden 64 \
      --I_indices "[2, 5]" "[7]" --beta 0.3 0.2 --gamma 0.1 0.4 \
      --out predictions.npz

Every scenario (seed-set, beta, gamma) is one row of a batched
``model.predict`` dispatch; ``--dispatch_batch`` caps the rows per dispatch.
Params are the port's checkpoint (``train.checkpoint.save_params``; a JAX
checkpoint is carried across with ``params_from_numpy``) and are validated
against the declared architecture before serving. Everything runs under
``torch.inference_mode()`` on ``--device`` (default cuda, which raises when
no card is visible).

With ``--spmd`` the scenario batch splits over the processes of a group
(one per device, as ``torchrun --nproc_per_node N`` starts them; the group
is joined from its environment through ``parallel.init_distributed``):
process r scores its block through ``parallel.spmd.make_spmd_predict_fn``
(per-scenario summaries reduced where they are computed), the blocks are
all-gathered, and process 0 writes the output. A group of one process takes
the plain path, as the JAX package does on one device.
"""

from __future__ import annotations

import argparse
import functools
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from gn_ode_sir_tpu_torch.cli.worker import (
    build_model_and_adj,
    build_parser as _worker_parser,
    parse_i_indices,
    resolve_device,
)
from gn_ode_sir_tpu_torch.train.checkpoint import tree_leaves
from gn_ode_sir_tpu_torch.utils.profiling import span


def build_parser() -> argparse.ArgumentParser:
    wp = _worker_parser()  # single source of truth for shared defaults
    w = wp.get_default
    p = argparse.ArgumentParser(
        description="Score (seed-set, beta, gamma) scenarios with trained "
                    "GN-ODE params — the serving entry point (PyTorch/CUDA port)")
    p.add_argument("--ckpt", required=True,
                   help="checkpoint dir holding serve.pt (train.checkpoint.save_params)")
    p.add_argument("--dataset", required=True)
    p.add_argument("--model", default=w("model"), choices=["ode_nn", "GCN", "GIN"])
    # architecture knobs — MUST match the training run
    p.add_argument("--hidden", type=int, default=w("hidden"))
    p.add_argument("--method", default=w("method"))
    p.add_argument("--deltaT", type=float, default=w("deltaT"))
    p.add_argument("--maxTime", type=int, default=w("maxTime"))
    p.add_argument("--adjoint", default=w("adjoint"))
    p.add_argument("--solver_unroll", type=int, default=w("solver_unroll"))
    p.add_argument("--gnode_dtype", default=w("gnode_dtype"), choices=["f32", "bf16"])
    p.add_argument("--spmm", default=w("spmm"),
                   choices=["auto", "dense", "dense-bf16", "coo", "ell",
                            "pallas2", "pallas2-bf16"])
    p.add_argument("--I_indices", nargs="+", default=None,
                   help="one seed-set per scenario, reference list-string or "
                        "comma form ('[2, 5]' or 2,5)")
    p.add_argument("--beta", type=float, nargs="+", default=None)
    p.add_argument("--gamma", type=float, nargs="+", default=None)
    p.add_argument("--scenarios", default=None,
                   help="JSON file: [{'seeds': [...], 'beta': f, 'gamma': f}]")
    p.add_argument("--out", default="predictions.npz",
                   help=".npz output: S/I/R [B, T, n] + scenario arrays")
    p.add_argument("--summary_csv", default=None,
                   help="optional per-scenario summary CSV (peak infection "
                        "time/size, final recovered fraction)")
    p.add_argument("--spmd", action="store_true",
                   help="shard the scenario batch over the processes of the group "
                        "(torchrun: one per device); process 0 writes the output")
    p.add_argument("--dispatch_batch", type=int, default=None,
                   help="cap scenarios per device dispatch (the f32 trajectory "
                        "costs T*3*n*h*4 bytes per scenario); the tail chunk is "
                        "padded and sliced")
    p.add_argument("--summary_only", action="store_true",
                   help="reduce trajectories to per-scenario summaries on the "
                        "device and skip the .npz")
    p.add_argument("--device", default=w("device"), choices=["cuda", "cpu"],
                   help="where the model runs; cuda raises when no card is visible")
    return p


def load_scenarios(args) -> tuple[list[list[int]], np.ndarray, np.ndarray]:
    if args.scenarios is not None:
        with open(args.scenarios) as f:
            rows = json.load(f)
        seeds = [list(map(int, r["seeds"])) for r in rows]
        beta = np.asarray([float(r["beta"]) for r in rows], np.float32)
        gamma = np.asarray([float(r["gamma"]) for r in rows], np.float32)
        return seeds, beta, gamma
    if args.I_indices is None:
        raise SystemExit("provide --I_indices/--beta/--gamma or --scenarios")
    seeds = parse_i_indices(args.I_indices)
    beta = np.asarray(args.beta if args.beta is not None
                      else [0.2] * len(seeds), np.float32)
    gamma = np.asarray(args.gamma if args.gamma is not None
                       else [0.1] * len(seeds), np.float32)
    if not (len(seeds) == len(beta) == len(gamma)):
        raise SystemExit(
            f"scenario arrays must align: {len(seeds)} seed sets, "
            f"{len(beta)} beta, {len(gamma)} gamma")
    return seeds, beta, gamma


def restore_params(ckpt: str, *, device) -> dict:
    """Params from ``<ckpt>/serve.pt`` on ``device``."""
    from gn_ode_sir_tpu_torch.train.checkpoint import params_path
    from gn_ode_sir_tpu_torch.train.checkpoint import restore_params as _restore

    if not os.path.isfile(params_path(ckpt)):
        raise SystemExit(
            f"no checkpoint found under {ckpt} (expected serve.pt written by "
            "gn_ode_sir_tpu_torch.train.checkpoint.save_params)")
    return _restore(ckpt, device=device)


def _leaf_shapes(tree):
    return [(path, tuple(leaf.shape)) for path, leaf in tree_leaves(tree)]


def check_params_match(model, params) -> None:
    """Fail loudly when params don't fit the declared architecture (wrong
    --hidden/--model, or a K-stacked ensemble checkpoint)."""
    expect = _leaf_shapes(model.init(torch.Generator().manual_seed(0), device="cpu"))
    got = _leaf_shapes(params) if isinstance(params, dict) else []
    if expect != got:
        raise SystemExit(
            "checkpoint params do not match the declared architecture "
            f"(check --model/--hidden, and that --ckpt is not a K-stacked "
            f"ensemble directory): expected leaves {expect}, checkpoint has {got}")


def scenario_batch(n_nodes: int, seeds, beta, gamma):
    """[B, n] initial indicator rows + [B] params (numpy), the model input
    contract."""
    b = len(seeds)
    i0 = np.zeros((b, n_nodes), np.float32)
    for j, s in enumerate(seeds):
        i0[j, np.asarray(s, np.int64)] = 1.0
    s0 = 1.0 - i0
    r0 = np.zeros_like(i0)
    return s0, i0, r0, np.asarray(beta, np.float32), np.asarray(gamma, np.float32)


def _summary_reduce(probs: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-scenario epidemic summary [T, B, n, 3] -> [B, 3]: peak infected
    fraction, peak time (the first maximum, as ``jnp.argmax``), final
    recovered fraction. ``mask`` ([B, n], 1 on real nodes) makes the node
    means exact on padded batches."""
    if mask is None:
        i_t = probs[..., 1].mean(dim=2)  # [T, B]
        final_r = probs[-1, :, :, 2].mean(dim=1)
    else:
        denom = mask.sum(dim=1).clamp_min(1.0)  # [B]
        i_t = (probs[..., 1] * mask[None]).sum(dim=2) / denom[None]
        final_r = (probs[-1, :, :, 2] * mask).sum(dim=1) / denom
    peak, _ = i_t.max(dim=0)
    t_idx = torch.arange(i_t.shape[0], device=i_t.device)[:, None].expand_as(i_t)
    first = torch.where(i_t == peak[None], t_idx, i_t.shape[0]).amin(dim=0)
    return torch.stack([peak, first.to(peak.dtype), final_r], dim=1)


def _chunked(call, arrays, dispatch_batch, batch_axis):
    """Run ``call(*chunk)`` over fixed-size chunks of the scenario arrays and
    concatenate on ``batch_axis``. The tail chunk is padded by repeating its
    last scenario (a valid model input); padding rows are sliced off."""
    b = arrays[0].shape[0]
    if dispatch_batch < 1:
        raise ValueError("dispatch_batch must be a positive integer")
    outs = []
    for lo in range(0, b, dispatch_batch):
        hi = min(lo + dispatch_batch, b)
        chunk = [a[lo:hi] for a in arrays]
        pad = dispatch_batch - (hi - lo)
        if pad:
            chunk = [np.concatenate([a, np.repeat(a[-1:], pad, 0)], 0)
                     for a in chunk]
        out = call(*chunk)
        sl = [slice(None)] * out.ndim
        sl[batch_axis] = slice(0, hi - lo)
        outs.append(out[tuple(sl)])
    return np.concatenate(outs, axis=batch_axis)


def _upload(arrays, dev) -> list:
    """The scenario arrays as tensors on ``dev``. ``_upload.upload_bytes``
    counts the bytes put on a device this way since import (a copy from the
    host where ``dev`` is a card), ``_upload.calls`` the calls."""
    xs = [torch.as_tensor(a, device=dev) for a in arrays]
    _upload.upload_bytes += sum(x.nbytes for x in xs)
    _upload.calls += 1
    return xs


_upload.upload_bytes = 0
_upload.calls = 0


def _dispatch(model, params, adj, arrays, reduce_fn=None) -> np.ndarray:
    """One device dispatch: numpy scenario arrays in, numpy out. Under a
    profiler its spans ``serve.upload``, ``serve.forward`` (prediction and
    reduction) and ``serve.readback`` (where the host waits for what the card
    has left to do)."""
    dev = next(leaf for _, leaf in tree_leaves(params)).device
    with torch.inference_mode():
        with span("serve.upload"):
            xs = _upload(arrays, dev)
        with span("serve.forward"):
            out = model.predict(params, adj, *xs)
            if reduce_fn is not None:
                out = reduce_fn(out)
        with span("serve.readback"):
            return out.cpu().numpy()


def _spmd_world() -> int:
    """The size of the process group the sharded path splits over (1: none)."""
    return dist.get_world_size() if dist.is_initialized() else 1


@functools.cache
def _serving_mesh(device_type: str):
    """One mesh over the whole group for every sharded dispatch of this
    process (building a mesh creates process groups)."""
    from gn_ode_sir_tpu_torch.parallel import make_mesh

    return make_mesh(device_type=device_type)


def _spmd_dispatch(model, params, adj, arrays, *, summary: bool) -> np.ndarray:
    """One dispatch split over the group: the batch is padded to a multiple
    of the group size by repeating its last scenario (a valid model input),
    each process scores its block (and reduces it to summaries when
    ``summary``), the blocks are all-gathered and the padding sliced off."""
    from gn_ode_sir_tpu_torch.parallel.spmd import make_spmd_predict_fn

    b, world = arrays[0].shape[0], _spmd_world()
    pad = (-b) % world
    if pad:
        arrays = [np.concatenate([a, np.repeat(a[-1:], pad, 0)], 0) for a in arrays]
    dev = next(leaf for _, leaf in tree_leaves(params)).device
    predict = make_spmd_predict_fn(model, lambda gi: adj, _serving_mesh(dev.type),
                                   reduce_fn=_summary_reduce if summary else None)
    out = predict(params, dict(zip(("s0", "i0", "r0", "beta", "gamma"), arrays)))
    out = out.cpu().numpy()
    return out[:b] if summary else out[:, :b]


def predict_scenarios(model, params, adj, s0, i0, r0, beta, gamma, *,
                      spmd=False, dispatch_batch=None) -> np.ndarray:
    """[T, B, n, 3] probabilities on the params' device; ``dispatch_batch``
    caps the scenarios of one dispatch; ``spmd`` splits each dispatch over
    the process group (every process returns the whole result)."""
    arrays = (s0, i0, r0, beta, gamma)
    if spmd and _spmd_world() > 1:
        call = lambda *c: _spmd_dispatch(model, params, adj, c, summary=False)
    else:
        call = lambda *c: _dispatch(model, params, adj, c)
    if dispatch_batch and s0.shape[0] > dispatch_batch:
        return _chunked(call, arrays, dispatch_batch, batch_axis=1)
    return call(*arrays)


def predict_summaries(model, params, adj, s0, i0, r0, beta, gamma, *,
                      spmd=False, dispatch_batch=None) -> list[dict]:
    """Summary-only serving: each dispatch reduces its [T, B, n, 3]
    trajectory on the device to [B, 3] (peak infected fraction/time, final
    recovered fraction), so only a few floats per scenario come back.
    Summaries are per-scenario, so ``dispatch_batch`` chunking is exact, and
    so is ``spmd``, where each process reduces its own block.
    Returns the same rows as :func:`summarize`."""
    arrays = (s0, i0, r0, beta, gamma)
    if spmd and _spmd_world() > 1:
        call = lambda *c: _spmd_dispatch(model, params, adj, c, summary=True)
    else:
        call = lambda *c: _dispatch(model, params, adj, c, reduce_fn=_summary_reduce)
    if dispatch_batch and s0.shape[0] > dispatch_batch:
        out = _chunked(call, arrays, dispatch_batch, batch_axis=0)
    else:
        out = call(*arrays)
    return [{"scenario": j, "peak_infected_frac": float(out[j, 0]),
             "peak_time": int(out[j, 1]),
             "final_recovered_frac": float(out[j, 2])}
            for j in range(out.shape[0])]


def summarize(probs_btn3) -> list[dict]:
    """Per-scenario epidemic summary from [B, T, n, 3] trajectories (numpy)."""
    rows = []
    for j in range(probs_btn3.shape[0]):
        i_t = probs_btn3[j, :, :, 1].mean(axis=1)  # expected infected frac
        rows.append({
            "scenario": j,
            "peak_infected_frac": float(i_t.max()),
            "peak_time": int(i_t.argmax()),
            "final_recovered_frac": float(probs_btn3[j, -1, :, 2].mean()),
        })
    return rows


def main(argv=None) -> int:
    from gn_ode_sir_tpu_torch.cli import apply_data_root_default

    apply_data_root_default()
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    joined = False
    if args.spmd:
        from gn_ode_sir_tpu_torch.parallel import init_distributed

        joined = init_distributed(device_type=device.type)
    try:
        return _serve(args, device)
    finally:
        if joined:
            _serving_mesh.cache_clear()
            dist.destroy_process_group()


def _serve(args, device) -> int:
    # full-f32 matmuls: TF32 would quietly change every dense A·Z and linear
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from gn_ode_sir_tpu_torch.graphs import load_graph

    g = load_graph(args.dataset)
    seeds, beta, gamma = load_scenarios(args)
    if not seeds:
        raise SystemExit("no scenarios to score (empty --scenarios file?)")
    for j, s in enumerate(seeds):
        bad = [v for v in s if not 0 <= int(v) < g.n_nodes]
        if bad:
            raise SystemExit(
                f"scenario {j}: seed nodes {bad} out of range for "
                f"{g.name} (n_nodes={g.n_nodes})")
    if args.dispatch_batch is not None and args.dispatch_batch < 1:
        raise SystemExit("--dispatch_batch must be a positive integer")
    # the solver policy is sized for what one DISPATCH holds
    dispatch_b = min(len(seeds), args.dispatch_batch or len(seeds))
    model, adj = build_model_and_adj(args, g, batch_size=dispatch_b, device=device)
    params = restore_params(args.ckpt, device=device)
    check_params_match(model, params)
    s0, i0, r0, beta, gamma = scenario_batch(g.n_nodes, seeds, beta, gamma)
    writer = not args.spmd or not dist.is_initialized() or dist.get_rank() == 0
    if args.summary_only:
        rows = predict_summaries(model, params, adj, s0, i0, r0, beta, gamma,
                                 spmd=args.spmd, dispatch_batch=args.dispatch_batch)
        if not writer:
            return 0
    else:
        out = predict_scenarios(model, params, adj, s0, i0, r0, beta, gamma, spmd=args.spmd,
                                dispatch_batch=args.dispatch_batch)  # [T, B, n, 3]
        if not writer:
            return 0
        probs = np.transpose(out, (1, 0, 2, 3))  # [B, T, n, 3]
        np.savez(
            args.out,
            S=probs[..., 0], I=probs[..., 1], R=probs[..., 2],
            beta=beta, gamma=gamma,
            seed_sets=np.asarray(
                [",".join(map(str, s)) for s in seeds], dtype=object),
        )
        rows = summarize(probs)
    if args.summary_csv:
        import csv

        with open(args.summary_csv, "w", newline="") as f:
            wtr = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            wtr.writeheader()
            wtr.writerows(rows)
    print(json.dumps({"scenarios": len(seeds),
                      "out": None if args.summary_only else args.out,
                      "summary": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
