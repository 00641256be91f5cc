"""The port's parallel layer across processes, one device each, against the
same work on one device.

    python3 scripts/torch_parallel_check.py [--device cuda|cpu] [--nprocs N] [--out FILE]

Starts N processes (default: every visible card; 4 on the CPU), each joining
one group through ``parallel.init_distributed`` (NCCL, one card a process;
gloo on the CPU, at a small size, as a rehearsal), on the enron-size
power-law graph of ``chip_smoke.py`` (n = 33,696, 361,000 directed edges;
on the CPU 2,000 nodes). Rank 0 then repeats each piece of work on its own
device alone and compares:

- ``edge_spmm``: ``spmm_edge_sharded`` over an N-way edge axis (K1 on each
  block's plan, all-reduce; K1-bwd in the backward) at [8, n, 64] against
  K1 and K1-bwd on the whole plan, within 1e-5 · (1 + sum|w x|), and the
  time of a forward and backward through an ``EdgeShardedCooAdj`` whose
  plans are built;
- ``train_step`` and ``train_step_2d``: one SGD step (lr 1, so that a
  leaf's update is its gradient) of C7 (hidden 64, euler, maxTime 20, batch
  1 a data shard) through ``make_spmd_train_step`` on an N-way data axis and
  ``make_spmd_train_step_2d`` on an (N/2) x 2 data x edge mesh, against the
  single-device step on the whole batch: loss within 1e-6, every leaf's
  update within 1e-5 of its largest entry;
- ``simulate``: ``simulate_sir_sharded`` (K2 on each process), 10,000
  simulations (1,000 on the CPU), S + I + R = 1, monotone R, mean |I - I_one| < 0.02 against
  ``simulate_sir`` on one device (other random streams);
- ``predict``: ``make_spmd_predict_fn`` over 16 scenarios against
  ``model.predict`` on one device, within 1e-5;
- ``ensemble``: ``fit_ensemble(mesh=)`` with N members (hidden 8, 1 epoch)
  split over an N-way member axis against the unsharded run on one device.

Each comparison is printed as one JSON line with the wall ms of both sides
(host clock around work that ends in a synchronise, after a warm-up call;
the ensemble's two runs are first calls), then the cards' name and power
limit as ``nvidia-smi`` gives them; the last line is ``{"ok": true, ...}``. Exits non-zero on any disagreement, and without a
card when ``--device cuda``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))

from chip_smoke import (  # noqa: E402
    ENRON_DIRECTED_EDGES, ENRON_NODES, SEED, KERNEL_REL_TOL, SPMD_LEAF_RTOL, SPMD_LOSS_ATOL,
    powerlaw_graph)

MAX_TIME = 20
SCENARIOS = 16
MC_TOL = 0.02


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    """(fn's result, wall ms), the work synchronised before and after."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def _inputs(graph, batch, rng):
    """A trial batch (numpy): ``batch`` rows of 3 seed nodes, random rates,
    Dirichlet pseudo-labels [B, T, n, 3]."""
    n = graph.n_nodes
    i0 = np.zeros((batch, n), np.float32)
    for b in range(batch):
        i0[b, rng.choice(n, 3, replace=False)] = 1.0
    labels = rng.dirichlet([2.0, 1.0, 1.0], size=(batch, MAX_TIME, n)).astype(np.float32)
    return {"s0": 1.0 - i0, "i0": i0, "r0": np.zeros_like(i0),
            "beta": rng.uniform(0.1, 0.5, batch).astype(np.float32),
            "gamma": rng.uniform(0.05, 0.3, batch).astype(np.float32),
            "weight": np.ones(batch, np.float32), "labels": labels}


def _sgd_update(params, device, step):
    """One SGD step at lr 1 from ``params`` on ``device``: (loss, the update
    of every leaf, on the host)."""
    from gn_ode_sir_tpu_torch.train.checkpoint import tree_leaves, tree_map

    p = tree_map(lambda t: t.detach().to(device).clone().requires_grad_(True), params)
    before = {k: leaf.detach().clone() for k, leaf in tree_leaves(p)}
    loss = float(step(p, torch.optim.SGD([leaf for _, leaf in tree_leaves(p)], lr=1.0)))
    return loss, {k: (leaf.detach() - before[k]).cpu() for k, leaf in tree_leaves(p)}


def _update_err(got, want) -> dict:
    (loss_got, upd_got), (loss_want, upd_want) = got, want
    rel = max(float((upd_got[k] - u).abs().max()) / max(float(u.abs().max()), 1e-30)
              for k, u in upd_want.items())
    return {"loss_abs_err": abs(loss_got - loss_want), "leaf_rel_err": rel,
            "ok": abs(loss_got - loss_want) <= SPMD_LOSS_ATOL and rel <= SPMD_LEAF_RTOL}


def _rank_main(rank, world, port, cfg, out_dir):
    import torch.distributed as dist

    from gn_ode_sir_tpu_torch.models import GNODE
    from gn_ode_sir_tpu_torch.ops.spmm2 import Spmm2Adj, spmm2, spmm2_plain
    from gn_ode_sir_tpu_torch.parallel import (init_distributed, make_mesh,
                                               make_spmd_predict_fn, make_spmd_train_step,
                                               make_spmd_train_step_2d, simulate_sir_sharded,
                                               spmm_edge_sharded)
    from gn_ode_sir_tpu_torch.parallel.mesh import axis_group, local_block, mesh_device
    from gn_ode_sir_tpu_torch.parallel.spmd import EdgeShardedCooAdj
    from gn_ode_sir_tpu_torch.sim import simulate_sir
    from gn_ode_sir_tpu_torch.train import build_trial_data, fit_ensemble, init_ensemble
    from gn_ode_sir_tpu_torch.train.checkpoint import tree_map
    from gn_ode_sir_tpu_torch.train.loss import l1_sir_loss

    torch.set_num_threads(1 if cfg["device"] == "cpu" else 4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not init_distributed(f"127.0.0.1:{port}", world, rank, device_type=cfg["device"]):
        raise RuntimeError("init_distributed did not join a group")
    mesh = make_mesh(device_type=cfg["device"])
    dev = mesh_device(mesh)
    graph = powerlaw_graph(cfg["n"], cfg["edges"], SEED)
    rng = np.random.default_rng([SEED, 61])
    records = []
    full = Spmm2Adj.from_graph(graph, device=dev)

    def one_device(fn):
        """``fn()`` on rank 0's device alone, the others waiting."""
        out = fn() if rank == 0 else None
        dist.barrier()
        return out

    # edge_spmm: N blocks of the dst-sorted edge list, zero-weight padding
    e = graph.n_edges
    pad = (-e) % world
    src = np.concatenate([graph.src, np.zeros(pad, np.int32)])
    dst = np.concatenate([graph.dst, np.zeros(pad, np.int32)])
    w = np.concatenate([np.ones(e), np.zeros(pad)]).astype(np.float32)
    sl = local_block(src.size, mesh, "data")
    x = torch.as_tensor(rng.standard_normal((8, graph.n_nodes, 64), np.float32), device=dev)
    g = torch.as_tensor(rng.standard_normal(x.shape, np.float32), device=dev)
    xg = x.clone().requires_grad_(True)
    group = axis_group(mesh, "data")
    y = spmm_edge_sharded(src[sl], dst[sl], xg, graph.n_nodes, group, w[sl])
    (dx,) = torch.autograd.grad(y, xg, g)
    # the same block applied again, its plans built once: forward and backward
    adj, ms_build = _timed(lambda: EdgeShardedCooAdj.from_local(
        src[sl], dst[sl], w[sl], graph.n_nodes, group, device=dev), dev)
    apply = lambda: torch.autograd.grad(adj.matvec(xg), xg, g)
    apply()
    _, ms = _timed(apply, dev)

    def edge_ref():
        want, want_dx = spmm2(full.plan, x), spmm2(full.plan_t, g)
        _, ms_one = _timed(lambda: (spmm2(full.plan, x), spmm2(full.plan_t, g)), dev)
        tol = KERNEL_REL_TOL * (1.0 + spmm2_plain(full.plan, x.abs()))
        tol_dx = KERNEL_REL_TOL * (1.0 + spmm2_plain(full.plan_t, g.abs()))
        err, err_dx = (y.detach() - want).abs(), (dx - want_dx).abs()
        return {"check": "edge_spmm", "shape": list(x.shape), "blocks": world,
                "max_abs_err": float(err.max()), "grad_max_abs_err": float(err_dx.max()),
                "ms_block_plan_build": ms_build, "ms_sharded_forward_backward": ms,
                "ms_one_device_forward_backward": ms_one,
                "ok": bool((err <= tol).all() and (err_dx <= tol_dx).all())}

    records.append(one_device(edge_ref))

    # train_step / train_step_2d: batch 1 a data shard, C7 on K1
    model = GNODE(hidden=64, max_time=MAX_TIME, delta_t=0.5, method="euler", adjoint="direct")
    params = model.init(torch.Generator().manual_seed(SEED), device="cpu")
    for name, shape, names in (("train_step", (world,), ("data",)),
                               ("train_step_2d", (max(world // 2, 1), min(world, 2)),
                                ("data", "edge"))):
        m = make_mesh(shape, names, device_type=cfg["device"])
        batch = _inputs(graph, shape[0], rng)
        if name == "train_step":
            step = make_spmd_train_step(model, lambda gi: full, m)
            call = lambda p, opt: step(p, opt, batch)
        else:
            step = make_spmd_train_step_2d(model, m, graph.n_nodes)
            call = lambda p, opt: step(p, opt, batch, src, dst, w)
        _sgd_update(params, dev, call)  # the first step builds the block's plans
        got, ms = _timed(lambda: _sgd_update(params, dev, call), dev)

        def single():
            on = lambda k: torch.as_tensor(batch[k], device=dev)

            def step1(p, opt):
                pred = model.predict(p, full, *(on(k) for k in ("s0", "i0", "r0", "beta",
                                                                "gamma")))
                loss = l1_sir_loss(pred, on("labels"), trial_weight=on("weight"))
                loss.backward()
                opt.step()
                return loss

            _sgd_update(params, dev, step1)  # warm, as the sharded step was
            want, ms_one = _timed(lambda: _sgd_update(params, dev, step1), dev)
            return {"check": name, "mesh": list(shape), "global_batch": shape[0],
                    "ms_sharded": ms, "ms_one_device": ms_one, **_update_err(got, want)}

        records.append(one_device(single))

    # simulate: K2 on every process
    nodes = sorted(rng.choice(graph.n_nodes, 3, replace=False).tolist())
    # warm: the dense adjacency of the count product is built at first use
    simulate_sir_sharded(graph, nodes, 0.3, 0.1, mesh=mesh, sims=16 * world, max_time=2)
    sims = cfg["sims"]
    (s, i, r), ms = _timed(lambda: simulate_sir_sharded(graph, nodes, 0.3, 0.1, mesh=mesh,
                                                        sims=sims, max_time=MAX_TIME,
                                                        key=1000), dev)

    def sim_ref():
        (_, i1, _), ms_one = _timed(lambda: simulate_sir(graph, nodes, 0.3, 0.1, sims=sims,
                                                         max_time=MAX_TIME, seed=2000,
                                                         device=dev), dev)
        mc = float(np.abs(i - i1).mean())
        ok = (np.abs(s + i + r - 1.0).max() <= 1e-9 and not (np.diff(r, axis=0) < 0).any()
              and mc < MC_TOL)
        return {"check": "simulate", "sims": sims, "mean_abs_diff_I": mc, "ms_sharded": ms,
                "ms_one_device": ms_one, "ok": bool(ok)}

    records.append(one_device(sim_ref))

    # predict: SCENARIOS split over the data axis
    batch = _inputs(graph, SCENARIOS, rng)
    scen = {k: batch[k] for k in ("s0", "i0", "r0", "beta", "gamma")}
    predict = make_spmd_predict_fn(model, lambda gi: full, mesh)
    p_dev = tree_map(lambda t: t.to(dev), params)
    predict(p_dev, scen)  # warm
    out, ms = _timed(lambda: predict(p_dev, scen), dev)

    def predict_ref():
        with torch.inference_mode():
            want, ms_one = _timed(lambda: model.predict(
                p_dev, full, *(torch.as_tensor(scen[k], device=dev)
                               for k in ("s0", "i0", "r0", "beta", "gamma"))), dev)
        err = float((out - want).abs().max())
        return {"check": "predict", "scenarios": SCENARIOS, "max_abs_err": err,
                "ms_sharded": ms, "ms_one_device": ms_one, "ok": err <= 1e-5}

    records.append(one_device(predict_ref))

    # ensemble: one member a process
    trials = _inputs(graph, 6, rng)
    data = build_trial_data(graph.n_nodes, [np.flatnonzero(t).tolist() for t in trials["i0"]],
                            trials["beta"], trials["gamma"],
                            [tuple(lab[..., c] for c in range(3)) for lab in trials["labels"]])
    small = GNODE(hidden=8, max_time=MAX_TIME, delta_t=0.5, method="euler", adjoint="direct")
    seeds = list(range(world))

    def ensemble(**kw):
        res = fit_ensemble(small, lambda leaves: torch.optim.Adam(leaves, lr=1e-3),
                           init_ensemble(small, seeds, device=dev), data, [0, 1, 2], [3],
                           [4, 5], lambda gi: full, seeds=seeds, epochs=1, batch_size=1,
                           verbose=False, **kw)
        return np.concatenate([np.ravel(res.history[0][1]), np.ravel(res.history[0][2]),
                               np.ravel(res.test_loss)])

    got, ms = _timed(lambda: ensemble(mesh=make_mesh(axis_names=("ensemble",),
                                                     device_type=cfg["device"])), dev)

    def ensemble_ref():
        want, ms_one = _timed(ensemble, dev)
        err = float(np.abs(got - want).max())
        return {"check": "ensemble", "members": world, "max_abs_err": err, "ms_sharded": ms,
                "ms_one_device": ms_one, "ok": err <= SPMD_LOSS_ATOL}

    records.append(one_device(ensemble_ref))
    if rank == 0:
        with open(os.path.join(out_dir, "records.json"), "w") as f:
            json.dump(records, f)
    dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--nprocs", type=int, default=None)
    p.add_argument("--out", default=None, help="also write the records to this JSON file")
    args = p.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_parallel_check: no CUDA device", file=sys.stderr)
            return 2
        from gn_ode_sir_tpu_torch import native
        from gn_ode_sir_tpu_torch.ops import _kernels

        _kernels.build_all()  # once, before the processes start
        native.native_available()
        world = args.nprocs or torch.cuda.device_count()
        cfg = {"device": "cuda", "n": ENRON_NODES, "edges": ENRON_DIRECTED_EDGES,
               "sims": 10_000}
        device = {"name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    else:
        world = args.nprocs or 4
        cfg = {"device": "cpu", "n": 2_000, "edges": 12_000, "sims": 1_000}
        device = {"name": "cpu", "count": world}
        smi = "cpu"
    from gn_ode_sir_tpu_torch.parallel.distributed import free_port

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        torch.multiprocessing.spawn(_rank_main, args=(world, free_port(), cfg, out_dir),
                                    nprocs=world, join=True)
        with open(os.path.join(out_dir, "records.json")) as f:
            records = json.load(f)
    for rec in records:
        print(json.dumps({"processes": world, "device": cfg["device"], **rec}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    ok = all(rec["ok"] for rec in records)
    print(smi)
    print(json.dumps({"ok": ok, "processes": world, "seconds": time.perf_counter() - t0,
                      "device": device}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
