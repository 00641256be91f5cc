"""Driver of the training cells: GN-ODE optimiser steps through the epoch
function that ``train.loop.fit`` builds (``make_train_epoch_fn``), on one
graph (``cli.worker.build_model_and_adj``) or on several with the
unseen-graph protocol (``train.multigraph.multigraph_auto_fns``: one K1 plan
per graph, graph-homogeneous minibatches, the train view's width).

Set-up builds the one trainer and makes its first call of the epoch
function at the window's shape (``steps_per_call`` rows, all different),
which warms up every shape the window uses; the window goes on with the
same trainer over seeded epoch shuffles. Two calls are recorded through
hooks on the optimiser's step, which keep, for each step, the parameters
and Adam's moments and step number before it, the gradient Adam takes and
the parameters after it: the first ``first_steps`` steps of the set-up's
call, and every step of one window call drawn from the seed among its
first ``check_call_within`` (the window runs until that call is done).
Once the window has closed the reference follows each recorded step from
the program's parameters before it (at some inputs the trajectory
amplifies rounding, and two trajectories a step apart drift apart), checks
Adam's update by itself, and checks the window call's mean loss.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import sys

import numpy as np
import torch

from perfbench import faults, harness, inputs, program
from perfbench.reference import gnode as ref


@dataclasses.dataclass
class State:
    cfg: dict
    traffic: dict
    seed: int
    graphs: list  # the benchmark's graphs (name, n, edges, pairs)
    graph_idx: np.ndarray  # [N] each trial's graph (its position in graphs)
    batch: int
    program: dict  # the trainer and its feed
    rng: np.random.Generator  # epoch shuffles
    sampled_call: int  # the window call the reference follows
    rows: np.ndarray = None
    weights: np.ndarray = None
    pos: int = 0
    epoch: int = -1
    calls: int = 0  # window calls made
    recorded: list = None  # the recorded calls
    check_inputs: list = None  # their steps' inputs for the reference


def _build_program(cfg, graphs, batch, device):
    """(model, adj_fn, node_mask_fn, n_view, width, by_graph, adjacency
    kind) as the worker builds them."""
    from gn_ode_sir_tpu_torch.cli import worker
    from gn_ode_sir_tpu_torch.graphs import pad_graphs
    from gn_ode_sir_tpu_torch.graphs.graph import graph_from_edges
    from gn_ode_sir_tpu_torch.train import multigraph_auto_fns

    args = program.worker_args(cfg, batch, device)
    pg = [graph_from_edges(g["n"], g["pairs"], name=g["name"]) for g in graphs]
    if len(pg) == 1:
        model, adj = worker.build_model_and_adj(args, pg[0], batch_size=batch, device=device)
        return model, lambda gi: adj, None, None, pg[0].n_nodes, False, type(adj).__name__
    gb = pad_graphs(pg, 8, 128)  # as train.assemble_multigraph_trials pads them
    model = worker.build_model(args, gb.n_max, device=device)
    conn = multigraph_auto_fns(gb, gcn_normalized=False, eval_graph=-1, kind=cfg["model"]["mg_adj"],
                               precision="f32", device=device)
    n_view = getattr(conn.adj_fn, "n_view", None)
    return (model, conn.adj_fn, conn.node_mask_fn, n_view, gb.n_max, conn.batch_by_graph,
            conn.kind)


def setup(cfg: dict, traffic: dict, seed: int, device) -> State:
    from gn_ode_sir_tpu_torch.train.loop import make_train_epoch_fn

    device = torch.device(device)
    rng = np.random.default_rng(seed)
    t = cfg["training"]
    graphs = inputs.graphs(cfg, rng)
    harness.mark("graphs")
    train_graphs = [k for k, g in enumerate(cfg["graphs"]) if g.get("role", "train") == "train"]
    if train_graphs != list(range(len(train_graphs))):
        raise ValueError("the unseen graph comes last (eval_graph=-1)")
    batch = t["batch_size"]
    model, adj_fn, mask_fn, n_view, width, by_graph, kind = _build_program(
        cfg, graphs, batch, device)
    program.check_model(model, cfg)
    program.check_adjacency(kind, cfg)
    harness.mark("program")
    per_graph = traffic["trials_per_graph"]
    scen, gidx = [], []
    for k in train_graphs:
        scen += inputs.trials(rng, graphs[k]["n"], per_graph, t["n_i"], t["beta"], t["gamma"])
        gidx += [k] * per_graph
    gidx = np.asarray(gidx, np.int32)
    gen = inputs.device_generator(seed, device)
    params = inputs.gnode_params(gen, cfg["model"]["hidden"], device)
    harness.mark("parameters")
    times = cfg["model"]["max_time"]
    # the trainer's feed, laid out as train.data.build_trial_data and
    # train.loop._data_to_device lay it out (nodes zero-padded to the width)
    count = len(scen)
    labels = torch.zeros((count, times, width, 3), device=device)
    for k in np.unique(gidx):
        at = torch.as_tensor(np.flatnonzero(gidx == k), device=device)
        n = graphs[k]["n"]
        labels[at, :, :n] = inputs.synthetic_labels(gen, len(at), times, n, device)
    i0 = torch.zeros((count, width), device=device)
    i0[np.repeat(np.arange(count), [len(sc[0]) for sc in scen]),
       np.concatenate([sc[0] for sc in scen])] = 1.0
    real = torch.arange(width, device=device) < torch.as_tensor(
        [graphs[k]["n"] for k in gidx], device=device)[:, None]
    d = {"s0": real.float() - i0, "i0": i0, "r0": torch.zeros_like(i0),
         "beta": torch.tensor([s[1] for s in scen], dtype=torch.float32, device=device),
         "gamma": torch.tensor([s[2] for s in scen], dtype=torch.float32, device=device),
         "labels": labels, "graph_idx": gidx}
    harness.mark("feed")
    # the trained copy and its optimiser, as fit makes them
    leaves = {key: params[key[0]][key[1]].detach().clone().requires_grad_(True)
              for key in ref.LEAVES}
    tree = {}
    for (layer, name), leaf in leaves.items():
        tree.setdefault(layer, {})[name] = leaf
    harness.mark("leaves")
    opt = torch.optim.Adam(list(leaves.values()), lr=t["lr"])
    harness.mark("optimizer")  # torch's first optimiser imports torch._dynamo
    epoch_fn = make_train_epoch_fn(model, opt, adj_fn, mask_fn, n_view=n_view)
    st = State(cfg=cfg, traffic=traffic, seed=seed, graphs=graphs, graph_idx=gidx, batch=batch,
               rng=np.random.default_rng([seed, 1]),
               sampled_call=int(np.random.default_rng([seed, 2]).integers(
                   traffic["check_call_within"])),
               program={"params": tree, "leaves": leaves, "opt": opt, "fn": epoch_fn, "d": d,
                        "by_graph": by_graph, "model": model, "adj_fn": adj_fn},
               recorded=[])
    harness.mark("epoch function")
    st.rows, st.weights = _epoch_rows(st)
    st.pos, st.epoch = 0, 0
    _next_call(st, traffic["steps_per_call"], record=traffic["first_steps"])
    harness.mark("first call")
    return st


def _epoch_rows(st: State):
    from gn_ode_sir_tpu_torch.train.loop import index_batches

    idx = np.arange(len(st.graph_idx))
    return index_batches(idx, st.graph_idx, st.batch, st.rng, st.program["by_graph"])


class _Recorder:
    """What a call's first ``keep`` steps produce, kept as device copies
    with no host sync: the model's prediction (``predict`` wrapped on this
    one model object), and through hooks on the optimiser's step the
    parameters, Adam's moments and step count before it, the gradient it
    takes, and the parameters after it."""

    def __init__(self, opt, leaves: dict, model, keep: int):
        self.leaves, self.model, self.keep, self.steps = leaves, model, keep, []
        self.handles = [opt.register_step_pre_hook(self.pre),
                        opt.register_step_post_hook(self.post)]
        self.k, self.pred = 0, None
        predict = model.predict

        def kept_predict(*args, **kwargs):
            out = predict(*args, **kwargs)
            if self.k < self.keep:
                self.pred = out.detach().clone()
            return out

        object.__setattr__(model, "predict", kept_predict)  # the model is a frozen dataclass

    def pre(self, opt, args, kwargs):
        if self.k >= self.keep:
            return
        copy = lambda t: t.detach().clone()
        state = {key: opt.state.get(leaf, {}) for key, leaf in self.leaves.items()}
        self.steps.append({
            "k": self.k, "pred": self.pred,
            "params": {key: copy(leaf) for key, leaf in self.leaves.items()},
            "grad": {key: copy(leaf.grad) if leaf.grad is not None else torch.zeros_like(leaf)
                     for key, leaf in self.leaves.items()},
            "moments": {key: tuple(copy(state[key][m]) if m in state[key]
                                   else torch.zeros_like(leaf)
                                   for m in ("exp_avg", "exp_avg_sq"))
                        for key, leaf in self.leaves.items()},
            "count": {key: copy(state[key]["step"]) if "step" in state[key] else None
                      for key in self.leaves}})
        self.pred = None

    def post(self, opt, args, kwargs):
        if self.k < self.keep:
            self.steps[-1]["after"] = {key: leaf.detach().clone()
                                       for key, leaf in self.leaves.items()}
        self.k += 1

    def close(self) -> list:
        for h in self.handles:
            h.remove()
        object.__delattr__(self.model, "predict")  # the class's own again
        return self.steps


def _call(st: State, rows, weights, epoch: int) -> float:
    from gn_ode_sir_tpu_torch.sim.mc_sir import fold_seed

    p = st.program
    loss = p["fn"](p["params"], p["d"], rows, weights, fold_seed(st.seed + 1, epoch))
    return float(loss)


def _next_call(st: State, take: int, record: int = 0) -> tuple[int, float]:
    """One call of the epoch function on the next ``take`` rows of the
    epoch (a new epoch's shuffle when this one is done); the first
    ``record`` steps recorded. (rows taken, the call's loss)"""
    if st.pos >= len(st.rows):
        st.rows, st.weights = _epoch_rows(st)
        st.pos, st.epoch = 0, st.epoch + 1
    sl = slice(st.pos, min(st.pos + take, len(st.rows)))
    p = st.program
    hooks = _Recorder(p["opt"], p["leaves"], p["model"], record) if record else None
    loss = _call(st, st.rows[sl], st.weights[sl], st.epoch)
    if hooks:
        st.recorded.append({"rows": st.rows[sl].copy(), "weights": st.weights[sl].copy(),
                            "loss": loss, "steps": hooks.close()})
    st.pos = sl.stop
    return sl.stop - sl.start, loss


def _run(st: State, *, seconds=None, steps=None) -> dict:
    """Steps until ``seconds`` have passed (the call under way finishes) or
    ``steps`` are done: wall time, steps, and each step's graph and real
    trials. A window (``seconds``) runs at least until its sampled call,
    which is recorded whole, is done."""
    spc = st.traffic["steps_per_call"]
    clock = harness.Clock(seconds if seconds is not None else float("inf"))
    done, units, bad = 0, [], 0
    window = seconds is not None
    while (not clock.over() or (window and st.calls <= st.sampled_call)) and (
            steps is None or done < steps):
        take = spc if steps is None else min(spc, steps - done)
        first = st.pos if st.pos < len(st.rows) else 0
        record = take if window and st.calls == st.sampled_call else 0
        k, loss = _next_call(st, take, record)
        bad += 0 if np.isfinite(loss) else k
        for r, w in zip(st.rows[first:first + k], st.weights[first:first + k]):
            units.append((int(st.graph_idx[r[0]]), int((w > 0).sum())))
        done += k
        st.calls += window
    return {"seconds": clock.elapsed(), "steps": done, "units": units, "failed": bad}


def window(st: State, seconds: float) -> dict:
    rec = _run(st, seconds=seconds)
    if st.traffic.get("trace_from_epoch_start"):
        # untimed: the rest of this epoch, so that the profiled stretch holds
        # whole epochs, each graph's rows in it the same for every seed
        _run(st, steps=len(st.rows) - st.pos)
    return rec


def traced(st: State) -> dict:
    from gn_ode_sir_tpu_torch.ops.spmm2 import spmm2

    k1 = spmm2.launches
    rec = _run(st, steps=st.traffic["trace_steps"])
    rec["k1_applies"] = spmm2.launches - k1
    return rec


def shapes(st: State) -> list[dict]:
    """Per graph the sizes the counts need."""
    return [{"n": g["n"], "edges": g["edges"]} for g in st.graphs]


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def _leaf_gaps(prog: dict, want: dict) -> dict:
    """Per leaf, the gap between the program's norm and the reference's,
    against the larger of that leaf's reference norm and the median leaf's."""
    p, r = _norms(prog), _norms(want)
    med = statistics.median(r.values())
    return {k: abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in r}


# At some inputs the GN-ODE's trajectory amplifies rounding, and any two
# float32 computations of it disagree far beyond float32's rounding (PERF.md,
# "Cells"). A call's mean loss, or a leaf's gradient at a step, is compared
# only where two float32 runs of the reference (the edges in two orders)
# both lie within these of the reference in float64; elsewhere it is noise
# at these inputs.
LOSS_NOISE = 3e-7
GRAD_NOISE = 1e-4


def _double(tree: dict) -> dict:
    return {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
            for k, v in tree.items()}


def _step_inputs(st: State, row, weight, edges: dict, device) -> dict:
    """The reference's copy of one step's inputs (the benchmark's own feed
    and graph, on the graph's real nodes)."""
    d = st.program["d"]
    k = int(st.graph_idx[row[0]])
    n = st.graphs[k]["n"]
    if k not in edges:
        edges[k] = tuple(torch.as_tensor(a, device=device)
                         for a in inputs.directed(st.graphs[k]["pairs"]))
    trial = torch.as_tensor(row, dtype=torch.long, device=device)
    return {"src": edges[k][0], "dst": edges[k][1], "s0": d["s0"][trial, :n].clone(),
            "i0": d["i0"][trial, :n].clone(), "r0": d["r0"][trial, :n].clone(),
            "beta": d["beta"][trial].clone(), "gamma": d["gamma"][trial].clone(),
            "labels": d["labels"][trial, :, :n].clone(),
            "weight": torch.as_tensor(weight, device=device), "n": n}


def _adam_count(count) -> int:
    """Adam's step number for a step, from the count in its state before."""
    return 1 if count is None else int(count) + 1


def _loss_of(pred, step: dict) -> float:
    """The loss, in float64, that the program's prediction [T, B, width, 3]
    gives on the step's real nodes; inf where it does not cover the batch."""
    if pred is None or pred.shape[1] != len(step["beta"]):
        return float("inf")
    return float(ref.l1_loss(pred[:, :, :step["n"]].double(), step["labels"].double(),
                             step["weight"].double()))


def check(st: State, rec: dict, limits: dict, detail: dict | None = None) -> list[dict]:
    """The reference follows every recorded step from the program's
    parameters before it, in float64, and judges what the step produced:
    the loss that its prediction gives, by the worst step (where the
    reference's float32 runs are within ``LOSS_NOISE`` of it), and a whole
    call's returned mean loss against its steps' (``loss_gap``); the
    gradient Adam took, by the worst leaf of each leaf's median over the
    steps (where the float32 runs are within ``GRAD_NOISE``; ``grad_gap``);
    Adam's update of each leaf from the program's gradient, moments and
    step count, by the worst leaf and step (``adam_gap``). A number with no
    comparison left reads inf. ``detail``, if given, gets every step's
    readings."""
    m, t = st.cfg["model"], st.cfg["training"]
    device = st.program["d"]["beta"].device
    edges, steps = {}, []
    for c, call in enumerate(st.recorded):
        for got in call["steps"]:
            steps.append((c, got, _step_inputs(st, call["rows"][got["k"]],
                                               call["weights"][got["k"]], edges, device)))
    calls = st.recorded
    st.program, st.recorded = None, None  # the program's state goes before the reference runs
    if device.type == "cuda":
        torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(st.seed)
    run = lambda params, step: ref.loss_and_grad(_tree(params), step, delta_t=m["delta_t"],
                                                 max_time=m["max_time"])
    per_step = []
    for c, got, step in steps:
        order = torch.randperm(len(step["src"]), generator=gen).to(step["src"].device)
        shuffled = {**step, "src": step["src"][order], "dst": step["dst"][order]}
        loss, grad = run(_double(got["params"]), _double(step))
        witnesses = [run(got["params"], step), run(got["params"], shuffled)]
        noise = [_leaf_gaps(g, grad) for _, g in witnesses]
        want = {key: ref.adam(got["params"][key], got["grad"][key], *got["moments"][key],
                              _adam_count(got["count"][key]), lr=t["lr"]) - got["params"][key]
                for key in ref.LEAVES}
        change = {key: got["after"][key] - got["params"][key] for key in ref.LEAVES}
        per_step.append({
            "call": c, "items": float(step["weight"].sum()) * step["n"],
            "mine": _loss_of(got["pred"], step), "loss": loss,
            "loss_noise": max(abs(w - loss) for w, _ in witnesses) / abs(loss),
            "grad": _leaf_gaps(got["grad"], grad),
            "noise": {key: max(n[key] for n in noise) for key in ref.LEAVES},
            "adam": _leaf_gaps(change, want)})
        got["pred"] = None
    loss_gaps = [abs(s["mine"] - s["loss"]) / abs(s["loss"]) for s in per_step
                 if s["loss_noise"] <= LOSS_NOISE]
    kept_steps = len(loss_gaps)
    # each call recorded whole: its returned mean loss against its steps'
    whole = 0
    for c, call in enumerate(calls):
        mine = [s for s in per_step if s["call"] == c]
        if len(mine) == len(call["rows"]):
            whole += 1
            want = sum(s["mine"] * s["items"] for s in mine) / sum(s["items"] for s in mine)
            loss_gaps.append(abs(call["loss"] - want) / abs(want))
    by_leaf = {key: [s["grad"][key] for s in per_step if s["noise"][key] <= GRAD_NOISE]
               for key in ref.LEAVES}
    kept = sum(map(len, by_leaf.values()))
    values = {
        "loss_gap": (max(loss_gaps) if kept_steps else float("inf"),
                     f"{kept_steps} of {len(per_step)} steps, {whole} calls"),
        "grad_gap": (max((statistics.median(v) for v in by_leaf.values() if v),
                         default=float("inf")),
                     f"{kept} of {len(per_step) * len(ref.LEAVES)} leaf-steps"),
        "adam_gap": (max((max(s["adam"].values()) for s in per_step), default=float("inf")),
                     f"{len(per_step)} steps")}
    if detail is not None:
        detail["steps"] = [{**s, "grad": list(s["grad"].values()),
                            "noise": list(s["noise"].values()),
                            "adam": list(s["adam"].values())} for s in per_step]
        detail["calls"] = [c["loss"] for c in calls]
    # a number the cell gives no limit has no upper reading there (PERF.md, "Cells")
    for k in values.keys() - limits.keys():
        print(f"not compared: {k} {values[k][0]!r} ({values[k][1]})", file=sys.stderr)
    return [{"name": k, "value": v, "limit": limits[k], "compared": n}
            for k, (v, n) in values.items() if k in limits]


def _tree(flat: dict) -> dict:
    out: dict = {}
    for (layer, name), v in flat.items():
        out.setdefault(layer, {})[name] = v
    return out


def attempted(rec: dict) -> tuple[int, int]:
    return rec["steps"], rec["failed"]


# The per-layer metrics that read the spans of this driver's path
# (``tests/test_spans.py``).
SPAN_METRICS = ("forward_host_ms.train", "backward_host_ms.train", "optimizer_host_ms.train")
# The field of ``State`` that holds what the optimiser's hooks recorded: a
# check with none of it reads inf (``tests/test_faults.py``).
RECORDED = "recorded"


# --- faults, control and CPU cut (``faults.py``, ``control.py``, ``tests/small.py``)

FAULTS = ("state_unchanged", "half_batch", "answer_altered")


def applicable(cfg: dict, traffic: dict) -> tuple:
    if cfg["training"]["batch_size"] < 2:
        return tuple(f for f in FAULTS if f != "half_batch")  # no half of one trial
    return FAULTS


def plant(fault: str):
    """``state_unchanged``: the optimiser's step leaves the parameters as
    they were; ``half_batch``: a minibatch's loss over its first half;
    ``answer_altered``: the prediction at one label time is the one before
    it."""
    from gn_ode_sir_tpu_torch.models.gnode import GNODE
    from gn_ode_sir_tpu_torch.train import loop

    if fault == "state_unchanged":
        return faults._patched(torch.optim.Adam, "step", lambda self, closure=None: None)
    if fault == "half_batch":
        orig = loop._batch_loss

        def half(model, params, adj_fn, mask_fn, d, bidx, bw, gi, **kw):
            k = max(1, len(bidx) // 2)
            return orig(model, params, adj_fn, mask_fn, d, bidx[:k], bw[:k], gi[:k], **kw)

        return faults._patched(loop, "_batch_loss", half)
    if fault == "answer_altered":
        orig = GNODE.predict
        return faults._patched(GNODE, "predict",
                               lambda self, *a, **k: faults._off_by_one(orig(self, *a, **k), 0))
    raise ValueError(f"unknown fault {fault!r}")


def control_run(kind: str):
    """What a ``control.py`` reading of ``kind`` runs in (the control: TF32
    on) and the keyword arguments its check takes (``detail``: every
    recorded step's readings, for the look)."""
    return (faults.tf32() if kind == "control" else contextlib.nullcontext()), {"detail": {}}


def cpu_cut(wl: dict, cfg: dict) -> None:
    """K1's plain version, a few steps a call, few trials."""
    cfg["model"]["spmm"] = "pallas2"
    if len(cfg["graphs"]) > 1:
        cfg["model"]["mg_adj"] = "pallas2"
        wl["traffic"].update(trials_per_graph=10, steps_per_call=3, first_steps=2,
                             check_call_within=2, trace_steps=4)
    else:
        wl["traffic"].update(trials_per_graph=6, steps_per_call=4, first_steps=2,
                             check_call_within=2, trace_steps=3)
