"""Chip smoke test of the PyTorch/CUDA port (``gn_ode_sir_tpu_torch``).

    python3 chip_smoke.py

Drives the port's main paths on one NVIDIA card — serving and labels ->
training -> CSV at enron size, the published multi-graph run (five train
graphs and an unseen evaluation graph) and the GCN, GIN, DMP and Runge-Kutta
baselines — and holds every hand-written kernel against its plain PyTorch
version. Phases, each printed as one JSON line:

1. device — the card (and ``nvidia-smi``'s name and power limit, raw);
2. build  — every kernel compiled from ``gn_ode_sir_tpu_torch/csrc``;
3. kernel — each kernel against its plain version on the card at the main
   paths' shapes and at edge cases, with kernel / plain / library times and
   the bound (K1 and the library call also replayed from a CUDA graph, the
   device's time without the host's): K1 (forward, at serving's batch 8 and
   16 and training's batch 1; a star graph and its transpose, rows at the
   plan's segment boundaries, bf16 messages and state, and two launches
   that must give the same bits), K2 (the fused SIR step: one trial, four
   trials, and the whole chunk of trials the label path puts into one
   launch, with the count product timed beside it and checked for exactness
   on the hub), K1-bwd (the gradient through the autograd Function, and the
   Function's forward), K3 (the fused euler SIR update of the no-grad
   forward, bit for bit, at serving's shape), K4 and K5 (DMP's fused edge
   update and marginals, bit for bit against their plain versions fed the
   same node product, at the DMP serving cell's [128, n, E]); K1 and K1-bwd
   also at the
   multi-graph shapes: width
   8 (the published multi-graph hidden) and 5 (GIN's first layer), plans
   padded to the train view's and the evaluation graph's width, with and
   without GCN-normalized weights;
4. serve  — C7 GN-ODE (hidden 64, euler, deltaT 0.5, maxTime 20) with
   seeded random params, scored through ``cli.worker``/``cli.infer``:
   16 summary scenarios in dispatches of 8 and 2 full-trajectory scenarios,
   K1 launch counts per dispatch (and as many of K3's), and the card's
   output against the same path on the CPU; then DMP's serving path, one
   dispatch of 128 scenarios on the same graph: K4, K5 and the node
   product 19 times each, the first summaries against the CPU's;
5. labels — Monte-Carlo labels of six trials (10,000 simulations each)
   through ``utils.load_or_extract_labels_many``: K2 launch counts, label
   invariants, and a second call that is a pure cache hit;
6. train  — ``cli.worker.main`` (C7, batch 1, Adam lr 1e-4, 2 epochs) on
   those six trials: K1 forward and backward launch counts, losses, the CSV
   row, the saved checkpoint served through ``cli.infer``, and one training
   step on the card against the same step on the CPU;
7. multigraph — the published multi-graph configuration through
   ``cli.worker.main`` (six power-law graphs of the published sizes, the last
   unseen; hidden 8, batch 8, Adam lr 1e-3, ``--mg_adj auto``): ``auto`` must
   resolve to K1, training must run at the train view's width and evaluation
   at the full width, graph-homogeneous minibatches, K1 launch counts, ms per
   training step by graph and per evaluation pass, the CSV row, and one
   training step of GN-ODE, GCN and GIN on the card against the CPU;
8. baselines — on the wiki-vote-size graph, ``--model GCN`` and ``GIN`` (one
   epoch each, a step against the CPU, the checkpoint served), ``--model
   dmp`` and ``--model rk`` through ``cli.worker.main``, DMP and RK on the
   card against the CPU, with K4's and K5's launches (one each a step);
9. matrix — the experiment matrix (ensembles, crash and resume, backsolve,
   adaptive dopri5, the node split);
10. parallel — ``parallel/`` at world size 1 over NCCL: the data-parallel
   and the data x edge training steps against the single-device step, the
   sharded simulator (K2), ``cli.infer --spmd`` and ``fit_ensemble(mesh=)``;
   utils — ``trace()``, ``fit(profile_dir=)``, ``device_memory_stats`` and
   the roofline utilization of a training step and of K1; with the kernel
   phase, K1 and K1-bwd on the two halves of the edge list (an edge shard's
   plans), ``ell`` (the bucketed-ELL adjacency against K1) and ``native``
   (the C++ graph core against its numpy path, host times);
11. kernels — one line listing every ported kernel;
and last ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero; without a CUDA device it exits non-zero before doing anything.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import glob
import io
import json
import os
import pickle
import platform
import re
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

from gn_ode_sir_tpu_torch.cli import infer, monitorer, worker
from gn_ode_sir_tpu_torch.graphs.graph import Graph, graph_from_edges
from gn_ode_sir_tpu_torch.models import DMPSIR, GCN, GIN, GNODE, TimeUnrolledSIR
from gn_ode_sir_tpu_torch.ops import _kernels, gcn_norm_edges
from gn_ode_sir_tpu_torch.ops import spmm2 as spmm2_module
from gn_ode_sir_tpu_torch.ops.dmp_step import (dmp_marginals, dmp_marginals_plain, dmp_step,
                                               dmp_step_plain)
from gn_ode_sir_tpu_torch.ops.gnode_step import gnode_step, gnode_step_plain
from gn_ode_sir_tpu_torch.ops.segment import segment_prod
from gn_ode_sir_tpu_torch.ops.spmm2 import (SEGMENT_EDGES, CsrPlan, Spmm2Adj, spmm2,
                                            spmm2_plain)
from gn_ode_sir_tpu_torch.sim import classical, mc_sir, sir_classical_batch
from gn_ode_sir_tpu_torch.sim.fused_step import philox4x32_words, sir_step, sir_update_plain
from gn_ode_sir_tpu_torch.train import (assemble_multigraph_trials, build_trial_data,
                                        init_ensemble, l1_sir_loss, multigraph_auto_fns,
                                        multigraph_split)
from gn_ode_sir_tpu_torch.train.checkpoint import save_params, tree_leaves, tree_map
from gn_ode_sir_tpu_torch.train.loop import (_batch_loss, _data_to_device, make_eval_fn,
                                             make_train_epoch_fn)
from gn_ode_sir_tpu_torch.utils import load_or_extract_labels_many
from gn_ode_sir_tpu_torch.utils.csvsink import TRIAL_COLUMNS
from perfbench.counts.spmm import k1_apply
from perfbench.inputs import powerlaw_pairs

SEED = 0
ENRON_NODES = 33_696  # enron's largest connected component
ENRON_DIRECTED_EDGES = 361_000  # ~enron's directed edge count
HUB_MIN_DEGREE = 1_000
STAR_EDGES = 50_000  # one dst row that owns every edge
SERVE_SCENARIOS = 16
DISPATCH_BATCH = 8
EULER_STEPS = 39  # maxTime 20 / deltaT 0.5 = 40 grid points
# H100 SXM peak (NVIDIA data sheet): the HBM3 rate
HBM_BYTES_PER_S = 3.35e12
KERNEL_REL_TOL = 1e-5  # |kernel - plain| <= tol * (1 + sum_e |w_e x_src|)
SERVE_ATOL = 1e-4  # card vs CPU probabilities after 39 steps
K2_NEAR_SHARE = 1e-5  # K2 states may differ from plain only within 1 of a threshold
LABEL_TRIALS = 6
LABEL_SIMS = 10_000
MAX_TIME = 20  # label times 0..19: 19 simulated steps
TRAIN_EPOCHS = 2
STEP_LOSS_ATOL = 1e-5  # one training step, card vs CPU
STEP_GRAD_RTOL = 1e-4  # per gradient leaf, max-norm
GIN_LOSS_SANITY = 1e-3  # GIN's step is reported, not held (check_step_against_cpu)
# the published multi-graph run: (nodes, directed edges) of dolphins, fb-food,
# fb-social, openflights, wiki-vote and enron; the last is the unseen graph
MG_GRAPH_SIZES = ((62, 318), (620, 4_204), (1_893, 27_670), (2_905, 31_290),
                  (7_066, 201_472), (33_696, 361_622))
MG_HIDDEN = 8
MG_BATCH = 8
MG_TRIALS_PER_GRAPH = 8  # the published run has 36 per train graph and 120 on enron
MG_SIMS = 1_000  # simulations per label (published: 10,000)
MG_EPOCHS = 2
MG_TRAIN_WIDTH = 7_168  # wiki-vote's 7,066 nodes rounded up to 128
# K1's narrow route takes rows of x under 128 bytes (f32 h <= 31); 32 is past it
NARROW_SWEEP_WIDTHS = (*range(1, 18), 24, 31, 32)
WIKI, FB_SOCIAL, FB_FOOD = 4, 2, 1  # positions in MG_GRAPH_SIZES
BASELINE_HIDDEN = 64
DMP_ATOL = 1e-5  # DMP marginals, card vs CPU
DMP_BATCH = 128  # the DMP serving cell's scenarios a dispatch
RK_ATOL = 1e-4  # RK trajectories, card vs CPU
MATRIX_K = 4  # ensemble members: the published hidden_dim_array=(8, 8, 8, 8)
ENSEMBLE_LOSS_ATOL = 1e-5  # member j vs the sequential fit with init seed j
CRASH_EPOCHS = 3
BACKSOLVE_GRAD_RTOL = 2e-3  # the JAX package's own, tests/test_odeint.py
DOPRI_BUDGET = 12  # attempts over the horizon (the default, 2 * 39, holds 78 states x 4)
DOPRI_ATOL = 1e-4  # card vs CPU probabilities
SPMD_LOSS_ATOL = 1e-6  # an SPMD step at world size 1 against the single-device step
SPMD_LEAF_RTOL = 1e-5  # its leaf update (SGD at lr 1: the gradient), max-norm


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def powerlaw_graph(n: int, n_directed: int, seed: int):
    """A seeded Chung-Lu power-law graph with exactly ``n_directed`` directed
    edges (no self-loops, no duplicates), node ids shuffled: the benchmark's
    stand-in graph (``perfbench/inputs.py::powerlaw_pairs``)."""
    return graph_from_edges(n, powerlaw_pairs(n, n_directed, seed), name=f"powerlaw{n}")


def transposed(graph: Graph) -> Graph:
    """The same directed edges with src and dst swapped, sorted by the new dst."""
    order = np.argsort(graph.src, kind="stable")
    return Graph(n_nodes=graph.n_nodes, src=graph.dst[order], dst=graph.src[order],
                 name=graph.name + "_t")


def star_graphs():
    """A star whose row 0 owns all ``STAR_EDGES`` edges, and its transpose
    (every other row one edge, all from node 0)."""
    star = Graph(n_nodes=STAR_EDGES + 1, src=np.arange(1, STAR_EDGES + 1),
                 dst=np.zeros(STAR_EDGES, np.int64), name="star")
    return star, transposed(star)


def boundary_rows_graph() -> Graph:
    """A directed graph with dst rows of exactly L - 1, L, L + 1, 2L and
    2L + 1 edges (L the plan's segment length) between short and edgeless
    rows, from seeded random sources."""
    el = SEGMENT_EDGES
    counts = np.array([el - 1, 3, el, 0, el + 1, 1, 2 * el, 0, 2 * el + 1, 5])
    dst = np.repeat(np.arange(counts.size), counts)
    src = np.random.default_rng([SEED, 3]).integers(0, counts.size, dst.size)
    return Graph(n_nodes=counts.size, src=src, dst=dst, name="boundary_rows")


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_replay_ms(fn, per_graph: int = 20, replays: int = 10) -> float:
    """Device time of one ``fn()``: ``per_graph`` calls captured in one CUDA
    graph, the graph replayed, so that the host issues nothing in between.
    Where one call takes the device less time than the host needs to issue
    it, :func:`time_ms` reads the host and this reads the device."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return time_ms(graph.replay, replays) / per_graph


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    info = {"phase": "device", "nvidia_smi": smi,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build() -> None:
    t0 = time.perf_counter()
    report = _kernels.build_all()
    for name in _kernels.KERNELS:
        if not _kernels.library_path(name).exists():
            raise RuntimeError(f"kernel {name} has no library after the build")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": report, "kernels": sorted(_kernels.KERNELS)})


def spmm2_bound(plan, x) -> dict:
    """The least time the card could take for one K1 apply of ``plan`` to
    ``x`` [B, n, h], as the benchmark counts it
    (``perfbench/counts/spmm.py::k1_apply``) with the plan's n: x read once,
    the plan read once, the f32 result written once, over the memory rate;
    2 operations per edge and column over the f32 rate."""
    bound = k1_apply(plan.n_nodes, plan.src.numel(), x.shape[0], x.shape[-1],
                     x.element_size())
    return {"bound_ms": bound["bound_s"] * 1e3, "bound_by": bound["bound_by"]}


def spmm2_library_times(plan, x) -> dict:
    """Yardstick only (never called by the port): one CSR sparse product on
    the node-major [n, B*h] layout of the same values, timed as K1 is."""
    n = plan.n_nodes
    a = torch.sparse_csr_tensor(plan.row_ptr.long(), plan.src.long(), plan.w, size=(n, n))
    xt = x.permute(1, 0, 2).reshape(n, -1).contiguous()
    call = lambda: torch.sparse.mm(a, xt)
    return {"library_ms": time_ms(call, 50), "library_device_ms": graph_replay_ms(call)}


def spmm2_times(plan, x, precision, with_library: bool) -> dict:
    """K1's time by events over back-to-back applies (``kernel_ms``, what a
    caller sees) and by CUDA-graph replay (``device_ms``), the plain
    version's, and the library call's where it computes the same function."""
    call = lambda: spmm2(plan, x, precision)
    row = {"kernel_ms": time_ms(call, 50), "device_ms": graph_replay_ms(call),
           "plain_ms": time_ms(lambda: spmm2_plain(plan, x, precision), 10)}
    library = (spmm2_library_times(plan, x) if with_library
               else {"library_ms": None, "library_device_ms": None})
    return {**row, **library}


def check_spmm2_case(name, graph, batch, h, precision, x_dtype, *, timed,
                     weighted=False, w=None, real_nodes=None):
    """K1 against its plain version on the card; raises on disagreement.
    ``weighted`` draws random edge weights, ``w`` gives them; ``real_nodes``:
    the rows from there on (a plan padded beyond its graph) must be zeros."""
    dev = torch.device("cuda")
    rng = np.random.default_rng([SEED, zlib.crc32(name.encode())])
    if weighted:
        w = rng.uniform(0.5, 1.5, graph.n_edges).astype(np.float32)
    plan = CsrPlan.build(graph.src, graph.dst, graph.n_nodes, w=w, device=dev)
    x = torch.as_tensor(rng.standard_normal((batch, graph.n_nodes, h), np.float32),
                        device=dev).to(x_dtype)
    got = spmm2(plan, x, precision)
    again = spmm2(plan, x, precision)
    want = spmm2_plain(plan, x, precision)
    scale = spmm2_plain(dataclasses.replace(plan, w=plan.w.abs()), x.float().abs(), precision)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != torch.float32:
        raise AssertionError(f"{name}: kernel gave {tuple(got.shape)} {got.dtype}")
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches on the same input differ")
    err = (got - want).abs()
    bad = err > KERNEL_REL_TOL * (1.0 + scale)
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version at {int(bad.sum())} "
            f"elements (max abs err {float(err.max())})")
    if real_nodes is not None and got[:, real_nodes:].any():
        raise AssertionError(f"{name}: rows beyond the graph's {real_nodes} nodes are not zeros")
    row = {"phase": "kernel", "kernel": "spmm2", "case": name, "n": graph.n_nodes,
           "edges": graph.n_edges, "batch": batch, "h": h, "precision": precision,
           "x_dtype": str(x_dtype).replace("torch.", ""),
           "work_items": plan.work.shape[0], "partial_slots": plan.n_slots,
           "bit_equal_twice": True,
           "max_abs_err": float(err.max()) if err.numel() else 0.0,
           "tol": f"{KERNEL_REL_TOL} * (1 + sum|w x|)", "ok": True,
           **spmm2_bound(plan, x)}
    if timed:
        row.update(spmm2_times(plan, x, precision,
                               precision == "f32" and x_dtype == torch.float32))
        row.update(library_ratio(row))
    emit(row)
    return row


def library_ratio(row) -> dict:
    """The library call's device-alone time over K1's (above 1: K1 is faster)."""
    lib = row.get("library_device_ms")
    return {"library_over_kernel": lib / row["device_ms"] if lib else None}


def multigraph_kernel_cases(mg_graphs):
    """(name, graph at the plan's width, weights, real nodes, h) of K1 at the
    multi-graph shapes: the wiki-vote-size graph on the train view's plan and
    the enron-size graph on the evaluation plan, each also with
    GCN-normalized weights (self-loops added), at the published hidden 8; and
    the train plan at GIN's first-layer width 5."""
    cases = []
    for tag, g, width in (("wiki_train", mg_graphs[WIKI], MG_TRAIN_WIDTH),
                          ("enron_eval", mg_graphs[-1], mg_graphs[-1].n_nodes)):
        at = lambda src, dst: Graph(n_nodes=width, src=src, dst=dst, name=g.name)
        cases.append((f"mg_{tag}_b8_h8", at(g.src, g.dst), None, g.n_nodes, MG_HIDDEN))
        src, dst, w = gcn_norm_edges(g)
        cases.append((f"mg_{tag}_b8_h8_gcn", at(src, dst), w, g.n_nodes, MG_HIDDEN))
        if width == MG_TRAIN_WIDTH:
            cases.append((f"mg_{tag}_b8_h5", at(g.src, g.dst), None, g.n_nodes, 5))
    return cases


def phase_kernel(graph, mg_graphs) -> tuple[dict, list]:
    degmax = int(graph.degrees.max())
    emit({"phase": "graph", "n": graph.n_nodes, "edges": graph.n_edges,
          "max_degree": degmax, "mean_degree": graph.n_edges / graph.n_nodes})
    if degmax < HUB_MIN_DEGREE:
        raise AssertionError(f"power-law graph hub degree {degmax} < {HUB_MIN_DEGREE}")
    f32, bf16 = torch.float32, torch.bfloat16
    main = check_spmm2_case("enron_b8_h64_f32", graph, DISPATCH_BATCH, 64, "f32", f32,
                            timed=True)
    check_spmm2_case("enron_b16_h64_f32", graph, 16, 64, "f32", f32, timed=True)
    check_spmm2_case("enron_b4_h64_f32", graph, 4, 64, "f32", f32, timed=True)
    check_spmm2_case("enron_b1_h64_f32", graph, 1, 64, "f32", f32, timed=True)  # training, batch 1
    check_spmm2_case("enron_b4_h64_bf16msg", graph, 4, 64, "bf16", f32, timed=True)
    check_spmm2_case("enron_b4_h64_bf16x", graph, 4, 64, "f32", bf16, timed=True)
    check_spmm2_case("enron_b2_h64_weighted", graph, 2, 64, "f32", f32, timed=False,
                     weighted=True)
    check_spmm2_case("enron_b2_h8", graph, 2, 8, "f32", f32, timed=False)
    check_spmm2_case("enron_b2_h100", graph, 2, 100, "bf16", f32, timed=False)
    check_spmm2_case("enron_b1_h130_bf16x", graph, 1, 130, "bf16", bf16, timed=False)
    check_spmm2_case("enron_b2_h33", graph, 2, 33, "f32", f32, timed=False)  # odd h: scalar loads
    check_spmm2_case("enron_b3_h64_bf16msg_bf16x", graph, 3, 64, "bf16", bf16, timed=False)
    star, star_t = star_graphs()
    check_spmm2_case("star_b3_h64", star, 3, 64, "f32", f32, timed=False, weighted=True)
    check_spmm2_case("star_transposed_b3_h64", star_t, 3, 64, "f32", f32, timed=False,
                     weighted=True)
    check_spmm2_case("star_b1_h64_bf16msg_bf16x", star, 1, 64, "bf16", bf16, timed=False,
                     weighted=True)
    check_spmm2_case("star_b8_h8", star, 8, 8, "f32", f32, timed=False, weighted=True)
    check_spmm2_case("star_transposed_b3_h5", star_t, 3, 5, "f32", f32, timed=False,
                     weighted=True)
    rows = boundary_rows_graph()
    for batch, h, precision, x_dtype in ((3, 64, "f32", f32), (2, 64, "bf16", bf16),
                                         (1, 33, "f32", f32), (2, 100, "f32", f32),
                                         (8, 8, "f32", f32), (3, 5, "bf16", bf16),
                                         (32, 8, "f32", f32)):
        check_spmm2_case(f"boundary_rows_b{batch}_h{h}_{precision}", rows, batch, h, precision,
                         x_dtype, timed=False, weighted=True)
    edgeless = Graph(n_nodes=1000, src=np.zeros(0, np.int32), dst=np.zeros(0, np.int32))
    row = check_spmm2_case("edgeless", edgeless, 2, 64, "f32", f32, timed=False)
    if row["max_abs_err"] != 0.0:
        raise AssertionError("edgeless graph must give exact zeros")
    mg_rows = [check_spmm2_case(name, g, MG_BATCH, h, "f32", f32, timed=True, w=w,
                                real_nodes=real)
               for name, g, w, real, h in multigraph_kernel_cases(mg_graphs)]
    # the matrix's folds: four members of the multi-graph evaluation in one
    # launch (the training fold at enron size, [4, n, 64], is the b4 case above)
    mg_rows.append(check_spmm2_case(f"matrix_fold_enron_eval_b{MATRIX_K * MG_BATCH}_h8",
                                    mg_graphs[-1], MATRIX_K * MG_BATCH, MG_HIDDEN, "f32", f32,
                                    timed=True))
    # every width of the narrow route and the first past it, on the train plan
    train = narrow_train_graph(mg_graphs)
    for h in NARROW_SWEEP_WIDTHS:
        check_spmm2_case(f"mg_wiki_train_b8_h{h}_f32", train, MG_BATCH, h, "f32", f32,
                         timed=False, real_nodes=mg_graphs[WIKI].n_nodes)
        check_spmm2_case(f"mg_wiki_train_b8_h{h}_bf16msg_bf16x", train, MG_BATCH, h, "bf16", bf16,
                         timed=False, real_nodes=mg_graphs[WIKI].n_nodes)
    return main, mg_rows


def narrow_train_graph(mg_graphs) -> Graph:
    """The wiki-vote-size graph at the multi-graph train view's width."""
    wiki = mg_graphs[WIKI]
    return Graph(n_nodes=MG_TRAIN_WIDTH, src=wiki.src, dst=wiki.dst, name=wiki.name)


def check_spmm2_bwd_case(name, graph, batch, precision, *, timed, weighted=False, w=None,
                         h=64):
    """K1-bwd: the gradient through the autograd Function on the card against
    (f32) autograd through the plain version, or (bf16) the plain version on
    the transpose plan with bf16 messages; raises on disagreement."""
    dev = torch.device("cuda")
    rng = np.random.default_rng([SEED, zlib.crc32(name.encode())])
    if weighted:
        w = rng.uniform(0.5, 1.5, graph.n_edges).astype(np.float32)
    adj = Spmm2Adj.from_graph(graph, w=w, precision=precision, device=dev)
    shape = (batch, graph.n_nodes, h)
    x = torch.as_tensor(rng.standard_normal(shape, np.float32), device=dev).requires_grad_(True)
    g = torch.as_tensor(rng.standard_normal(shape, np.float32), device=dev)
    before = (spmm2.launches, spmm2.backward_launches)
    y = adj.matvec(x)
    (got,) = torch.autograd.grad(y, x, g)
    if (spmm2.launches - before[0], spmm2.backward_launches - before[1]) != (2, 1):
        raise AssertionError(f"{name}: expected one forward and one backward K1 launch")
    (again,) = torch.autograd.grad(adj.matvec(x), x, g)
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two gradients of the same input differ")
    xd = x.detach()
    y_want = spmm2_plain(adj.plan, xd, precision)
    y_scale = spmm2_plain(dataclasses.replace(adj.plan, w=adj.plan.w.abs()), xd.abs(), precision)
    if ((y.detach() - y_want).abs() > KERNEL_REL_TOL * (1.0 + y_scale)).any():
        raise AssertionError(f"{name}: the Function's forward disagrees with the plain version")
    if precision == "f32":
        (want,) = torch.autograd.grad(spmm2_plain(adj.plan, x), x, g)
    else:
        want = spmm2_plain(adj.plan_t, g, "bf16")
    plan_t = adj.plan_t
    scale = spmm2_plain(dataclasses.replace(plan_t, w=plan_t.w.abs()), g.abs(), precision)
    torch.cuda.synchronize()
    err = (got - want).abs()
    bad = err > KERNEL_REL_TOL * (1.0 + scale)
    if got.shape != x.shape or not torch.isfinite(got).all() or bad.any():
        raise AssertionError(
            f"{name}: K1-bwd disagrees with its plain version at {int(bad.sum())} "
            f"elements (max abs err {float(err.max())})")
    row = {"phase": "kernel", "kernel": "spmm2_bwd", "case": name, "n": graph.n_nodes,
           "edges": graph.n_edges, "batch": batch, "h": h, "precision": precision,
           "weighted": w is not None, "work_items": plan_t.work.shape[0],
           "partial_slots": plan_t.n_slots, "bit_equal_twice": True,
           "max_abs_err": float(err.max()),
           "tol": f"{KERNEL_REL_TOL} * (1 + sum|w g|)", "ok": True,
           **spmm2_bound(plan_t, g)}
    if timed:
        row.update(spmm2_times(plan_t, g, precision, precision == "f32"))
        row.update(library_ratio(row))
    emit(row)
    return row


def phase_kernel_bwd(graph, mg_graphs) -> tuple[dict, list]:
    main = check_spmm2_bwd_case("bwd_enron_b1_f32", graph, 1, "f32", timed=True)
    check_spmm2_bwd_case("bwd_enron_b8_f32", graph, DISPATCH_BATCH, "f32", timed=True)
    check_spmm2_bwd_case("bwd_enron_b16_f32", graph, 16, "f32", timed=True)
    check_spmm2_bwd_case("bwd_enron_b2_weighted", graph, 2, "f32", timed=False, weighted=True)
    check_spmm2_bwd_case("bwd_enron_b2_bf16_weighted", graph, 2, "bf16", timed=True,
                         weighted=True)
    star, star_t = star_graphs()  # the gradient of each runs on the other's rows
    check_spmm2_bwd_case("bwd_star_b2", star, 2, "f32", timed=False, weighted=True)
    check_spmm2_bwd_case("bwd_star_transposed_b2", star_t, 2, "f32", timed=False, weighted=True)
    check_spmm2_bwd_case("bwd_star_b2_bf16", star, 2, "bf16", timed=False, weighted=True)
    rows = boundary_rows_graph()
    check_spmm2_bwd_case("bwd_boundary_rows_b3", rows, 3, "f32", timed=False, weighted=True)
    # transposed, so that the gradient is the one that walks the boundary rows
    check_spmm2_bwd_case("bwd_boundary_rows_transposed_b3", transposed(rows), 3, "f32",
                         timed=False, weighted=True)
    check_spmm2_bwd_case("bwd_boundary_rows_transposed_b3_bf16", transposed(rows), 3, "bf16",
                         timed=False, weighted=True)
    mg_rows = [check_spmm2_bwd_case("bwd_" + name, g, MG_BATCH, "f32", timed=True, w=w, h=h)
               for name, g, w, _, h in multigraph_kernel_cases(mg_graphs)]
    # the single-graph ensemble's training fold: four members at batch 1
    mg_rows.append(check_spmm2_bwd_case(f"bwd_matrix_fold_enron_b{MATRIX_K}", graph, MATRIX_K,
                                        "f32", timed=True))
    # and the folded multi-graph evaluation's shape, [32, 33,696, 8]
    mg_rows.append(check_spmm2_bwd_case(
        f"bwd_matrix_fold_enron_eval_b{MATRIX_K * MG_BATCH}_h8", mg_graphs[-1],
        MATRIX_K * MG_BATCH, "f32", timed=True, h=MG_HIDDEN))
    check_spmm2_bwd_case("bwd_star_b8_h8", star, MG_BATCH, "f32", timed=False, weighted=True,
                         h=MG_HIDDEN)
    check_spmm2_bwd_case("bwd_boundary_rows_transposed_b3_h5", transposed(rows), 3, "f32",
                         timed=False, weighted=True, h=5)
    return main, mg_rows  # batch 1 is the training path's shape


def narrow_summary(rows) -> dict:
    """K1 and K1-bwd at the narrow route's timed shapes beside the library
    call, device alone."""
    return {"phase": "narrow", "cases": [
        {"kernel": r["kernel"], "case": r["case"], "device_ms": r["device_ms"],
         "library_device_ms": r["library_device_ms"],
         "library_over_kernel": r["library_over_kernel"]}
        for r in rows if r["h"] * (2 if r.get("x_dtype") == "bfloat16" else 4) < 128]}


def check_sir_step_case(name, i, r, counts, betas, gammas, sims, *, step=3, timed=False,
                        seed_list=None):
    """K2 against its plain version on the card with the same seeds and step,
    one trial's rows at a time (so the plain side never holds more than one
    trial). The Philox words must be equal; the states must be equal except
    where the low half-word lies within 1 of p_inf * 2^16 (where a last-bit
    difference in expm1 could flip the coin), and those must stay under
    ``K2_NEAR_SHARE`` of the elements. Raises otherwise."""
    dev = torch.device("cuda")
    rows, n = i.shape
    trials = rows // sims
    log1m_beta = torch.log1p(-torch.tensor(betas, dtype=torch.float32)).to(dev)
    gamma16 = (torch.tensor(gammas, dtype=torch.float32) * 65536.0).to(dev)
    if seed_list is None:
        seed_list = [mc_sir.fold_seed(SEED, 77 + j) for j in range(trials)]
    seeds = torch.tensor(seed_list, dtype=torch.int64, device=dev)
    trial_rows = lambda j: slice(j * sims, (j + 1) * sims)

    def plain_trial(j):
        sl = trial_rows(j)
        words = philox4x32_words(seed_list[j], step, sims * n, device=dev).reshape(sims, n)
        return (*sir_update_plain(i[sl], r[sl], counts[sl], log1m_beta[j], gamma16[j], words),
                words)

    before = sir_step.launches
    ki, kr, kwords = sir_step(i, r, counts, log1m_beta, gamma16, seeds, step, sims=sims,
                              return_words=True)
    if sir_step.launches != before + 1:
        raise AssertionError(f"{name}: the wrapper did not count its launch")
    mismatched, max_err = 0, 0
    for j in range(trials):
        sl = trial_rows(j)
        pi, pr, pwords = plain_trial(j)
        if not torch.equal(kwords[sl], pwords):
            raise AssertionError(
                f"{name}: trial {j}: the kernel's Philox words differ from the plain version's")
        diff = (ki[sl] != pi) | (kr[sl] != pr)
        if diff.any():
            thresh = -torch.expm1(counts[sl].float() * log1m_beta[j]) * 65536.0
            near = ((pwords & 0xFFFF).float() - thresh).abs() <= 1.0
            if (diff & ~near).any():
                raise AssertionError(
                    f"{name}: trial {j}: K2 disagrees with its plain version away from a threshold")
            mismatched += int(diff.sum())
        max_err = max(max_err, int((ki[sl] - pi).abs().max()), int((kr[sl] - pr).abs().max()))
        del pi, pr, pwords, diff
    if mismatched > K2_NEAR_SHARE * i.numel():
        raise AssertionError(
            f"{name}: K2 disagrees with its plain version at {mismatched} elements")
    if ki.dtype != torch.int8 or ((ki + kr) > 1).any() or (ki < 0).any() or (kr < r).any():
        raise AssertionError(f"{name}: K2 wrote an invalid state")
    bytes_moved = i.numel() * (2 + counts.element_size() + 2)
    row = {"phase": "kernel", "kernel": "sir_step", "case": name, "rows": rows, "n": n,
           "trials": trials, "counts_dtype": str(counts.dtype).replace("torch.", ""),
           "last_flat_offset": i.numel() - 1, "words_equal": True, "mismatched": mismatched,
           "max_abs_err": float(max_err),
           "tol": f"equal but for <= {K2_NEAR_SHARE} of elements within 1 of a threshold",
           "newly_infected": int(((ki == 1) & (i == 0)).sum()),
           "newly_recovered": int((kr - r).sum(dtype=torch.int64)), "ok": True,
           "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    del ki, kr, kwords
    if timed:
        call = lambda: sir_step(i, r, counts, log1m_beta, gamma16, seeds, step, sims=sims)
        row["kernel_ms"] = time_ms(call, 20)

        def plain_all():  # one trial at a time, as the comparison above
            for j in range(trials):
                plain_trial(j)

        row["plain_ms"] = time_ms(plain_all, 2, warmup=1)
        row["library_ms"] = None  # no single PyTorch call computes this function
    emit(row)
    return row


def _random_state(rows, n, share, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand((rows, n), device=dev, generator=gen)
    return (u < share).to(torch.int8), ((u >= share) & (u < 2 * share)).to(torch.int8)


def phase_kernel_k2(graph, chunk_trials) -> dict:
    """K2 at the label path's shapes, with the count product beside it.
    ``chunk_trials``: the (seed nodes, beta, gamma) trials of the one chunk the
    label path dispatches; trial k runs under seed 1000 + k. Returns the row
    of that chunk's shape."""
    dev = torch.device("cuda")
    n = graph.n_nodes
    # small and awkward shapes: numel not a multiple of 4, one row, beta = 0,
    # gamma = 0 and 1, trials whose elements are not a multiple of 4
    for name, rows, cols, sims, betas, gammas in (
            ("one_row_n34", 1, 34, 1, [0.3], [0.1]),
            ("odd_numel_beta0_gamma0", 7, 33, 7, [0.0], [0.0]),
            ("three_trials_gamma_0_1", 9, 35, 3, [0.2, 0.5, 0.1], [1.0, 0.0, 0.3])):
        i, r = _random_state(rows, cols, 0.2, dev, rows)
        counts = torch.randint(0, 9, (rows, cols), device=dev, dtype=torch.int32)
        for c in (counts, counts.float()):
            row = check_sir_step_case(name, i, r, c, betas, gammas, sims)
        if name.startswith("odd") and (row["newly_infected"] or row["newly_recovered"]):
            raise AssertionError("beta = 0 and gamma = 0 must leave the state as it was")

    # the count product at [10,000 x n]: both routes, exact on the hub column
    # against an int64 sum over the hub's neighbours
    i, r = _random_state(LABEL_SIMS, n, 0.05, dev, SEED)
    hub = int(np.argmax(graph.degrees))
    nbrs = torch.as_tensor(graph.src[graph.dst == hub], dtype=torch.long, device=dev)
    i[: LABEL_SIMS // 2, nbrs] = 1  # half the simulations see the whole hub infected
    i, r = i.contiguous(), (r * (1 - i)).contiguous()
    want_hub = i[:, nbrs].long().sum(1)
    product = {}
    counts_by_route = {}
    for route in ("int8", "bf16"):
        a = mc_sir.device_adjacency(graph, route, dev)
        counts = mc_sir.count_product(i, a)
        if not torch.equal(counts[:, hub].long(), want_hub) or int(want_hub.max()) <= 256:
            raise AssertionError(f"count product ({route}) is not exact on the hub column")
        product[route + "_ms"] = time_ms(lambda: mc_sir.count_product(i, a), 5, warmup=2)
        counts_by_route[route] = counts
    if not torch.equal(counts_by_route["int8"].float(), counts_by_route["bf16"]):
        raise AssertionError("the int8 and bf16 count products differ")
    ops = 2 * LABEL_SIMS * n * n
    emit({"phase": "count_product", "rows": LABEL_SIMS, "n": n, **product,
          "hub_degree": int(graph.degrees[hub]), "hub_count_max": int(want_hub.max()),
          "exact": True, "auto": mc_sir.CUDA_AUTO_MATMUL,
          "bound_ms_int8": ops / 1979e12 * 1e3, "bound_ms_bf16": ops / 989e12 * 1e3})
    counts = counts_by_route[mc_sir.CUDA_AUTO_MATMUL]
    del counts_by_route
    check_sir_step_case("enron_10000x1_trial", i, r, counts, [0.3], [0.1], LABEL_SIMS,
                        timed=True)
    check_sir_step_case("enron_2500x4_trials", i, r, counts, [0.2, 0.5, 0.1, 0.3],
                        [0.1, 0.2, 0.3, 0.05], LABEL_SIMS // 4, timed=True)
    del i, r, counts

    # the chunk the label path dispatches: its trials' rates and seeds, all
    # their simulations in one launch, counts from the route `auto` takes
    k = len(chunk_trials)
    i, r = _random_state(k * LABEL_SIMS, n, 0.05, dev, SEED + 1)
    a = mc_sir.device_adjacency(graph, mc_sir.CUDA_AUTO_MATMUL, dev)
    counts = mc_sir.count_product(i, a)
    main = check_sir_step_case(
        f"enron_{LABEL_SIMS}x{k}_trials_label_chunk", i, r, counts,
        [t[1] for t in chunk_trials], [t[2] for t in chunk_trials], LABEL_SIMS,
        seed_list=[1000 + j for j in range(k)], timed=True)
    main["count_product_ms"] = time_ms(lambda: mc_sir.count_product(i, a), 3, warmup=1)
    del i, r, counts
    torch.cuda.empty_cache()
    return main


def phase_kernel_k3(graph) -> tuple[dict, list]:
    """K3 (the fused euler SIR update) against its plain version on the card
    at serving's shape [8, n, 64], bit for bit, at a plain step and at a label
    time (the state also written into the decoder's slice), with kernel,
    device-alone and plain times and the bound: each operand read once, the
    state (and the slice) written once."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(SEED)
    shape = (DISPATCH_BATCH, graph.n_nodes, 64)
    ai = (torch.rand(shape, generator=g) * 40).to(dev)
    zs, zi = torch.rand(shape, generator=g).to(dev), torch.rand(shape, generator=g).to(dev)
    state0 = torch.randn((3, *shape), generator=g).to(dev)
    beta = (0.1 + 0.4 * torch.rand(DISPATCH_BATCH, generator=g)).to(dev)
    gamma = (0.1 + 0.4 * torch.rand(DISPATCH_BATCH, generator=g)).to(dev)
    out = torch.empty((DISPATCH_BATCH, graph.n_nodes, 3, 64), device=dev)
    rows = []
    for label_time in (False, True):
        slot = out if label_time else None
        state, want, want_out = state0.clone(), state0.clone(), torch.zeros_like(out)
        gnode_step(ai, zs, zi, state, beta, gamma, 0.5, out=slot)
        gnode_step_plain(ai, zs, zi, want, beta, gamma, 0.5,
                         out=want_out if label_time else None)
        torch.cuda.synchronize()
        if not torch.equal(state, want) or (label_time and not torch.equal(out, want_out)):
            raise AssertionError(f"K3 (label time {label_time}) is not its plain version's bits")
        bytes_moved = ai.numel() * 4 * (6 + 3 + (3 if label_time else 0)) + 2 * DISPATCH_BATCH * 4
        call = lambda: gnode_step(ai, zs, zi, state, beta, gamma, 0.5, out=slot)
        row = {"phase": "kernel", "kernel": "gnode_step",
               "case": "label_time" if label_time else "step", "shape": list(shape),
               "bit_equal": True, "max_abs_err": 0.0, "bytes": bytes_moved,
               "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
               "kernel_ms": time_ms(call, 50), "device_ms": graph_replay_ms(call),
               "plain_ms": time_ms(lambda: gnode_step_plain(
                   ai, zs, zi, want, beta, gamma, 0.5,
                   out=want_out if label_time else None), 10),
               "library_ms": None, "ok": True}
        emit(row)
        rows.append(row)
    return rows[0], rows[1:]


def phase_kernel_dmp(graph) -> tuple[dict, dict]:
    """K4 (DMP's edge update) and K5 (its marginals) against their plain
    versions on the card at [128, n, E], bit for bit, both fed one node
    product, in the recursion's scenario-minor layout (edge state [E, 128],
    node state [n, 128], the marginals [128, n, 3]), with kernel,
    device-alone and plain times and the bounds: K4 reads theta, phi and
    Ps_ij and writes phi, Ps_ij and the next theta once (24 B an edge
    update), the int32 edge indices and the node arrays once; K5 reads Ps(0),
    the node product and the marginals at t - 1 and writes those at t and
    the pair (node, Ps(0)) that K4 gathers (36 B a node). K4's row also
    times the node product (``segment_prod``) on the same theta, near 1 as
    the recursion holds it: a product that underflows to 0 would end the
    scatter's compare-and-swap retries (0 over 0 succeeds) and read fast."""
    dev = torch.device("cuda")
    model = DMPSIR.from_graph(graph)
    edges = model.edges(dev)
    b, n, e = DMP_BATCH, graph.n_nodes, graph.n_edges
    g = torch.Generator(device=dev).manual_seed(SEED)
    rand = lambda *shape, lo=0.0, hi=1.0: lo + (hi - lo) * torch.rand(*shape, generator=g,
                                                                     device=dev)
    theta, phi, ps_ij = rand(e, b, lo=0.9), rand(e, b, hi=0.3), rand(e, b)
    ps_0, prev = rand(n, b), rand(b, n, 3)
    w, gamma = rand(1, b, lo=0.1, hi=0.5), rand(1, b, lo=0.1, hi=0.5)
    node = segment_prod(theta, edges.dst, n)
    out, want_out = torch.empty_like(prev), torch.empty_like(prev)
    pair, want_pair = torch.empty((n, b, 2), device=dev), torch.empty((n, b, 2), device=dev)
    dmp_marginals(out, prev, node, ps_0, gamma, pair)
    dmp_marginals_plain(want_out, prev, node, ps_0, gamma, want_pair)
    nxt, want_nxt = torch.empty_like(theta), torch.empty_like(theta)
    got, want = (phi.clone(), ps_ij.clone()), (phi.clone(), ps_ij.clone())
    dmp_step(theta, nxt, *got, pair, w, gamma, edges.src, edges.reverse)
    dmp_step_plain(theta, want_nxt, *want, want_pair, w, gamma, edges.src, edges.reverse)
    torch.cuda.synchronize()
    if not (torch.equal(out, want_out) and torch.equal(pair, want_pair)
            and torch.equal(nxt, want_nxt) and all(torch.equal(x, y) for x, y in zip(got, want))):
        raise AssertionError("K4 or K5 is not its plain version's bits")
    k4_bytes = 24 * b * e + 8 * e + 8 * b * n + 8 * b
    k5_bytes = 36 * b * n + 4 * b
    k4 = lambda: dmp_step(theta, nxt, *got, pair, w, gamma, edges.src, edges.reverse)
    k5 = lambda: dmp_marginals(out, prev, node, ps_0, gamma, pair)
    rows = []
    for name, call, plain, moved in (
            ("dmp_step", k4, lambda: dmp_step_plain(theta, want_nxt, *want, want_pair, w, gamma,
                                                    edges.src, edges.reverse), k4_bytes),
            ("dmp_marginals", k5, lambda: dmp_marginals_plain(want_out, prev, node, ps_0, gamma,
                                                              want_pair), k5_bytes)):
        row = {"phase": "kernel", "kernel": name, "case": "dmp_serve",
               "shape": [b, n, e], "bit_equal": True, "max_abs_err": 0.0, "bytes": moved,
               "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
               "kernel_ms": time_ms(call, 50), "device_ms": graph_replay_ms(call),
               "plain_ms": time_ms(plain, 10), "library_ms": None, "ok": True}
        if name == "dmp_step":
            row["node_product_ms"] = time_ms(lambda: segment_prod(theta, edges.dst, n), 50)
        emit(row)
        rows.append(row)
    del theta, phi, ps_ij, nxt, want_nxt, got, want, pair, want_pair
    torch.cuda.empty_cache()
    return rows[0], rows[1]


def phase_serve(graph) -> dict:
    argv = ["--model", "ode_nn", "--hidden", "64", "--method", "euler",
            "--deltaT", "0.5", "--maxTime", "20", "--spmm", "auto"]
    args = worker.build_parser().parse_args([*argv, "--device", "cuda"])
    t0 = time.perf_counter()
    model, adj = worker.build_model_and_adj(args, graph, batch_size=DISPATCH_BATCH)
    if not isinstance(adj, Spmm2Adj):
        raise AssertionError(f"--spmm auto picked {type(adj).__name__}, not the K1 adjacency")
    with tempfile.TemporaryDirectory() as ckpt:
        save_params(ckpt, model.init(torch.Generator().manual_seed(SEED), device="cpu"))
        params = infer.restore_params(ckpt, device="cuda")
        params_cpu = infer.restore_params(ckpt, device="cpu")
    infer.check_params_match(model, params)
    setup_s = time.perf_counter() - t0

    rng = np.random.default_rng(SEED)
    seeds = [sorted(rng.choice(graph.n_nodes, 3, replace=False).tolist())
             for _ in range(SERVE_SCENARIOS)]
    beta = rng.uniform(0.1, 0.5, SERVE_SCENARIOS)
    gamma = rng.uniform(0.05, 0.3, SERVE_SCENARIOS)
    sb = infer.scenario_batch(graph.n_nodes, seeds, beta, gamma)
    two = tuple(a[:2] for a in sb)

    # warm-up dispatch (kernel library load, cuBLAS handles, allocator)
    t0 = time.perf_counter()
    infer.predict_summaries(model, params, adj, *(a[:DISPATCH_BATCH] for a in sb))
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    spmm2.launches = gnode_step.launches = 0  # the main path starts here
    t0 = time.perf_counter()
    rows = infer.predict_summaries(model, params, adj, *sb, dispatch_batch=DISPATCH_BATCH)
    t_summ = time.perf_counter() - t0
    launches_summ = spmm2.launches
    t0 = time.perf_counter()
    out = infer.predict_scenarios(model, params, adj, *two)
    t_full = time.perf_counter() - t0
    launches = spmm2.launches  # the main path ends here
    k3_launches = gnode_step.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if k3_launches != launches:
        raise AssertionError(f"K3 launches {k3_launches} != K1 launches {launches}: a field "
                             "evaluation of serving did not take the fused step")

    n_dispatch = -(-SERVE_SCENARIOS // DISPATCH_BATCH)
    if launches_summ != n_dispatch * EULER_STEPS or launches != (n_dispatch + 1) * EULER_STEPS:
        raise AssertionError(
            f"K1 launches {launches_summ} (summaries) / {launches} (total): expected "
            f"{EULER_STEPS} per dispatch over {n_dispatch} + 1 dispatches")
    if out.shape != (20, 2, graph.n_nodes, 3) or not np.isfinite(out).all():
        raise AssertionError(f"serving output {out.shape} is not finite [20, 2, n, 3]")
    if np.abs(out.sum(-1) - 1.0).max() > 1e-5:
        raise AssertionError("probabilities do not sum to 1 within 1e-5")
    vals = np.asarray([[r["peak_infected_frac"], r["final_recovered_frac"]] for r in rows])
    if len(rows) != SERVE_SCENARIOS or not np.isfinite(vals).all() or not all(
            0 <= r["peak_time"] < 20 for r in rows):
        raise AssertionError("summary rows are malformed")

    # reference: the port's same serving path on the CPU (K1's plain version)
    args_cpu = worker.build_parser().parse_args([*argv, "--device", "cpu"])
    model_cpu, adj_cpu = worker.build_model_and_adj(args_cpu, graph, batch_size=2)
    t0 = time.perf_counter()
    ref = infer.predict_scenarios(model_cpu, params_cpu, adj_cpu, *two)
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(out - ref).max())
    if err > SERVE_ATOL:
        raise AssertionError(f"card vs CPU serving output max abs err {err} > {SERVE_ATOL}")

    row = {"phase": "serve", "n": graph.n_nodes, "edges": graph.n_edges, "hidden": 64,
           "method": "euler", "grid_points": EULER_STEPS + 1,
           "adjacency": type(adj).__name__, "setup_s": setup_s, "warmup_s": warm_s,
           "summary_scenarios": SERVE_SCENARIOS, "dispatch_batch": DISPATCH_BATCH,
           "summary_s": t_summ, "scenarios_per_s": SERVE_SCENARIOS / t_summ,
           "ms_per_dispatch": t_summ / n_dispatch * 1e3,
           "full_trajectory_scenarios": 2, "full_trajectory_s": t_full,
           "k1_launches": launches, "k1_launches_per_dispatch": EULER_STEPS,
           "k3_launches": k3_launches,
           "peak_memory_gb": peak_gb, "cpu_reference_s": cpu_s,
           "max_abs_err_vs_cpu": err, "atol": SERVE_ATOL, "ok": True}
    emit(row)
    return row


def phase_serve_dmp(graph) -> dict:
    """DMP's serving path, ``cli.infer.predict_summaries`` on
    ``DMPSIR.predict``, one dispatch of the DMP cell's 128 scenarios on the
    enron-size graph: a node product, K5 and K4 a step (19 each, counted from
    0 just before the dispatch), and its first scenarios' summaries against
    the CPU's."""
    model = DMPSIR.from_graph(graph)
    t0 = time.perf_counter()
    adj = model.edges("cuda")
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng([SEED, 15])
    seeds = [sorted(rng.choice(graph.n_nodes, 3, replace=False).tolist())
             for _ in range(DMP_BATCH)]
    sb = infer.scenario_batch(graph.n_nodes, seeds, rng.uniform(0.1, 0.5, DMP_BATCH),
                              rng.uniform(0.05, 0.3, DMP_BATCH))
    infer.predict_summaries(model, {}, adj, *sb)  # warm-up: the kernels' library, the allocator
    torch.cuda.synchronize()
    dmp_step.launches = dmp_marginals.launches = segment_prod.calls = 0  # the path starts here
    t0 = time.perf_counter()
    rows = infer.predict_summaries(model, {}, adj, *sb)
    dispatch_s = time.perf_counter() - t0
    launches = (dmp_step.launches, dmp_marginals.launches, segment_prod.calls)  # and ends here
    steps = model.max_time - 1
    if launches != (steps,) * 3:
        raise AssertionError(f"DMP serving: K4, K5 and node products {launches}, not {steps} "
                             "each in one dispatch")
    few = tuple(a[:2] for a in sb)
    want = infer.predict_summaries(model, {}, model.edges("cpu"), *few)
    err = max(abs(a[k] - b[k]) for a, b in zip(rows, want)
              for k in ("peak_infected_frac", "final_recovered_frac"))
    if (len(rows) != DMP_BATCH or any(a["peak_time"] != b["peak_time"] for a, b in zip(rows, want))
            or not err <= DMP_ATOL):
        raise AssertionError(f"DMP serving on the card vs the CPU: {err}")
    row = {"phase": "serve_dmp", "n": graph.n_nodes, "edges": graph.n_edges,
           "dispatch_batch": DMP_BATCH, "max_time": model.max_time, "setup_s": setup_s,
           "dispatch_s": dispatch_s, "scenarios_per_s": DMP_BATCH / dispatch_s,
           "k4_launches": launches[0], "k5_launches": launches[1],
           "node_products": launches[2], "max_abs_err_vs_cpu": err, "atol": DMP_ATOL,
           "ok": True}
    emit(row)
    return row


def label_trials(graph):
    rng = np.random.default_rng([SEED, 2])
    nodes = [sorted(rng.choice(graph.n_nodes, 3, replace=False).tolist())
             for _ in range(LABEL_TRIALS)]
    beta = rng.uniform(0.1, 0.5, LABEL_TRIALS).round(4)
    gamma = rng.uniform(0.05, 0.3, LABEL_TRIALS).round(4)
    return [(nodes[k], float(beta[k]), float(gamma[k])) for k in range(LABEL_TRIALS)]


def label_chunk(graph) -> int:
    """Trials per dispatch of the label path on this card, as
    ``simulate_sir_counts_many`` chooses them."""
    torch.cuda.empty_cache()
    return mc_sir.balanced_chunk(
        LABEL_TRIALS, mc_sir.auto_trials_chunk(graph.n_nodes, LABEL_SIMS, torch.device("cuda")))


def phase_labels(graph, trials, save_dir, compared_chunk) -> dict:
    """Monte-Carlo labels of the six trials, as the worker extracts them
    (trial k under seed 1000 + k), into ``save_dir``. ``compared_chunk``: the
    trials per launch at which K2 was held against its plain version."""
    dev = torch.device("cuda")
    kw = dict(sim=LABEL_SIMS, max_time=MAX_TIME, save_dir=save_dir,
              seeds=[1000 + k for k in range(LABEL_TRIALS)], device=dev)
    chunk = label_chunk(graph)
    if chunk != compared_chunk:
        raise AssertionError(
            f"the label path dispatches {chunk} trials a launch; K2 was compared at "
            f"{compared_chunk}")
    chunks = -(-LABEL_TRIALS // chunk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sir_step.launches = 0  # the label path starts here
    t0 = time.perf_counter()
    triples = load_or_extract_labels_many(graph, trials, **kw)
    seconds = time.perf_counter() - t0
    launches = sir_step.launches  # and ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != (MAX_TIME - 1) * chunks:
        raise AssertionError(
            f"K2 launches {launches}: expected {MAX_TIME - 1} per chunk over {chunks} chunks")
    final_r = []
    for (nodes, _, _), (s, i, r) in zip(trials, triples):
        if s.shape != (MAX_TIME, graph.n_nodes) or s.dtype != np.float64:
            raise AssertionError(f"label array {s.shape} {s.dtype}")
        if np.abs(s + i + r - 1.0).max() > 1e-6:
            raise AssertionError("S + I + R != 1 in the labels")
        if (np.diff(r, axis=0) < 0).any():
            raise AssertionError("recovered probability decreases in time")
        if not (i[0, nodes] == 1.0).all() or i[0].sum() != len(nodes):
            raise AssertionError("seed nodes are not the infected set at t = 0")
        final_r.append(float(r[-1].mean()))
    if max(final_r) <= 1e-3:
        raise AssertionError("no epidemic spread in any trial")
    sir_step.launches = 0
    t0 = time.perf_counter()
    again = load_or_extract_labels_many(graph, trials, **kw)
    cache_s = time.perf_counter() - t0
    if sir_step.launches != 0 or not all(
            np.array_equal(a[1], b[1]) for a, b in zip(again, triples)):
        raise AssertionError("the second call was not a pure cache hit")
    row = {"phase": "labels", "trials": LABEL_TRIALS, "sims": LABEL_SIMS,
           "max_time": MAX_TIME, "n": graph.n_nodes, "seconds": seconds,
           "sims_per_s": LABEL_TRIALS * LABEL_SIMS / seconds, "trial_chunks": chunks,
           "rows_per_launch": chunk * LABEL_SIMS,
           "k2_launches": launches, "count_product": mc_sir.CUDA_AUTO_MATMUL,
           "peak_memory_gb": peak_gb, "final_recovered_mean": final_r,
           "cache_hit_s": cache_s, "ok": True}
    emit(row)
    return row


def _loss_and_grads(model, params, adj, data, device):
    """Loss of trial 0 as one minibatch, and its gradient per leaf."""
    params = tree_map(lambda t: t.detach().to(device).requires_grad_(True), params)
    first = lambda a: torch.as_tensor(a[:1], device=device)
    pred = model.predict(params, adj, first(data.s0), first(data.i0), first(data.r0),
                         first(data.beta), first(data.gamma), train=True)
    loss = l1_sir_loss(pred, first(data.labels), trial_weight=torch.ones(1, device=device))
    loss.backward()
    return float(loss.detach()), _grads(params), params


def _grads(params) -> dict:
    """Gradient per leaf that has one (the baselines' last layer has none)."""
    return {path: leaf.grad.cpu() for path, leaf in tree_leaves(params)
            if leaf.grad is not None}


def check_step_against_cpu(what, card, cpu, hold_gradients=True) -> dict:
    """``card`` and ``cpu``: (loss, gradient per leaf) of the same step.
    Raises unless the losses agree within ``STEP_LOSS_ATOL`` and every leaf
    within ``STEP_GRAD_RTOL`` of its largest entry. A leaf whose gradient is
    rounding noise (dec2/b shifts all three logits, which the softmax
    ignores) is held to the scale of the largest leaf.

    ``hold_gradients=False`` (GIN): the leaves must be the same and finite and
    the losses within ``GIN_LOSS_SANITY``; the errors are returned, not held
    to the tolerances. GIN's 19 batch-normalized layers at a random init
    amplify float32 rounding so far that the CPU path disagrees with itself:
    with the neighbour sum taken in another order (the flat COO sum for K1's
    plain version) its loss moves by up to 1e-4 and its gradient leaves by
    more than their own size on every graph here but the smallest, at hidden
    8 and 64, while GCN's leaves move by 2e-7."""
    (loss_gpu, grads_gpu), (loss_cpu, grads_cpu) = card, cpu
    top = max(float(g.abs().max()) for g in grads_cpu.values())
    rel = {k: float((grads_gpu[k] - g).abs().max()) / max(float(g.abs().max()), 1e-3 * top)
           for k, g in grads_cpu.items()}
    worst = worst_leaf(rel)
    loss_atol = STEP_LOSS_ATOL if hold_gradients else GIN_LOSS_SANITY
    if (abs(loss_gpu - loss_cpu) > loss_atol or grads_gpu.keys() != grads_cpu.keys()
            or not np.isfinite(worst["max"])
            or (hold_gradients and worst["max"] > STEP_GRAD_RTOL)):
        raise AssertionError(
            f"{what}: one step, card vs CPU: loss {loss_gpu} vs {loss_cpu}, "
            f"worst gradient leaf {worst}")
    return rel


def worst_leaf(rel: dict) -> dict:
    """The largest entry of a per-leaf error dict, for a model of many leaves."""
    at = max(rel, key=rel.get)
    return {"leaves": len(rel), "max": rel[at], "at": at}


def run_worker(argv, graph):
    """``cli.worker.main`` on the card with its output captured: (what it
    printed, seconds). Raises unless it returns 0."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = worker.main([*argv, "--device", "cuda"], graph=graph)
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"worker.main returned {rc}")
    return out.getvalue(), seconds


def training_history(printed: str, epochs: int) -> list:
    """(train loss, val loss, seconds) per epoch from the worker's output;
    raises unless they are ``epochs`` finite rows."""
    hist = [(float(a), float(b), float(c)) for a, b, c in re.findall(
        r"Train Loss: ([0-9.eE+-]+|nan|inf), Val Loss: ([0-9.eE+-]+|nan|inf) \(([0-9.]+)s\)",
        printed)]
    if len(hist) != epochs or not np.isfinite(hist).all():
        raise AssertionError(f"training history is not {epochs} finite epochs: {hist}")
    return hist


def csv_row(save_dir, dataset_name) -> dict:
    """The one row of ``Metrics-trials-<dataset_name>``, by column."""
    with open(os.path.join(save_dir, f"Metrics-trials-{dataset_name}"), newline="") as f:
        rows = list(csv.reader(f))
    if rows[0] != TRIAL_COLUMNS or len(rows) != 2 or len(rows[1]) != len(TRIAL_COLUMNS):
        raise AssertionError(f"CSV is not one row of the {len(TRIAL_COLUMNS)} columns")
    return dict(zip(TRIAL_COLUMNS, rows[1]))


def trial_argv(trials) -> list:
    return ["--I_indices", *[str(t[0]) for t in trials],
            "--beta", *[str(t[1]) for t in trials], "--gamma", *[str(t[2]) for t in trials]]


def phase_train(graph, trials, save_dir) -> dict:
    """``cli.worker.main`` on the six trials (labels cached by the labels
    phase), then one training step on the card against the CPU."""
    argv = ["--model", "ode_nn", "--hidden", "64", "--method", "euler", "--deltaT", "0.5",
            "--maxTime", str(MAX_TIME), "--batch_size", "1", "--lr", "1e-4",
            "--epochs", str(TRAIN_EPOCHS), "--sim", str(LABEL_SIMS), "--spmm", "auto",
            "--save_checkpoint", "--dataset", graph.name, "--path_to_save", save_dir,
            *trial_argv(trials)]
    args = worker.build_parser().parse_args([*argv, "--device", "cuda"])
    model, _ = worker.build_model_and_adj(args, graph)
    n_train, n_val = 3, 1  # 0.6 / 0.2 / 0.2 of six trials, int-floor boundaries
    fwd_per_batch = EULER_STEPS * (2 if model.adjoint == "checkpoint" else 1)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the path starts here
    spmm2.launches = spmm2.backward_launches = sir_step.launches = gnode_step.launches = 0
    printed, seconds = run_worker(argv, graph)
    total, backward, k2 = spmm2.launches, spmm2.backward_launches, sir_step.launches
    k3 = gnode_step.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if k2 != 0:
        raise AssertionError(f"K2 launches {k2} (labels were cached)")
    hist = training_history(printed, TRAIN_EPOCHS)
    if not hist[1][0] < hist[0][0]:
        raise AssertionError(f"train loss did not fall: {hist[0][0]} -> {hist[1][0]}")
    steps = TRAIN_EPOCHS * n_train
    evals = (total - backward - steps * fwd_per_batch) / EULER_STEPS  # val + test passes
    if backward != steps * EULER_STEPS or evals not in (TRAIN_EPOCHS + 1, TRAIN_EPOCHS + 2):
        raise AssertionError(
            f"K1 launches: {total} in all, {backward} backward; expected {EULER_STEPS} "
            f"backward and {fwd_per_batch} forward per training minibatch over {steps}, "
            f"plus {EULER_STEPS} per evaluation pass")
    test_loss = float(csv_row(save_dir, graph.name)["test_loss"])
    if not 0.0 < test_loss < 1.0:
        raise AssertionError(f"test_loss {test_loss} in the CSV")

    # the saved checkpoint serves
    ckpt = worker.checkpoint_dir_for(save_dir, args.trial, args.model, args.dataset)
    trained = infer.restore_params(ckpt, device="cuda")
    infer.check_params_match(model, trained)
    _, adj = worker.build_model_and_adj(args, graph, batch_size=2)
    sb = infer.scenario_batch(graph.n_nodes, [t[0] for t in trials[:2]],
                              [t[1] for t in trials[:2]], [t[2] for t in trials[:2]])
    served = infer.predict_summaries(model, trained, adj, *sb)
    if len(served) != 2 or not all(np.isfinite(list(r.values())).all() for r in served):
        raise AssertionError("the trained checkpoint did not score")

    # one training step from the same params: card (kernels) against CPU (plain)
    triples = load_or_extract_labels_many(
        graph, trials[:1], sim=LABEL_SIMS, max_time=MAX_TIME, save_dir=save_dir, device="cuda")
    data = build_trial_data(graph.n_nodes, [trials[0][0]], [trials[0][1]], [trials[0][2]],
                            triples)
    params = model.init(torch.Generator().manual_seed(SEED), device="cpu")
    args_cpu = worker.build_parser().parse_args([*argv, "--device", "cpu"])
    model_cpu, adj_cpu = worker.build_model_and_adj(args_cpu, graph)
    _, adj1 = worker.build_model_and_adj(args, graph)
    loss_gpu, grads_gpu, leaves = _loss_and_grads(model, params, adj1, data, "cuda")
    t0 = time.perf_counter()
    loss_cpu, grads_cpu, _ = _loss_and_grads(model_cpu, params, adj_cpu, data, "cpu")
    cpu_s = time.perf_counter() - t0
    rel = check_step_against_cpu("train", (loss_gpu, grads_gpu), (loss_cpu, grads_cpu))

    # time of one training step at batch 1 (forward, backward, Adam), warm
    opt = torch.optim.Adam([leaf for _, leaf in tree_leaves(leaves)], lr=1e-4)
    first = lambda a: torch.as_tensor(a[:1], device="cuda")
    xs = tuple(first(a) for a in (data.s0, data.i0, data.r0, data.beta, data.gamma))
    labels, ones = first(data.labels), torch.ones(1, device="cuda")

    def step():
        opt.zero_grad(set_to_none=True)
        l1_sir_loss(model.predict(leaves, adj1, *xs), labels, trial_weight=ones).backward()
        opt.step()

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 5 * 1e3

    row = {"phase": "train", "n": graph.n_nodes, "hidden": 64, "batch_size": 1,
           "epochs": TRAIN_EPOCHS, "adjoint": model.adjoint, "trials": "3 train, 1 val, 2 test",
           "seconds": seconds, "history": hist, "test_loss": test_loss,
           "k1_launches": total, "k1_backward_launches": backward, "k3_launches": k3,
           "k1_forward_per_minibatch": fwd_per_batch, "k1_backward_per_minibatch": EULER_STEPS,
           "evaluation_passes": int(evals), "peak_memory_gb": peak_gb,
           "step_ms": step_ms, "step_loss_card": loss_gpu, "step_loss_cpu": loss_cpu,
           "step_grad_rel_err": rel, "cpu_step_s": cpu_s,
           "tol": f"loss {STEP_LOSS_ATOL}, gradient leaves {STEP_GRAD_RTOL} (max-norm)",
           "served_scenarios": len(served), "ok": True}
    emit(row)
    return row


def multigraph_graphs() -> list:
    """Six seeded power-law graphs with the published run's node and
    directed-edge counts, the enron-size one last."""
    return [dataclasses.replace(powerlaw_graph(n, e, SEED + 10 + k), name=f"pl{n}")
            for k, (n, e) in enumerate(MG_GRAPH_SIZES)]


@contextlib.contextmanager
def recorded_matvecs():
    """Every ``Spmm2Adj.matvec`` call made inside: (x's shape, the plan's
    edge count, whether autograd was recording)."""
    record = []
    matvec = Spmm2Adj.matvec

    def recording(self, x):
        record.append((tuple(x.shape), self.plan.src.numel(), torch.is_grad_enabled()))
        return matvec(self, x)

    Spmm2Adj.matvec = recording
    try:
        yield record
    finally:
        Spmm2Adj.matvec = matvec


def _mg_loss_and_grads(model, params, conn, data, idx, device):
    """Loss of the trials ``idx`` (of one graph) as one training minibatch
    through the train-side connectivity, and its gradient per leaf."""
    params = tree_map(lambda t: t.detach().to(device).requires_grad_(True), params)
    d = _data_to_device(data.take(idx), device)
    rows = torch.arange(len(idx), device=device)
    loss, _ = _batch_loss(model, params, conn.adj_fn, conn.node_mask_fn, d, rows,
                          torch.ones(len(idx), device=device), d["graph_idx"], train=True,
                          n_view=getattr(conn.adj_fn, "n_view", None))
    loss.backward()
    return float(loss.detach()), _grads(params)


def phase_multigraph(graphs, save_dir) -> dict:
    """The published multi-graph configuration through ``cli.worker.main``
    (depth cut: ``MG_TRIALS_PER_GRAPH`` trials a graph, ``MG_SIMS``
    simulations a label, ``MG_EPOCHS`` epochs), then the time of a training
    step by graph and of an evaluation pass, and one training step of
    GN-ODE, GCN and GIN at the wiki-vote-size graph on the card against the
    CPU."""
    names = [g.name for g in graphs]
    dataset = "+".join(names)
    n_graphs = len(graphs)
    n_max = -(-graphs[-1].n_nodes // 8) * 8  # pad_graphs rounds the width up to 8
    argv = ["--model", "ode_nn", "--hidden", str(MG_HIDDEN), "--method", "euler",
            "--deltaT", "0.5", "--maxTime", str(MAX_TIME), "--batch_size", str(MG_BATCH),
            "--lr", "1e-3", "--epochs", str(MG_EPOCHS), "--sim", str(MG_SIMS),
            "--mg_adj", "auto", "--instances_per_graph", *[str(MG_TRIALS_PER_GRAPH)] * n_graphs,
            "--dataset", dataset, "--path_to_save", save_dir, "--save_checkpoint"]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the path starts here
    spmm2.launches = spmm2.backward_launches = sir_step.launches = gnode_step.launches = 0
    with recorded_matvecs() as record:
        printed, seconds = run_worker(argv, graphs)
    total, backward, k2 = spmm2.launches, spmm2.backward_launches, sir_step.launches
    k3 = gnode_step.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    if "multigraph adjacency backend: pallas2" not in printed:
        raise AssertionError("--mg_adj auto did not resolve to K1 above the dense limit")
    if f"padded to n={n_max}," not in printed:
        raise AssertionError(f"the batch is not padded to the evaluation graph's {n_max} nodes")
    hist = training_history(printed, MG_EPOCHS)
    train = [r for r in record if r[2]]
    evals = [r for r in record if not r[2]]
    steps = MG_EPOCHS * (n_graphs - 1)  # one minibatch of MG_BATCH trials per train graph
    if [r[0] for r in train] != [(MG_BATCH, MG_TRAIN_WIDTH, MG_HIDDEN)] * (steps * EULER_STEPS):
        raise AssertionError(
            f"training did not run {steps} minibatches of {EULER_STEPS} K1 applies at "
            f"[{MG_BATCH}, {MG_TRAIN_WIDTH}, {MG_HIDDEN}]")
    per_step = [{r[1] for r in train[k * EULER_STEPS:(k + 1) * EULER_STEPS]}
                for k in range(steps)]
    train_edges = sorted(g.n_edges for g in graphs[:-1])
    for epoch in range(MG_EPOCHS):
        mine = per_step[epoch * (n_graphs - 1):(epoch + 1) * (n_graphs - 1)]
        if any(len(e) != 1 for e in mine) or sorted(e for s in mine for e in s) != train_edges:
            raise AssertionError(f"epoch {epoch}: a training minibatch mixed graphs: {mine}")
    passes = len(evals) // EULER_STEPS
    if ({r[:2] for r in evals} != {((MG_BATCH, n_max, MG_HIDDEN), graphs[-1].n_edges)}
            or len(evals) != passes * EULER_STEPS
            or not MG_EPOCHS + 1 <= passes <= 2 * MG_EPOCHS):
        raise AssertionError(
            f"evaluation did not run at [{MG_BATCH}, {n_max}, {MG_HIDDEN}] on the unseen graph "
            f"in {MG_EPOCHS + 1} to {2 * MG_EPOCHS} passes of {EULER_STEPS} applies")
    if backward != len(train) or total != len(record) + backward:
        raise AssertionError(
            f"K1 launches {total}, {backward} backward; expected {len(record)} forward and "
            f"{len(train)} backward ({EULER_STEPS} each per minibatch and pass)")
    if k2 < n_graphs * (MAX_TIME - 1):
        raise AssertionError(f"K2 launches {k2}: the labels of {n_graphs} graphs were not extracted")
    row = csv_row(save_dir, dataset)
    if not 0.0 < float(row["test_loss"]) < 1.0 or row["hidden"] != str(MG_HIDDEN):
        raise AssertionError(f"CSV row {row}")
    ckpt = worker.checkpoint_dir_for(save_dir, 1, "ode_nn", dataset)
    args = worker.build_parser().parse_args(argv + ["--device", "cuda"])
    model = worker.build_model(args, n_max)
    infer.check_params_match(model, infer.restore_params(ckpt, device="cuda"))

    # the same trials again (labels and trial parameters are cached now)
    per_graph = []
    for name in names:
        parts = []
        for key in ("seed", "beta", "gamma"):
            path = os.path.join(save_dir, f"Experiments-seed2-{name}", f"initial-{key}.pkl")
            with open(path, "rb") as f:
                parts.append(pickle.load(f))
        per_graph.append(list(zip(*parts)))
    sir_step.launches = 0
    batch, data = assemble_multigraph_trials(
        graphs, per_graph, sim=MG_SIMS, max_time=MAX_TIME, device="cuda",
        label_dirs=[os.path.join(save_dir, f"Experiments-seed2-{name}") for name in names])
    if sir_step.launches != 0:
        raise AssertionError("the second assembly was not a pure cache hit")
    tr, va, te = multigraph_split([MG_TRIALS_PER_GRAPH] * n_graphs)
    conn = multigraph_auto_fns(batch, device="cuda")
    if (conn.kind, getattr(conn.adj_fn, "n_view", None)) != ("pallas2", MG_TRAIN_WIDTH):
        raise AssertionError(f"auto gave {conn.kind} at width {getattr(conn.adj_fn, 'n_view', None)}")

    # wall ms of one training step (forward, backward, Adam) by graph, warm
    params = tree_map(lambda t: t.requires_grad_(True),
                      model.init(torch.Generator().manual_seed(SEED), device="cuda"))
    opt = torch.optim.Adam([leaf for _, leaf in tree_leaves(params)], lr=1e-3)
    train_epoch = make_train_epoch_fn(model, opt, conn.adj_fn, conn.node_mask_fn,
                                      n_view=conn.adj_fn.n_view)
    evaluate = make_eval_fn(model, conn.eval_adj_fn, conn.node_mask_fn)
    d = _data_to_device(data, "cuda")
    ones = np.ones((1, MG_BATCH), np.float32)

    def wall_ms(fn, iters=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3

    step_ms = {}
    for g_i, g in enumerate(graphs[:-1]):
        rows = tr[data.graph_idx[tr] == g_i][None, :MG_BATCH]
        step_ms[g.name] = wall_ms(lambda: train_epoch(params, d, rows, ones))
    eval_rows = np.concatenate([va, te])[None, :MG_BATCH]
    eval_ms = wall_ms(lambda: evaluate(params, d, eval_rows, ones))

    # one training step at the wiki-vote-size graph, card against CPU, for
    # each trainable family (GCN through K1 with normalized weights, GIN
    # through K1 at its first layer's width 5). One trial, as in the train
    # phase: at a minibatch of 8 the CPU path's own dec2/w gradient (a float32
    # sum over 3.4 M terms that cancel) moves by 5e-4 of itself between one
    # and four threads, five times the tolerance; at one trial by 2e-5
    wiki_idx = tr[data.graph_idx[tr] == WIKI][:1]
    gnn = dict(hidden_dim=MG_HIDDEN, penultimate_dim=MG_HIDDEN // 2, window=MAX_TIME, dropout=0.0)
    step_rel, cpu_s = {}, {}
    for family, fam_model, gcn_norm in (("ode_nn", model, False),
                                        ("GCN", TimeUnrolledSIR(GCN(**gnn)), True),
                                        ("GIN", TimeUnrolledSIR(GIN(**gnn)), False)):
        start = fam_model.init(torch.Generator().manual_seed(SEED), device="cpu")
        sides = {}
        for device in ("cuda", "cpu"):
            fam_conn = multigraph_auto_fns(batch, gcn_normalized=gcn_norm, device=device)
            before = (spmm2.launches, spmm2.backward_launches)
            t0 = time.perf_counter()
            sides[device] = _mg_loss_and_grads(fam_model, start, fam_conn, data, wiki_idx, device)
            if device == "cpu":
                cpu_s[family] = time.perf_counter() - t0
                continue
            applies = EULER_STEPS if family == "ode_nn" else MAX_TIME - 1
            # GIN's first layer aggregates the input features, which take no gradient
            bwd_applies = applies - 1 if family == "GIN" else applies
            if (spmm2.launches - before[0], spmm2.backward_launches - before[1]) != (
                    applies + bwd_applies, bwd_applies):
                raise AssertionError(f"{family}: the multi-graph step did not go through K1")
        step_rel[family] = worst_leaf(check_step_against_cpu(
            f"multigraph {family}", sides["cuda"], sides["cpu"],
            hold_gradients=family != "GIN"))

    out = {"phase": "multigraph", "graphs": {g.name: [g.n_nodes, g.n_edges] for g in graphs},
           "hidden": MG_HIDDEN, "batch_size": MG_BATCH, "epochs": MG_EPOCHS,
           "trials_per_graph": MG_TRIALS_PER_GRAPH, "sims": MG_SIMS, "backend": conn.kind,
           "train_width": MG_TRAIN_WIDTH, "eval_width": n_max, "seconds": seconds,
           "history": hist, "csv_row": row, "k1_launches": total,
           "k1_backward_launches": backward, "k3_launches": k3,
           "k1_per_minibatch_or_pass": EULER_STEPS,
           "train_minibatches": steps, "evaluation_passes": passes, "k2_launches": k2,
           "peak_memory_gb": peak_gb, "step_ms_by_graph": step_ms, "eval_pass_ms": eval_ms,
           "step_grad_rel_err": step_rel, "cpu_step_s": cpu_s,
           "tol": f"loss {STEP_LOSS_ATOL}, gradient leaves {STEP_GRAD_RTOL} (max-norm; "
                  f"GIN: reported, loss within {GIN_LOSS_SANITY})",
           "ok": True}
    emit(out)
    return out


def phase_baselines(wiki, small, save_dir) -> dict:
    """The GCN, GIN, DMP and Runge-Kutta baselines on the wiki-vote-size graph
    through ``cli.worker.main``; a GCN and a GIN step, DMP, and RK (on
    ``small``, the fb-social-size graph: the CPU takes minutes for the 256
    substeps a hub of the larger graph asks for) on the card against the CPU."""
    trials = label_trials(wiki)
    common = ["--hidden", str(BASELINE_HIDDEN), "--deltaT", "0.5", "--maxTime", str(MAX_TIME),
              "--batch_size", "1", "--lr", "1e-3", "--epochs", "1", "--sim", str(MG_SIMS),
              "--dataset", wiki.name, "--path_to_save", save_dir, *trial_argv(trials)]
    out = {"phase": "baselines", "n": wiki.n_nodes, "edges": wiki.n_edges, "sims": MG_SIMS,
           "trials": "3 train, 1 val, 2 test", "hidden": BASELINE_HIDDEN}

    def one_row(model):
        """The CSV row a run of ``--model`` wrote, the file then set aside."""
        row = csv_row(save_dir, wiki.name)
        if row["model"] != model or not 0.0 < float(row["test_loss"]) < 1.0:
            raise AssertionError(f"--model {model}: CSV row {row}")
        os.remove(os.path.join(save_dir, f"Metrics-trials-{wiki.name}"))
        return row

    triples = None
    for family in ("GCN", "GIN"):
        argv = ["--model", family, "--save_checkpoint", *common]
        printed, seconds = run_worker(argv, wiki)
        hist = training_history(printed, 1)
        row = one_row(family)
        args = worker.build_parser().parse_args([*argv, "--device", "cuda"])
        model, adj = worker.build_model_and_adj(args, wiki, batch_size=2)
        trained = infer.restore_params(
            worker.checkpoint_dir_for(save_dir, 1, family, wiki.name), device="cuda")
        infer.check_params_match(model, trained)
        sb = infer.scenario_batch(wiki.n_nodes, [t[0] for t in trials[:2]],
                                  [t[1] for t in trials[:2]], [t[2] for t in trials[:2]])
        served = infer.predict_summaries(model, trained, adj, *sb)
        if len(served) != 2 or not all(np.isfinite(list(r.values())).all() for r in served):
            raise AssertionError(f"the trained {family} checkpoint did not score")
        if triples is None:
            triples = load_or_extract_labels_many(
                wiki, trials[:1], sim=MG_SIMS, max_time=MAX_TIME, save_dir=save_dir,
                device="cuda")
        data = build_trial_data(wiki.n_nodes, [trials[0][0]], [trials[0][1]], [trials[0][2]],
                                triples)
        start = model.init(torch.Generator().manual_seed(SEED), device="cpu")
        args_cpu = worker.build_parser().parse_args([*argv, "--device", "cpu"])
        _, adj_cpu = worker.build_model_and_adj(args_cpu, wiki)
        card = _loss_and_grads(model, start, adj, data, "cuda")[:2]
        t0 = time.perf_counter()
        cpu = _loss_and_grads(model, start, adj_cpu, data, "cpu")[:2]
        out[family] = {"seconds": seconds, "history": hist, "test_loss": float(row["test_loss"]),
                       "adjacency": type(adj).__name__, "served_scenarios": len(served),
                       "step_grad_rel_err": worst_leaf(check_step_against_cpu(
                           family, card, cpu, hold_gradients=family != "GIN")),
                       "cpu_step_s": time.perf_counter() - t0}

    # DMP: the worker's run, and run_many on the card against run on the CPU
    dmp_step.launches = dmp_marginals.launches = 0  # the DMP baseline's path starts here
    _, out["dmp_seconds"] = run_worker(["--model", "dmp", *common], wiki)
    row = one_row("dmp")
    out["dmp_test_loss"], out["dmp_inference_s"] = float(row["test_loss"]), float(row["n_ode_time"])
    dmp = DMPSIR.from_graph(wiki)
    many = dmp.run_many([t[0] for t in trials], [t[1] for t in trials], [t[2] for t in trials],
                        max_time=MAX_TIME, device="cuda").cpu()
    out["k4_launches"], out["k5_launches"] = dmp_step.launches, dmp_marginals.launches
    ones = torch.stack([dmp.run(*t, max_time=MAX_TIME, device="cpu") for t in trials])
    if out["k4_launches"] != out["k5_launches"] or out["k4_launches"] % (MAX_TIME - 1):
        raise AssertionError(f"DMP on the card: {out['k4_launches']} K4 and "
                             f"{out['k5_launches']} K5 launches, not one each a step")
    out["dmp_max_abs_err_vs_cpu"] = float((many - ones).abs().max())
    if (many.shape != (len(trials), MAX_TIME, wiki.n_nodes, 3)
            or not out["dmp_max_abs_err_vs_cpu"] <= DMP_ATOL
            or float((many.sum(-1) - 1).abs().max()) > 1e-5):
        raise AssertionError(f"DMP on the card vs the CPU: {out['dmp_max_abs_err_vs_cpu']}")

    # RK: the worker's run at this size, and the card against the CPU on the
    # smaller graph
    _, out["rk_seconds"] = run_worker(["--model", "rk", *common], wiki)
    row = one_row("rk")
    out["rk_test_loss"], out["rk_inference_s"] = float(row["test_loss"]), float(row["rk_time"])
    out["rk_substeps"] = classical.auto_substeps(
        wiki, [t[1] for t in trials[4:]], max(t[2] for t in trials[4:]), 0.5)
    rk_trials = label_trials(small)[:2]
    rk = lambda device: sir_classical_batch(
        small, [t[0] for t in rk_trials], [t[1] for t in rk_trials], [t[2] for t in rk_trials],
        max_time=MAX_TIME, device=device)
    card = rk("cuda")
    t0 = time.perf_counter()
    cpu = rk("cpu")
    out["rk_cpu_s"], out["rk_compared_n"] = time.perf_counter() - t0, small.n_nodes
    out["rk_compared_substeps"] = classical.auto_substeps(
        small, [t[1] for t in rk_trials], max(t[2] for t in rk_trials), 0.5)
    out["rk_max_abs_err_vs_cpu"] = max(float(np.abs(a - b).max()) for a, b in zip(card, cpu))
    if (not out["rk_max_abs_err_vs_cpu"] <= RK_ATOL
            or float(np.abs(sum(card) - 1).max()) > 1e-4 or not np.isfinite(card[0]).all()):
        raise AssertionError(f"RK on the card vs the CPU: {out['rk_max_abs_err_vs_cpu']}")
    out["tol"] = (f"step: loss {STEP_LOSS_ATOL}, gradient leaves {STEP_GRAD_RTOL} (GIN: reported, "
                  f"loss within {GIN_LOSS_SANITY}); DMP {DMP_ATOL}; RK {RK_ATOL}")
    out["ok"] = True
    emit(out)
    return out


@contextlib.contextmanager
def recorded_launches():
    """Every K1 launch made inside: (x's shape, whether a backward pass made
    it), read where the wrapper hands x to the kernel, so that a ``vmap``
    fold shows its real [K·B, n, h]."""
    record = []
    launch = spmm2_module._launch

    def recording(plan, x, precision, backward):
        record.append((tuple(x.shape), backward))
        return launch(plan, x, precision, backward)

    spmm2_module._launch = recording
    try:
        yield record
    finally:
        spmm2_module._launch = launch


class FdCapture:
    """What this process and its children write to file descriptor ``fd`` (1:
    standard output, 2: errors) inside the block, as ``.text`` after it."""

    def __init__(self, fd: int = 1):
        self.fd, self.stream = fd, (sys.stdout if fd == 1 else sys.stderr)

    def __enter__(self):
        self.stream.flush()
        self._saved = os.dup(self.fd)
        self._file = tempfile.TemporaryFile()
        os.dup2(self._file.fileno(), self.fd)
        return self

    def __exit__(self, *exc):
        self.stream.flush()
        os.dup2(self._saved, self.fd)
        os.close(self._saved)
        self._file.seek(0)
        self.text = self._file.read().decode(errors="replace")
        self._file.close()


def ensemble_history(printed: str, k: int) -> list:
    """[(train losses [k], val losses [k], seconds)] per epoch from an
    ensemble worker's output."""
    rows = re.findall(r"Train Loss: ([0-9.eE+/-]+), Val Loss: ([0-9.eE+/-]+) \(([0-9.]+)s\)",
                      printed)
    hist = [([float(x) for x in a.split("/")], [float(x) for x in b.split("/")], float(c))
            for a, b, c in rows]
    if not hist or any(len(a) != k or len(b) != k for a, b, _ in hist):
        raise AssertionError(f"ensemble history is not {k} members an epoch: {rows}")
    return hist


def csv_rows(save_dir, dataset_name) -> list:
    with open(os.path.join(save_dir, f"Metrics-trials-{dataset_name}"), newline="") as f:
        rows = list(csv.reader(f))
    if rows[0] != TRIAL_COLUMNS:
        raise AssertionError("CSV header")
    return [dict(zip(TRIAL_COLUMNS, r)) for r in rows[1:]]


def launch_counts(record, shape) -> dict:
    return {"forward": sum(1 for s, b in record if s == shape and not b),
            "backward": sum(1 for s, b in record if s == shape and b)}


def matrix_ensemble(graph, trials, save_dir) -> dict:
    """``cli.worker.main --ensemble 4`` (C7, hidden 64, batch 1, euler) on the
    six labelled trials, against four sequential workers with init seeds
    0..3: member j's losses equal run j's within ``ENSEMBLE_LOSS_ATOL``, and
    K1 takes the four members in one launch per field evaluation of a
    training step. The evaluation passes (batch 8: 8.3 GB of trajectory a
    member, four over the activation budget) run the members one after
    another."""
    k, n, h = MATRIX_K, graph.n_nodes, 64
    argv = ["--model", "ode_nn", "--hidden", str(h), "--method", "euler", "--deltaT", "0.5",
            "--maxTime", str(MAX_TIME), "--batch_size", "1", "--lr", "1e-4", "--epochs", "1",
            "--sim", str(LABEL_SIMS), "--spmm", "auto", "--dataset", graph.name,
            "--path_to_save", save_dir, *trial_argv(trials)]
    csv_before = len(csv_rows(save_dir, graph.name))
    torch.cuda.synchronize()
    spmm2.launches = spmm2.backward_launches = gnode_step.launches = 0  # the path starts here
    with recorded_launches() as record:
        printed, seconds = run_worker([*argv, "--ensemble", str(k), "--trial", "11"], graph)
    launches = (spmm2.launches, spmm2.backward_launches, gnode_step.launches)  # and ends here
    if "ensemble routes (training, evaluation): ('fold', 'per_member')" not in printed:
        raise AssertionError("the single-graph ensemble did not fold its training steps")
    hist = ensemble_history(printed, k)
    n_train = 3
    train, evals = launch_counts(record, (k, n, h)), launch_counts(record, (8, n, h))
    if (train != {"forward": n_train * EULER_STEPS, "backward": n_train * EULER_STEPS}
            or evals != {"forward": 2 * k * EULER_STEPS, "backward": 0}
            or len(record) != launches[0] or launches[1] != train["backward"]):
        raise AssertionError(
            f"K1 launches {launches}: expected {EULER_STEPS} forward and backward at "
            f"[{k}, {n}, {h}] per training step over {n_train}, {EULER_STEPS} at "
            f"[8, {n}, {h}] per member and evaluation pass over 2: {train}, {evals}")
    rows = csv_rows(save_dir, graph.name)[csv_before:]
    if [r["trial"] for r in rows] != [str(11 + j) for j in range(k)]:
        raise AssertionError(f"the ensemble wrote trials {[r['trial'] for r in rows]}")
    seq, seq_s = [], []
    for j in range(k):
        out, _ = run_worker([*argv, "--trial", str(21 + j), "--init_seed", str(j)], graph)
        seq.append(training_history(out, 1)[0])
    err = max(max(abs(hist[0][0][j] - seq[j][0]), abs(hist[0][1][j] - seq[j][1]))
              for j in range(k))
    if err > ENSEMBLE_LOSS_ATOL:
        raise AssertionError(f"ensemble members vs sequential fits: max loss error {err}")
    return {"part": "ensemble_single_graph", "n": n, "hidden": h, "members": k,
            "batch_size": 1, "routes": ["fold", "per_member"], "seconds": seconds,
            "csv_rows": [{c: r[c] for c in ("trial", "best_epoch", "val_loss", "test_loss")}
                         for r in rows],
            "k1_launches": launches[0], "k1_backward_launches": launches[1],
            "k3_launches": launches[2],
            "k1_per_training_step": {"forward": EULER_STEPS, "backward": EULER_STEPS,
                                     "shape": [k, n, h]},
            "k1_per_evaluation_pass": {"forward": k * EULER_STEPS, "shape": [8, n, h]},
            "epoch_ms_ensemble": hist[0][2] * 1e3,
            "epoch_ms_sequential": [r[2] * 1e3 for r in seq],
            "epoch_ms_sequential_sum": sum(r[2] for r in seq) * 1e3,
            "member_loss_max_abs_err": err, "tol": ENSEMBLE_LOSS_ATOL}


def matrix_multigraph(graphs, save_dir) -> dict:
    """``run_matrix`` in this process on ``ngraphs_config()`` with
    ``--ensemble``: the published four repeats at hidden 8 become one
    ``--ensemble 4`` worker (depth cut as the multigraph phase's, whose
    pinned trials and labels in ``save_dir`` it reuses). Training takes the
    per-member route (one K1 plan per graph); evaluation folds."""
    dataset = "+".join(g.name for g in graphs)
    n_max = -(-graphs[-1].n_nodes // 8) * 8
    cfg = dataclasses.replace(
        monitorer.ngraphs_config(), datasets_array=(dataset,), epochs=1, sim=MG_SIMS,
        experiments_root=save_dir,
        worker_flags=("--instances_per_graph", *[str(MG_TRIALS_PER_GRAPH)] * len(graphs),
                      "--mg_adj", "auto"))
    k = len(cfg.hidden_dim_array)
    csv_before = len(csv_rows(save_dir, dataset))
    torch.cuda.synchronize()
    # the path starts here
    spmm2.launches = spmm2.backward_launches = sir_step.launches = gnode_step.launches = 0
    with recorded_launches() as record, FdCapture() as out:
        t0 = time.perf_counter()
        rc = monitorer.run_matrix(cfg, ensemble=True, device="cuda", graphs={dataset: graphs})
        seconds = time.perf_counter() - t0
    launches = (spmm2.launches, spmm2.backward_launches, sir_step.launches,
                gnode_step.launches)  # the path ends here
    printed = out.text
    if rc != 0 or "Started experiment 1/1" not in printed or f"ensemble={k}" not in printed:
        raise AssertionError(f"run_matrix --ensemble: rc {rc}\n{printed[-3000:]}")
    if "ensemble routes (training, evaluation): ('per_member', 'fold')" not in printed:
        raise AssertionError("the multi-graph ensemble did not train per member and fold evaluation")
    hist = ensemble_history(printed, k)
    steps = len(graphs) - 1  # one minibatch of MG_BATCH trials a train graph, per member
    train = launch_counts(record, (MG_BATCH, MG_TRAIN_WIDTH, MG_HIDDEN))
    evals = launch_counts(record, (k * MG_BATCH, n_max, MG_HIDDEN))
    if (train != {"forward": k * steps * EULER_STEPS, "backward": k * steps * EULER_STEPS}
            or evals["backward"] or evals["forward"] not in (2 * EULER_STEPS,)
            or len(record) != launches[0] or launches[2] != 0):
        raise AssertionError(
            f"K1 launches {launches}: training {train} (expected {k * steps * EULER_STEPS} "
            f"each way at [{MG_BATCH}, {MG_TRAIN_WIDTH}, {MG_HIDDEN}]), evaluation {evals} "
            f"(expected {2 * EULER_STEPS} at [{k * MG_BATCH}, {n_max}, {MG_HIDDEN}])")
    rows = csv_rows(save_dir, dataset)[csv_before:]
    if [r["trial"] for r in rows] != [str(1 + j) for j in range(k)] or not all(
            0.0 < float(r["test_loss"]) < 1.0 for r in rows):
        raise AssertionError(f"matrix CSV rows {rows}")

    # the evaluation pass alone: the four members folded into one K1 launch a
    # field evaluation, timed warm
    per_graph = []
    for g in graphs:
        parts = []
        for key in ("seed", "beta", "gamma"):
            path = os.path.join(save_dir, f"Experiments-seed2-{g.name}", f"initial-{key}.pkl")
            with open(path, "rb") as f:
                parts.append(pickle.load(f)[:MG_TRIALS_PER_GRAPH])
        per_graph.append(list(zip(*parts)))
    batch, data = assemble_multigraph_trials(
        graphs, per_graph, sim=MG_SIMS, max_time=MAX_TIME, device="cuda",
        label_dirs=[os.path.join(save_dir, f"Experiments-seed2-{g.name}") for g in graphs])
    _, va, te = multigraph_split([MG_TRIALS_PER_GRAPH] * len(graphs))
    conn = multigraph_auto_fns(batch, device="cuda")
    args = worker.build_parser().parse_args(
        ["--hidden", str(MG_HIDDEN), "--batch_size", str(MG_BATCH), "--device", "cuda"])
    model = worker.build_model(args, n_max)
    params = init_ensemble(model, range(k), device="cuda")
    evaluate = make_eval_fn(model, conn.eval_adj_fn, conn.node_mask_fn)
    d = _data_to_device(data, "cuda")
    rows_idx = np.concatenate([va, te])[None, :MG_BATCH]
    ones = np.ones((1, MG_BATCH), np.float32)
    fold = lambda: torch.func.vmap(lambda p: evaluate(p, d, rows_idx, ones))(params)
    one_by_one = lambda: torch.stack([evaluate(tree_map(lambda t: t[j], params), d, rows_idx,
                                               ones) for j in range(k)])
    eval_ms, one_by_one_ms = {}, {}
    for turn in range(2):  # in turns: fold, members one by one, and again
        for name, fn in (("fold", fold), ("one_by_one", one_by_one)):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            (eval_ms if name == "fold" else one_by_one_ms)[turn] = (
                (time.perf_counter() - t0) / 3 * 1e3)
    if not torch.allclose(fold(), one_by_one(), rtol=1e-6, atol=0.0):
        raise AssertionError("the folded evaluation differs from the members' own")
    eval_ms, one_by_one_ms = min(eval_ms.values()), min(one_by_one_ms.values())
    epoch_ms = hist[0][2] * 1e3
    return {"part": "multigraph_matrix_folded", "graphs": len(graphs), "members": k,
            "hidden": MG_HIDDEN, "batch_size": MG_BATCH, "epochs": 1,
            "routes": ["per_member", "fold"], "seconds": seconds,
            "csv_rows": [{c: r[c] for c in ("trial", "best_epoch", "val_loss", "test_loss")}
                         for r in rows],
            "k1_launches": launches[0], "k1_backward_launches": launches[1],
            "k3_launches": launches[3],
            "k1_training": {**train, "shape": [MG_BATCH, MG_TRAIN_WIDTH, MG_HIDDEN]},
            "k1_evaluation": {**evals, "shape": [k * MG_BATCH, n_max, MG_HIDDEN],
                              "per_pass": EULER_STEPS},
            "epoch_ms": epoch_ms, "eval_pass_ms": eval_ms,
            "eval_pass_ms_members_one_by_one": one_by_one_ms,
            "training_step_ms": (epoch_ms - eval_ms) / steps,
            "training_step_ms_is": "(epoch - one evaluation pass) / minibatches; a step "
                                   "runs the four members one after another"}


def matrix_crash_resume(graph, trials, root) -> dict:
    """One single-graph job through ``run_matrix`` in worker processes, with
    ``--checkpoint_every 1 --die_at_epoch 1``: the first attempt exits with
    17 at epoch 1, the retry resumes its checkpoint. Its history and CSV row
    must equal an uninterrupted run's in this process."""
    dataset = os.path.join(root, graph.name)
    with open(dataset + ".pkl", "wb") as f:  # a worker process reads it without networkx
        pickle.dump(Graph(n_nodes=graph.n_nodes, src=graph.src, dst=graph.dst,
                          name=graph.name), f)
    save_dir = os.path.join(root, f"Experiments-seed2-{graph.name}")
    cfg = monitorer.MatrixConfig(
        epochs=CRASH_EPOCHS, lr=1e-4, batch_size=1, sim=LABEL_SIMS, max_time=MAX_TIME,
        hidden_dim_array=(64,), datasets_array=(dataset,), experiments_root=root,
        worker_flags=("--spmm", "auto", "--checkpoint_every", "1", "--die_at_epoch", "1"))
    i_indices, betas, gammas = monitorer._load_or_create_params(cfg, dataset, save_dir)
    if len(i_indices) != len(trials):
        raise AssertionError("the job does not reuse the labelled trials")
    plain = dataclasses.replace(cfg, worker_flags=("--spmm", "auto", "--auto_checkpoint", "0"))
    argv = monitorer.build_worker_argv(plain, dataset, save_dir, 64, 1, i_indices, betas, gammas)
    spmm2.launches = spmm2.backward_launches = gnode_step.launches = 0  # the run starts here
    printed, _ = run_worker(argv, graph)
    launches = (spmm2.launches, spmm2.backward_launches, gnode_step.launches)  # and ends here
    want = training_history(printed, CRASH_EPOCHS)
    want_row = csv_rows(save_dir, graph.name)[-1]
    with FdCapture(1) as out, FdCapture(2) as err:
        t0 = time.perf_counter()
        rc = monitorer.run_matrix(cfg, use_subprocess=True, retries=1, retry_wait_s=0,
                                  device="cuda")
        seconds = time.perf_counter() - t0
    printed = out.text
    resumed = [(float(a), float(b)) for a, b in re.findall(
        r"Train Loss: ([0-9.eE+-]+), Val Loss: ([0-9.eE+-]+)", printed)]
    if (rc != 0 or "[fault-injection] dying at epoch 1" not in printed
            or "worker exited with 17" not in err.text
            or "resumed from" not in printed or "attempt 1/2 failed" not in printed):
        raise AssertionError(f"crash and resume did not run as drilled (rc {rc}):\n"
                             f"{printed[-4000:]}\n{err.text[-4000:]}")
    # the first attempt printed epoch 0 (it dies in the logger of epoch 1,
    # before epoch 1's line), the resumed one epochs 1 and 2
    if resumed != [r[:2] for r in want]:
        raise AssertionError(f"resumed history {resumed} differs from the uninterrupted {want}")
    row = csv_rows(save_dir, graph.name)[-1]
    keys = ("trial", "best_epoch", "val_loss", "test_loss")
    if any(row[c] != want_row[c] for c in keys):
        raise AssertionError(f"resumed CSV row {row} differs from the uninterrupted {want_row}")
    return {"part": "crash_resume", "n": graph.n_nodes, "epochs": CRASH_EPOCHS,
            "die_at_epoch": 1, "child_exit": 17, "seconds_two_processes": seconds,
            "history": [list(r) for r in resumed], "csv_row": {c: row[c] for c in keys},
            "equal_to_uninterrupted": True,
            "k1_launches": launches[0], "k1_backward_launches": launches[1],
            "k3_launches": launches[2],
            "launches_counted": "the uninterrupted run in this process; the worker "
                                "processes' are not counted"}


def _step_grads(model, params, adj, data, device):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = (spmm2.launches, spmm2.backward_launches)
    loss, grads, _ = _loss_and_grads(model, params, adj, data, device)
    torch.cuda.synchronize()
    return (loss, grads, torch.cuda.max_memory_allocated() / 1e9,
            (spmm2.launches - before[0], spmm2.backward_launches - before[1]))


def matrix_backsolve(graph, small, trials, save_dir) -> dict:
    """One training step (batch 1, C7's field at hidden 64, K1) with
    ``adjoint='backsolve'`` against ``direct`` on the card.

    At enron size with C7's own solver (euler, deltaT 0.5, maxTime 20, as
    trained) the loss is held (1e-6 relative: the forward is the same) and
    the gradient gap is reported, not held: reversing the integration is
    unstable where the field is stiff (a hub of 1,436 neighbours), so the
    reconstructed state runs off, as it would in the JAX package. The
    gradient is held (every leaf within 2e-3 of its scale) on the
    fb-food-size graph with rk4 at deltaT 0.125 over maxTime 5, where the
    reverse reconstruction is accurate."""
    out = {"part": "backsolve", "hidden": 64, "batch_size": 1}
    spmm2.launches = spmm2.backward_launches = gnode_step.launches = 0  # the path starts here
    for case, g, method, max_time, delta_t, held in (
            ("enron_c7_euler", graph, "euler", MAX_TIME, 0.5, False),
            ("fb_food_rk4_fine", small, "rk4", 5, 0.125, True)):
        lt = trials if g is graph else label_trials(g)
        triples = load_or_extract_labels_many(
            g, lt[:1], sim=LABEL_SIMS if g is graph else MG_SIMS, max_time=max_time,
            save_dir=save_dir, device="cuda")
        data = build_trial_data(g.n_nodes, [lt[0][0]], [lt[0][1]], [lt[0][2]], triples)
        adj = Spmm2Adj.from_graph(g, device="cuda")
        cfg = dict(hidden=64, method=method, max_time=max_time, delta_t=delta_t)
        start = GNODE(**cfg).init(torch.Generator().manual_seed(SEED), device="cpu")
        sides = {adjoint: _step_grads(GNODE(**cfg, adjoint=adjoint), start, adj, data, "cuda")
                 for adjoint in ("direct", "backsolve")}
        (l_d, g_d, mem_d, k_d), (l_b, g_b, mem_b, k_b) = sides["direct"], sides["backsolve"]
        rel = {k: float((g_b[k] - v).abs().max()) / max(float(v.abs().max()), 1e-30)
               for k, v in g_d.items() if k != "dec2/b"}  # dec2/b: rounding noise
        evals = (int(round(max_time / delta_t)) - 1) * (4 if method == "rk4" else 1)
        # direct: the forward and its gradient; backsolve: the forward without
        # a graph, then per reverse evaluation one K1 and one K1-bwd
        if k_b != (3 * evals, evals) or k_d != (2 * evals, evals):
            raise AssertionError(
                f"{case}: K1 launches (all, backward) direct {k_d}, backsolve {k_b}; "
                f"expected ({2 * evals}, {evals}) and ({3 * evals}, {evals})")
        loss_rel = abs(l_b - l_d) / abs(l_d)
        if loss_rel > 1e-6 or (held and max(rel.values()) > BACKSOLVE_GRAD_RTOL):
            raise AssertionError(f"{case}: backsolve vs direct loss {loss_rel}, leaves {rel}")
        out[case] = {"n": g.n_nodes, "max_degree": int(g.degrees.max()), "method": method,
                     "max_time": max_time, "delta_t": delta_t, "loss_rel_err": loss_rel,
                     "grad_rel_err_worst": max(rel.values()), "grad_rel_err": rel,
                     "gradient_held": held,
                     "k1_launches": {"direct": list(k_d), "backsolve": list(k_b)},
                     "peak_memory_gb": {"direct": mem_d, "backsolve": mem_b}}
    out["k1_launches"], out["k1_backward_launches"] = spmm2.launches, spmm2.backward_launches
    out["k3_launches"] = gnode_step.launches
    out["tol"] = f"loss 1e-6 relative; fb_food_rk4_fine leaves {BACKSOLVE_GRAD_RTOL} of their scale"
    return out


def _dopri_setup(graph, spmm, device, budget, batch):
    args = worker.build_parser().parse_args(
        ["--hidden", "64", "--method", "dopri5_adaptive", "--spmm", spmm, "--device", device])
    model, adj = worker.build_model_and_adj(args, graph, batch_size=batch)
    return dataclasses.replace(model, solver_budget=budget), adj


def _dopri_scenarios(graph):
    rng = np.random.default_rng([SEED, 5])
    seeds = [sorted(rng.choice(graph.n_nodes, 3, replace=False).tolist())
             for _ in range(DISPATCH_BATCH)]
    return infer.scenario_batch(graph.n_nodes, seeds, rng.uniform(0.1, 0.5, DISPATCH_BATCH),
                                rng.uniform(0.05, 0.3, DISPATCH_BATCH))


def matrix_dopri(graph, small) -> dict:
    """``method='dopri5_adaptive'`` in serving. At enron size, eight
    scenarios in one dispatch with a budget of ``DOPRI_BUDGET`` attempts (the
    default 78 would hold 4 x 78 states of [8, n, 64], 65 GB): ms per
    dispatch and K1's six launches per attempt plus one. That budget is
    starved, so whether an attempt is accepted follows the last bits of the
    error estimate: the same dispatch with the neighbour sum in another
    order (the COO adjacency, plain ``index_add_``) is reported beside it,
    not held. Held: the fb-food-size graph through K1 with the default
    budget, eight scenarios on the card against the CPU within
    ``DOPRI_ATOL``."""
    model, adj = _dopri_setup(graph, "auto", "cuda", DOPRI_BUDGET, DISPATCH_BATCH)
    params_cpu = model.init(torch.Generator().manual_seed(SEED), device="cpu")
    params = tree_map(lambda t: t.to("cuda"), params_cpu)
    sb = _dopri_scenarios(graph)
    infer.predict_summaries(model, params, adj, *sb)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spmm2.launches = gnode_step.launches = 0  # the path starts here
    t0 = time.perf_counter()
    card = infer.predict_scenarios(model, params, adj, *sb)
    ms = (time.perf_counter() - t0) * 1e3
    launches = spmm2.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    if launches != 6 * DOPRI_BUDGET + 1:
        raise AssertionError(f"dopri5_adaptive: {launches} K1 launches, expected "
                             f"{6 * DOPRI_BUDGET + 1}")
    if (card.shape != (MAX_TIME, DISPATCH_BATCH, graph.n_nodes, 3) or not np.isfinite(card).all()
            or np.abs(card.sum(-1) - 1.0).max() > 1e-5):
        raise AssertionError(f"dopri5_adaptive output {card.shape} is not finite probabilities")
    coo_model, coo_adj = _dopri_setup(graph, "coo", "cuda", DOPRI_BUDGET, DISPATCH_BATCH)
    reordered = infer.predict_scenarios(coo_model, params, coo_adj, *sb)

    budget = 2 * EULER_STEPS  # the default: 2 (T - 1) attempts for T = 40 grid points
    model_s, adj_s = _dopri_setup(small, "pallas2", "cuda", 0, DISPATCH_BATCH)
    cpu_model, cpu_adj = _dopri_setup(small, "pallas2", "cpu", 0, DISPATCH_BATCH)
    sb_s = _dopri_scenarios(small)
    before = spmm2.launches
    card_s = infer.predict_scenarios(model_s, params, adj_s, *sb_s)
    launches_s = spmm2.launches - before
    launches, k3 = spmm2.launches, gnode_step.launches  # and ends here
    cpu_s = infer.predict_scenarios(cpu_model, params_cpu, cpu_adj, *sb_s)
    err = float(np.abs(card_s - cpu_s).max())
    if launches_s != 6 * budget + 1 or not np.isfinite(card_s).all() or err > DOPRI_ATOL:
        raise AssertionError(f"dopri5_adaptive at {small.n_nodes} nodes: {launches_s} K1 "
                             f"launches, card vs CPU max abs err {err}")
    return {"part": "dopri5_adaptive", "hidden": 64, "scenarios": DISPATCH_BATCH,
            "enron": {"n": graph.n_nodes, "budget": DOPRI_BUDGET, "ms_per_dispatch": ms,
                      "k1_per_dispatch": 6 * DOPRI_BUDGET + 1, "peak_memory_gb": peak,
                      "max_abs_diff_other_sum_order": float(np.abs(card - reordered).max())},
            "held": {"n": small.n_nodes, "budget": budget, "k1_per_dispatch": launches_s,
                     "max_abs_err_vs_cpu": err, "atol": DOPRI_ATOL},
            "k1_launches": launches, "k3_launches": k3}


def matrix_node_split(graph, trials, save_dir) -> dict:
    """``cli.worker --node_split`` (C6: relu, rk4, layer-normed derivative,
    hidden 64) on one trial at beta 0.2 (64 RK substeps on the hub), one
    epoch, and the RK baseline."""
    nodes = trials[0][0]
    argv = ["--node_split", "--model", "ode_nn", "--hidden", "64", "--maxTime", str(MAX_TIME),
            "--deltaT", "0.5", "--lr", "1e-3", "--epochs", "1", "--sim", str(LABEL_SIMS),
            "--spmm", "auto", "--dataset", graph.name, "--path_to_save", save_dir,
            "--trial", "31", "--I_indices", str(nodes), "--beta", "0.2", "--gamma", "0.1"]
    # the path starts here
    spmm2.launches = spmm2.backward_launches = sir_step.launches = gnode_step.launches = 0
    printed, seconds = run_worker(argv, graph)
    launches = (spmm2.launches, spmm2.backward_launches, sir_step.launches, gnode_step.launches)
    row = csv_rows(save_dir, graph.name)[-1]
    evals = 4 * EULER_STEPS  # rk4
    # forward, the checkpoint adjoint's recompute, and the test pass; backward
    if launches[:2] != (4 * evals, evals) or row["trial"] != "31" or not (
            0.0 < float(row["test_loss"]) < 1.0 and float(row["loss_baseline"]) > 0.0):
        raise AssertionError(f"node split: K1 launches {launches[:2]}, CSV row {row}")
    return {"part": "node_split", "n": graph.n_nodes, "model": "C6", "hidden": 64,
            "epochs": 1, "seconds": seconds, "rk_time_s": float(row["rk_time"]),
            "csv_row": {c: row[c] for c in ("trial", "best_epoch", "val_loss", "test_loss",
                                            "loss_baseline", "n_ode_time", "rk_time")},
            "k1_launches": launches[0], "k1_backward_launches": launches[1],
            "k2_launches": launches[2], "k3_launches": launches[3]}


def phase_matrix_single(graph, trials, small, root, save_dir) -> dict:
    """The single-graph parts of the experiment matrix at enron size."""
    parts = {}
    for name, fn in (("ensemble", lambda: matrix_ensemble(graph, trials, save_dir)),
                     ("crash", lambda: matrix_crash_resume(graph, trials, root)),
                     ("backsolve", lambda: matrix_backsolve(graph, small, trials, save_dir)),
                     ("dopri", lambda: matrix_dopri(graph, small)),
                     ("node_split", lambda: matrix_node_split(graph, trials, save_dir))):
        parts[name] = fn()
        emit({"phase": "matrix", **parts[name], "ok": True})
        torch.cuda.empty_cache()
    return parts


def edge_halves(graph) -> list:
    """The two blocks of the dst-sorted edge list that the edge axis of a
    2-process mesh holds (``parallel.mesh.local_block``); the hub rows that
    straddle the cut are split between them."""
    cut = graph.n_edges // 2
    return [Graph(n_nodes=graph.n_nodes, src=graph.src[sl], dst=graph.dst[sl],
                  name=f"{graph.name}_edges{k}")
            for k, sl in enumerate((slice(0, cut), slice(cut, None)))]


def phase_kernel_shards(graph) -> tuple[list, list]:
    """K1 and K1-bwd on each half of the enron-size edge list, the plans an
    edge-sharded SpMM launches on: each half against its plain version, the
    many rows without an edge in a half exact zeros, and the two halves'
    outputs summed against the full plan's (forward and gradient) within
    ``KERNEL_REL_TOL * (1 + sum|w x|)``."""
    dev = torch.device("cuda")
    halves = edge_halves(graph)
    fwd = [check_spmm2_case(f"enron_edge_shard{k}_b8_h64", h, DISPATCH_BATCH, 64, "f32",
                            torch.float32, timed=True) for k, h in enumerate(halves)]
    bwd = [check_spmm2_bwd_case(f"bwd_enron_edge_shard{k}_b1", h, 1, "f32", timed=True)
           for k, h in enumerate(halves)]
    rng = np.random.default_rng([SEED, 6])
    x = torch.as_tensor(rng.standard_normal((DISPATCH_BATCH, graph.n_nodes, 64), np.float32),
                        device=dev)
    full = Spmm2Adj.from_graph(graph, device=dev)
    adjs = [Spmm2Adj.from_graph(h, device=dev) for h in halves]
    row = {"phase": "kernel", "kernel": "spmm2", "case": "enron_edge_shards_summed",
           "batch": DISPATCH_BATCH, "h": 64, "edges": [h.n_edges for h in halves],
           "tol": f"{KERNEL_REL_TOL} * (1 + sum|w x|)"}
    for which, plan_of, rows_of in (("forward", lambda a: a.plan, lambda h: h.dst),
                                    ("gradient", lambda a: a.plan_t, lambda h: h.src)):
        parts = []
        for h, adj in zip(halves, adjs):
            y = spmm2(plan_of(adj), x)
            empty = np.setdiff1d(np.arange(graph.n_nodes), rows_of(h))
            if not empty.size or y[:, torch.as_tensor(empty, device=dev)].any():
                raise AssertionError(f"{which}: a shard's {empty.size} edgeless rows are not zeros")
            parts.append(y)
            row.setdefault(f"{which}_edgeless_rows", []).append(int(empty.size))
        plan = plan_of(full)
        scale = spmm2_plain(dataclasses.replace(plan, w=plan.w.abs()), x.abs())
        err = (parts[0] + parts[1] - spmm2(plan, x)).abs()
        if (err > KERNEL_REL_TOL * (1.0 + scale)).any():
            raise AssertionError(f"{which}: the two shards summed differ from the full plan "
                                 f"(max abs err {float(err.max())})")
        row[f"{which}_max_abs_err"] = float(err.max())
    emit({**row, "ok": True})
    return fwd, bwd


def phase_ell(graph) -> dict:
    """The bucketed-ELL adjacency (``ops/ell.py``, plain torch gathers) at
    enron size, [8, n, 64], against K1 within ``KERNEL_REL_TOL * (1 + sum|x|)``,
    and the two times side by side."""
    from gn_ode_sir_tpu_torch.ops.ell import EllAdj

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ell = EllAdj.from_graph(graph, device=dev)
    build_s = time.perf_counter() - t0
    k1 = Spmm2Adj.from_graph(graph, device=dev)
    rng = np.random.default_rng([SEED, 7])
    x = torch.as_tensor(rng.standard_normal((DISPATCH_BATCH, graph.n_nodes, 64), np.float32),
                        device=dev)
    with torch.no_grad():
        got, want = ell.matvec(x), spmm2(k1.plan, x)
        scale = spmm2_plain(k1.plan, x.abs())
        err = (got - want).abs()
        if not torch.isfinite(got).all() or (err > KERNEL_REL_TOL * (1.0 + scale)).any():
            raise AssertionError(f"EllAdj disagrees with K1 (max abs err {float(err.max())})")
        ell_ms = time_ms(lambda: ell.matvec(x), 10)
        k1_ms = time_ms(lambda: spmm2(k1.plan, x), 50)
    row = {"phase": "ell", "n": graph.n_nodes, "edges": graph.n_edges,
           "shape": [DISPATCH_BATCH, graph.n_nodes, 64], "buckets": len(ell.bucket_idx),
           "widths": [int(b.shape[1]) for b in ell.bucket_idx],
           "gathered_rows": int(sum(b.numel() for b in ell.bucket_idx)),
           "host_build_s": build_s, "ell_ms": ell_ms, "k1_ms": k1_ms,
           "max_abs_err_vs_k1": float(err.max()), "tol": f"{KERNEL_REL_TOL} * (1 + sum|x|)",
           "ok": True}
    emit(row)
    return row


def host_cpu() -> str:
    """The host's CPU (its model where ``/proc/cpuinfo`` names one), its
    architecture and logical core count, for host times."""
    model = "CPU"
    with contextlib.suppress(OSError):
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f
                          if ln.lower().startswith(("model name", "cpu model"))), model)
    return f"{model} ({platform.machine()}), {os.cpu_count()} logical cores"


def best_ms(fn, repeats: int = 3) -> float:
    """The least host wall time of ``fn()`` over ``repeats`` calls."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def phase_native(graph) -> dict:
    """The native graph core (``native/graphcore.cc``, built with g++ at
    first use) must load on this machine; at enron size, graph construction
    (coalescing the undirected pairs, the one call site the port gives it)
    with the library must equal the numpy path, and the library's CSR
    offsets and reverse-edge index must equal the numpy code that K1's plan
    and DMP's ``cave_index`` run, element for element; the host ms of
    both."""
    from gn_ode_sir_tpu_torch import native
    from gn_ode_sir_tpu_torch.models.dmp import cave_index

    t0 = time.perf_counter()
    if not native.native_available():
        raise AssertionError("the native graph core did not build or load (g++ -O3 -shared)")
    load_s = time.perf_counter() - t0
    keep = graph.src < graph.dst
    pairs = np.stack([graph.src[keep], graph.dst[keep]], axis=1)
    pairs = pairs[np.random.default_rng([SEED, 8]).permutation(len(pairs))]

    def numpy_offsets():
        row_ptr = np.zeros(graph.n_nodes + 1, np.int64)
        np.cumsum(np.bincount(graph.dst, minlength=graph.n_nodes), out=row_ptr[1:])
        return row_ptr

    calls = {  # name: (with the library, numpy)
        "coalesce": (lambda: graph_from_edges(graph.n_nodes, pairs), None),
        "csr_offsets": (lambda: native.csr_offsets(graph.dst, graph.n_nodes), numpy_offsets),
        "reverse_edge_index": (
            lambda: native.reverse_edge_index(graph.src, graph.dst, graph.n_nodes),
            lambda: cave_index(graph.src, graph.dst)),
    }
    out, ms = {}, {}
    for name, (lib, plain) in calls.items():
        out[name, "native"], ms[f"{name}_native_ms"] = lib(), best_ms(lib)
        if plain is None:  # the call site's own numpy fallback
            os.environ["GN_ODE_SIR_NO_NATIVE"] = "1"
            plain = lib
        try:
            out[name, "numpy"], ms[f"{name}_numpy_ms"] = plain(), best_ms(plain)
        finally:
            os.environ.pop("GN_ODE_SIR_NO_NATIVE", None)
    g_lib, g_np = out["coalesce", "native"], out["coalesce", "numpy"]
    if not (np.array_equal(g_lib.src, g_np.src) and np.array_equal(g_lib.dst, g_np.dst)
            and np.array_equal(g_lib.src, graph.src) and np.array_equal(g_lib.dst, graph.dst)
            and all(np.array_equal(out[k, "native"], out[k, "numpy"])
                    for k in ("csr_offsets", "reverse_edge_index"))):
        raise AssertionError("the native graph core disagrees with the numpy path")
    row = {"phase": "native", "n": graph.n_nodes, "edges": graph.n_edges,
           "undirected_pairs": len(pairs), "library": str(native.library_path().name),
           "first_use_s": load_s, "host": host_cpu(), **ms,
           "equal_to_numpy": True, "ok": True}
    emit(row)
    return row


def _trial_batch(data, k: int) -> dict:
    """Trial ``k`` as a one-row SPMD batch (numpy)."""
    sl = slice(k, k + 1)
    return {"s0": data.s0[sl], "i0": data.i0[sl], "r0": data.r0[sl], "beta": data.beta[sl],
            "gamma": data.gamma[sl], "labels": data.labels[sl], "weight": np.ones(1, np.float32)}


def _sgd_update(params, step):
    """Params on the card, one SGD step at lr 1 by ``step(params, optimizer)``:
    (loss, the update of every leaf, i.e. minus its gradient)."""
    p = tree_map(lambda t: t.detach().to("cuda").clone().requires_grad_(True), params)
    before = {path: leaf.detach().clone() for path, leaf in tree_leaves(p)}
    loss = float(step(p, torch.optim.SGD([leaf for _, leaf in tree_leaves(p)], lr=1.0)))
    return loss, {path: (leaf.detach() - before[path]).cpu() for path, leaf in tree_leaves(p)}


def _held_update(what, got, want) -> dict:
    """Loss within ``SPMD_LOSS_ATOL``, every leaf's update within
    ``SPMD_LEAF_RTOL`` of its largest entry (max-norm)."""
    (loss_got, upd_got), (loss_want, upd_want) = got, want
    rel = {k: float((upd_got[k] - u).abs().max()) / max(float(u.abs().max()), 1e-30)
           for k, u in upd_want.items()}
    worst = worst_leaf(rel)
    if abs(loss_got - loss_want) > SPMD_LOSS_ATOL or worst["max"] > SPMD_LEAF_RTOL:
        raise AssertionError(f"{what}: loss {loss_got} vs {loss_want}, worst leaf {worst}")
    return {"loss": loss_got, "loss_abs_err": abs(loss_got - loss_want), "worst_leaf": worst,
            "bit_equal": loss_got == loss_want and all(
                torch.equal(upd_got[k], u) for k, u in upd_want.items())}


def _ensemble_summary(res) -> dict:
    return {"history": [[e, np.asarray(a).tolist(), np.asarray(b).tolist()]
                        for e, a, b in res.history],
            "best_epoch": np.asarray(res.best_epoch).tolist(),
            "test_loss": np.asarray(res.test_loss).tolist(),
            "params": {p: leaf.cpu() for p, leaf in tree_leaves(res.params)}}


def _ensemble_err(a, b) -> float:
    """The largest difference between two ensemble results' losses and params."""
    flat = lambda r: np.concatenate(
        [np.ravel(h[1] + h[2]) for h in r["history"]] + [np.ravel(r["test_loss"])]
        + [t.numpy().ravel() for t in r["params"].values()])
    return float(np.abs(flat(a) - flat(b)).max())


def phase_parallel(graph, trials, root, save_dir) -> dict:
    """``parallel/`` on this one card, in a process group of this process
    alone over NCCL (rendezvous on 127.0.0.1; a multi-card group is not
    available here): (a) ``make_spmd_train_step`` (C7, hidden 64, batch 1,
    K1) against the single-device step, (b) ``make_spmd_train_step_2d`` on a
    (1, 1) data x edge mesh through ``EdgeShardedCooAdj`` against (a), both
    one SGD step at lr 1 so that the leaf update is the gradient; (c)
    ``simulate_sir_sharded`` (K2) at the label path's size; (d) the sharded
    dispatch of ``cli.infer --spmd`` (``make_spmd_predict_fn`` with its
    all-gather) against the plain one, and the CLI with the flag against
    the CLI without (at world size 1 the CLI takes the plain path, as the
    JAX package's does: that pair holds only the fallback); (e)
    ``fit_ensemble(mesh=)`` over a member group of size 1, and with
    ``data_axis`` on a (1, 1) mesh, against the run without a mesh.

    Each piece's launches are counted on their own (every count set to 0
    just before the piece's parallel path and read just after; the
    references it is held against run outside that window), and each piece
    must have launched the kernels its path runs."""
    import torch.distributed as dist

    from gn_ode_sir_tpu_torch import parallel
    from gn_ode_sir_tpu_torch.train import fit_ensemble

    t0 = time.perf_counter()
    mesh = parallel.make_mesh(device_type="cuda")
    mesh_2d = parallel.make_mesh((1, 1), ("data", "edge"), device_type="cuda")
    setup_s = time.perf_counter() - t0
    if dist.get_world_size() != 1 or dist.get_backend() != "nccl":
        raise AssertionError(f"process group {dist.get_backend()} x {dist.get_world_size()}")
    argv = ["--model", "ode_nn", "--hidden", "64", "--method", "euler", "--deltaT", "0.5",
            "--maxTime", str(MAX_TIME), "--batch_size", "1", "--spmm", "auto"]
    args = worker.build_parser().parse_args([*argv, "--device", "cuda"])
    model, adj = worker.build_model_and_adj(args, graph)
    triples = load_or_extract_labels_many(graph, trials, sim=LABEL_SIMS, max_time=MAX_TIME,
                                          save_dir=save_dir, device="cuda")
    data = build_trial_data(graph.n_nodes, [t[0] for t in trials], [t[1] for t in trials],
                            [t[2] for t in trials], triples)
    params = model.init(torch.Generator().manual_seed(SEED), device="cpu")
    batch = _trial_batch(data, 0)
    on = lambda k: torch.as_tensor(batch[k], device="cuda")
    out = {"phase": "parallel", "world_size": 1, "backend": "nccl", "setup_s": setup_s}
    launches = {}

    def counted(piece, fn, *kernels):
        """``fn()`` with every launch count set to 0 just before it and read
        just after it; every kernel named must have been launched."""
        torch.cuda.synchronize()
        spmm2.launches = spmm2.backward_launches = sir_step.launches = gnode_step.launches = 0
        result = fn()
        torch.cuda.synchronize()
        n = {"k1": spmm2.launches - spmm2.backward_launches,
             "k1_backward": spmm2.backward_launches, "k2": sir_step.launches,
             "k3": gnode_step.launches}
        if any(n[k] == 0 for k in kernels):
            raise AssertionError(f"{piece} did not go through {kernels}: launches {n}")
        launches[piece] = n
        return result

    def single(p, opt):
        loss = l1_sir_loss(model.predict(p, adj, *(on(k) for k in ("s0", "i0", "r0", "beta",
                                                                  "gamma"))),
                           on("labels"), trial_weight=on("weight"))
        loss.backward()
        opt.step()
        return loss

    want = _sgd_update(params, single)
    step_a = parallel.make_spmd_train_step(model, lambda gi: adj, mesh)
    got_a = counted("a", lambda: _sgd_update(params, lambda p, opt: step_a(p, opt, batch)),
                    "k1", "k1_backward")
    out["a_train_step"] = _held_update("(a) make_spmd_train_step", got_a, want)
    t0 = time.perf_counter()
    step_b = parallel.make_spmd_train_step_2d(model, mesh_2d, graph.n_nodes)
    ones = np.ones(graph.n_edges, np.float32)
    got_b = counted("b", lambda: _sgd_update(
        params, lambda p, opt: step_b(p, opt, batch, graph.src, graph.dst, ones)),
        "k1", "k1_backward")
    out["b_train_step_2d"] = {**_held_update("(b) make_spmd_train_step_2d", got_b, got_a),
                              "seconds_with_plan_build": time.perf_counter() - t0}

    t0 = time.perf_counter()
    nodes, beta, gamma = trials[0]
    s, i, r = counted("c", lambda: parallel.simulate_sir_sharded(
        graph, nodes, beta, gamma, mesh=mesh, sims=LABEL_SIMS, max_time=MAX_TIME, key=1000),
        "k2")
    sim_s = time.perf_counter() - t0
    if (s.shape != (MAX_TIME, graph.n_nodes) or np.abs(s + i + r - 1.0).max() > 1e-9
            or (np.diff(r, axis=0) < 0).any() or r[-1].mean() <= 0.0):
        raise AssertionError("(c) simulate_sir_sharded: S + I + R != 1, R not monotone, or "
                             "no spread")
    out["c_simulate_sir_sharded"] = {"sims": LABEL_SIMS, "seconds": sim_s,
                                     "final_recovered_mean": float(r[-1].mean())}

    sb = infer.scenario_batch(graph.n_nodes, [t[0] for t in trials], [t[1] for t in trials],
                              [t[2] for t in trials])
    p_card = tree_map(lambda t: t.to("cuda"), params)
    plain = infer._dispatch(model, p_card, adj, sb, reduce_fn=infer._summary_reduce)
    sharded = counted("d", lambda: infer._spmd_dispatch(model, p_card, adj, sb, summary=True),
                      "k1")
    if not np.array_equal(sharded, plain):
        raise AssertionError("(d) the sharded summary dispatch differs from the plain one")
    serve_dir = os.path.join(root, "serve_spmd")
    os.makedirs(serve_dir)
    dataset = os.path.join(serve_dir, graph.name)
    with open(dataset + ".pkl", "wb") as f:
        pickle.dump(Graph(n_nodes=graph.n_nodes, src=graph.src, dst=graph.dst), f)
    save_params(os.path.join(serve_dir, "ckpt"), params)
    serve_argv = ["--device", "cuda", "--ckpt", os.path.join(serve_dir, "ckpt"),
                  "--dataset", dataset, *argv[:10], "--spmm", "auto",
                  *trial_argv(trials[:2])]
    npz = {flag: os.path.join(serve_dir, f"out{flag}.npz") for flag in ("", "--spmd")}
    with contextlib.redirect_stdout(io.StringIO()):
        for flag, path in npz.items():
            if infer.main([*serve_argv, *([flag] if flag else []), "--out", path]) != 0:
                raise AssertionError(f"cli.infer {flag} did not return 0")
    plain_out, spmd_out = np.load(npz[""]), np.load(npz["--spmd"])
    if not all(np.array_equal(plain_out[k], spmd_out[k]) for k in ("S", "I", "R")):
        raise AssertionError("(d) cli.infer --spmd differs from the run without the flag")
    out["d_infer_spmd"] = {"summary_scenarios": len(trials), "sharded_dispatch_bit_equal": True,
                           "cli_size1_fallback_scenarios": 2,
                           "cli_size1_fallback_bit_equal": True}

    ens_model = dataclasses.replace(model, hidden=MG_HIDDEN)
    seeds = [0, 1]
    runs = {}
    for name, kw in (("no_mesh", {}),
                     ("mesh", {"mesh": parallel.make_mesh(axis_names=("ensemble",),
                                                          device_type="cuda")}),
                     ("mesh_data_axis", {"mesh": parallel.make_mesh(
                         (1, 1), ("ensemble", "data"), device_type="cuda"),
                         "data_axis": "data"})):
        def run(kw=kw):
            return fit_ensemble(ens_model, lambda leaves: torch.optim.Adam(leaves, lr=1e-3),
                                init_ensemble(ens_model, seeds, device="cuda"), data,
                                [0, 1, 2], [3], [4, 5], lambda gi: adj, seeds=seeds, epochs=1,
                                batch_size=1, verbose=False, **kw)

        t0 = time.perf_counter()
        res = run() if name == "no_mesh" else counted(f"e_{name}", run, "k1", "k1_backward")
        runs[name] = (_ensemble_summary(res), time.perf_counter() - t0)
    errs = {name: _ensemble_err(runs[name][0], runs["no_mesh"][0])
            for name in ("mesh", "mesh_data_axis")}
    if max(errs.values()) > SPMD_LOSS_ATOL:
        raise AssertionError(f"(e) fit_ensemble(mesh=) differs from the run without: {errs}")
    out["e_fit_ensemble_mesh"] = {"members": len(seeds), "hidden": MG_HIDDEN,
                                  "max_abs_err": errs,
                                  "seconds": {k: v[1] for k, v in runs.items()},
                                  "history": runs["mesh"][0]["history"]}
    out["launches"] = launches  # by piece, each counted on its own
    total = lambda k: sum(n[k] for n in launches.values())
    out["k1_backward_launches"] = total("k1_backward")
    out["k1_launches"] = total("k1") + total("k1_backward")  # as spmm2.launches counts
    out["k2_launches"] = total("k2")
    out["k3_launches"] = total("k3")
    out["tol"] = (f"loss {SPMD_LOSS_ATOL}, leaf update {SPMD_LEAF_RTOL} (max-norm), "
                  "serving bit for bit")
    infer._serving_mesh.cache_clear()
    dist.destroy_process_group()
    out["ok"] = True
    emit(out)
    return out


def phase_utils(graph, trials, root, save_dir) -> dict:
    """``utils/``: a ``trace()`` around one training step (C7, batch 1, K1)
    leaves a trace file with the card's kernels in it, ``fit(profile_dir=)``
    traces its epoch range, ``device_memory_stats`` reads the allocator, and
    the roofline models score the step and K1 against ``H100_PEAKS``."""
    from gn_ode_sir_tpu_torch.train import fit
    from gn_ode_sir_tpu_torch.utils import device_memory_stats, trace
    from gn_ode_sir_tpu_torch.utils.roofline import (H100_PEAKS, mg_train_epoch_model,
                                                     spmm_apply_model, utilization)

    argv = ["--model", "ode_nn", "--hidden", "64", "--method", "euler", "--deltaT", "0.5",
            "--maxTime", str(MAX_TIME), "--batch_size", "1", "--spmm", "auto",
            "--device", "cuda"]
    model, adj = worker.build_model_and_adj(worker.build_parser().parse_args(argv), graph)
    triples = load_or_extract_labels_many(graph, trials, sim=LABEL_SIMS, max_time=MAX_TIME,
                                          save_dir=save_dir, device="cuda")
    data = build_trial_data(graph.n_nodes, [t[0] for t in trials], [t[1] for t in trials],
                            [t[2] for t in trials], triples)
    params = tree_map(lambda t: t.requires_grad_(True),
                      model.init(torch.Generator().manual_seed(SEED), device="cuda"))
    opt = torch.optim.Adam([leaf for _, leaf in tree_leaves(params)], lr=1e-4)
    first = lambda a: torch.as_tensor(a[:1], device="cuda")
    xs = tuple(first(a) for a in (data.s0, data.i0, data.r0, data.beta, data.gamma))
    labels, ones = first(data.labels), torch.ones(1, device="cuda")
    x1 = torch.randn((1, graph.n_nodes, 64), device="cuda")
    k1_b1_ms = time_ms(lambda: spmm2(adj.plan, x1), 50)  # K1 at the training shape

    def step():
        opt.zero_grad(set_to_none=True)
        l1_sir_loss(model.predict(params, adj, *xs), labels, trial_weight=ones).backward()
        opt.step()

    torch.cuda.synchronize()
    spmm2.launches = spmm2.backward_launches = gnode_step.launches = 0  # the paths start here
    step()

    def step_ms(repeats: int = 3) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(repeats):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / repeats * 1e3

    untraced_ms = step_ms()
    trace_dir = os.path.join(root, "trace")
    with trace(trace_dir):
        traced_ms = step_ms(1)
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if not files:
        raise AssertionError("trace() left no trace file")
    with open(files[0]) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    if not kernels:
        raise AssertionError("the trace holds no kernel of the card")
    profile_dir = os.path.join(root, "fit_profile")
    res = fit(dataclasses.replace(model, hidden=MG_HIDDEN),
              lambda leaves: torch.optim.Adam(leaves, lr=1e-3),
              dataclasses.replace(model, hidden=MG_HIDDEN).init(
                  torch.Generator().manual_seed(SEED), device="cuda"),
              data, [0, 1, 2], [3], [4, 5], lambda gi: adj, epochs=2, verbose=False,
              profile_dir=profile_dir, profile_epochs=(1, 1))
    if not glob.glob(os.path.join(profile_dir, "*.pt.trace.json")) or len(res.history) != 2:
        raise AssertionError("fit(profile_dir=) left no trace")
    stats = device_memory_stats()
    if not stats:
        raise AssertionError("device_memory_stats() is empty on the card")
    after_ms = step_ms()  # the profiler is off again
    torch.cuda.synchronize()
    launches = (spmm2.launches, spmm2.backward_launches, gnode_step.launches)  # paths end here
    step_model = mg_train_epoch_model(graph.n_nodes, 64, 1, [(1, graph.n_edges)], EULER_STEPS)
    k1_model = spmm_apply_model(graph.n_nodes, graph.n_edges, 64)
    row = {"phase": "utils", "trace_file_bytes": os.path.getsize(files[0]),
           "trace_kernel_events": kernels, "fit_profile_epochs": [1, 1],
           "memory_stats_keys": len(stats),
           "allocated_bytes_peak": stats.get("allocated_bytes.all.peak"),
           "step_ms": untraced_ms, "step_ms_traced": traced_ms,
           "step_ms_after_tracing": after_ms, "k1_b1_ms": k1_b1_ms,
           "utilization_step": utilization(step_model, untraced_ms / 1e3, H100_PEAKS),
           "utilization_k1_b1": utilization(k1_model, k1_b1_ms / 1e3, H100_PEAKS),
           "k1_launches": launches[0], "k1_backward_launches": launches[1],
           "k3_launches": launches[2], "ok": True}
    emit(row)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    # full-f32 matmuls: TF32 would quietly change every dense A·Z and linear
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = phase_device()
    phase_build()
    graph = powerlaw_graph(ENRON_NODES, ENRON_DIRECTED_EDGES, SEED)
    trials = label_trials(graph)
    chunk = label_chunk(graph)
    mg_graphs = multigraph_graphs()
    k1, k1_mg = phase_kernel(graph, mg_graphs)
    k2 = phase_kernel_k2(graph, trials[:chunk])
    k3, k3_label = phase_kernel_k3(graph)
    k4, k5 = phase_kernel_dmp(graph)
    k1b, k1b_mg = phase_kernel_bwd(graph, mg_graphs)
    emit(narrow_summary(k1_mg + k1b_mg))
    shard_fwd, shard_bwd = phase_kernel_shards(graph)
    phase_ell(graph)
    phase_native(graph)
    serve = phase_serve(graph)
    serve_dmp = phase_serve_dmp(graph)
    with tempfile.TemporaryDirectory() as root:
        # the reference's layout, so that the matrix's jobs find the labels
        save_dir = os.path.join(root, f"Experiments-seed2-{graph.name}")
        os.makedirs(save_dir)
        labels = phase_labels(graph, trials, save_dir, chunk)
        train = phase_train(graph, trials, save_dir)
        matrix = phase_matrix_single(graph, trials, mg_graphs[FB_FOOD], root, save_dir)
        parallel = phase_parallel(graph, trials, root, save_dir)
        del graph
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as mg_dir:
            mg = phase_multigraph(mg_graphs, mg_dir)
            matrix["multigraph"] = matrix_multigraph(mg_graphs, mg_dir)
            emit({"phase": "matrix", **matrix["multigraph"], "ok": True})
        with tempfile.TemporaryDirectory() as baselines_dir:
            baselines = phase_baselines(mg_graphs[WIKI], mg_graphs[FB_SOCIAL], baselines_dir)
        # last, so that the profiler's tracing cannot touch the times of the
        # phases before it; the same seeded graph, whose labels are cached
        # in save_dir
        utils = phase_utils(powerlaw_graph(ENRON_NODES, ENRON_DIRECTED_EDGES, SEED), trials,
                            root, save_dir)
    times = lambda row: {
        "case": row["case"], "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
    # launches: those of the main paths (serving, labels, single-graph and
    # multi-graph training, DMP serving and the DMP baseline); `cases`: the same kernel at the multi-graph shapes
    kernel = lambda name, source, replaces, launches, row, more=(): {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, **times(row), "cases": [times(r) for r in more]}
    forward = lambda phase: phase["k1_launches"] - phase.get("k1_backward_launches", 0)
    paths = [train, mg, *matrix.values(), parallel, utils]
    emit({"kernels": [
        kernel("spmm2", "gn_ode_sir_tpu_torch/csrc/spmm2.cu",
               "gn_ode_sir_tpu/ops/pallas_spmm2.py:119",
               serve["k1_launches"] + sum(forward(p) for p in paths), k1, k1_mg + shard_fwd),
        kernel("spmm2_bwd", "gn_ode_sir_tpu_torch/csrc/spmm2.cu",
               "gn_ode_sir_tpu/ops/pallas_spmm2.py:239",
               sum(p.get("k1_backward_launches", 0) for p in paths), k1b, k1b_mg + shard_bwd),
        kernel("sir_step", "gn_ode_sir_tpu_torch/csrc/sir_step.cu",
               "gn_ode_sir_tpu/sim/pallas_step.py:36",
               labels["k2_launches"] + mg["k2_launches"]
               + matrix["node_split"]["k2_launches"] + parallel["k2_launches"], k2),
        kernel("gnode_step", "gn_ode_sir_tpu_torch/csrc/gnode_step.cu", None,
               sum(p["k3_launches"] for p in (serve, *paths)), k3, k3_label),
        kernel("dmp_step", "gn_ode_sir_tpu_torch/csrc/dmp_step.cu", None,
               serve_dmp["k4_launches"] + baselines["k4_launches"], k4),
        kernel("dmp_marginals", "gn_ode_sir_tpu_torch/csrc/dmp_step.cu", None,
               serve_dmp["k5_launches"] + baselines["k5_launches"], k5)]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
