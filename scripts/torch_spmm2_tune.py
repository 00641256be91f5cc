"""Sweep K1's compile-time constants and its plan's segment length on the card.

    python3 scripts/torch_spmm2_tune.py [--batches 1 4 8 16] [--out FILE]
    python3 scripts/torch_spmm2_tune.py --narrow [--out FILE]

K1 (``gn_ode_sir_tpu_torch/csrc/spmm2.cu``) fixes its geometry at compile
time — for rows of 16 bytes and up ``kStepsInFlight``, ``kScenariosPerWarp``,
``kWarpsPerBlock``, ``kMinBlocksPerSM``; for narrow rows ``kNarrowRowBytes``
(the widest row the narrow route takes), ``kNarrowSteps``,
``kNarrowTeamLanes``, ``kNarrowMinBlocks`` — and its host plan one,
``ops.spmm2.SEGMENT_EDGES``; the order of the work list is the plan's too.
None is exposed to a caller. This script measures the choices: for each
variant it compiles a copy of the source with the constants replaced (into
``gn_ode_sir_tpu_torch/_build/tune/``, all ``nvcc`` started together),
builds the plan with the variant's segment length and item order, holds one
apply against the plain version, and times ``spmm2`` with CUDA events (mean
of 50 back-to-back applies, the whole sweep twice in turn so that a drift of
the card shows), beside ``torch.sparse.mm`` on the same values. Without
``--narrow`` the cases are f32 [B, 33,696, 64] on the enron-size power-law
graph of ``chip_smoke.py`` for each B; with it, the narrow route's
variants at the multi-graph shapes of ``chip_smoke.py`` (the wiki-vote-size
graph on the 7,168-wide train plan at h = 8, 5, 16, 17, 24, 31 and 32 and
in bf16, the enron-size graph at [8, n, 8], the matrix's fold [32, n, 8] and
[32, n, 24]).
``enqueue_ms`` is the host's time to issue one apply; where it is close to
``kernel_ms`` that reading is bound by the host, and ``device_ms`` — 20
applies captured in one CUDA graph and replayed — is what the device alone
takes. The variant named ``shipped`` is the source as it is.

Prints one JSON line per measurement (and writes them to ``--out`` when
given). Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (ENRON_DIRECTED_EDGES, ENRON_NODES, KERNEL_REL_TOL,  # noqa: E402
                        MG_TRAIN_WIDTH, SEED, WIKI, graph_replay_ms, multigraph_graphs,
                        powerlaw_graph, spmm2_library_times, time_ms)
from gn_ode_sir_tpu_torch.graphs.graph import Graph  # noqa: E402
from gn_ode_sir_tpu_torch.ops import _kernels  # noqa: E402
from gn_ode_sir_tpu_torch.ops import spmm2 as spmm2_mod  # noqa: E402
from gn_ode_sir_tpu_torch.ops.spmm2 import CsrPlan, spmm2, spmm2_plain  # noqa: E402
from perfbench import profiling  # noqa: E402

CONSTANTS = ("kStepsInFlight", "kScenariosPerWarp", "kWarpsPerBlock", "kMinBlocksPerSM",
             "kNarrowRowBytes", "kNarrowSteps", "kNarrowTeamLanes", "kNarrowMinBlocks",
             "kNarrowGroupBytes", "kNarrowFixupOverlap", "kNarrowFixupSteps", "kNarrowThreads")


@dataclasses.dataclass(frozen=True)
class Variant:
    name: str
    steps: int | None = None  # kStepsInFlight; None: as the source has it
    scenarios: int | None = None  # kScenariosPerWarp
    warps: int | None = None  # kWarpsPerBlock
    blocks: int | None = None  # kMinBlocksPerSM
    narrow_bytes: int | None = None  # kNarrowRowBytes
    narrow_steps: int | None = None  # kNarrowSteps
    team_lanes: int | None = None  # kNarrowTeamLanes
    narrow_blocks: int | None = None  # kNarrowMinBlocks
    group_bytes: int | None = None  # kNarrowGroupBytes
    overlap: int | None = None  # kNarrowFixupOverlap
    fixup_steps: int | None = None  # kNarrowFixupSteps
    narrow_threads: int | None = None  # kNarrowThreads
    segment: int | None = None  # SEGMENT_EDGES
    order: str = "by_count"  # as built | "long_first" | "by_row"

    @property
    def constants(self):
        return (self.steps, self.scenarios, self.warps, self.blocks, self.narrow_bytes,
                self.narrow_steps, self.team_lanes, self.narrow_blocks, self.group_bytes,
                self.overlap, self.fixup_steps, self.narrow_threads)


VARIANTS = (
    Variant("shipped"),
    Variant("steps1", steps=1), Variant("steps3", steps=3), Variant("steps4", steps=4),
    Variant("scen1", scenarios=1), Variant("scen1_steps4", scenarios=1, steps=4),
    Variant("scen4_steps1", scenarios=4, steps=1),
    Variant("blocks1", blocks=1),  # no cap on registers
    Variant("blocks6", blocks=6), Variant("blocks10", blocks=10), Variant("blocks12", blocks=12),
    Variant("warps8_blocks4", warps=8, blocks=4), Variant("warps2_blocks16", warps=2, blocks=16),
    Variant("seg16", segment=16), Variant("seg32", segment=32), Variant("seg128", segment=128),
    Variant("seg_none", segment=1 << 30),  # no row is cut: one sub-warp walks the hub
    Variant("long_first", order="long_first"), Variant("by_row", order="by_row"),
)

NARROW_VARIANTS = (
    Variant("shipped"),
    Variant("h64_route", narrow_bytes=0),  # every width on the 16-byte-row geometry
    Variant("narrow64", narrow_bytes=64),  # the narrow route up to 64-byte rows only
    Variant("fixup_after", overlap=0),  # the fixup launched after the segments, not beside
    Variant("steps3", narrow_steps=3), Variant("steps6", narrow_steps=6),
    Variant("steps8", narrow_steps=8), Variant("steps8_blocks3", narrow_steps=8, narrow_blocks=3),
    Variant("fixup16", fixup_steps=16), Variant("threads128", narrow_threads=128, narrow_blocks=8),
    Variant("group6m", group_bytes=6 << 20), Variant("group_all", group_bytes=1 << 40),
    Variant("team32", team_lanes=32),
)


def variant_source(constants) -> str:
    text = (_kernels.CSRC_DIR / "spmm2.cu").read_text()
    for name, value in zip(CONSTANTS, constants):
        if value is not None:
            text, hits = re.subn(rf"(constexpr (?:int|long long) {name} = )[^;]+;",
                                 rf"\g<1>{value};", text)
            if hits != 1:
                raise RuntimeError(f"constant {name} not found once in spmm2.cu")
    return text


def build_variants(constant_sets) -> dict:
    """One library per distinct set of constants, compiled side by side."""
    out_dir = _kernels.BUILD_DIR / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for cs in constant_sets:
        tag = "_".join("x" if v is None else str(v) for v in cs)
        src, lib = out_dir / f"spmm2_{tag}.cu", out_dir / f"libspmm2_{tag}.so"
        src.write_text(variant_source(cs))
        procs[cs] = (subprocess.Popen(
            [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    funcs = {}
    _, symbol, argtypes = _kernels.KERNELS["spmm2"]
    for cs, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for constants {cs}:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        funcs[cs] = (fn, _kernels._ptxas_summary(log))
    return funcs


def variant_plan(graph, variant, device) -> CsrPlan:
    shipped = spmm2_mod.SEGMENT_EDGES
    try:
        if variant.segment is not None:
            spmm2_mod.SEGMENT_EDGES = variant.segment
        plan = CsrPlan.build(graph.src, graph.dst, graph.n_nodes, device=device)
    finally:
        spmm2_mod.SEGMENT_EDGES = shipped
    work = plan.work  # as built: by edge count, largest first
    by_row = work[torch.argsort(work[:, 2], stable=True)]
    if variant.order == "by_row":  # a long row's items where the row stands
        work = by_row
    elif variant.order == "long_first":  # the pieces of long rows, then the whole rows
        work = by_row[torch.argsort((by_row[:, 3] < 0).int(), stable=True)]
    return dataclasses.replace(plan, work=work.contiguous())


def wide_cases(batches, dev) -> list:
    """(name, graph, x) of f32 [B, 33,696, 64] on the enron-size graph."""
    graph = powerlaw_graph(ENRON_NODES, ENRON_DIRECTED_EDGES, SEED)
    rng = np.random.default_rng(SEED)
    return [(f"enron_b{b}_h64", graph,
             torch.as_tensor(rng.standard_normal((b, graph.n_nodes, 64), np.float32), device=dev))
            for b in batches]


def narrow_cases(dev) -> list:
    """(name, graph, x) at the multi-graph shapes and around the narrow
    route's threshold."""
    graphs = multigraph_graphs()
    wiki, enron = graphs[WIKI], graphs[-1]
    train = Graph(n_nodes=MG_TRAIN_WIDTH, src=wiki.src, dst=wiki.dst, name=wiki.name)
    rng = np.random.default_rng(SEED)
    cases = []
    for name, graph, batch, h, dtype in (
            ("mg_wiki_train_b8_h8", train, 8, 8, torch.float32),
            ("mg_wiki_train_b8_h5", train, 8, 5, torch.float32),
            ("mg_wiki_train_b8_h16", train, 8, 16, torch.float32),
            ("mg_wiki_train_b8_h17", train, 8, 17, torch.float32),
            ("mg_wiki_train_b8_h24", train, 8, 24, torch.float32),
            ("mg_wiki_train_b8_h31", train, 8, 31, torch.float32),
            ("mg_wiki_train_b8_h32", train, 8, 32, torch.float32),
            ("mg_wiki_train_b8_h8_bf16x", train, 8, 8, torch.bfloat16),
            ("mg_enron_eval_b8_h8", enron, 8, 8, torch.float32),
            ("matrix_fold_enron_eval_b32_h8", enron, 32, 8, torch.float32),
            ("enron_eval_b32_h24", enron, 32, 24, torch.float32)):
        x = rng.standard_normal((batch, graph.n_nodes, h), np.float32)
        cases.append((name, graph, torch.as_tensor(x, device=dev).to(dtype)))
    return cases


PROFILED_APPLIES = 20


def kernel_profile(call) -> dict:
    """``torch.profiler``'s device time over PROFILED_APPLIES applies: the
    device's busy time (the union of its operation spans), its time by
    kernel group, and the longest operations by name, all in ms."""
    call()
    _, trace = profiling.profiled(lambda: [call() for _ in range(PROFILED_APPLIES)])
    groups = {}
    for name, start, end in trace.device_ops:
        group = profiling.kernel_group(name)
        groups[group] = groups.get(group, 0.0) + (end - start) / 1e3
    return {"device_busy_ms": profiling.union(trace.spans()) / 1e3,
            "device_ms_by_group": dict(sorted(groups.items())),
            "top_kernels": [[name, s * 1e3]
                            for name, s in profiling.breakdown(trace)["device_ops"]]}


def enqueue_ms(fn, iters: int = 50) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 4, 8, 16])
    ap.add_argument("--narrow", action="store_true",
                    help="the narrow route's constants at the multi-graph shapes")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_spmm2_tune: no CUDA device", file=sys.stderr)
        return 2
    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__})
    variants = NARROW_VARIANTS if args.narrow else VARIANTS
    t0 = time.perf_counter()
    funcs = build_variants(sorted({v.constants for v in variants},
                                  key=lambda cs: tuple(-1 if c is None else c for c in cs)))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {str(cs): rep for cs, (_, rep) in funcs.items()}})

    dev = torch.device("cuda")
    cases = narrow_cases(dev) if args.narrow else wide_cases(args.batches, dev)
    plans = {(v.name, name): variant_plan(graph, v, dev)
             for v in variants for name, graph, _ in cases}
    shipped_fn = _kernels.kernel_function("spmm2")
    try:
        for name, _, x in cases:
            base = plans[(variants[0].name, name)]
            x2 = x[:2].contiguous()
            want, scale = spmm2_plain(base, x2), spmm2_plain(base, x2.float().abs())
            first = None
            for v in variants:
                _kernels._FUNCS["spmm2"] = funcs[v.constants][0]
                plan = plans[(v.name, name)]
                got = spmm2(plan, x2)
                err = (got - want).abs()
                if (err > KERNEL_REL_TOL * (1.0 + scale)).any():
                    raise AssertionError(f"variant {v.name} disagrees with the plain version "
                                         f"at {name}")
                first = got if first is None else first
                emit({"phase": "check", "variant": v.name, "case": name,
                      "work_items": plan.work.shape[0], "partial_slots": plan.n_slots,
                      "max_abs_err": float(err.max()),
                      "bit_equal_to_first_variant": bool(torch.equal(got, first))})
        for sweep in (1, 2):
            for name, _, x in cases:
                base = plans[(variants[0].name, name)]
                if x.dtype == torch.float32:
                    emit({"phase": "library", "sweep": sweep, "case": name,
                          "shape": list(x.shape), **spmm2_library_times(base, x)})
                for v in variants:
                    _kernels._FUNCS["spmm2"] = funcs[v.constants][0]
                    call = lambda: spmm2(plans[(v.name, name)], x)
                    emit({"phase": "time", "sweep": sweep, "variant": v.name, "case": name,
                          "shape": list(x.shape), "kernel_ms": time_ms(call, 50),
                          "enqueue_ms": enqueue_ms(call), "device_ms": graph_replay_ms(call),
                          **dataclasses.asdict(v)})
        # the kernels of one apply of the source as it is, by the profiler
        _kernels._FUNCS["spmm2"] = funcs[variants[0].constants][0]
        for name, _, x in cases:
            emit({"phase": "profile", "variant": variants[0].name, "case": name,
                  "applies": PROFILED_APPLIES,
                  **kernel_profile(lambda: spmm2(plans[(variants[0].name, name)], x))})
    finally:
        _kernels._FUNCS["spmm2"] = shipped_fn
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.writelines(json.dumps(ln) + "\n" for ln in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
