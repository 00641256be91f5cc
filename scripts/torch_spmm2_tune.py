"""Sweep K1's compile-time constants and its plan's segment length on the card.

    python3 scripts/torch_spmm2_tune.py [--batches 1 4 8 16] [--out FILE]

K1 (``gn_ode_sir_tpu_torch/csrc/spmm2.cu``) fixes four constants at compile
time — ``kStepsInFlight``, ``kScenariosPerWarp``, ``kWarpsPerBlock``,
``kMinBlocksPerSM`` — and its host plan one, ``ops.spmm2.SEGMENT_EDGES``;
the order of the work list is the plan's too. None is exposed to a caller.
This script measures the choices: for each variant it compiles a copy of the
source with the constants replaced (into
``gn_ode_sir_tpu_torch/_build/tune/``, all ``nvcc`` started together),
builds the plan of the enron-size power-law graph of ``chip_smoke.py`` with
the variant's segment length and item order, holds one apply against the
plain version, and times ``spmm2`` on f32 [B, 33,696, 64] for each B with
CUDA events (mean of 50 back-to-back applies, the whole sweep twice in turn
so that a drift of the card shows), beside ``torch.sparse.mm`` on the same
values. ``enqueue_ms`` is the host's time to issue one apply; where it is
close to ``kernel_ms`` that reading is bound by the host, and ``device_ms``
— 20 applies captured in one CUDA graph and replayed — is what the device
alone takes. The variant named ``shipped`` is the source as it is.

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

from chip_smoke import (ENRON_DIRECTED_EDGES, ENRON_NODES, KERNEL_REL_TOL, SEED,  # noqa: E402
                        graph_replay_ms, powerlaw_graph, spmm2_library_times, time_ms)
from gn_ode_sir_tpu_torch.ops import _kernels  # noqa: E402
from gn_ode_sir_tpu_torch.ops import spmm2 as spmm2_mod  # noqa: E402
from gn_ode_sir_tpu_torch.ops.spmm2 import CsrPlan, spmm2, spmm2_plain  # noqa: E402

CONSTANTS = ("kStepsInFlight", "kScenariosPerWarp", "kWarpsPerBlock", "kMinBlocksPerSM")


@dataclasses.dataclass(frozen=True)
class Variant:
    name: str
    steps: int | None = None  # kStepsInFlight; None: as the source has it
    scenarios: int | None = None  # kScenariosPerWarp
    warps: int | None = None  # kWarpsPerBlock
    blocks: int | None = None  # kMinBlocksPerSM
    segment: int | None = None  # SEGMENT_EDGES
    order: str = "by_count"  # as built | "long_first" | "by_row"

    @property
    def constants(self):
        return (self.steps, self.scenarios, self.warps, self.blocks)


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


def variant_source(constants) -> str:
    text = (_kernels.CSRC_DIR / "spmm2.cu").read_text()
    for name, value in zip(CONSTANTS, constants):
        if value is not None:
            text, hits = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};", text)
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
    variants = VARIANTS
    t0 = time.perf_counter()
    funcs = build_variants(sorted({v.constants for v in variants},
                                  key=lambda cs: tuple(-1 if c is None else c for c in cs)))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {str(cs): rep for cs, (_, rep) in funcs.items()}})

    dev = torch.device("cuda")
    graph = powerlaw_graph(ENRON_NODES, ENRON_DIRECTED_EDGES, SEED)
    rng = np.random.default_rng(SEED)
    xs = {b: torch.as_tensor(rng.standard_normal((b, graph.n_nodes, 64), np.float32), device=dev)
          for b in args.batches}
    plans = {v.name: variant_plan(graph, v, dev) for v in variants}
    base = plans[variants[0].name]
    x2 = xs[min(args.batches)][:2].contiguous()
    want, scale = spmm2_plain(base, x2), spmm2_plain(base, x2.abs())
    shipped_fn = _kernels.kernel_function("spmm2")
    try:
        for v in variants:
            _kernels._FUNCS["spmm2"] = funcs[v.constants][0]
            err = (spmm2(plans[v.name], x2) - want).abs()
            if (err > KERNEL_REL_TOL * (1.0 + scale)).any():
                raise AssertionError(f"variant {v.name} disagrees with the plain version")
            emit({"phase": "check", "variant": v.name, "work_items": plans[v.name].work.shape[0],
                  "partial_slots": plans[v.name].n_slots, "max_abs_err": float(err.max())})
        for sweep in (1, 2):
            for b in args.batches:
                emit({"phase": "library", "sweep": sweep, "batch": b,
                      **spmm2_library_times(base, xs[b])})
                for v in variants:
                    _kernels._FUNCS["spmm2"] = funcs[v.constants][0]
                    call = lambda: spmm2(plans[v.name], xs[b])
                    emit({"phase": "time", "sweep": sweep, "variant": v.name, "batch": b,
                          "kernel_ms": time_ms(call, 50), "enqueue_ms": enqueue_ms(call),
                          "device_ms": graph_replay_ms(call),
                          **dataclasses.asdict(v)})
    finally:
        _kernels._FUNCS["spmm2"] = shipped_fn
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.writelines(json.dumps(ln) + "\n" for ln in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
