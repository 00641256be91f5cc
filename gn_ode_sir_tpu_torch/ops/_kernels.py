"""Build and load the port's hand-written CUDA kernels.

Each source in ``gn_ode_sir_tpu_torch/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface and
loaded with ``ctypes``. The build happens at first use, never at import,
into ``gn_ode_sir_tpu_torch/_build/`` (listed in ``.gitignore``); the
library is named after its source and carries a hash of the source and the
flags, so an edited source is rebuilt and a fresh checkout builds everything
on its first call. Kernels whose entry points share a source share its
library. :func:`build_all` starts one ``nvcc`` per source at once.

Every kernel's wrapper goes the same way to its kernel: :func:`on_cuda`
sends a CUDA tensor to the kernel and a CPU tensor to the plain version,
:func:`check` refuses what the kernel cannot take, and :func:`launch` calls
the entry point under a guard of the tensors' device, on its current stream,
and raises if the launch failed. Every C entry point takes that stream as its
last argument and returns its ``cudaError_t``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint
_F = ctypes.c_float
# kernel name -> (source file, C symbol, argtypes, the stream last); restype is
# int (cudaError_t)
KERNELS = {
    "spmm2": ("spmm2.cu", "gnode_spmm2",
              [_P, _I, _I, _P, _I, _P, _P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _P]),
    "sir_step": ("sir_step.cu", "gnode_sir_step",
                 [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _L, _I, _I, _U, _P]),
    "gnode_step": ("gnode_step.cu", "gnode_step",
                   [_P, _P, _P, _P, _P, _P, _P, _P, _F, _P, _I, _L, _I, _P]),
    "dmp_edge_step": ("dmp_step.cu", "dmp_edge_step",
                      [_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _P, _L, _I, _I, _I, _I, _P]),
    "dmp_marginals": ("dmp_step.cu", "dmp_marginals",
                      [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P]),
}

_FUNCS: dict[str, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's CUDA "
        "kernels are compiled at first use on the machine with the card")


def library_path(name: str) -> Path:
    src = CSRC_DIR / KERNELS[name][0]
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def _short_entry(mangled: str) -> str:
    """``kernel<template arguments>`` out of an Itanium-mangled entry name
    (``<length><name>``, the name ending in ``kernel``)."""
    end = mangled.find("kernel") + len("kernel")
    for start in range(end - len("kernel"), 1, -1):
        for digits in (mangled[start - 2:start], mangled[start - 1:start]):
            if digits.isdigit() and int(digits) == end - start:
                targs = re.match(r"I(\w+?)EEv", mangled[end:])
                return mangled[start:end] + (f"<{targs[1]}>" if targs else "")
    return mangled


def _ptxas_summary(log: str) -> list[str]:
    """Per entry function of ``-Xptxas -v``'s report: its name, registers,
    shared memory, and any spills."""
    out, entry = [], "?"
    for ln in log.splitlines():
        text = ln.split(":", 1)[-1].strip()
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = _short_entry(m[1])
        elif "registers" in ln or ("spill" in ln and " 0 bytes spill loads" not in ln):
            out.append(f"{entry}: {text}")
    return sorted(out)


def build_all(names=None) -> dict:
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source, all started together. Returns ``{name: {"seconds", "ptxas"}}``
    for the kernels built (``ptxas`` holds the register/spill report).
    Raises RuntimeError with the compiler output if any build fails."""
    names = list(KERNELS) if names is None else list(names)
    todo = list({library_path(n): n for n in names if not library_path(n).exists()}.values())
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        final = library_path(name)
        tmp = final.with_name(f"{final.name}.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / KERNELS[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, final)
    report, failed = {}, []
    for name, (proc, tmp, final) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, final)
        report[name] = {"seconds": time.perf_counter() - t0,
                        "ptxas": _ptxas_summary(log)}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def kernel_function(name: str):
    """The ctypes function of kernel ``name``, building its library first
    if needed."""
    fn = _FUNCS.get(name)
    if fn is None:
        build_all([name])
        _, symbol, argtypes = KERNELS[name]
        fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[name] = fn
    return fn


def on_cuda(name: str, device: torch.device) -> bool:
    """The route of kernel ``name``'s wrapper for tensors on ``device``: True
    on a CUDA device (launch the kernel), False on the CPU (the plain
    version); any other device raises ValueError."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"{name} runs on cuda or cpu tensors, got {device}")


def check(name: str, device: torch.device, typed, contiguous) -> None:
    """Refuse tensors that kernel ``name`` cannot take: ``typed`` pairs a
    tuple of dtypes with the tensors that must have one of them, and every
    one of those tensors must lie on ``device``; the tensors of
    ``contiguous`` must be contiguous. Raises TypeError or ValueError."""
    for dtypes, tensors in typed:
        for t in tensors:
            if t.dtype not in dtypes:
                allowed = " or ".join(str(d).replace("torch.", "") for d in dtypes)
                raise TypeError(f"{name} kernel takes {allowed} tensors, got {t.dtype}")
            if t.device != device:
                raise ValueError(f"{name}: tensors on {t.device} and {device}")
    if not all(t.is_contiguous() for t in contiguous):
        raise ValueError(f"{name} kernel takes contiguous tensors")


def launch(name: str, device: torch.device, *args) -> None:
    """Kernel ``name`` on ``args`` and the current stream of ``device``,
    under a guard of that device; raises RuntimeError if the launch failed
    or the kernel cannot be built."""
    fn = kernel_function(name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
