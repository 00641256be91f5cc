"""K2: one synchronous Monte-Carlo SIR step with the coins fused in, as a CUDA
kernel (port of ``gn_ode_sir_tpu.sim.pallas_step``).

    p_inf = -expm1(counts * log(1 - beta))          # 1 - (1 - beta)^counts
    one uint32 word w per (simulation, node):
      infect a susceptible node where (w & 0xFFFF) < p_inf * 2^16
      recover an infected node where  (w >> 16)    < gamma * 2^16

Replaces the Pallas TPU kernel
``gn_ode_sir_tpu/sim/pallas_step.py::_step_kernel``. The kernel,
``gn_ode_sir_tpu_torch/csrc/sir_step.cu``, reads the int8 (I, R) state and
the infected-neighbour counts once, draws its words from Philox4x32-10
(counter = (element index within the trial // 4, step), key = the trial's
seed) and writes the new state: 8 bytes per element, which bounds it on an
H100 (0.8 ms for [10,000 x 33,696] at 3.35 TB/s). Rows are ``trials * sims``;
each trial has its own rates and seed, so many trials advance in one launch.

Beside the kernel, its plain PyTorch version: :func:`philox4x32_words` (the
same words, in int64 tensor arithmetic) and :func:`sir_update_plain` (the
``bits16`` formula of ``gn_ode_sir_tpu/sim/mc_sir.py::_sir_transition``).
:func:`sir_step` takes the plain pair only for CPU tensors; CUDA tensors
launch the kernel or raise. ``sir_step.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from gn_ode_sir_tpu_torch.ops import _kernels

_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Weyl key increments
_MASK32 = 0xFFFFFFFF
MAX_SEED = 2**63 - 1  # seeds travel as int64 tensors


def _mulhilo(m: int, x: torch.Tensor):
    """(high, low) 32-bit halves of m * x for a 32-bit constant ``m`` and
    int64 ``x`` in [0, 2^32). The product is taken in two 16-bit halves of
    ``x`` so that no int64 intermediate overflows."""
    lo16 = m * (x & 0xFFFF)  # < 2^48
    hi16 = m * (x >> 16)  # < 2^48
    low = (lo16 + ((hi16 & 0xFFFF) << 16)) & _MASK32
    high = (hi16 + (lo16 >> 16)) >> 16
    return high, low


def philox4x32(counter, key):
    """Philox4x32-10 on int64 tensors holding 32-bit values: ``counter`` is
    four tensors, ``key`` two; returns the four output-word tensors."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def philox4x32_words(seed: int, step: int, numel: int, *, device) -> torch.Tensor:
    """The ``numel`` uint32 words (as int64) that K2 draws for one trial at
    ``step``: element e takes word e % 4 of Philox(counter = (e // 4, step),
    key = seed)."""
    if not 0 <= seed <= MAX_SEED:
        raise ValueError(f"seed must lie in [0, 2^63), got {seed}")
    q = torch.arange(-(-numel // 4), dtype=torch.int64, device=device)
    full = lambda v: torch.full_like(q, v)
    words = philox4x32((q & _MASK32, q >> 32, full(step & _MASK32), full(0)),
                       (full(seed & _MASK32), full(seed >> 32)))
    return torch.stack(words, dim=1).reshape(-1)[:numel]


def sir_update_plain(i, r, counts, log1m_beta_rows, gamma16_rows, words):
    """The plain PyTorch version of K2's update. ``i``, ``r``: [rows, n]
    indicators (any integer or float dtype); ``counts``: [rows, n] f32 or
    int32; ``log1m_beta_rows``, ``gamma16_rows``: f32, broadcastable to
    [rows, n] (log(1 - beta) and gamma * 2^16 of each row's trial);
    ``words``: [rows, n] integer tensor of uint32 values. Returns (i', r')."""
    dt = i.dtype
    p_inf = -torch.expm1(counts.to(torch.float32) * log1m_beta_rows)
    u = (words & 0xFFFF).to(torch.float32)
    v = (words >> 16).to(torch.float32)
    s = 1 - i - r
    new_inf = s * (u < p_inf * 65536.0).to(dt)
    new_rec = i * (v < gamma16_rows).to(dt)
    return i + new_inf - new_rec, r + new_rec


def _check_shapes(i, r, counts, log1m_beta, gamma16, seeds, sims):
    if i.dim() != 2 or r.shape != i.shape or counts.shape != i.shape:
        raise ValueError(
            f"i, r, counts must share one [rows, n] shape, got {tuple(i.shape)}, "
            f"{tuple(r.shape)}, {tuple(counts.shape)}")
    rows = i.shape[0]
    if sims < 1 or rows % sims:
        raise ValueError(f"rows = {rows} is not a multiple of sims = {sims}")
    trials = rows // sims
    for name, t in (("log1m_beta", log1m_beta), ("gamma16", gamma16), ("seeds", seeds)):
        if tuple(t.shape) != (trials,):
            raise ValueError(f"{name} must be [{trials}], got {tuple(t.shape)}")
    return trials


def _launch(i, r, counts, log1m_beta, gamma16, seeds, step, sims, return_words):
    if i.dtype != torch.int8 or r.dtype != torch.int8:
        raise TypeError(f"sir_step kernel takes int8 states, got {i.dtype}, {r.dtype}")
    if counts.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"sir_step kernel takes float32 or int32 counts, got {counts.dtype}")
    if log1m_beta.dtype != torch.float32 or gamma16.dtype != torch.float32:
        raise TypeError("sir_step kernel takes float32 log1m_beta and gamma16")
    if seeds.dtype != torch.int64:
        raise TypeError(f"sir_step kernel takes int64 seeds, got {seeds.dtype}")
    for t in (i, r, counts, log1m_beta, gamma16, seeds):
        if t.device != i.device:
            raise ValueError(f"sir_step: tensors on {t.device} and {i.device}")
        if not t.is_contiguous():
            raise ValueError("sir_step kernel takes contiguous tensors")
    rows, n = i.shape
    if rows // sims > 65535:
        raise ValueError(f"sir_step kernel takes at most 65,535 trials a launch, got {rows // sims}")
    i_out, r_out = torch.empty_like(i), torch.empty_like(r)
    words = (torch.empty((rows, n), dtype=torch.int32, device=i.device)
             if return_words else None)
    if i.numel():
        fn = _kernels.kernel_function("sir_step")
        with torch.cuda.device(i.device):
            err = fn(i.data_ptr(), r.data_ptr(), counts.data_ptr(),
                     int(counts.dtype == torch.int32), log1m_beta.data_ptr(),
                     gamma16.data_ptr(), seeds.data_ptr(), i_out.data_ptr(),
                     r_out.data_ptr(), words.data_ptr() if return_words else None,
                     rows, n, sims, step,
                     torch.cuda.current_stream(i.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"sir_step kernel launch failed: cudaError_t {err}")
        sir_step.launches += 1
    if return_words:
        return i_out, r_out, words.to(torch.int64).bitwise_and_(_MASK32)
    return i_out, r_out


def sir_step(i, r, counts, log1m_beta, gamma16, seeds, step: int, *, sims: int,
             return_words: bool = False):
    """K2: one SIR step over [trials * sims, n] int8 states.

    ``log1m_beta``, ``gamma16``: f32 [trials]; ``seeds``: int64 [trials], each
    in [0, 2^63); ``step``: the time step, part of the Philox counter. CUDA
    tensors launch the kernel (or raise); CPU tensors take
    :func:`philox4x32_words` and :func:`sir_update_plain`. Returns (i', r'),
    and with ``return_words`` also the uint32 words drawn, as int64."""
    trials = _check_shapes(i, r, counts, log1m_beta, gamma16, seeds, sims)
    if not 0 <= step <= _MASK32:
        raise ValueError(f"step must fit 32 bits, got {step}")
    if i.device.type == "cuda":
        return _launch(i, r, counts, log1m_beta, gamma16, seeds, step, sims, return_words)
    if i.device.type != "cpu":
        raise ValueError(f"sir_step runs on cuda or cpu tensors, got {i.device}")
    n = i.shape[1]
    words = torch.cat([philox4x32_words(s, step, sims * n, device=i.device)
                       for s in seeds.tolist()]).reshape(trials * sims, n)
    rows = lambda t: t.repeat_interleave(sims)[:, None]
    out = sir_update_plain(i, r, counts, rows(log1m_beta), rows(gamma16), words)
    return (*out, words) if return_words else out


sir_step.launches = 0  # kernel launches since the last reset (CPU calls do not count)
