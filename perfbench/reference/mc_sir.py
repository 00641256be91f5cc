"""The Monte-Carlo SIR label path written out in plain PyTorch: the reference
of the label cells. It imports nothing of the program.

One trial: ``sims`` simulations start with the seed nodes infected. At step t
(1 .. max_time - 1) a susceptible node with k infected neighbours is infected
where ``(w & 0xFFFF) < p_inf * 2^16``, ``p_inf = -expm1(k log(1 - beta))``,
and a node infected at the start of the step recovers where ``(w >> 16) <
gamma * 2^16``, all in float32. The word w of element e (e = sim * n + node)
at step t is word e % 4 of Philox4x32-10 with counter (e // 4, t) and the
trial's seed as key: the stream the program's documentation states for its
fused step, so the replay is exact. The infected-neighbour counts are a
dense product with bfloat16 operands and float32 sums (exact below 2^24).
Philox is written out below from its definition (Salmon et al., SC'11).

``precision="bf16"`` rounds both thresholds to bfloat16 before the
comparison: the lower precision the output check must reject.
"""

from __future__ import annotations

import numpy as np
import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
    lo16 = m * (x & 0xFFFF)
    hi16 = m * (x >> 16)
    low = (lo16 + ((hi16 & 0xFFFF) << 16)) & _MASK32
    high = (hi16 + (lo16 >> 16)) >> 16
    return high, low


def philox4x32(counter, key):
    """Philox4x32-10 on int64 tensors holding 32-bit values."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def words(seed: int, step: int, first: int, count: int, device) -> torch.Tensor:
    """The words of elements ``first .. first + count - 1`` at ``step``."""
    q0, q1 = first // 4, -(-(first + count) // 4)
    q = torch.arange(q0, q1, dtype=torch.int64, device=device)
    full = lambda v: torch.full_like(q, v)
    out = philox4x32((q & _MASK32, q >> 32, full(step & _MASK32), full(0)),
                     (full(seed & _MASK32), full(seed >> 32)))
    flat = torch.stack(out, dim=1).reshape(-1)
    return flat[first - 4 * q0:first - 4 * q0 + count]


def adjacency(src, dst, n: int, device) -> torch.Tensor:
    """Dense {0, 1} [n, n] with a[k, j] = 1 for each edge j -> k, so that
    ``infected @ a`` counts each node's infected neighbours (bfloat16 on a
    card, float32 on the CPU)."""
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    a = torch.zeros((n, n), dtype=dtype, device=device)
    a[torch.as_tensor(dst, device=device), torch.as_tensor(src, device=device)] = 1
    return a


def _counts(infected: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    if a.dtype == torch.bfloat16:
        return torch.mm(infected.to(torch.bfloat16), a, out_dtype=torch.float32)
    return infected.to(torch.float32) @ a


def simulate(a: torch.Tensor, seed_nodes, beta: float, gamma: float, seed: int, *,
             sims: int, max_time: int, block_rows: int = 2048,
             precision: str = "f32") -> np.ndarray:
    """Per-node (S, I, R) probabilities of one trial, [3, max_time, n]
    float64."""
    n, device = a.shape[0], a.device
    log1m_beta = torch.tensor(np.float32(np.log1p(-np.float64(np.float32(beta)))),
                              device=device)
    gamma16 = torch.tensor(np.float32(gamma) * np.float32(65536.0), device=device)
    if precision == "bf16":
        gamma16 = gamma16.to(torch.bfloat16).float()
    elif precision != "f32":
        raise ValueError(f"precision must be f32 or bf16, got {precision!r}")
    sums = torch.zeros((max_time, 2, n), dtype=torch.float64, device=device)
    mask = torch.zeros(n, dtype=torch.uint8, device=device)
    mask[torch.as_tensor(seed_nodes, device=device)] = 1
    for lo in range(0, sims, block_rows):
        rows = min(block_rows, sims - lo)
        i = mask.expand(rows, n).to(torch.int32)
        r = torch.zeros_like(i)
        sums[0, 0] += i.sum(0)
        for t in range(1, max_time):
            p_inf = -torch.expm1(_counts(i, a) * log1m_beta)
            thr = p_inf * 65536.0
            if precision == "bf16":
                thr = p_inf.to(torch.bfloat16).float() * 65536.0
            w = words(seed, t, lo * n, rows * n, device).view(rows, n)
            u = (w & 0xFFFF).to(torch.float32)
            v = (w >> 16).to(torch.float32)
            new_inf = (1 - i - r) * (u < thr)
            new_rec = i * (v < gamma16)
            i, r = i + new_inf - new_rec, r + new_rec
            sums[t, 0] += i.sum(0)
            sums[t, 1] += r.sum(0)
    probs = (sums / sims).cpu().numpy()
    return np.stack([1.0 - probs[:, 0] - probs[:, 1], probs[:, 0], probs[:, 1]])
