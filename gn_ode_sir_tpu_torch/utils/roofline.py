"""Roofline models of the hot paths (port of ``gn_ode_sir_tpu.utils.roofline``):
modelled operations and device-memory bytes from shapes, and the achieved
utilization against the peaks of one NVIDIA H100.

The models are the JAX package's, term for term (dominant terms only, each
count derived from the algorithm's op list), so that the same arguments give
the same ``ops`` and ``bytes`` in both packages. What differs is the peak a
model is scored against (``peak_key``), which names the rate the PORT's path
runs at on the card:

- the GN-ODE, SpMM and multi-graph models point at ``f32_flops``: the port
  runs its float32 matmuls with TF32 off (``torch.backends.cuda.matmul.
  allow_tf32 = False`` in ``cli/worker.py``, ``cli/infer.py`` and
  ``chip_smoke.py``), i.e. outside the tensor cores — where the JAX package
  chose ``bf16_flops``, the rate of the TPU's f32-via-bf16 lowering;
- ``mc_sim_model`` keeps ``int8_ops``: the count product is
  ``torch._int_mm`` on int8 operands, as the TPU path's int8 MXU product.

``H100_PEAKS`` takes the place of the JAX package's ``V5E_PEAKS``. Its dense
rates (no sparsity) are NVIDIA's H100 data sheet figures for the SXM5 part at
its 700 W limit; a card set to a lower power limit runs slower under load, so
a utilization is stated with the card's name and power limit beside it.
"""

from __future__ import annotations

H100_PEAKS = {
    "name": "NVIDIA H100 80GB HBM3 (SXM5, 700 W)",
    "f32_flops": 67e12,  # outside the tensor cores
    "tf32_flops": 494.7e12,  # tensor cores, dense
    "bf16_flops": 989.4e12,  # tensor cores, dense
    "int8_ops": 1979e12,  # tensor cores, dense
    "hbm_bytes_per_s": 3.35e12,  # HBM3
}


def mc_sim_model(n_nodes: int, sims: int, max_time: int, state_bytes: int = 1) -> dict:
    """Monte-Carlo SIR label extraction (``sim/mc_sir.py``, int8 count path).

    Dominant compute: the per-step neighbour-count product
    ``I[sims, n] @ A[n, n]`` in int8 x int8 -> int32, 2·sims·n² operations a
    step over T-1 steps. Dominant traffic a step: the adjacency read (n² int8)
    and ~6 [sims, n] state, coin and indicator streams (``state_bytes`` 1 for
    the int8 (I, R) carry)."""
    steps = max_time - 1
    ops = 2.0 * sims * n_nodes * n_nodes * steps
    bytes_ = steps * (n_nodes * n_nodes * 1.0 + 6.0 * sims * n_nodes * state_bytes)
    return {"ops": ops, "bytes": bytes_, "peak_key": "int8_ops"}


def gnode_train_epoch_model(n_nodes: int, hidden: int, batch: int, steps_per_epoch: int,
                            n_solver_steps: int) -> dict:
    """A GN-ODE training epoch on the dense backend (``train/loop.py``).

    Per field evaluation (``models/gnode.py``): the hidden linear on the
    stacked state, 2·3·B·n·h² FLOPs, and the adjacency product A[n, n] @
    Z_I[B, n, h], 2·B·n²·h FLOPs. Forward is ``n_solver_steps`` evaluations;
    the backward costs ~2x the forward, so 3x in all. Traffic: one f32
    adjacency read (4·n²) per product, forward and one transpose read in the
    backward, plus the [3, B, n, h] state in and out per evaluation."""
    per_eval_flops = (2.0 * 3 * batch * n_nodes * hidden * hidden
                      + 2.0 * batch * n_nodes * n_nodes * hidden)
    flops = 3.0 * n_solver_steps * per_eval_flops * steps_per_epoch
    per_eval_bytes = 4.0 * n_nodes * n_nodes + 2 * 4.0 * 3 * batch * n_nodes * hidden
    bytes_ = n_solver_steps * steps_per_epoch * (2.0 * per_eval_bytes)
    return {"ops": flops, "bytes": bytes_, "peak_key": "f32_flops"}


def spmm_apply_model(n_nodes: int, n_directed_edges: int, hidden: int,
                     msg_bytes: int = 4) -> dict:
    """One sparse SpMM apply (K1, ``ops/spmm2.py``, or the COO backends).

    Compute is 2·E·h FLOPs of multiply-adds; traffic is one h-vector gather
    ``x[src]`` and one int32 index per edge, and one h-vector write per
    node: a gather-bound path."""
    flops = 2.0 * n_directed_edges * hidden
    bytes_ = n_directed_edges * (hidden * msg_bytes + 4.0) + n_nodes * hidden * 4.0
    return {"ops": flops, "bytes": bytes_, "peak_key": "f32_flops"}


def mg_train_epoch_model(n_max: int, hidden: int, batch: int, steps_edges,
                         n_solver_steps: int, msg_bytes: int = 4) -> dict:
    """A multi-graph GN-ODE training epoch on the sparse backend
    (``train/multigraph.py``, K1 on one plan per graph).

    ``steps_edges``: per train graph, ``(train_steps_this_epoch,
    directed_edges)``; grouped minibatches make every step single-graph, so
    the epoch is a sum of per-graph terms. Per field evaluation on graph g:
    the hidden linear on the stacked state, 2·3·B·n_max·h² FLOPs (padding rows
    ride through the dense layers), and the sparse product, 2·E_g·B·h FLOPs,
    whose bytes are the E_g message gathers (B·h wide), index reads and node
    writes, plus the [3, B, n_max, h] state in and out. Backward ~2x the
    forward, 3x in all."""
    flops = 0.0
    bytes_ = 0.0
    for steps, e_g in steps_edges:
        per_eval_flops = (2.0 * 3 * batch * n_max * hidden * hidden
                          + 2.0 * e_g * batch * hidden)
        per_eval_bytes = (e_g * (batch * hidden * msg_bytes + 4.0)
                          + batch * n_max * hidden * 4.0
                          + 2 * 4.0 * 3 * batch * n_max * hidden)
        flops += 3.0 * n_solver_steps * per_eval_flops * steps
        bytes_ += 3.0 * n_solver_steps * per_eval_bytes * steps
    return {"ops": flops, "bytes": bytes_, "peak_key": "f32_flops"}


def utilization(model: dict, wall_s: float, peaks: dict = H100_PEAKS) -> dict:
    """Achieved rates and fractions of peak for a modelled path: achieved
    TFLOP/s (or TOP/s), ``mfu`` (the fraction of the model's ``peak_key``
    rate), achieved GB/s and ``hbm_frac`` (the fraction of the memory rate
    under the streaming byte model; it may exceed 1.0 where the caches reuse
    more than the model assumes)."""
    achieved_ops = model["ops"] / wall_s
    achieved_bytes = model["bytes"] / wall_s
    return {
        "modeled_tops": model["ops"] / 1e12,
        "modeled_gb": model["bytes"] / 1e9,
        "achieved_tops": achieved_ops / 1e12,
        "mfu": achieved_ops / peaks[model["peak_key"]],
        "achieved_gbps": achieved_bytes / 1e9,
        "hbm_frac": achieved_bytes / peaks["hbm_bytes_per_s"],
        "peaks_for": peaks["name"],
    }
