"""Label extraction (port of ``gn_ode_sir_tpu.sim``): the vectorized
Monte-Carlo SIR simulator, whose per-step coin flips and state update run in
the CUDA kernel K2 (``sim.fused_step``), and the classical mean-field
baseline (``sim.classical``)."""

from gn_ode_sir_tpu_torch.sim.classical import sir_classical, sir_classical_batch, sir_field
from gn_ode_sir_tpu_torch.sim.mc_sir import (
    simulate_sir,
    simulate_sir_counts,
    simulate_sir_counts_many,
    simulate_sir_many,
    simulate_sir_per_sim,
    sir_per_sim_stats,
)

__all__ = [
    "simulate_sir",
    "simulate_sir_counts",
    "simulate_sir_counts_many",
    "simulate_sir_many",
    "simulate_sir_per_sim",
    "sir_per_sim_stats",
    "sir_classical",
    "sir_field",
    "sir_classical_batch",
]
