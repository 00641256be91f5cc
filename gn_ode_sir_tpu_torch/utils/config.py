"""Single experiment configuration consumed by both the library API and CLI
(port of ``gn_ode_sir_tpu.utils.config``, field for field, so that a JSON
config written for either package loads in the other).

Unifies the reference's two-level flag system: monitorer module constants
(``monitorer-sim.py:8-24``) + per-worker argparse (``ode_nn_ngraph_sim.py:
326-343``). CLI flag names are kept for familiarity.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence


@dataclasses.dataclass
class ExperimentConfig:
    # model
    model: str = "ode_nn"  # 'ode_nn' | 'GCN' | 'GIN' | 'dmp' | 'rk'
    hidden: int = 64
    # optimization (reference defaults: monitorer-sim.py:10)
    lr: float = 1e-4
    epochs: int = 500
    batch_size: int = 1
    # SIR dynamics / labels (monitorer-sim.py:13-17)
    n_i: Sequence[int] = (2,)
    trials_per_number: int = 200
    beta: Sequence[float] = ()
    gamma: Sequence[float] = ()
    i_indices: Sequence[Sequence[int]] = ()
    delta_t: float = 0.5
    max_time: int = 20
    sim: int = 10000
    # data
    dataset: str = "./real_graphs/karate"
    path_to_save: str = "./experiments"
    train_val_test_ratio: Sequence[float] = (0.6, 0.2, 0.2)
    out_of_dist: bool = False
    trial: int = 1
    # solver
    method: str = "euler"
    adjoint: str = "auto"
    # protocol variants
    node_split: bool = False  # legacy transductive protocol (ode_nn.py path)
    instances_per_graph: Sequence[int] | None = None  # multi-graph trial counts
    # performance knobs
    spmm: str = "auto"  # GN-ODE message-passing backend: auto|dense|coo|pallas2
    coins: str = "auto"  # MC coin mode: auto|bits16|rbg16|bits32|uniform|pallas
    sim_matmul: str = "auto"  # MC neighbor-count matmul dtype: auto|bf16|int8
    gnode_dtype: str = "f32"  # GN-ODE compute dtype: f32|bf16 (mixed precision)
    solver_unroll: int = 0  # time-scan unroll (0 = auto from solver_policy)
    mg_adj: str = "auto"  # multi-graph adjacency backend: auto|coo|dense
    sims_chunk: int | None = None  # MC simulator device-memory chunking
    eval_batch_size: int = 8
    # runtime
    seed: int = 0
    init_seed: int | None = None  # model-init seed (None: follow seed);
    # repeats share `seed` (pinned trials/splits) and vary `init_seed`
    mesh_shape: Sequence[int] = ()

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), default=list, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentConfig":
        return cls(**json.loads(s))
