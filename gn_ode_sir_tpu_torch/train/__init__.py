"""Training layer (port of ``gn_ode_sir_tpu.train``): loss, trial datasets,
the training loop with periodic checkpoints and resume, multi-graph
assembly, the K-repeat ensemble, the legacy node-split protocol, and the
params and training-state checkpoints."""

from gn_ode_sir_tpu_torch.train.checkpoint import (
    params_from_numpy,
    params_to_numpy,
    restore_checkpoint,
    restore_params,
    save_checkpoint,
    save_params,
)
from gn_ode_sir_tpu_torch.train.data import (
    TrialData,
    build_trial_data,
    make_out_of_dist_split,
    out_of_dist_split,
    split_indices,
)
from gn_ode_sir_tpu_torch.train.loop import (
    FitResult,
    fit,
    make_eval_fn,
    make_eval_per_trial_fn,
    make_train_epoch_fn,
)
from gn_ode_sir_tpu_torch.train.ensemble import (
    EnsembleFitResult,
    fit_ensemble,
    init_ensemble,
    member_routes,
    trajectory_bytes,
)
from gn_ode_sir_tpu_torch.train.loss import l1_sir_loss, masked_l1
from gn_ode_sir_tpu_torch.train.multigraph import (
    MultigraphConnectivity,
    assemble_multigraph_trials,
    multigraph_adj_fns,
    multigraph_auto_fns,
    multigraph_pallas2_fns,
    multigraph_split,
    resolve_mg_kind,
)
from gn_ode_sir_tpu_torch.train.node_split import (
    NodeSplitResult,
    fit_node_split,
    node_split_indices,
)

__all__ = [
    "l1_sir_loss",
    "masked_l1",
    "TrialData",
    "build_trial_data",
    "split_indices",
    "out_of_dist_split",
    "make_out_of_dist_split",
    "FitResult",
    "fit",
    "make_eval_fn",
    "make_eval_per_trial_fn",
    "make_train_epoch_fn",
    "params_from_numpy",
    "params_to_numpy",
    "restore_checkpoint",
    "restore_params",
    "save_checkpoint",
    "save_params",
    "EnsembleFitResult",
    "fit_ensemble",
    "init_ensemble",
    "member_routes",
    "trajectory_bytes",
    "NodeSplitResult",
    "fit_node_split",
    "node_split_indices",
    "MultigraphConnectivity",
    "assemble_multigraph_trials",
    "multigraph_adj_fns",
    "multigraph_auto_fns",
    "multigraph_pallas2_fns",
    "multigraph_split",
    "resolve_mg_kind",
]
