"""Cross-cutting utilities (port of ``gn_ode_sir_tpu.utils``): config, label
cache, CSV metrics sink. Timing, profiling and roofline helpers are not
ported yet (ROADMAP.md Queue 1)."""

from gn_ode_sir_tpu_torch.utils.config import ExperimentConfig
from gn_ode_sir_tpu_torch.utils.csvsink import csv_trials, save_trial_to_csv
from gn_ode_sir_tpu_torch.utils.labels import (
    label_paths,
    load_labels,
    load_or_extract_labels,
    load_or_extract_labels_many,
)

__all__ = [
    "ExperimentConfig",
    "label_paths",
    "load_labels",
    "load_or_extract_labels",
    "load_or_extract_labels_many",
    "csv_trials",
    "save_trial_to_csv",
]
