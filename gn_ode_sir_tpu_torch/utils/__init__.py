"""Cross-cutting utilities (port of ``gn_ode_sir_tpu.utils``): config, label
cache, CSV metrics sink, timing, tracing and metrics logging; the roofline
models are in ``utils.roofline``."""

from gn_ode_sir_tpu_torch.utils.config import ExperimentConfig
from gn_ode_sir_tpu_torch.utils.csvsink import csv_trials, save_trial_to_csv
from gn_ode_sir_tpu_torch.utils.labels import (
    label_paths,
    load_labels,
    load_or_extract_labels,
    load_or_extract_labels_many,
)
from gn_ode_sir_tpu_torch.utils.profiling import (MetricsLogger, device_memory_stats, span,
                                                  trace)
from gn_ode_sir_tpu_torch.utils.timing import Timer

__all__ = [
    "MetricsLogger",
    "device_memory_stats",
    "span",
    "trace",
    "ExperimentConfig",
    "label_paths",
    "load_labels",
    "load_or_extract_labels",
    "load_or_extract_labels_many",
    "csv_trials",
    "save_trial_to_csv",
    "Timer",
]
