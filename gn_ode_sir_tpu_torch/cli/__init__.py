"""CLI layer: the experiment worker, the experiment-matrix monitorer and the
serving entry point.

As in the JAX package, the CLI (not the library) owns the dataset-root
default: relative reference-style dataset paths ('./real_graphs/karate')
resolve against ``GN_ODE_SIR_DATA_ROOT``, which each ``main()`` defaults to
the reference checkout in the user's home directory — never at import time.
"""

import os


def apply_data_root_default() -> None:
    """Set the dataset-root default (CLI entry points only)."""
    os.environ.setdefault(
        "GN_ODE_SIR_DATA_ROOT", os.path.join(os.path.expanduser("~"), "reference"))


# the monitorer's public names, imported on first use so that
# ``python -m gn_ode_sir_tpu_torch.cli.monitorer`` does not import the module
# twice
_MONITORER = ("MatrixConfig", "build_worker_argv", "ngraphs_config", "random_parameters_sir",
              "run_matrix")
__all__ = ["apply_data_root_default", *_MONITORER]


def __getattr__(name):
    if name in _MONITORER:
        from gn_ode_sir_tpu_torch.cli import monitorer

        return getattr(monitorer, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
