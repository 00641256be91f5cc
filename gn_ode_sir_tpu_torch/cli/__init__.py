"""CLI layer: the experiment worker and the serving entry point.

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
