"""Per-trial CSV results sink, schema-compatible with the reference (port of
``gn_ode_sir_tpu.utils.csvsink``).

Create-with-header on first write, append thereafter, then read the whole
CSV back and print it (the reference's progress display). The read-back uses
the ``csv`` module, not pandas, so the worker runs on a machine without
pandas. Set ``PRINT_TABLE = False`` (or pass ``print_table=False``) to
silence it in library use.
"""

from __future__ import annotations

import csv
import os

TRIAL_COLUMNS = [
    "trial", "model", "lr", "epochs", "MC sim", "train_val_test_ratio",
    "beta", "gamma", "deltaT", "maxTime", "I_indices", "hidden",
    "best_epoch", "val_loss", "test_loss", "loss_baseline",
    "n_ode_time", "rk_time",
]

PRINT_TABLE = True  # module-level default for the reference's print side effect


def _print_csv(path: str) -> None:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    widths = [max(len(r[c]) for r in rows if c < len(r)) for c in range(len(rows[0]))]
    for r in rows:
        print("  ".join(v.rjust(w) for v, w in zip(r, widths)))


def csv_trials(path_to_csv: str, columns, row, print_table: bool | None = None) -> None:
    exists = os.path.exists(path_to_csv)
    os.makedirs(os.path.dirname(os.path.abspath(path_to_csv)), exist_ok=True)
    with open(path_to_csv, "a", newline="") as f:
        writer = csv.writer(f)
        if not exists:
            writer.writerow(columns)
        writer.writerow(row)
    if PRINT_TABLE if print_table is None else print_table:
        _print_csv(path_to_csv)


def save_trial_to_csv(
    cfg,
    dataset_name: str,
    best_epoch: int,
    val_loss: float,
    test_loss: float,
    loss_baseline: float,
    n_ode_time: float,
    rk_time: float,
    path_to_save: str | None = None,
    print_table: bool | None = None,
) -> None:
    """Append one trial row (the 18 columns of ``TRIAL_COLUMNS``).

    ``print_table=False`` silences the whole-table read-back for this call
    (module default: ``PRINT_TABLE``)."""
    save_dir = path_to_save or cfg.path_to_save
    row = [
        cfg.trial, cfg.model, cfg.lr, cfg.epochs, cfg.sim,
        list(cfg.train_val_test_ratio), len(cfg.beta), len(cfg.gamma),
        cfg.delta_t, cfg.max_time,
        [len(cfg.i_indices[0]) if cfg.i_indices else 0, len(cfg.i_indices)],
        cfg.hidden, best_epoch, val_loss, test_loss, loss_baseline,
        n_ode_time, rk_time,
    ]
    csv_trials(
        os.path.join(save_dir, f"Metrics-trials-{dataset_name}"),
        TRIAL_COLUMNS, row, print_table=print_table,
    )
