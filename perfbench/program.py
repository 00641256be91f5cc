"""How the harness builds the program's objects: through the worker's own
parser and model constructors, as ``cli.worker`` and ``cli.infer`` do."""

from __future__ import annotations

import torch


def worker_args(cfg: dict, batch: int, device):
    """The worker's arguments for the configuration's GN-ODE."""
    from gn_ode_sir_tpu_torch.cli import worker

    m, t = cfg["model"], cfg["training"]
    return worker.build_parser().parse_args([
        "--model", "ode_nn", "--hidden", str(m["hidden"]), "--method", m["method"],
        "--deltaT", str(m["delta_t"]), "--maxTime", str(m["max_time"]),
        "--batch_size", str(batch), "--lr", str(t["lr"]), "--spmm", m["spmm"],
        "--gnode_dtype", m["dtype"], "--device", torch.device(device).type])


def check_model(model, cfg: dict) -> None:
    """The program runs what the configuration states, or the run is void."""
    m = cfg["model"]
    got = {"hidden": model.hidden, "method": model.method, "delta_t": model.delta_t,
           "max_time": model.max_time, "activation": model.activation,
           "encode_r": model.encode_r, "dtype": model.compute_dtype}
    want = {k: m[k] for k in got}
    if got != want:
        raise RuntimeError(f"the program built {got}, the configuration states {want}")


def check_adjacency(kind: str, cfg: dict) -> None:
    """``kind``: the adjacency's class or the multi-graph backend's name."""
    kind = "K1" if kind in ("Spmm2Adj", "pallas2") else kind
    if kind != cfg["model"]["adjacency"]:
        raise RuntimeError(f"the program's adjacency is {kind}, the configuration states "
                           f"{cfg['model']['adjacency']}")
