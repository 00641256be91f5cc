"""Process-group initialization (port of ``gn_ode_sir_tpu.parallel.distributed``).

The port runs one process per device, as ``torchrun`` starts them: call
:func:`init_distributed` once in every process before building a mesh. Where
the JAX package reads ``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/
``JAX_PROCESS_ID``, this reads the environment ``torchrun`` sets:
``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` (and
``LOCAL_RANK`` to pick the card).
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist


def backend_for(device_type: str) -> str:
    """The collective backend of a device type: NCCL for CUDA, gloo for the CPU."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    return "nccl" if device_type == "cuda" else "gloo"


def default_device_type() -> str:
    """The device type of a caller that names none: CUDA. Raises where no card
    is visible, so that a group meant for the cards never runs on the CPU
    unasked; the CPU (gloo) is ``device_type="cpu"``."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device_type='cpu' to run the "
                           "process group on the CPU over gloo")
    return "cuda"


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device_type: str | None = None,
) -> bool:
    """Join the process group (no-op for a single process).

    Arguments default to ``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``. The backend is chosen from ``device_type``: ``nccl`` for CUDA
    (the default; raises RuntimeError where no card is visible), after making
    card ``LOCAL_RANK`` (default ``RANK``) modulo the card count this
    process's device, and ``gloo`` for ``"cpu"``. Returns True when a group
    of more than one process was initialized here."""
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if num_processes <= 1 or not coordinator_address:
        return False
    device_type = device_type or default_device_type()
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend_for(device_type), init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def init_single_process(device_type: str) -> None:
    """A process group of this process alone (world size 1), rendezvousing
    with itself on a free port of 127.0.0.1: what a one-card run of the
    parallel code (``chip_smoke.py``) needs, where no launcher set the
    environment. Does nothing when a group exists."""
    if dist.is_initialized():
        return
    dist.init_process_group(backend_for(device_type),
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
