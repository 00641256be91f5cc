"""The port's checkpoints and the JAX <-> port params converter.

Params are the nested tree both packages share: dicts
(``{"enc": {"w": [1, h], "b": [h]}, "func": ..., "dec1": ..., "dec2": ...}``)
and, for the GCN and GIN baselines, lists of dicts (``"convs"``).
The port saves it with ``torch.save`` and loads it with
``torch.load(weights_only=True)``. It cannot read an Orbax checkpoint (Orbax
imports JAX): the JAX side restores one and hands its leaves over as numpy
arrays, which :func:`params_from_numpy` turns into the port's tensors.

:func:`save_checkpoint` / :func:`restore_checkpoint` hold a whole training
state (``fit``'s and ``fit_ensemble``'s periodic checkpoints: params, the
optimizer's ``state_dict()``, epoch, best-val bookkeeping, the best-val
params, the test time and, on out-of-dist runs, the per-trial test losses)
in one ``<directory>/state.pt``. The JAX package restores its Orbax state
through a layout ladder (``restore_with_layout_ladder``), because Orbax
matches a target structure strictly and older runs wrote fewer keys. Here
there is one layout, a dict: a key that an older state lacks (``test_time``,
``best_params``, ``test_loss_all``) is absent, and the caller defaults it as
the ladder's rungs do (0.0, the params, none). A NaN test loss (no
validation improvement yet) is stored as NaN, not as a score.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree, prefix=()):
    """(path, leaf) pairs of a params tree: dict keys in sorted order, list
    items by position, the path joined by '/'."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for k, v in enumerate(tree):
            yield from tree_leaves(v, prefix + (str(k),))
    else:
        yield "/".join(prefix), tree


def params_path(directory: str, name: str = "serve") -> str:
    return os.path.join(directory, f"{name}.pt")


def save_params(directory: str, params: dict, name: str = "serve") -> str:
    """Write ``params`` (moved to the CPU) to ``<directory>/<name>.pt``."""
    os.makedirs(directory, exist_ok=True)
    path = params_path(directory, name)
    torch.save(tree_map(lambda t: t.detach().cpu(), params), path)
    return path


def restore_params(directory: str, name: str = "serve", *, device) -> dict:
    """Load ``<directory>/<name>.pt`` onto ``device``."""
    tree = torch.load(params_path(directory, name), map_location="cpu", weights_only=True)
    return tree_map(lambda t: t.to(device), tree)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, np.ndarray):  # torch.load(weights_only=True) reads tensors, not arrays
        return torch.from_numpy(tree)
    return tree


def checkpoint_path(directory: str, name: str = "state") -> str:
    return os.path.join(directory, f"{name}.pt")


def save_checkpoint(directory: str, state: dict, name: str = "state") -> str:
    """Write a training state (nested dicts and lists of tensors, numpy
    arrays, which are stored as tensors, and Python numbers) to
    ``<directory>/<name>.pt``. The file is written beside and then renamed
    over the old one, so a crash during the write leaves the previous
    state."""
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, name)
    torch.save(_to_cpu(state), path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def restore_checkpoint(directory: str, name: str = "state") -> dict:
    """The state :func:`save_checkpoint` wrote, its tensors on the CPU."""
    return torch.load(checkpoint_path(directory, name), map_location="cpu", weights_only=True)


def params_from_numpy(tree, *, device) -> dict:
    """JAX params with numpy leaves (``tree_map(np.asarray, params)``) -> the
    port's params on ``device``."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device), tree)


def params_to_numpy(params) -> dict:
    """The port's params -> numpy leaves, the form the JAX side accepts."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
