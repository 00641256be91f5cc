"""The port's params checkpoint and the JAX <-> port params converter.

Params are the nested tree both packages share: dicts
(``{"enc": {"w": [1, h], "b": [h]}, "func": ..., "dec1": ..., "dec2": ...}``)
and, for the GCN and GIN baselines, lists of dicts (``"convs"``).
The port saves it with ``torch.save`` and loads it with
``torch.load(weights_only=True)``. It cannot read an Orbax checkpoint (Orbax
imports JAX): the JAX side restores one and hands its leaves over as numpy
arrays, which :func:`params_from_numpy` turns into the port's tensors.
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


def params_from_numpy(tree, *, device) -> dict:
    """JAX params with numpy leaves (``tree_map(np.asarray, params)``) -> the
    port's params on ``device``."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device), tree)


def params_to_numpy(params) -> dict:
    """The port's params -> numpy leaves, the form the JAX side accepts."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
