"""Port parity for three public names of already-ported modules:
``odeint.resample_expected_counts`` (float32 sums over the node axis, within
1e-6 of the JAX package's), ``ops.spmm`` (the dispatching SpMM: dense up to
``DENSE_NODE_THRESHOLD`` nodes unless ``prefer_dense`` says otherwise, COO
with edge weights; within 1e-5) and ``graphs.GRAPH_STEM``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gn_ode_sir_tpu.graphs import GRAPH_STEM as JAX_GRAPH_STEM
from gn_ode_sir_tpu.odeint import resample_expected_counts as jax_resample_expected_counts
from gn_ode_sir_tpu.ops import spmm as jax_spmm
from gn_ode_sir_tpu_torch.graphs import GRAPH_STEM, Graph
from gn_ode_sir_tpu_torch.odeint import resample_expected_counts
from gn_ode_sir_tpu_torch.ops import spmm

torch.set_num_threads(1)


def test_graph_stem():
    assert GRAPH_STEM == JAX_GRAPH_STEM == "real_graphs"


@pytest.mark.parametrize("max_time,delta_t", [(20, 0.5), (8, 0.25), (5, 1.0)])
def test_resample_expected_counts_equals_jax(max_time, delta_t):
    steps = int(round(max_time / delta_t))
    traj = np.random.default_rng(steps).random((steps, 7, 30, 3)).astype(np.float32)
    got = resample_expected_counts(torch.as_tensor(traj), max_time, delta_t)
    want = jax_resample_expected_counts(jnp.asarray(traj), max_time, delta_t)
    assert tuple(got.shape) == want.shape == (max_time, 30, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def _port(jg):
    return Graph(n_nodes=jg.n_nodes, src=jg.src, dst=jg.dst, name=jg.name)


@pytest.mark.parametrize("prefer_dense", [None, True, False])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("batched", [False, True])
def test_spmm_equals_jax(random_graph, prefer_dense, weighted, batched):
    g = random_graph
    rng = np.random.default_rng(1)
    x = rng.standard_normal(((3,) if batched else ()) + (g.n_nodes, 5)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, g.n_edges).astype(np.float32) if weighted else None
    got = spmm(_port(g), torch.as_tensor(x), None if w is None else torch.as_tensor(w),
               prefer_dense=prefer_dense)
    want = jax_spmm(g, jnp.asarray(x), None if w is None else jnp.asarray(w),
                    prefer_dense=prefer_dense)
    assert tuple(got.shape) == want.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
