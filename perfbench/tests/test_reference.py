"""The plain references agree with the program at a small size on the CPU
(the test imports both; the references import nothing of the program)."""

import ast

import numpy as np
import pytest
import torch

from perfbench import harness, inputs
from perfbench.reference import gnode as ref
from perfbench.reference import mc_sir as ref_mc

torch.set_num_threads(1)


def _graph(n=40, edges=160, seed=5):
    from gn_ode_sir_tpu_torch.graphs.graph import graph_from_edges

    pairs = inputs.powerlaw_pairs(n, edges, seed)
    return pairs, graph_from_edges(n, pairs)


@pytest.mark.parametrize("kind", ["pallas2", "dense"])
def test_gnode_forward_matches_the_program(kind):
    from gn_ode_sir_tpu_torch.models import GNODE
    from gn_ode_sir_tpu_torch.ops.adjacency import adjacency_from_graph

    pairs, g = _graph()
    params = inputs.gnode_params(torch.Generator().manual_seed(2), 8, "cpu")
    i0 = torch.zeros(3, g.n_nodes)
    i0[0, 1] = i0[1, 5] = i0[2, 7] = 1
    beta, gamma = torch.tensor([0.2, 0.3, 0.45]), torch.tensor([0.1, 0.25, 0.4])
    model = GNODE(hidden=8, adjoint="direct")
    got = model.predict(params, adjacency_from_graph(g, kind=kind, device="cpu"), 1 - i0, i0,
                        torch.zeros_like(i0), beta, gamma)
    src, dst = (torch.as_tensor(a) for a in inputs.directed(pairs))
    want = ref.predict(params, src, dst, 1 - i0, i0, torch.zeros_like(i0), beta, gamma,
                       delta_t=0.5, max_time=20)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


def test_one_training_step_matches_the_program():
    from gn_ode_sir_tpu_torch.models import GNODE
    from gn_ode_sir_tpu_torch.ops.adjacency import adjacency_from_graph
    from gn_ode_sir_tpu_torch.train.loop import make_train_epoch_fn

    pairs, g = _graph()
    gen = torch.Generator().manual_seed(3)
    params = inputs.gnode_params(gen, 8, "cpu")
    labels = inputs.synthetic_labels(gen, 2, 20, g.n_nodes, "cpu")
    i0 = torch.zeros(2, g.n_nodes)
    i0[0, 2] = i0[1, 9] = 1
    d = {"s0": 1 - i0, "i0": i0, "r0": torch.zeros_like(i0), "beta": torch.tensor([0.3, 0.2]),
         "gamma": torch.tensor([0.2, 0.1]), "labels": labels, "graph_idx": np.zeros(2, np.int32)}
    leaves = {k: params[k[0]][k[1]].clone().requires_grad_(True) for k in ref.LEAVES}
    tree = {}
    for (layer, name), leaf in leaves.items():
        tree.setdefault(layer, {})[name] = leaf
    opt = torch.optim.Adam(list(leaves.values()), lr=1e-3)
    adj = adjacency_from_graph(g, kind="pallas2", device="cpu")
    fn = make_train_epoch_fn(GNODE(hidden=8, adjoint="direct"), opt, lambda gi: adj)
    loss = float(fn(tree, d, np.array([[0, 1]]), np.ones((1, 2), np.float32)))
    src, dst = (torch.as_tensor(a) for a in inputs.directed(pairs))
    want_loss, want_grad = ref.loss_and_grad(
        params, dict(src=src, dst=dst, s0=d["s0"], i0=i0, r0=d["r0"], beta=d["beta"],
                     gamma=d["gamma"], labels=labels, weight=torch.ones(2)),
        delta_t=0.5, max_time=20)
    assert abs(loss - want_loss) <= 1e-6 * abs(want_loss)
    for k, leaf in leaves.items():
        torch.testing.assert_close(leaf.grad, want_grad[k], rtol=1e-4, atol=1e-6)
        moved = ref.adam(params[k[0]][k[1]], leaf.grad, torch.zeros_like(leaf),
                         torch.zeros_like(leaf), 1, lr=1e-3)
        torch.testing.assert_close(leaf.detach(), moved, rtol=1e-6, atol=1e-9)


def test_label_replay_is_exact():
    from gn_ode_sir_tpu_torch.sim import mc_sir

    pairs, g = _graph(n=50, edges=200, seed=7)
    trials = [([3, 11], 0.35, 0.2), ([0, 40], 0.15, 0.45)]
    seeds = [2**62 + 12345, 987654321]
    got = mc_sir.simulate_sir_many(g, trials, sims=96, max_time=8, seeds=seeds, device="cpu")
    src, dst = inputs.directed(pairs)
    a = ref_mc.adjacency(src, dst, g.n_nodes, "cpu")
    for (nodes, beta, gamma), seed, sir in zip(trials, seeds, got):
        want = ref_mc.simulate(a, nodes, beta, gamma, seed, sims=96, max_time=8, block_rows=40)
        np.testing.assert_allclose(np.stack(sir), want, rtol=0, atol=1e-12)
        low = ref_mc.simulate(a, nodes, beta, gamma, seed, sims=96, max_time=8, precision="bf16")
        assert np.abs(low - want).max() > 0  # the lower precision moves the labels


def test_references_import_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = {a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
                 for a in node.names}
        names |= {node.module for node in ast.walk(tree)
                  if isinstance(node, ast.ImportFrom) and node.module}
        assert not {n.split(".")[0] for n in names} & {harness.PROGRAM, *harness.FORBIDDEN}, path
