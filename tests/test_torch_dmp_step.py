"""K4's and K5's plain versions and DMP's fused recursion on the CPU: one
step of the plain versions, in the scenario-minor layout ([E, B] edge state,
[n, B] node state), gives the bits of ``models/dmp.py::_step`` and of the
eager ops in the scenario-major layout they replaced, and ``dmp_recursion``
(the node product, K5 and K4 a step) gives the bits of the recursion that
loops ``_step``, for every rate form; the benchmark's DMP faults and control
still move the recursion; the wrappers refuse what the kernels cannot take.
The kernels themselves are held against their plain versions on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from gn_ode_sir_tpu_torch.graphs.graph import graph_from_edges
from gn_ode_sir_tpu_torch.models import DMPSIR, dmp
from gn_ode_sir_tpu_torch.ops import _kernels
from gn_ode_sir_tpu_torch.ops import dmp_step as k4
from gn_ode_sir_tpu_torch.ops.dmp_step import (dmp_marginals, dmp_marginals_plain, dmp_step,
                                               dmp_step_plain)
from gn_ode_sir_tpu_torch.ops.segment import segment_prod
from perfbench import inputs

torch.set_num_threads(1)


def _edges(one_way: bool, n=150, directed=1200, seed=2):
    """A power-law graph's edges on the CPU; ``one_way`` drops a third of
    them, so that some keep no reverse edge."""
    g = graph_from_edges(n, inputs.powerlaw_pairs(n, directed, seed), name="powerlaw")
    src, dst = g.src, g.dst
    if one_way:
        keep = np.random.default_rng(seed).random(len(src)) > 0.33
        src, dst = src[keep], dst[keep]
    cave = dmp.cave_index(src, dst)
    assert bool((cave == len(src)).any()) is one_way
    return dmp.DmpEdges.build(src, dst, cave, n, device="cpu")


def _rates(form, b, edges, seed=0):
    """(w, gamma, seeds) with a lead axis of ``b``, or none where ``b`` is
    None; ``form`` 'scenario' ([B, 1]) or 'edge' ([B, E] and [B, n])."""
    rng = np.random.default_rng(seed)
    lead = () if b is None else (b,)
    e, n = edges.n_edges, edges.n_nodes
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    seeds = np.zeros((*lead, n), np.float32)
    for row in seeds.reshape(-1, n):
        row[rng.choice(n, 3, replace=False)] = 1.0
    w = rng.uniform(0.1, 0.5, (*lead, e if form == "edge" else 1))
    gamma = rng.uniform(0.1, 0.5, (*lead, n if form == "edge" else 1))
    return t(w), t(gamma), t(seeds)


def _unfused(monkeypatch):
    """``dmp_recursion`` on the loop of ``_step`` (a wrapped ``_step`` is not
    the module's own)."""
    own = dmp._step
    monkeypatch.setattr(dmp, "_step", lambda *a, **k: own(*a, **k))


@pytest.mark.parametrize("one_way", [False, True], ids=["reverse", "one_way"])
@pytest.mark.parametrize("form,b", [("scenario", 4), ("edge", 3), ("scenario", None),
                                    ("edge", None), ("scenario", 1), ("edge", 1),
                                    ("scenario", 37), ("edge", 37)])
def test_recursion_gives_the_bits_of_the_step_loop(form, b, one_way, monkeypatch):
    edges = _edges(one_way)
    w, gamma, seeds = _rates(form, b, edges, seed=len(form) + (b or 0))
    calls = segment_prod.calls
    got = dmp.dmp_recursion(edges, w, gamma, seeds, max_time=12)
    assert segment_prod.calls - calls == 11  # the node product once a step
    _unfused(monkeypatch)
    want = dmp.dmp_recursion(edges, w, gamma, seeds, max_time=12)
    assert got.shape == (12, *(() if b is None else (b,)), edges.n_nodes, 3)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def _eager_step(theta, phi, ps_ij, pr, pi, w, gamma, ps_0, edges, *, first):
    """One step in the recursion's eager ops, as they stood before K4 and K5,
    scenario-major ([B, E] edge state): theta, phi, Ps_ij and the marginals
    [B, n, 3] at t from those at t - 1."""
    theta = theta - w * phi
    if first:
        theta = theta + 1e-10
    node = segment_prod(theta, edges.dst, edges.n_nodes, dim=-1)
    rev = edges.reverse.long()
    cav = torch.where(rev >= 0, theta.index_select(-1, rev.clamp(min=0)), 1.0)
    gamma_src = gamma if gamma.shape[-1] == 1 else gamma.index_select(-1, edges.src)
    new_ps_ij = ps_0.index_select(-1, edges.src) * (node.index_select(-1, edges.src) / cav)
    phi = (1.0 - w) * (1.0 - gamma_src) * phi - (new_ps_ij - ps_ij)
    ps_t = ps_0 * node
    pr_t = pr + gamma * pi
    return theta, phi, new_ps_ij, torch.stack([ps_t, 1.0 - ps_t - pr_t, pr_t], dim=-1)


@pytest.mark.parametrize("one_way", [False, True], ids=["reverse", "one_way"])
@pytest.mark.parametrize("form", ["scenario", "edge"])
@pytest.mark.parametrize("first", [True, False], ids=["first_step", "later_step"])
def test_plain_step_gives_the_bits_of_step(form, first, one_way):
    """The step's eager ops from the state at t - 1, scenario-major, against
    ``_step`` and against the same state moved on by the fused form, both
    scenario-minor: theta at t, the node product, then K5's and K4's plain
    versions. The marginals, phi and Ps_ij at t, and theta at t + 1 as the
    eager ops make it at the next step, bit for bit."""
    edges = _edges(one_way)
    w, gamma, seeds = _rates(form, 5, edges, seed=7)
    ps_0 = 1.0 - seeds
    ps_i0 = ps_0.index_select(-1, edges.src)
    eager = lambda *state, first: _eager_step(*state, w, gamma, ps_0, edges, first=first)
    theta, phi, ps_ij, pr, pi = torch.ones(()), 1.0 - ps_i0, ps_i0, torch.zeros_like(seeds), seeds
    for t in range(1, 1 if first else 4):  # a later step: three in, every term moving
        theta, phi, ps_ij, marg = eager(theta, phi, ps_ij, pr, pi, first=t == 1)
        pi, pr = marg[..., 1], marg[..., 2]
    want_theta, want_phi, want_ps_ij, want_marg = eager(theta, phi, ps_ij, pr, pi, first=first)
    prev = torch.stack([torch.full_like(pi, float("nan")), pi, pr], dim=-1)
    minor = lambda x: x.t().contiguous()  # [B, ...] -> [..., B]; a 0-d theta stays
    w_m, gamma_m, ps_0_m = minor(w), minor(gamma), minor(ps_0)
    c = dmp._Constants(edges=edges, w=w_m, gamma=gamma_m, ps_0=ps_0_m)
    got = dmp._step(minor(theta), minor(phi), minor(ps_ij), prev, c, first=first)
    for x, y in zip(got, (minor(want_theta), minor(want_phi), minor(want_ps_ij), want_marg)):
        assert torch.equal(x, y)
    theta, phi, ps_ij = minor(theta) - w_m * minor(phi), minor(phi), minor(ps_ij)
    if first:
        theta = theta + 1e-10
    assert torch.equal(theta, minor(want_theta))
    node = segment_prod(theta, edges.dst, edges.n_nodes)  # [n, B]
    out, pair = torch.empty((5, edges.n_nodes, 3)), torch.empty((edges.n_nodes, 5, 2))
    dmp_marginals(out, prev, node, ps_0_m, gamma_m, pair)
    assert torch.equal(out, want_marg)
    assert torch.equal(pair, torch.stack([node, ps_0_m], dim=-1))
    nxt, phi_t, ps_ij_t = torch.empty_like(theta), phi.clone(), ps_ij.clone()
    dmp_step(theta, nxt, phi_t, ps_ij_t, pair, w_m, gamma_m, edges.src, edges.reverse)
    assert torch.equal(phi_t, minor(want_phi)) and torch.equal(ps_ij_t, minor(want_ps_ij))
    assert torch.equal(nxt, minor(want_theta - w * want_phi))
    # the last step writes no theta and moves phi and Ps_ij alike
    phi_t, ps_ij_t = phi.clone(), ps_ij.clone()
    dmp_step_plain(theta, None, phi_t, ps_ij_t, pair, w_m, gamma_m, edges.src, edges.reverse)
    assert torch.equal(phi_t, minor(want_phi)) and torch.equal(ps_ij_t, minor(want_ps_ij))


def test_run_and_predict_take_the_fused_step(monkeypatch):
    """``run`` (B = 1, no lead axis, a scalar rate and per-edge / per-node
    rates), ``run_many`` and ``predict`` all run the fused recursion."""
    calls = []
    own = dmp.dmp_step

    def recording(*a, **k):
        calls.append(a[1] is None)
        return own(*a, **k)

    monkeypatch.setattr(dmp, "dmp_step", recording)
    g = graph_from_edges(60, inputs.powerlaw_pairs(60, 400, 3), name="powerlaw")
    model = DMPSIR.from_graph(g, max_time=6)
    model.run([1, 4], 0.3, 0.2, max_time=6, device="cpu")
    rng = np.random.default_rng(0)
    model.run([2], rng.uniform(0.1, 0.5, g.n_edges), rng.uniform(0.1, 0.5, g.n_nodes),
              max_time=6, device="cpu")
    model.run_many([[1], [5, 6]], [0.2, 0.4], [0.1, 0.3], max_time=6, device="cpu")
    i0 = torch.zeros((2, 60))
    i0[:, 3] = 1.0
    model.predict({}, model.edges("cpu"), 1 - i0, i0, 0 * i0, torch.tensor([0.2, 0.3]),
                  torch.tensor([0.1, 0.2]))
    assert calls == [False, False, False, False, True] * 4  # the last step writes no theta


def test_faults_on_step_or_cavity_take_the_step_loop(monkeypatch):
    """A replaced ``_step`` or ``_cavity`` (the benchmark's DMP faults)
    runs the loop of ``_step``, where the replacement acts."""
    edges = _edges(False)
    w, gamma, seeds = _rates("scenario", 2, edges)
    whole = dmp.dmp_recursion(edges, w, gamma, seeds, max_time=5)
    monkeypatch.setattr(dmp, "_cavity", lambda theta, edges: torch.ones_like(theta))
    backtracking = dmp.dmp_recursion(edges, w, gamma, seeds, max_time=5)
    assert not torch.equal(whole, backtracking)


@pytest.mark.parametrize("planted", ["state_unchanged", "backtracking", "bfloat16_edge_state"])
def test_benchmark_faults_and_control_still_move_the_recursion(planted):
    """``perfbench/control_dmp.py``'s faults and its control wrap ``_step``
    or replace ``_cavity`` without knowing the edge state's layout: each
    still sends the recursion to ``_step``'s loop and moves a marginal by
    more than the DMP cell's limit of 1e-4; once it is lifted, the fused
    recursion is back."""
    from perfbench import control_dmp

    edges = _edges(True)
    w, gamma, seeds = _rates("scenario", 6, edges, seed=3)
    sound = dmp.dmp_recursion(edges, w, gamma, seeds, max_time=10)
    with (control_dmp.bfloat16_edge_state() if planted == "bfloat16_edge_state"
          else control_dmp.plant(planted)):
        assert not dmp._fused()
        got = dmp.dmp_recursion(edges, w, gamma, seeds, max_time=10)
    assert dmp._fused()
    assert got.shape == sound.shape
    assert float((got - sound).abs().max()) > 1e-4


def _step_args(b=2, e=7, n=4):
    z = lambda *s: torch.zeros(s)
    return dict(theta=z(e, b), theta_next=z(e, b), phi=z(e, b), ps_ij=z(e, b), pair=z(n, b, 2),
                w=z(1, b), gamma=z(n, b), src=torch.zeros(e, dtype=torch.int32),
                reverse=torch.zeros(e, dtype=torch.int32))


@pytest.mark.parametrize("name,bad,match", [
    ("phi", torch.zeros(6, 2), "phi"), ("theta_next", torch.zeros(7, 3), "theta_next"),
    ("pair", torch.zeros(4, 2, 3), "pair"), ("pair", torch.zeros(5, 2, 2), "gamma must"),
    ("src", torch.zeros(6, dtype=torch.int32), "src"), ("w", torch.zeros(3, 2), "w must"),
    ("gamma", torch.zeros(4, 3), "gamma must"), ("theta", torch.zeros(7, 2, 1), "theta must")])
def test_step_refuses_shapes_that_do_not_fit(name, bad, match):
    args = _step_args()
    args[name] = bad
    with pytest.raises(ValueError, match=match):
        dmp_step(**args)


def test_marginals_refuse_shapes_that_do_not_fit():
    """out and prev [B, n, 3]; node, ps_0 [n, B]; gamma [n or 1, B or 1];
    pair [n, B, 2] (B = 2, n = 4)."""
    z = torch.zeros
    with pytest.raises(ValueError, match="out"):
        dmp_marginals(z(2, 4, 2), z(2, 4, 3), z(4, 2), z(4, 2), z(1, 2), z(4, 2, 2))
    with pytest.raises(ValueError, match="prev"):
        dmp_marginals(z(2, 4, 3), z(1, 4, 3), z(4, 2), z(4, 2), z(1, 2), z(4, 2, 2))
    with pytest.raises(ValueError, match="ps_0"):
        dmp_marginals(z(2, 4, 3), z(2, 4, 3), z(4, 2), z(2, 4), z(1, 2), z(4, 2, 2))
    with pytest.raises(ValueError, match="gamma"):
        dmp_marginals(z(2, 4, 3), z(2, 4, 3), z(4, 2), z(4, 2), z(3, 2), z(4, 2, 2))
    with pytest.raises(ValueError, match="pair"):
        dmp_marginals(z(2, 4, 3), z(2, 4, 3), z(4, 2), z(4, 2), z(1, 2), z(2, 4, 2))
    with pytest.raises(ValueError, match="cuda or cpu"):
        dmp_marginals(*(t.to("meta") for t in (z(2, 4, 3), z(2, 4, 3), z(4, 2), z(4, 2),
                                               z(1, 2), z(4, 2, 2))))


def test_k4_kernel_path_refuses_int64_indices_theta_over_itself_and_strided_rates():
    """What K4's kernel path refuses beyond the checks every kernel shares
    (``tests/test_torch_kernels.py``), on CPU tensors: int64 edge indices,
    theta at t + 1 written over theta at t, and rates strided along their
    last axis."""
    args = _step_args()
    with pytest.raises(TypeError, match="int32"):
        k4._launch_step(**{**args, "src": args["src"].long()})
    with pytest.raises(ValueError, match="beside"):
        k4._launch_step(**{**args, "theta_next": args["theta"]})
    with pytest.raises(ValueError, match="rates contiguous"):
        k4._launch_step(**{**args, "gamma": torch.zeros(2, 4).t()})


def test_cpu_calls_are_not_counted():
    launches = (dmp_step.launches, dmp_marginals.launches)
    edges = _edges(True)
    dmp.dmp_recursion(edges, *_rates("edge", 2, edges), max_time=4)
    assert (dmp_step.launches, dmp_marginals.launches) == launches
    out, pair = torch.empty(2, 3, 3), torch.empty(3, 2, 2)
    dmp_marginals_plain(out, torch.zeros(2, 3, 3), torch.ones(3, 2), torch.ones(3, 2),
                        torch.zeros(1, 2), pair)
    assert torch.equal(out[..., 0], torch.ones(2, 3)) and torch.equal(pair, torch.ones(3, 2, 2))


def test_k4_and_k5_share_one_library(monkeypatch, tmp_path):
    """Entry points of one source share its library, named after the source,
    and a build starts one nvcc for it; the other kernels keep their names."""
    assert _kernels.library_path("dmp_edge_step") == _kernels.library_path("dmp_marginals")
    assert _kernels.library_path("dmp_marginals").name.startswith("libdmp_step-")
    for name in ("spmm2", "sir_step", "gnode_step"):
        assert _kernels.library_path(name).name.startswith(f"lib{name}-")
    started = []

    class Nvcc:
        returncode = 0

        def __init__(self, cmd, **kwargs):
            started.append(cmd)
            open(cmd[cmd.index("-o") + 1], "wb").close()

        def communicate(self):
            return "", None

    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_kernels.subprocess, "Popen", Nvcc)
    report = _kernels.build_all(["dmp_edge_step", "dmp_marginals"])
    assert len(started) == 1 and started[0][-1].endswith("dmp_step.cu")
    assert list(report) == ["dmp_marginals"]
    assert _kernels.library_path("dmp_edge_step").exists()
    assert _kernels.build_all(["dmp_edge_step"]) == {}
