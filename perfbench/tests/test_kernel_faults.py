"""The faults and the control planted on the kernels that the serving
windows time, on the CPU, where K3, K4 and K5 take their plain versions
from the same call sites: under each, the program keeps its fused path
(``models.dmp._fused()``, ``GNODE._fused_forward``), the planted call site
runs as often as in a sound forward, and the output changes."""

import numpy as np
import pytest
import torch

from perfbench import faults, harness, inputs
from perfbench.tests import small

torch.set_num_threads(1)


def _program(cell: str):
    """The driver, and the model, parameters and adjacency its set-up built
    at the small size, with one batch of scenarios from the seed."""
    wl, cfg = small.cell(cell)
    driver = harness.load_module("drivers", wl["driver"])
    st = driver.setup(cfg, wl["traffic"], small.SEED, "cpu")
    n = st.graph["n"]
    scen = inputs.trials(np.random.default_rng(small.SEED), n, 4, 2, [0.1, 0.5], [0.1, 0.5])
    i0 = torch.zeros((len(scen), n))
    for j, s in enumerate(scen):
        i0[j, s[0]] = 1.0
    rates = torch.tensor([[s[1] for s in scen], [s[2] for s in scen]], dtype=torch.float32)
    p = st.program
    args = (p.get("params", {}), p["adj"], 1.0 - i0, i0, torch.zeros_like(i0), *rates)
    return driver, p["model"], args


def _counted(module, name: str, run):
    """``run()`` with ``module.<name>`` counted: (its output, the calls)."""
    calls, inner = [], getattr(module, name)

    def count(*a, **k):
        calls.append(1)
        return inner(*a, **k)

    with faults._patched(module, name, count):
        return run(), len(calls)


@pytest.mark.parametrize("kind,fault", [("fault", "state_unchanged"), ("fault", "backtracking"),
                                        ("control", None)])
def test_dmp_fault_runs_on_k4_and_changes_the_output(kind, fault):
    from gn_ode_sir_tpu_torch.models import dmp

    driver, model, args = _program("dmp_enron.serve_b128")
    predict = lambda: model.predict(*args)
    sound, steps = _counted(dmp, "dmp_step", predict)
    planted = driver.plant(fault) if fault else driver.control_run(kind)[0]
    with planted:
        assert dmp._fused()
        out, calls = _counted(dmp, "dmp_step", predict)
    assert calls == steps == model.max_time - 1
    assert float((out - sound).abs().max()) > 1e-6
    assert torch.equal(predict(), sound)  # the plant is gone with its context


def test_serving_state_unchanged_runs_on_k3_and_changes_the_output():
    from gn_ode_sir_tpu_torch.models import gnode

    driver, model, args = _program("c7_enron.serve_b8")
    params, _, s0, i0, r0, *_ = args
    predict = lambda: model.predict(*args)
    with torch.no_grad():
        sound, steps = _counted(gnode, "gnode_step", predict)
        with driver.plant("state_unchanged"):
            assert model._fused_forward(params, (s0, i0, r0))
            out, calls = _counted(gnode, "gnode_step", predict)
        assert calls == steps > 0
        assert float((out - sound).abs().max()) > 1e-3
        assert torch.equal(predict(), sound)
