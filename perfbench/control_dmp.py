"""DMP's faults and control as they were planted before they moved onto K4
(``drivers/serve_dmp.py``): on ``models/dmp.py::_step`` and ``_cavity``,
which send the recursion to ``_step``'s loop instead of the node product,
K5 and K4. The harness no longer uses them. They stay for
``tests/test_torch_dmp_step.py``, which holds that loop, the program's
stopgap path, with them; they go with it.

- ``state_unchanged``: theta held at its value before the first step;
- ``backtracking``: the cavity term left out, Ps_ij from the node's full
  product;
- :func:`bfloat16_edge_state`: theta, phi and Ps_ij rounded to bfloat16
  after every step.
"""

from __future__ import annotations

import torch

from perfbench import faults


def plant(fault: str):
    """The context manager that plants ``fault`` on ``_step`` or ``_cavity``."""
    from gn_ode_sir_tpu_torch.models import dmp

    if fault == "state_unchanged":
        orig = dmp._step

        def held(theta, *a, **k):
            _, *rest = orig(theta, *a, **k)
            return (theta, *rest)

        return faults._patched(dmp, "_step", held)
    if fault == "backtracking":
        return faults._patched(dmp, "_cavity", lambda theta, edges: torch.ones_like(theta))
    raise ValueError(f"unknown fault {fault!r}")


def bfloat16_edge_state():
    """theta, phi and Ps_ij rounded to bfloat16 after every ``_step``, so
    that each step starts from edge state held in bfloat16."""
    from gn_ode_sir_tpu_torch.models import dmp

    orig = dmp._step
    low = lambda x: x.to(torch.bfloat16).to(x.dtype)

    def rounded(*a, **k):
        theta, phi, ps_ij, marg = orig(*a, **k)
        return low(theta), low(phi), low(ps_ij), marg

    return faults._patched(dmp, "_step", rounded)
