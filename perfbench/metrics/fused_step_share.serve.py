"""The share of K1's applies whose euler SIR update ran in K3, the fused
step of ``gn_ode_sir_tpu_torch/csrc/gnode_step.cu``: the program's counter
``ops.gnode_step.gnode_step.launches`` over ``ops.spmm2.spmm2.launches``,
over the whole serving process (warm-up, window and profiled stretch), %.
100 where every field evaluation of every dispatch took the fused step.
None off the card, before K1 has launched, or where the program has no
such counter."""


def read(run):
    from gn_ode_sir_tpu_torch.ops.spmm2 import spmm2

    try:
        from gn_ode_sir_tpu_torch.ops.gnode_step import gnode_step
    except ModuleNotFoundError:
        return None
    launches = getattr(gnode_step, "launches", None)
    if not run.on_card or launches is None or not spmm2.launches:
        return None
    return 100.0 * launches / spmm2.launches
