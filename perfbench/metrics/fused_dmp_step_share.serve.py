"""The share of DMP's node products whose step went on in K4, the fused
edge update of ``gn_ode_sir_tpu_torch/csrc/dmp_step.cu``: the program's
counter ``ops.dmp_step.dmp_step.launches`` over ``ops.segment.segment_prod.
calls``, over the whole serving process (warm-up, window and profiled
stretch), %. 100 where every step of every dispatch took K4. None off the
card, before a node product, or where the program has no such counter."""


def read(run):
    from gn_ode_sir_tpu_torch.ops.segment import segment_prod

    try:
        from gn_ode_sir_tpu_torch.ops.dmp_step import dmp_step
    except ModuleNotFoundError:
        return None
    launches = getattr(dmp_step, "launches", None)
    calls = getattr(segment_prod, "calls", None)
    if not run.on_card or launches is None or not calls:
        return None
    return 100.0 * launches / calls
