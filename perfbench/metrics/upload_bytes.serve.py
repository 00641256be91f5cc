"""Bytes copied host to device per request: the program's counter
``cli.infer._upload.upload_bytes`` over ``_upload.calls``, i.e. over every
dispatch of the process (warm-up, window and profiled stretch, all of the
cell's one shape), times the dispatches of a request. None off the card or
where the program has no such counter."""


def read(run):
    from gn_ode_sir_tpu_torch.cli import infer

    upload = getattr(infer, "_upload", None)
    calls = getattr(upload, "calls", 0)
    if not run.on_card or not calls:
        return None
    per, cap = run.traffic["scenarios_per_request"], run.traffic["dispatch_batch"]
    return upload.upload_bytes / calls * -(-per // cap)
