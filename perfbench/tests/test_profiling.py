"""The trace reduction: busy time as the union of spans, annotations left
out, kernels with lambdas in their names kept, idle gaps named by the host."""

from types import SimpleNamespace

from torch.autograd import DeviceType

from perfbench import profiling


def _evt(name, start, end, device=DeviceType.CUDA, parent=None, annotation=False):
    return SimpleNamespace(name=name, device_type=device, cpu_parent=parent,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def test_reduce_and_read():
    events = [
        _evt("spmm2_segment_kernel<float>", 0, 10),
        _evt("spmm2_narrow_fixup_kernel<4>", 5, 12),  # overlaps its segment kernel (PDL)
        _evt("direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}", 30, 40),
        _evt("Optimizer.step#Adam.step", 0, 100),  # spans idle time: left out
        _evt("annotated range", 0, 100, annotation=True),
        _evt("Memcpy DtoH (Device -> Pageable)", 60, 70),
        _evt("aten::mul", 12, 28, device=DeviceType.CPU),
        _evt("aten::add", 41, 44, device=DeviceType.CPU),
        _evt("cudaLaunchKernel", 13, 14, device=DeviceType.CPU, parent=object()),
    ]
    trace = profiling.reduce_events(events, wall_s=100e-6)
    assert [n for n, _, _ in trace.device_ops][0].startswith("spmm2_segment")
    assert len(trace.device_ops) == 4 and len(trace.host_ops) == 2
    assert trace.busy_s() == 32e-6  # [0, 12] + [30, 40] + [60, 70]
    assert trace.busy_s(lambda n: "spmm2" in n) == 12e-6
    assert trace.count(profiling.is_kernel) == 3
    assert dict(profiling.idle_gaps(trace)) == {"aten::mul": 18e-6,
                                                "host between operations": 20e-6}
    out = profiling.breakdown(trace)
    assert out["device_ops"][0][1] == 10e-6 and len(out["idle_gaps"]) == 2
