"""Peaks of one NVIDIA H100 SXM5 at its 700 W limit: the values of
``gn_ode_sir_tpu_torch/utils/roofline.py::H100_PEAKS`` (NVIDIA's data sheet,
dense rates), frozen here. The port runs float32 with TF32 off, outside the
tensor cores, so its float32 work is scored against ``f32_flops``; the
label path's count product is int8 on the tensor cores."""

H100 = {
    "f32_flops": 67e12,
    "tf32_flops": 494.7e12,
    "bf16_flops": 989.4e12,
    "int8_ops": 1979e12,
    "hbm_bytes_per_s": 3.35e12,
}
