// K3 on Hopper: the euler SIR update of the GN-ODE's no-grad forward, fused.
//
//   ds = (-beta * ai) * zs,  di = (-ds) - gamma * zi,  dr = gamma * zi
//   s += dt * ds,  i += dt * di,  r += dt * dr        (in place)
//   at a label time also out[b, node, c, :] = the new (s, i, r)[c][b, node, :]
//
// ai = A @ zi is K1's output; zs, zi are the field's activations, all
// [B, n, h] f32; beta, gamma are per scenario. out is one time slice of the
// decoder's input [T_label, B, n, 3, h], the layout that stacking the three
// channels on the second-to-last axis gives.
//
// It replaces no TPU kernel. The JAX package leaves these elementwise ops to
// XLA, which fuses them on the TPU; in eager PyTorch they are a dozen
// kernels a field evaluation (the derivative's multiplies, negation and
// subtraction, a multiply and an add per channel for the step) plus, after
// the loop, the stacks and the gather of the label times. Bound (H100 SXM):
// bytes. Per element the kernel reads ai, zs, zi, s, i, r once and writes
// s, i, r once (36 B), 12 B more at a label time; at [8, 33,696, 64] that is
// 621 MB, 0.19 ms at 3.35 TB/s (0.25 ms at a label time), against 10 flops
// an element.
//
// Every product and sum is written with an explicitly rounded intrinsic:
// nvcc contracts a * b + c into one fused multiply-add by default, which
// would round once where the plain ops (separate kernels) round twice. So the
// kernel gives the bits of its plain version, ops/gnode_step.py. One thread
// takes four consecutive elements of a row with 16-byte accesses where h is a
// multiple of 4 and every pointer is 16-byte aligned, else one element.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void euler_update(float ai, float zs, float zi, float nbeta,
                                             float gamma, float dt, float& s, float& i,
                                             float& r) {
  const float ds = __fmul_rn(__fmul_rn(nbeta, ai), zs);
  const float gz = __fmul_rn(gamma, zi);
  const float di = __fsub_rn(-ds, gz);
  s = __fadd_rn(s, __fmul_rn(dt, ds));
  i = __fadd_rn(i, __fmul_rn(dt, di));
  r = __fadd_rn(r, __fmul_rn(dt, gz));
}

// blockIdx.x walks a scenario's n * h elements V to a thread (V = 4:
// h % 4 == 0, so a thread's four elements lie in one row); blockIdx.y walks
// the scenarios, gridDim.y apart, so that a batch has no limit of the grid's.
template <int V>
__global__ void __launch_bounds__(kThreads)
gnode_step_kernel(const float* __restrict__ ai, const float* __restrict__ zs,
                  const float* __restrict__ zi, float* s, float* i, float* r,
                  const float* __restrict__ beta, const float* __restrict__ gamma, float dt,
                  float* out, int batch, long long per_scenario, int h) {
  const long long e = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (e >= per_scenario) return;
  // the element's place in a scenario's slice of out: node e / h, column e % h
  const long long node = e / h;
  const long long at_out = node * 3 * h + (e - node * h);
  float* const ch[3] = {s, i, r};
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const long long g = b * per_scenario + e;
    const float nbeta = -__ldg(beta + b);
    const float gm = __ldg(gamma + b);

    float va[V], vs[V], vi[V], vy[3][V];
    if constexpr (V == 4) {
      const float4 a = __ldcs(reinterpret_cast<const float4*>(ai + g));
      const float4 p = __ldcs(reinterpret_cast<const float4*>(zs + g));
      const float4 q = __ldcs(reinterpret_cast<const float4*>(zi + g));
      va[0] = a.x, va[1] = a.y, va[2] = a.z, va[3] = a.w;
      vs[0] = p.x, vs[1] = p.y, vs[2] = p.z, vs[3] = p.w;
      vi[0] = q.x, vi[1] = q.y, vi[2] = q.z, vi[3] = q.w;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float4 y = *reinterpret_cast<const float4*>(ch[c] + g);
        vy[c][0] = y.x, vy[c][1] = y.y, vy[c][2] = y.z, vy[c][3] = y.w;
      }
    } else {
      va[0] = __ldcs(ai + g);
      vs[0] = __ldcs(zs + g);
      vi[0] = __ldcs(zi + g);
#pragma unroll
      for (int c = 0; c < 3; ++c) vy[c][0] = ch[c][g];
    }

#pragma unroll
    for (int k = 0; k < V; ++k) {
      euler_update(va[k], vs[k], vi[k], nbeta, gm, dt, vy[0][k], vy[1][k], vy[2][k]);
    }

    float* const o = out == nullptr ? nullptr : out + b * per_scenario * 3 + at_out;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if constexpr (V == 4) {
        const float4 y = make_float4(vy[c][0], vy[c][1], vy[c][2], vy[c][3]);
        *reinterpret_cast<float4*>(ch[c] + g) = y;
        if (o != nullptr) __stcs(reinterpret_cast<float4*>(o + c * h), y);
      } else {
        ch[c][g] = vy[c][0];
        if (o != nullptr) __stcs(o + c * h, vy[c][0]);
      }
    }
  }
}

inline bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Plain C entry point (bound with ctypes). ai, zs, zi: f32 [batch, n, h];
// s, i, r: f32 [batch, n, h], updated in place; beta, gamma: f32 [batch];
// out: f32 [batch, n, 3, h] or null (no label time). per_scenario = n * h.
// All contiguous on the current device, none overlapping another. Returns
// the cudaError_t of the launch (0 = ok).
extern "C" int gnode_step(const void* ai, const void* zs, const void* zi, void* s, void* i,
                          void* r, const void* beta, const void* gamma, float dt, void* out,
                          int batch, long long per_scenario, int h, void* stream) {
  if (batch <= 0 || h <= 0 || per_scenario <= 0 || per_scenario % h != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = h % 4 == 0 && aligned16(ai) && aligned16(zs) && aligned16(zi) &&
                   aligned16(s) && aligned16(i) && aligned16(r) && aligned16(out);
  const int v = vec ? 4 : 1;
  const long long blocks = (per_scenario / v + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kMaxGridY = 65535;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(batch < kMaxGridY ? batch : kMaxGridY));
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(ai);
  const auto* p = static_cast<const float*>(zs);
  const auto* q = static_cast<const float*>(zi);
  const auto* bp = static_cast<const float*>(beta);
  const auto* gp = static_cast<const float*>(gamma);
  auto* sp = static_cast<float*>(s);
  auto* ip = static_cast<float*>(i);
  auto* rp = static_cast<float*>(r);
  auto* op = static_cast<float*>(out);
  if (vec) {
    gnode_step_kernel<4><<<grid, block, 0, st>>>(a, p, q, sp, ip, rp, bp, gp, dt, op,
                                                 batch, per_scenario, h);
  } else {
    gnode_step_kernel<1><<<grid, block, 0, st>>>(a, p, q, sp, ip, rp, bp, gp, dt, op,
                                                 batch, per_scenario, h);
  }
  return static_cast<int>(cudaGetLastError());
}
