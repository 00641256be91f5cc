// K1 on Hopper: the A·Z_I SpMM of the GN-ODE vector field.
//
//   out[b, d, :] = sum_{e : dst[e] == d} w[e] * x[b, src[e], :]
//
// Replaces the chunked Pallas TPU kernel
// gn_ode_sir_tpu/ops/pallas_spmm2.py::_kernel (launched by _spmm2_call).
// That kernel recast the segment sum as one-hot [R, K] @ msgs [K, h] matmuls
// over host-built edge chunks, with the gather x[src] * w done beforehand in
// XLA. Its one-hot trick, sublane replication, lane padding and batch fold
// existed only for the TPU compiler; none of it is needed here.
//
// Design: CSR over dst (row_ptr built once on the host from the dst-sorted
// edge list). One warp owns one (scenario b, dst row d) pair: it walks the
// row's edges, 32 edge indices/weights at a time loaded cooperatively and
// broadcast with __shfl_sync, gathers x[b, src[e], :] with coalesced vector
// loads (h = 64: 32 lanes x float2 = one 256-byte row), eight rows in
// flight before it sums them, and accumulates in f32 registers. Each output
// row is written exactly once: no atomics, no zero-fill pass, deterministic
// summation order, and the gather is fused into the reduction. A row without edges writes zeros, so an edgeless graph
// needs no special case.
//
// Bound (H100 SXM, one f32 [n, 64] apply at enron size, n = 33,696,
// E = 361k): reads x 8.6 MB + src 1.45 MB + w 1.45 MB + row_ptr 0.13 MB,
// writes out 8.6 MB: ~20 MB, ~6 us at 3.35 TB/s; 2·E·h = 46 MFLOP, ~0.7 us
// at 67 TFLOP/s f32. Memory-bound: x and out scale with the batch B, the
// index arrays do not. A hub row (enron's largest has ~1.4k edges) is
// walked by one warp alone, eight loads in flight; splitting hubs across
// warps and staging with cp.async/TMA is later work.
//
// bf16 message precision reproduces the JAX rounding exactly:
// message = bf16(bf16(x) * bf16(w)), summed in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kEdgesInFlight = 8;  // row loads a warp issues before summing

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Load VEC consecutive elements of x as floats.
template <typename T, int VEC>
struct LoadVec;

template <>
struct LoadVec<float, 1> {
  static __device__ __forceinline__ void run(const float* p, float* v) {
    v[0] = __ldg(p);
  }
};

template <>
struct LoadVec<float, 2> {
  static __device__ __forceinline__ void run(const float* p, float* v) {
    const float2 f = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = f.x;
    v[1] = f.y;
  }
};

template <>
struct LoadVec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p, float* v) {
    v[0] = __bfloat162float(p[0]);
  }
};

template <>
struct LoadVec<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p, float* v) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = f.x;
    v[1] = f.y;
  }
};

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// x: [batch, n, h] (T = float or bf16), out: [batch, n, h] f32.
// Lane `lane` owns columns c0 + lane*VEC .. +VEC-1 of each 32*VEC-wide tile.
template <typename T, bool BF16_MSG, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm2_csr_kernel(const T* __restrict__ x, const int* __restrict__ row_ptr,
                 const int* __restrict__ src, const float* __restrict__ w,
                 float* __restrict__ out, int n, int h, long long rows_total) {
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= rows_total) return;  // warp-uniform: the whole warp leaves
  const long long b = warp / n;
  const int row = static_cast<int>(warp - b * n);
  const T* xb = x + b * static_cast<long long>(n) * h;
  float* orow = out + warp * static_cast<long long>(h);
  const int start = __ldg(row_ptr + row);
  const int end = __ldg(row_ptr + row + 1);

  for (int c0 = 0; c0 < h; c0 += 32 * VEC) {
    const int c = c0 + lane * VEC;
    const bool active = c < h;  // h % VEC == 0, so the whole vector is in range
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;

    for (int base = start; base < end; base += 32) {
      const int e = base + lane;
      int s_lane = 0;
      float w_lane = 0.f;
      if (e < end) {
        s_lane = __ldg(src + e);
        w_lane = __ldg(w + e);
        if constexpr (BF16_MSG) w_lane = round_bf16(w_lane);
      }
      const int cnt = min(32, end - base);  // warp-uniform
      for (int j0 = 0; j0 < cnt; j0 += kEdgesInFlight) {
        // kEdgesInFlight independent row loads are issued before any is
        // summed, so a long (hub) row is not one memory latency per edge.
        // Lanes past cnt wrap modulo 32 in the shuffle and are masked below.
        int s[kEdgesInFlight];
        float wj[kEdgesInFlight];
        float v[kEdgesInFlight][VEC];
#pragma unroll
        for (int u = 0; u < kEdgesInFlight; ++u) {
          s[u] = __shfl_sync(kFullMask, s_lane, j0 + u);
          wj[u] = __shfl_sync(kFullMask, w_lane, j0 + u);
        }
        if (active) {
#pragma unroll
          for (int u = 0; u < kEdgesInFlight; ++u) {
            if (j0 + u < cnt) {
              LoadVec<T, VEC>::run(xb + static_cast<long long>(s[u]) * h + c, v[u]);
            }
          }
#pragma unroll
          for (int u = 0; u < kEdgesInFlight; ++u) {
            if (j0 + u < cnt) {
#pragma unroll
              for (int k = 0; k < VEC; ++k) {
                // the message is rounded before the sum, as the reference
                // rounds x[src] * w (no fused multiply-add across it)
                if constexpr (BF16_MSG) {
                  acc[k] += round_bf16(__fmul_rn(round_bf16(v[u][k]), wj[u]));
                } else {
                  acc[k] += __fmul_rn(v[u][k], wj[u]);
                }
              }
            }
          }
        }
      }
    }
    if (active) store_vec<VEC>(orow + c, acc);
  }
}

template <typename T, bool BF16_MSG>
cudaError_t launch_typed(const void* x, const void* row_ptr, const void* src,
                         const void* w, void* out, int n, int h, int batch,
                         cudaStream_t stream) {
  const long long rows_total = static_cast<long long>(n) * batch;
  const long long blocks = (rows_total + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kWarpsPerBlock * 32);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  const T* xt = static_cast<const T*>(x);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* sp = static_cast<const int*>(src);
  const float* wp = static_cast<const float*>(w);
  float* op = static_cast<float*>(out);
  if (h % 2 == 0 && xa % (2 * sizeof(T)) == 0 && oa % 8 == 0) {
    spmm2_csr_kernel<T, BF16_MSG, 2><<<grid, block, 0, stream>>>(
        xt, rp, sp, wp, op, n, h, rows_total);
  } else {
    spmm2_csr_kernel<T, BF16_MSG, 1><<<grid, block, 0, stream>>>(
        xt, rp, sp, wp, op, n, h, rows_total);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). x_bf16: x holds bf16 (else f32);
// bf16_msg: round messages to bf16 before the f32 sum. row_ptr is int32
// [n + 1], src int32 [E], w f32 [E], out f32 [batch, n, h]; all contiguous
// on the current device. Returns the cudaError_t of the launch (0 = ok).
extern "C" int gnode_spmm2_csr(const void* x, int x_bf16, int bf16_msg,
                               const void* row_ptr, const void* src,
                               const void* w, void* out, int n, int h,
                               int batch, void* stream) {
  if (n <= 0 || h <= 0 || batch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_bf16) {
    err = bf16_msg ? launch_typed<__nv_bfloat16, true>(x, row_ptr, src, w, out, n, h, batch, s)
                   : launch_typed<__nv_bfloat16, false>(x, row_ptr, src, w, out, n, h, batch, s);
  } else {
    err = bf16_msg ? launch_typed<float, true>(x, row_ptr, src, w, out, n, h, batch, s)
                   : launch_typed<float, false>(x, row_ptr, src, w, out, n, h, batch, s);
  }
  return static_cast<int>(err);
}
