// K4 and K5 on Hopper: DMP's time step around the node product, fused.
//
// One step of the recursion from t - 1 to t, per scenario b, takes the node
// product node[b, i] = prod over edges k -> i of theta_ki(t) (PyTorch's
// scatter_reduce_, ops/segment.py) and then
//
//   K5, per node i (the marginals, written into out[t] [B, n, 3]):
//     Ps = Ps(0) * node,  Pr = Pr(t-1) + gamma * Pi(t-1),  Pi = (1 - Ps) - Pr
//     and (node, Ps(0)) side by side into pair [B, n, 2], for K4
//   K4, per directed edge e = i -> j (the edge state, in one pass):
//     Ps_ij   = Ps_i(0) * (node[i] / theta[reverse(e)])   (1 where e has none)
//     phi     = decay * phi - (Ps_ij - Ps_ij(t-1)),   decay = (1 - w)(1 - gamma_i)
//     theta'  = theta - w * phi                        (theta at t + 1)
//
// phi and Ps_ij are updated in place; theta at t + 1 goes to a second buffer,
// because the cavity gather reads other edges' theta at t. The last step of
// a recursion writes no theta'. The rates are per scenario (element stride 0)
// or per edge / per node (stride 1).
//
// They replace no TPU kernel: the JAX package leaves DMP's step to XLA,
// which fuses the elementwise ops on the TPU; in eager PyTorch the step was
// about twelve passes over [B, E] (two gathers, adds, multiplies, the
// division) and six node-sized kernels and a strided stack for the
// marginals. Bound (H100 SXM): K4 reads theta, phi and Ps_ij once and writes
// phi, Ps_ij and theta' once (24 B an edge update; the int32 edge indices, 8 B
// an edge, are read again by each scenario, from L2): 1.11 GB at
// [128, 361,622], 0.33 ms at 3.35 TB/s, 0.40-0.44 ms with the indices. The
// edges are sorted by destination, so its two gathers, theta of the reverse
// edge and (node, Ps(0)) at the source, are random within a scenario's row:
// each element is a cache line of its own, and L1's throughput of such lines,
// not HBM, is what bounds them. So the gathers are as few as they can be: one
// 8-byte load of the pair that K5 writes serves node and Ps(0) (two 4-byte
// gathers took 0.27 ms more a step on an H100 at [128, 361,000]), and the
// gathered rows stay in the 50 MB L2: blockIdx.x walks the edges and
// blockIdx.y the scenarios, so the blocks in flight share one or two
// scenarios, whose theta row (1.45 MB at enron) and pair row (270 KB) L2
// holds. Each thread takes kEdgesPerThread edges a block apart and loads them
// all before it computes, so that every stream access is coalesced and
// several are in flight. K5 reads Ps(0), the node product and out[t-1]'s Pi
// and Pr and writes out[t] and the pair: 36 B a node, 0.046 ms at
// [128, 33,696] at 3.35 TB/s.
//
// Every product, quotient and difference is written with an explicitly
// rounded intrinsic, in the plain ops' order: nvcc would contract
// decay * phi - d and theta - w * phi into fused multiply-adds, which round
// once where the plain ops (separate kernels) round twice. So, fed the same
// node product, the kernels give the bits of their plain versions,
// ops/dmp_step.py.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEdgesPerThread = 4;
constexpr int kMaxGridY = 65535;

template <bool kWriteTheta>
__global__ void __launch_bounds__(kThreads)
dmp_edge_kernel(const float* __restrict__ theta, float* __restrict__ theta_next,
                float* __restrict__ phi, float* __restrict__ ps_ij,
                const float2* __restrict__ pair, const int* __restrict__ src,
                const int* __restrict__ rev,
                const float* __restrict__ w, long long w_sb, int w_se,
                const float* __restrict__ gamma, long long g_sb, int g_sn, int batch,
                int edges, int n) {
  const long long first = static_cast<long long>(blockIdx.x) * kThreads * kEdgesPerThread +
                          threadIdx.x;
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const long long row = static_cast<long long>(b) * edges;
    const float* const th = theta + row;
    const float2* const np = pair + static_cast<long long>(b) * n;
    int s[kEdgesPerThread], r[kEdgesPerThread];
    float own[kEdgesPerThread], cav[kEdgesPerThread], f[kEdgesPerThread],
        old[kEdgesPerThread], wv[kEdgesPerThread], gv[kEdgesPerThread],
        nv[kEdgesPerThread], pv[kEdgesPerThread];
#pragma unroll
    for (int k = 0; k < kEdgesPerThread; ++k) {
      const long long e = first + k * kThreads;
      if (e < edges) {
        s[k] = __ldg(src + e);
        r[k] = __ldg(rev + e);
        if (kWriteTheta) own[k] = th[e];
        f[k] = phi[row + e];
        old[k] = ps_ij[row + e];
        wv[k] = __ldg(w + b * w_sb + e * w_se);
      }
    }
#pragma unroll
    for (int k = 0; k < kEdgesPerThread; ++k) {
      const long long e = first + k * kThreads;
      if (e < edges) {
        cav[k] = r[k] < 0 ? 1.0f : th[r[k]];
        const float2 q = __ldg(np + s[k]);
        nv[k] = q.x;
        pv[k] = q.y;
        gv[k] = __ldg(gamma + b * g_sb + static_cast<long long>(s[k]) * g_sn);
      }
    }
#pragma unroll
    for (int k = 0; k < kEdgesPerThread; ++k) {
      const long long e = first + k * kThreads;
      if (e < edges) {
        const float next = __fmul_rn(pv[k], __fdiv_rn(nv[k], cav[k]));
        const float decay = __fmul_rn(__fsub_rn(1.0f, wv[k]), __fsub_rn(1.0f, gv[k]));
        const float p = __fsub_rn(__fmul_rn(decay, f[k]), __fsub_rn(next, old[k]));
        phi[row + e] = p;
        ps_ij[row + e] = next;
        if (kWriteTheta) theta_next[row + e] = __fsub_rn(own[k], __fmul_rn(wv[k], p));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dmp_marginals_kernel(float* __restrict__ out, const float* __restrict__ prev,
                     const float* __restrict__ node, const float* __restrict__ ps0,
                     float2* __restrict__ pair, const float* __restrict__ gamma, long long g_sb,
                     int g_sn, int batch, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const long long at = static_cast<long long>(b) * n + i;
    const float nd = node[at], p0 = __ldg(ps0 + at);
    const float ps = __fmul_rn(p0, nd);
    const float g = __ldg(gamma + b * g_sb + static_cast<long long>(i) * g_sn);
    const float pr = __fadd_rn(prev[3 * at + 2], __fmul_rn(g, prev[3 * at + 1]));
    const float pi = __fsub_rn(__fsub_rn(1.0f, ps), pr);
    out[3 * at] = ps;
    out[3 * at + 1] = pi;
    out[3 * at + 2] = pr;
    pair[at] = make_float2(nd, p0);
  }
}

inline unsigned grid_y(int batch) {
  return static_cast<unsigned>(batch < kMaxGridY ? batch : kMaxGridY);
}

}  // namespace

// Plain C entry points (bound with ctypes), on the current device, every
// array f32 and contiguous unless a stride says otherwise. Each returns the
// cudaError_t of its launch (0 = ok).
//
// K4. theta: [batch, edges] at t; theta_next: [batch, edges] or null (the
// last step), not overlapping theta; phi, ps_ij: [batch, edges], updated in
// place; pair: [batch, n, 2], (node, Ps(0)) as K5 writes it; src, rev: int32
// [edges], rev -1 where the edge has no reverse edge; w[b * w_sb + e * w_se],
// gamma[b * g_sb + i * g_sn].
extern "C" int dmp_edge_step(const void* theta, void* theta_next, void* phi, void* ps_ij,
                             const void* pair, const void* src, const void* rev, const void* w,
                             long long w_sb, int w_se, const void* gamma, long long g_sb,
                             int g_sn, int batch, int edges, int n, void* stream) {
  if (batch <= 0 || edges <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long per_block = static_cast<long long>(kThreads) * kEdgesPerThread;
  const dim3 grid(static_cast<unsigned>((edges + per_block - 1) / per_block), grid_y(batch));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* th = static_cast<const float*>(theta);
  auto* f = static_cast<float*>(phi);
  auto* p = static_cast<float*>(ps_ij);
  const auto* np = static_cast<const float2*>(pair);
  const auto* s = static_cast<const int*>(src);
  const auto* r = static_cast<const int*>(rev);
  const auto* wp = static_cast<const float*>(w);
  const auto* gp = static_cast<const float*>(gamma);
  if (theta_next != nullptr) {
    dmp_edge_kernel<true><<<grid, kThreads, 0, st>>>(
        th, static_cast<float*>(theta_next), f, p, np, s, r, wp, w_sb, w_se, gp, g_sb, g_sn,
        batch, edges, n);
  } else {
    dmp_edge_kernel<false><<<grid, kThreads, 0, st>>>(
        th, nullptr, f, p, np, s, r, wp, w_sb, w_se, gp, g_sb, g_sn, batch, edges, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5. out, prev: [batch, n, 3] (out[t] and out[t - 1]); node, ps0: [batch, n];
// pair: [batch, n, 2], receives (node, Ps(0)); gamma[b * g_sb + i * g_sn].
extern "C" int dmp_marginals(void* out, const void* prev, const void* node, const void* ps0,
                             void* pair, const void* gamma, long long g_sb, int g_sn, int batch,
                             int n, void* stream) {
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads), grid_y(batch));
  dmp_marginals_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<const float*>(prev),
      static_cast<const float*>(node), static_cast<const float*>(ps0),
      static_cast<float2*>(pair), static_cast<const float*>(gamma), g_sb, g_sn, batch, n);
  return static_cast<int>(cudaGetLastError());
}
