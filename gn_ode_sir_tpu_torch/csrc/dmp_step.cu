// K4 and K5 on Hopper: DMP's time step around the node product, fused.
//
// One step of the recursion from t - 1 to t, per scenario b, takes the node
// product node[i, b] = prod over edges k -> i of theta_ki(t) (PyTorch's
// scatter_reduce_, ops/segment.py) and then
//
//   K5, per node i (the marginals, written into out[t] [B, n, 3]):
//     Ps = Ps(0) * node,  Pr = Pr(t-1) + gamma * Pi(t-1),  Pi = (1 - Ps) - Pr
//     and (node, Ps(0)) side by side into pair [n, B, 2], for K4
//   K4, per directed edge e = i -> j (the edge state, in one pass):
//     Ps_ij   = Ps_i(0) * (node[i] / theta[reverse(e)])   (1 where e has none)
//     phi     = decay * phi - (Ps_ij - Ps_ij(t-1)),   decay = (1 - w)(1 - gamma_i)
//     theta'  = theta - w * phi                        (theta at t + 1)
//
// The state is scenario-minor: theta, phi and Ps_ij are [E, B], the node
// product, Ps(0) and the pair [n, B], row-major. phi and Ps_ij are updated in
// place; theta at t + 1 goes to a second buffer, because the cavity gather
// reads other edges' theta at t. The last step of a recursion writes no
// theta'. The rates are per scenario (row stride 0) or per edge / per node.
//
// They replace no TPU kernel: the JAX package leaves DMP's step to XLA,
// which fuses the elementwise ops on the TPU; in eager PyTorch the step was
// about twelve passes over the edge state (two gathers, adds, multiplies, the
// division) and six node-sized kernels and a strided stack for the
// marginals. Bound (H100 SXM): K4 reads theta, phi and Ps_ij once and writes
// phi, Ps_ij and theta' once (24 B an edge update): 1.11 GB at
// [361,622, 128], 0.33 ms at 3.35 TB/s. Its thread index is flattened over
// [E, B], so a warp's lanes walk the scenarios of one edge (at B = 1, one
// edge a lane): the three streams are coalesced along B, each lane reads src
// and rev once per edge it touches, and its two gathers, theta of the
// reverse edge and (node, Ps(0)) at the source, read contiguous rows of B
// scenarios (512 B and 1 KB at B = 128) that a warp shares, not an element a
// cache line as the scenario-major layout did (40% of the bound there). One
// 8-byte load of the pair that K5 writes serves node and Ps(0). Each thread
// takes kElementsPerThread elements a block apart and loads them all before it
// computes, so that several loads are in flight.
//
// K5 reads Ps(0), the node product and out[t-1]'s Pi and Pr and writes out[t]
// and the pair: 36 B a node and scenario, 0.046 ms at [33,696, 128]. It turns
// [n, B] into [B, n, 3] through shared memory, a tile of kTile nodes by kTile
// scenarios a block: the node-side arrays are read and the pair written with
// the lanes along the scenarios, the rows of out[t-1] read and those of out[t]
// written with the lanes along a scenario's 3 * kTile contiguous floats.
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
constexpr int kElementsPerThread = 4;
constexpr int kTile = 32;                     // K5: nodes and scenarios of a tile
constexpr int kTileRows = kThreads / kTile;   // K5: warps of a block
constexpr int kMaxGridY = 65535;

template <bool kWriteTheta>
__global__ void __launch_bounds__(kThreads)
dmp_edge_kernel(const float* __restrict__ theta, float* __restrict__ theta_next,
                float* __restrict__ phi, float* __restrict__ ps_ij,
                const float2* __restrict__ pair, const int* __restrict__ src,
                const int* __restrict__ rev,
                const float* __restrict__ w, long long w_se, int w_sb,
                const float* __restrict__ gamma, long long g_sn, int g_sb, int batch,
                long long total, int step_e, int step_b) {
  const long long first = static_cast<long long>(blockIdx.x) * kThreads * kElementsPerThread +
                          threadIdx.x;
  if (first >= total) return;
  // the element's (edge, scenario); a 32-bit division where the state allows
  int e = static_cast<int>(total <= 0xffffffffLL
                               ? static_cast<unsigned>(first) / static_cast<unsigned>(batch)
                               : first / batch);
  int b = static_cast<int>(first - static_cast<long long>(e) * batch);
  constexpr int kPer = kElementsPerThread;
  int ek[kPer], bk[kPer], s[kPer], r[kPer];
  float own[kPer], cav[kPer], f[kPer], old[kPer], wv[kPer], gv[kPer], nv[kPer], pv[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {  // kThreads elements on: step_e edges and step_b scenarios
    ek[k] = e;
    bk[k] = b;
    e += step_e;
    b += step_b;
    if (b >= batch) {
      b -= batch;
      ++e;
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long at = first + k * kThreads;
    if (at < total) {
      s[k] = __ldg(src + ek[k]);
      r[k] = __ldg(rev + ek[k]);
      if (kWriteTheta) own[k] = theta[at];
      f[k] = phi[at];
      old[k] = ps_ij[at];
      wv[k] = __ldg(w + ek[k] * w_se + bk[k] * w_sb);
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (first + k * kThreads < total) {
      cav[k] = r[k] < 0 ? 1.0f : theta[static_cast<long long>(r[k]) * batch + bk[k]];
      const float2 q = __ldg(pair + static_cast<long long>(s[k]) * batch + bk[k]);
      nv[k] = q.x;
      pv[k] = q.y;
      gv[k] = __ldg(gamma + s[k] * g_sn + bk[k] * g_sb);
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long at = first + k * kThreads;
    if (at < total) {
      const float next = __fmul_rn(pv[k], __fdiv_rn(nv[k], cav[k]));
      const float decay = __fmul_rn(__fsub_rn(1.0f, wv[k]), __fsub_rn(1.0f, gv[k]));
      const float p = __fsub_rn(__fmul_rn(decay, f[k]), __fsub_rn(next, old[k]));
      phi[at] = p;
      ps_ij[at] = next;
      if (kWriteTheta) theta_next[at] = __fsub_rn(own[k], __fmul_rn(wv[k], p));
    }
  }
}

// A block of kTile x kTileRows threads: threadIdx.x a lane, threadIdx.y a warp.
__global__ void __launch_bounds__(kThreads)
dmp_marginals_kernel(float* __restrict__ out, const float* __restrict__ prev,
                     const float* __restrict__ node, const float* __restrict__ ps0,
                     float2* __restrict__ pair, const float* __restrict__ gamma, long long g_sn,
                     int g_sb, int batch, int n) {
  __shared__ float ps[kTile][kTile + 1], g[kTile][kTile + 1];  // [node][scenario]
  __shared__ float rows[kTile][3 * kTile + 1];                // [scenario][3 * node + S, I, R]
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int i0 = blockIdx.x * kTile;
  const int nodes = min(kTile, n - i0);
  for (int b0 = blockIdx.y * kTile; b0 < batch; b0 += gridDim.y * kTile) {
    const int scenarios = min(kTile, batch - b0);
    // [n, B]: a warp along the scenarios of a node
    for (int r = warp; r < nodes; r += kTileRows) {
      if (lane < scenarios) {
        const int i = i0 + r, b = b0 + lane;
        const long long at = static_cast<long long>(i) * batch + b;
        const float nd = node[at], p0 = __ldg(ps0 + at);
        pair[at] = make_float2(nd, p0);
        ps[r][lane] = __fmul_rn(p0, nd);
        g[r][lane] = __ldg(gamma + i * g_sn + b * g_sb);
      }
    }
    // [B, n, 3]: a warp along a scenario's row of out[t - 1]
    for (int r = warp; r < scenarios; r += kTileRows) {
      const float* const row = prev + (static_cast<long long>(b0 + r) * n + i0) * 3;
      for (int j = lane; j < 3 * nodes; j += kTile) rows[r][j] = row[j];
    }
    __syncthreads();
    for (int r = warp; r < scenarios; r += kTileRows) {  // scenario r, node lane
      if (lane < nodes) {
        float* const x = rows[r] + 3 * lane;
        const float p = ps[lane][r];
        const float pr = __fadd_rn(x[2], __fmul_rn(g[lane][r], x[1]));
        x[0] = p;
        x[1] = __fsub_rn(__fsub_rn(1.0f, p), pr);
        x[2] = pr;
      }
    }
    __syncthreads();
    for (int r = warp; r < scenarios; r += kTileRows) {
      float* const row = out + (static_cast<long long>(b0 + r) * n + i0) * 3;
      for (int j = lane; j < 3 * nodes; j += kTile) row[j] = rows[r][j];
    }
    __syncthreads();  // the next tile of scenarios reuses the shared arrays
  }
}

}  // namespace

// Plain C entry points (bound with ctypes), on the current device, every
// array f32 and contiguous unless a stride says otherwise. Each returns the
// cudaError_t of its launch (0 = ok).
//
// K4. theta: [edges, batch] at t; theta_next: [edges, batch] or null (the
// last step), not overlapping theta; phi, ps_ij: [edges, batch], updated in
// place; pair: [n, batch, 2], (node, Ps(0)) as K5 writes it; src, rev: int32
// [edges], rev -1 where the edge has no reverse edge; w[e * w_se + b * w_sb],
// gamma[i * g_sn + b * g_sb].
extern "C" int dmp_edge_step(const void* theta, void* theta_next, void* phi, void* ps_ij,
                             const void* pair, const void* src, const void* rev, const void* w,
                             long long w_se, int w_sb, const void* gamma, long long g_sn,
                             int g_sb, int batch, int edges, int n, void* stream) {
  if (batch <= 0 || edges <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(edges) * batch;
  const long long per_block = static_cast<long long>(kThreads) * kElementsPerThread;
  const dim3 grid(static_cast<unsigned>((total + per_block - 1) / per_block));
  const int step_e = kThreads / batch, step_b = kThreads % batch;
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
        th, static_cast<float*>(theta_next), f, p, np, s, r, wp, w_se, w_sb, gp, g_sn, g_sb,
        batch, total, step_e, step_b);
  } else {
    dmp_edge_kernel<false><<<grid, kThreads, 0, st>>>(
        th, nullptr, f, p, np, s, r, wp, w_se, w_sb, gp, g_sn, g_sb, batch, total, step_e,
        step_b);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5. out, prev: [batch, n, 3] (out[t] and out[t - 1]); node, ps0: [n, batch];
// pair: [n, batch, 2], receives (node, Ps(0)); gamma[i * g_sn + b * g_sb].
extern "C" int dmp_marginals(void* out, const void* prev, const void* node, const void* ps0,
                             void* pair, const void* gamma, long long g_sn, int g_sb, int batch,
                             int n, void* stream) {
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_b = (batch + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>((n + kTile - 1) / kTile),
                  static_cast<unsigned>(tiles_b < kMaxGridY ? tiles_b : kMaxGridY));
  dmp_marginals_kernel<<<grid, dim3(kTile, kTileRows), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<const float*>(prev),
      static_cast<const float*>(node), static_cast<const float*>(ps0),
      static_cast<float2*>(pair), static_cast<const float*>(gamma), g_sn, g_sb, batch, n);
  return static_cast<int>(cudaGetLastError());
}
