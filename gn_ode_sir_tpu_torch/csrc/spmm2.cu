// K1 on Hopper: the A·Z_I SpMM of the GN-ODE vector field, forward and (on
// the transpose plan) gradient.
//
//   out[b, d, :] = sum_{e : dst[e] == d} w[e] * x[b, src[e], :]
//
// Replaces the chunked Pallas TPU kernel
// gn_ode_sir_tpu/ops/pallas_spmm2.py::_kernel (launched by _spmm2_call).
// That kernel recast the segment sum as one-hot [R, K] @ msgs [K, h] matmuls
// to feed a matrix unit, multiplying mostly by zeros. Here the work is 2
// operations per 4-8 bytes gathered, so the tensor cores have nothing to do.
//
// What bounds it (H100 SXM, one f32 [n, 64] apply at enron size, n = 33,696,
// E = 361k, largest row 1,436 edges): by the count of bytes it must move (x
// and out 8.6 MB each, indices and weights 2.9 MB) 6 us at 3.35 TB/s; its
// 46 MFLOP take 0.7 us. But a gather kernel really moves E·h·4 = 92 MB of x
// rows per scenario, each row once per edge that names it. One scenario's x
// sits in the 50 MB L2, so that traffic is L2 traffic, and the time is
// set by how many row loads the card keeps in flight, not by the HBM rate.
//
// What the design does about it:
// - A work list of bounded segments (built once per graph on the host,
//   ops/spmm2.py::CsrPlan). Every dst row is one item, except that a row of
//   more than L edges is cut into items of at most L consecutive edges. An
//   item that is a whole row writes out[b, row, :]; an item that is a piece
//   of a long row writes its partial sum to a scratch slot, and a small
//   second kernel adds each long row's slots in segment order. So a hub row
//   is gathered by many warps at once instead of one, its pieces come first
//   in the list so that they are not the tail, and every output element is
//   still written by one thread in an order the plan fixes: no atomics, two
//   launches give the same bits. An edgeless row is an item of no edges and
//   writes zeros.
// - 16-byte loads, several rows per load instruction. Where a row of x is a
//   multiple of 16 bytes (h = 64: 16 lanes x float4, or 8 lanes x 8 bf16),
//   LPR lanes cover one row, so a warp holds 32 / LPR items and one load
//   instruction gathers a row for each; kStepsInFlight such instructions are
//   issued before any is summed. The list is sorted by edge count, so the
//   items of one warp and of one block are equally long. Other widths (odd
//   h, h = 130 bf16) take 2-, 4- or 8-byte loads with the whole warp on one
//   item. A lane adds its item's messages in edge order, so a row that is
//   one item is summed exactly as a sequential loop over the edge list sums
//   it, which keeps the card's result next to the CPU path's.
// - Registers capped (kMinBlocksPerSM) so that 32 warps are resident on an
//   SM: the gather is bound by the loads in flight, not by arithmetic.
// - Indices reused across scenarios. The lanes of an item gather it for
//   kScenariosPerWarp scenarios at once: src and w are read once for the
//   group and a short row still puts several loads in flight. Groups of
//   scenarios are scheduled one after another, so that the x being gathered
//   stays within the L2.
//
// Narrow rows. A row of x shorter than kNarrowRowBytes = 128 bytes (f32
// h <= 31, bf16 h <= 63: every width below the 128-byte rows the design
// above was built for; the multi-graph runs at hidden 8, GIN's first layer
// at 5, the matrix's fold at [32, n, 8]) takes a route of its own. There the
// design above leaves lanes idle (f32 h = 8: 2 of 8 lanes carry data; odd h:
// 5 of 32) and walks a 64-edge item in 32 dependent steps. What bounds the
// narrow route: each (edge, scenario) gathers one 4-124-byte row from the L2,
// one or more 32-byte sector requests apart from every other. At [8, 7,168,
// 8] (201,472 edges) that is 1.6M requests (52 MB) where the bytes the call
// must move take 1.6 us at the HBM rate, at [32, 33,696, 8] (361,622 edges)
// 11.6M (370 MB), so the time is the rate of those requests and the chain of
// dependent loads of the longest item, plus the launch. What the design does
// (measured with scripts/torch_spmm2_tune.py --narrow):
// - Every lane carries data. A lane owns one (work item, scenario, column
//   vector) with the widest load that divides the row (16, 8, 4 or 2 bytes,
//   else scalars): f32 h = 8 is two float4 lanes per scenario, h = 5 five
//   scalar lanes.
// - The lanes of one item span the scenarios of a group (at most
//   kNarrowTeamLanes lanes), so src, w and the work item are read once per
//   group. A group gathers from at most kNarrowGroupBytes of x (a quarter of
//   the L2) and groups run one after another: [8, n, 8] is one group of 8,
//   [32, 33,696, 8] three of 11 (one group of 32 ran 1.35x slower: its x
//   left the L2).
// - kNarrowSteps = 4 row loads in flight per lane. Whole steps take no
//   bounds checks, which holds a lane to 46 registers, so five blocks stay
//   resident on an SM; 3, 6 or 8 steps gained at most 6% on one case and
//   lost up to 20% on another.
// - Long rows' partial sums are added by a second kernel with one lane per
//   (scenario, long row, column vector). It is launched as a programmatic
//   dependent of the segment kernel (PDL): it is scheduled and reads its
//   indices while the segments run, and waits for their writes
//   (griddepcontrol.wait) before it reads the partial sums. Folding it into
//   the segment kernel would need per-row counters that outlive a launch.
// What remains: the request rate. torch.sparse.mm, given x node-major,
// reads an edge's rows of all scenarios as one contiguous run (1 KB at [32,
// n, 8]), where x's [B, n, h] layout puts them 32 rows 1 MB apart; the
// conversion to that layout is not in the library's time.
// Each output element and partial slot is still summed by one thread in edge
// order (slot order in the fixup): the narrow route gives the bits the
// design above gives, and two launches the same bits.
//
// bf16 message precision reproduces the JAX rounding exactly:
// message = bf16(bf16(x) * bf16(w)), summed in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kStepsInFlight = 2;     // gather instructions issued before summing
constexpr int kScenariosPerWarp = 2;  // scenarios that share one read of src and w
constexpr int kMinBlocksPerSM = 8;    // blocks resident on an SM: caps registers at 64

// the narrow route
constexpr int kNarrowRowBytes = 128;   // rows of x shorter than this take the narrow route
constexpr int kNarrowThreads = 256;    // threads of a block
constexpr int kNarrowSteps = 4;        // row loads in flight per lane
constexpr int kNarrowTeamLanes = 64;   // most lanes that share one work item
constexpr int kNarrowMinBlocks = 4;    // blocks resident on an SM: caps registers at 64
constexpr long long kNarrowGroupBytes = 12 << 20;  // most x one group of scenarios gathers from
constexpr int kNarrowFixupOverlap = 1;  // launch the fixup while the segments run (PDL)
constexpr int kNarrowFixupSteps = 8;    // partial sums in flight per lane of the fixup

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// VEC consecutive elements of x: loaded as they lie in memory (one load of
// up to 16 bytes, held in as few registers while it is in flight) and
// widened to floats only where they are summed.
template <typename T, int VEC>
struct RowPiece;

template <>
struct RowPiece<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void widen(const Raw& r, float* v) { v[0] = r; }
};

template <>
struct RowPiece<float, 2> {
  using Raw = float2;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  static __device__ __forceinline__ void widen(const Raw& r, float* v) {
    v[0] = r.x;
    v[1] = r.y;
  }
};

template <>
struct RowPiece<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void widen(const Raw& r, float* v) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
};

__device__ __forceinline__ void widen_bf16x2(unsigned bits, float* v) {
  v[0] = __uint_as_float(bits << 16);          // the low half is the first element
  v[1] = __uint_as_float(bits & 0xffff0000u);  // bf16 is the top half of an f32
}

template <>
struct RowPiece<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) { return p[0]; }
  static __device__ __forceinline__ void widen(const Raw& r, float* v) {
    v[0] = __bfloat162float(r);
  }
};

template <>
struct RowPiece<__nv_bfloat16, 2> {
  using Raw = unsigned;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned*>(p));
  }
  static __device__ __forceinline__ void widen(const Raw& r, float* v) { widen_bf16x2(r, v); }
};

template <>
struct RowPiece<__nv_bfloat16, 4> {
  using Raw = uint2;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ void widen(const Raw& r, float* v) {
    widen_bf16x2(r.x, v);
    widen_bf16x2(r.y, v + 2);
  }
};

template <>
struct RowPiece<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void widen(const Raw& r, float* v) {
    widen_bf16x2(r.x, v);
    widen_bf16x2(r.y, v + 2);
    widen_bf16x2(r.z, v + 4);
    widen_bf16x2(r.w, v + 6);
  }
};

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      *reinterpret_cast<float4*>(p + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    }
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// LPR lanes per (work item, group of scenarios): a warp takes 32 / LPR items
// that stand side by side in the list. x: [batch, n, h] (T = float or bf16);
// out: [batch, n, h] f32; partial: [batch, n_slots, h] f32. work[i] = {first
// edge, edge count, dst row, slot}: slot < 0 writes out[b, row, :], else
// partial[b, slot, :]. Each lane owns VEC columns of every LPR * VEC-wide
// column tile and adds its item's messages in edge order, as a sequential
// sum would. No lane waits for another, so each leaves when it is done.
template <typename T, bool BF16_MSG, int VEC, int LPR>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocksPerSM)
spmm2_segment_kernel(const T* __restrict__ x, const int4* __restrict__ work,
                     const int* __restrict__ src, const float* __restrict__ w,
                     float* __restrict__ out, float* __restrict__ partial,
                     int n, int h, int batch, int n_work, int n_slots,
                     int item_blocks) {
  constexpr int G = kScenariosPerWarp;
  constexpr int U = kStepsInFlight;
  constexpr int kItemsPerBlock = kWarpsPerBlock * 32 / LPR;
  const int group = blockIdx.x / item_blocks;
  const int item = (blockIdx.x - group * item_blocks) * kItemsPerBlock + threadIdx.x / LPR;
  if (item >= n_work) return;
  const int lane_col = (threadIdx.x % LPR) * VEC;
  const int4 it = __ldg(work + item);
  const int end = it.x + it.y;

  const T* xb[G];
  float* ob[G];
  bool live[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const long long b = static_cast<long long>(group) * G + g;
    live[g] = b < batch;
    const long long bb = live[g] ? b : 0;
    xb[g] = x + bb * n * h;
    ob[g] = it.w < 0 ? out + (bb * n + it.z) * h : partial + (bb * n_slots + it.w) * h;
  }

  for (int c = lane_col; c < h; c += LPR * VEC) {  // h % VEC == 0: whole vectors
    float acc[G][VEC];
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[g][k] = 0.f;
    }

    for (int e0 = it.x; e0 < end; e0 += U) {
      // U * G independent row loads are issued before any is summed
      long long off[U];
      float wj[U];
      typename RowPiece<T, VEC>::Raw raw[U][G];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (e0 + u < end) {
          off[u] = static_cast<long long>(__ldg(src + e0 + u)) * h + c;
          wj[u] = __ldg(w + e0 + u);
          if constexpr (BF16_MSG) wj[u] = round_bf16(wj[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (e0 + u < end && live[g]) raw[u][g] = RowPiece<T, VEC>::load(xb[g] + off[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (e0 + u < end && live[g]) {
            float v[VEC];
            RowPiece<T, VEC>::widen(raw[u][g], v);
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
              // the message is rounded before the sum, as the reference
              // rounds x[src] * w (no fused multiply-add across it)
              if constexpr (BF16_MSG) {
                acc[g][k] += round_bf16(__fmul_rn(round_bf16(v[k]), wj[u]));
              } else {
                acc[g][k] += __fmul_rn(v[k], wj[u]);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (live[g]) store_vec<VEC>(ob[g] + c, acc[g]);
    }
  }
}

// One warp per (scenario, long row): out[b, row, :] = the row's partial sums
// added in segment order. fix_row[j] is the j-th long row, its slots are
// fix_ptr[j] .. fix_ptr[j + 1] - 1.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm2_fixup_kernel(const float* __restrict__ partial, const int* __restrict__ fix_row,
                   const int* __restrict__ fix_ptr, float* __restrict__ out, int n,
                   int h, int n_fix, int n_slots, long long warps_total) {
  constexpr int U = 8;
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= warps_total) return;
  const int lane = threadIdx.x & 31;
  const long long b = warp / n_fix;
  const int j = static_cast<int>(warp - b * n_fix);
  const int s0 = __ldg(fix_ptr + j);
  const int s1 = __ldg(fix_ptr + j + 1);
  const float* p = partial + b * n_slots * h;
  float* o = out + (b * n + __ldg(fix_row + j)) * h;
  for (int c = lane; c < h; c += 32) {
    float acc = 0.f;
    for (int s = s0; s < s1; s += U) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (s + u < s1) v[u] = p[static_cast<long long>(s + u) * h + c];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (s + u < s1) acc += v[u];
      }
    }
    o[c] = acc;
  }
}

// U edges of one lane of the narrow route, e0 .. e0 + U - 1 (WHOLE) or those
// of them before `end`: the U row loads are issued before any is summed.
template <typename T, bool BF16_MSG, int VEC, int U, bool WHOLE>
__device__ __forceinline__ void narrow_step(const T* __restrict__ xb, const int* __restrict__ src,
                                            const float* __restrict__ w, int e0, int end, int h,
                                            float* acc) {
  typename RowPiece<T, VEC>::Raw raw[U];
  float wj[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (WHOLE || e0 + u < end) {
      raw[u] = RowPiece<T, VEC>::load(xb + static_cast<long long>(__ldg(src + e0 + u)) * h);
      wj[u] = __ldg(w + e0 + u);
      if constexpr (BF16_MSG) wj[u] = round_bf16(wj[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (WHOLE || e0 + u < end) {
      float v[VEC];
      RowPiece<T, VEC>::widen(raw[u], v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        // the message is rounded before the sum, as in the segment kernel
        if constexpr (BF16_MSG) {
          acc[k] += round_bf16(__fmul_rn(round_bf16(v[k]), wj[u]));
        } else {
          acc[k] += __fmul_rn(v[k], wj[u]);
        }
      }
    }
  }
}

// The narrow route: one lane per (work item, scenario, column vector of VEC
// elements). Lanes are numbered group-major: the groups of `scen`
// scenarios one after another, within a group a team of `team` = scen *
// pieces lanes per item in list order, `pieces` = h / VEC lanes per
// scenario. Each lane adds its item's messages in edge order, kNarrowSteps
// rows in flight.
template <typename T, bool BF16_MSG, int VEC>
__global__ void __launch_bounds__(kNarrowThreads, kNarrowMinBlocks)
spmm2_narrow_kernel(const T* __restrict__ x, const int4* __restrict__ work,
                    const int* __restrict__ src, const float* __restrict__ w,
                    float* __restrict__ out, float* __restrict__ partial, int n, int h,
                    int batch, int n_work, int n_slots, int pieces, int scen,
                    long long lanes_total) {
  constexpr int U = kNarrowSteps;
  // the fixup of this apply may be scheduled now: it waits for this grid's
  // writes before it reads them (no-op when it was launched without PDL)
  if constexpr (kNarrowFixupOverlap) asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const long long lane = static_cast<long long>(blockIdx.x) * kNarrowThreads + threadIdx.x;
  if (lane >= lanes_total) return;
  const int team = scen * pieces;
  const long long pair = lane / team;  // (group, item)
  const int r = static_cast<int>(lane - pair * team);
  const int group = static_cast<int>(pair / n_work);
  const int item = static_cast<int>(pair - static_cast<long long>(group) * n_work);
  const int g = r / pieces;
  const long long b = static_cast<long long>(group) * scen + g;
  if (b >= batch) return;
  const int c = (r - g * pieces) * VEC;
  const int4 it = __ldg(work + item);
  const int end = it.x + it.y;
  const T* xb = x + b * n * h + c;
  float* o = (it.w < 0 ? out + (b * n + it.z) * h : partial + (b * n_slots + it.w) * h) + c;

  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  int e0 = it.x;
  for (; e0 + U <= end; e0 += U) narrow_step<T, BF16_MSG, VEC, U, true>(xb, src, w, e0, end, h, acc);
  if (e0 < end) narrow_step<T, BF16_MSG, VEC, U, false>(xb, src, w, e0, end, h, acc);
  store_vec<VEC>(o, acc);
}

// The narrow route's fixup: one lane per (scenario, long row, column vector
// of VEC elements) adds the row's partial sums in segment order. Launched
// while the segment kernel still runs, it reads its indices, then waits for
// that grid to finish (griddepcontrol.wait: the segment kernel's writes are
// visible after it) and reads the partial sums from the L2.
template <int VEC>
__device__ __forceinline__ void load_partial(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 r = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  } else if constexpr (VEC == 2) {
    const float2 r = __ldcg(reinterpret_cast<const float2*>(p));
    v[0] = r.x;
    v[1] = r.y;
  } else {
    v[0] = __ldcg(p);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kNarrowThreads)
spmm2_narrow_fixup_kernel(const float* __restrict__ partial, const int* __restrict__ fix_row,
                          const int* __restrict__ fix_ptr, float* __restrict__ out, int n,
                          int h, int n_fix, int n_slots, int pieces, long long lanes_total) {
  constexpr int U = kNarrowFixupSteps;
  const long long lane = static_cast<long long>(blockIdx.x) * kNarrowThreads + threadIdx.x;
  if (lane >= lanes_total) return;
  const long long q = lane / pieces;  // (scenario, long row)
  const int c = static_cast<int>(lane - q * pieces) * VEC;
  const long long b = q / n_fix;
  const int j = static_cast<int>(q - b * n_fix);
  const int s0 = __ldg(fix_ptr + j);
  const int s1 = __ldg(fix_ptr + j + 1);
  float* o = out + (b * n + __ldg(fix_row + j)) * h + c;
  const float* p = partial + b * n_slots * h + c;
  if constexpr (kNarrowFixupOverlap) asm volatile("griddepcontrol.wait;" ::: "memory");
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  for (int s = s0; s < s1; s += U) {
    float v[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s + u < s1) load_partial<VEC>(p + static_cast<long long>(s + u) * h, v[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s + u < s1) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += v[u][k];
      }
    }
  }
  store_vec<VEC>(o, acc);
}

struct Args {
  const void* x;
  const void* work;
  const void* src;
  const void* w;
  const void* fix_row;
  const void* fix_ptr;
  void* partial;
  void* out;
  int n, h, batch, n_work, n_fix, n_slots;
  cudaStream_t stream;
};

template <typename T, bool BF16_MSG, int VEC, int LPR>
cudaError_t launch_segments(const Args& a) {
  constexpr int kItemsPerBlock = kWarpsPerBlock * 32 / LPR;
  const int item_blocks = (a.n_work + kItemsPerBlock - 1) / kItemsPerBlock;
  const int groups = (a.batch + kScenariosPerWarp - 1) / kScenariosPerWarp;
  const long long blocks = static_cast<long long>(item_blocks) * groups;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  spmm2_segment_kernel<T, BF16_MSG, VEC, LPR>
      <<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, a.stream>>>(
          static_cast<const T*>(a.x), static_cast<const int4*>(a.work),
          static_cast<const int*>(a.src), static_cast<const float*>(a.w),
          static_cast<float*>(a.out), static_cast<float*>(a.partial), a.n, a.h, a.batch,
          a.n_work, a.n_slots, item_blocks);
  return cudaGetLastError();
}

template <typename T, bool BF16_MSG, int VEC>
cudaError_t launch_narrow_segments(const Args& a) {
  // as many scenarios per item as kNarrowTeamLanes lanes hold, spread evenly
  // over the fewest groups
  const int pieces = a.h / VEC;
  const long long plane = static_cast<long long>(a.n) * a.h * sizeof(T);  // one scenario's x
  long long most = kNarrowTeamLanes / pieces;
  if (kNarrowGroupBytes / plane < most) most = kNarrowGroupBytes / plane;
  if (most < 1) most = 1;
  const int groups = static_cast<int>((a.batch + most - 1) / most);
  const int scen = (a.batch + groups - 1) / groups;
  const long long lanes = static_cast<long long>(a.n_work) * groups * scen * pieces;
  const long long blocks = (lanes + kNarrowThreads - 1) / kNarrowThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  spmm2_narrow_kernel<T, BF16_MSG, VEC>
      <<<static_cast<unsigned>(blocks), kNarrowThreads, 0, a.stream>>>(
          static_cast<const T*>(a.x), static_cast<const int4*>(a.work),
          static_cast<const int*>(a.src), static_cast<const float*>(a.w),
          static_cast<float*>(a.out), static_cast<float*>(a.partial), a.n, a.h, a.batch,
          a.n_work, a.n_slots, pieces, scen, lanes);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_narrow_fixup(const Args& a) {
  const int pieces = a.h / VEC;
  const long long lanes = static_cast<long long>(a.n_fix) * a.batch * pieces;
  const long long blocks = (lanes + kNarrowThreads - 1) / kNarrowThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  cudaLaunchAttribute overlap;
  overlap.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kNarrowThreads);
  cfg.stream = a.stream;
  cfg.attrs = &overlap;
  cfg.numAttrs = kNarrowFixupOverlap ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, spmm2_narrow_fixup_kernel<VEC>,
                            static_cast<const float*>(a.partial),
                            static_cast<const int*>(a.fix_row),
                            static_cast<const int*>(a.fix_ptr), static_cast<float*>(a.out), a.n,
                            a.h, a.n_fix, a.n_slots, pieces, lanes);
}

// Rows of x shorter than kNarrowRowBytes: the widest vector (16, 8, 4 or 2
// bytes, else scalars) that divides a row and that x's and the outputs'
// alignment allow.
template <typename T, bool BF16_MSG>
cudaError_t launch_narrow(const Args& a) {
  constexpr int kVec16 = 16 / static_cast<int>(sizeof(T));  // elements in 16 bytes
  const uintptr_t xa = reinterpret_cast<uintptr_t>(a.x);
  const uintptr_t oa =
      reinterpret_cast<uintptr_t>(a.out) | reinterpret_cast<uintptr_t>(a.partial);
  const auto fits = [&](int vec) {
    const int out_bytes = 4 * (vec < 4 ? vec : 4);  // stores are at most a float4
    return a.h % vec == 0 && xa % (vec * sizeof(T)) == 0 && oa % out_bytes == 0;
  };
  cudaError_t err;
  if (fits(kVec16)) {
    err = launch_narrow_segments<T, BF16_MSG, kVec16>(a);
  } else if (fits(kVec16 / 2)) {
    err = launch_narrow_segments<T, BF16_MSG, kVec16 / 2>(a);
  } else if (kVec16 == 8 && fits(2)) {
    err = launch_narrow_segments<T, BF16_MSG, 2>(a);
  } else {
    err = launch_narrow_segments<T, BF16_MSG, 1>(a);
  }
  if (err != cudaSuccess || a.n_fix == 0) return err;
  if (a.h % 4 == 0 && oa % 16 == 0) return launch_narrow_fixup<4>(a);
  if (a.h % 2 == 0 && oa % 8 == 0) return launch_narrow_fixup<2>(a);
  return launch_narrow_fixup<1>(a);
}

template <typename T, bool BF16_MSG>
cudaError_t launch_typed(const Args& a) {
  if (a.h < kNarrowRowBytes / static_cast<int>(sizeof(T))) return launch_narrow<T, BF16_MSG>(a);
  constexpr int kVec16 = 16 / static_cast<int>(sizeof(T));  // elements in 16 bytes
  const uintptr_t xa = reinterpret_cast<uintptr_t>(a.x);
  const uintptr_t oa =
      reinterpret_cast<uintptr_t>(a.out) | reinterpret_cast<uintptr_t>(a.partial);
  cudaError_t err;
  if (a.h % kVec16 == 0 && xa % 16 == 0 && oa % 16 == 0) {
    const int vecs = a.h / kVec16;  // 16-byte pieces in one row of x
    if (vecs <= 8) {
      err = launch_segments<T, BF16_MSG, kVec16, 8>(a);
    } else if (vecs <= 16) {
      err = launch_segments<T, BF16_MSG, kVec16, 16>(a);
    } else {
      err = launch_segments<T, BF16_MSG, kVec16, 32>(a);
    }
  } else if (a.h % 2 == 0 && xa % (2 * sizeof(T)) == 0 && oa % 8 == 0) {
    err = launch_segments<T, BF16_MSG, 2, 32>(a);
  } else {
    err = launch_segments<T, BF16_MSG, 1, 32>(a);
  }
  if (err != cudaSuccess || a.n_fix == 0) return err;
  const long long warps_total = static_cast<long long>(a.n_fix) * a.batch;
  const long long fix_blocks = (warps_total + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (fix_blocks > INT_MAX) return cudaErrorInvalidValue;
  spmm2_fixup_kernel<<<static_cast<unsigned>(fix_blocks), kWarpsPerBlock * 32, 0, a.stream>>>(
      static_cast<const float*>(a.partial), static_cast<const int*>(a.fix_row),
      static_cast<const int*>(a.fix_ptr), static_cast<float*>(a.out), a.n, a.h, a.n_fix,
      a.n_slots, warps_total);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes): one apply on the current device
// and `stream`, the segment kernel and, where the plan has long rows, the
// kernel that adds their partial sums. x_bf16: x holds bf16 (else f32);
// bf16_msg: round messages to bf16 before the f32 sum. work is int32
// [n_work, 4], src int32 [E], w f32 [E], fix_row int32 [n_fix], fix_ptr int32
// [n_fix + 1], partial f32 [batch, n_slots, h] (scratch; unused when
// n_fix == 0), out f32 [batch, n, h]; all contiguous on the current device.
// Returns the cudaError_t of the launches (0 = ok).
extern "C" int gnode_spmm2(const void* x, int x_bf16, int bf16_msg, const void* work,
                           int n_work, const void* src, const void* w, const void* fix_row,
                           const void* fix_ptr, int n_fix, void* partial, int n_slots,
                           void* out, int n, int h, int batch, void* stream) {
  if (n <= 0 || h <= 0 || batch <= 0 || n_work <= 0 || n_work > INT_MAX - kWarpsPerBlock * 32 ||
      n_fix < 0 || n_slots < 0 || (n_fix > 0 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, work, src, w, fix_row, fix_ptr, partial, out,
               n, h, batch, n_work, n_fix, n_slots, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (x_bf16) {
    err = bf16_msg ? launch_typed<__nv_bfloat16, true>(a) : launch_typed<__nv_bfloat16, false>(a);
  } else {
    err = bf16_msg ? launch_typed<float, true>(a) : launch_typed<float, false>(a);
  }
  return static_cast<int>(err);
}
