// K2 on Hopper: one synchronous Monte-Carlo SIR step, coins and update fused.
//
//   p_inf = 1 - (1 - beta)^counts = -expm1(counts * log(1 - beta))
//   one uint32 word w per (simulation, node):
//     a susceptible node is infected where  (w & 0xFFFF) < p_inf * 2^16
//     an infected node recovers where       (w >> 16)    < gamma * 2^16
//   both read the state at the start of the step.
//
// Replaces the Pallas TPU kernel gn_ode_sir_tpu/sim/pallas_step.py::_step_kernel
// (launched by sir_update_pallas). Of that kernel only the function is kept:
// its 256 x 512 tiles, padding and per-tile seeding of the core's hardware
// generator were shaped by the TPU. Here every element depends on its own
// inputs only, so one thread takes four consecutive elements of one trial's
// flat [sims, n] state with char4 / 16-byte accesses.
//
// The state is (I, R) as int8 indicators (S = 1 - I - R); rows = trials * sims,
// and trial = row / sims selects that trial's log(1 - beta), gamma * 2^16 and
// 64-bit seed, so several trials with different rates advance in one launch.
// counts is the infected-neighbour count product, f32 or int32.
//
// Random words: Philox4x32-10, written out below. Counter = (q, step) with q
// the element's index within its trial divided by 4, key = the trial's seed;
// the four output words serve the four elements 4q .. 4q+3. The words depend
// on (seed, step, element) only, never on the launch geometry or on how many
// trials share the launch, and the plain PyTorch version
// (sim/fused_step.py::philox4x32_words) produces the same words.
//
// p_inf uses expm1f, the package's own formula (the TPU kernel took 1 - exp
// only because expm1 had no lowering there). The file is compiled without
// --use_fast_math so that expm1f here and torch.expm1 on the card agree.
//
// Bound (H100 SXM): bytes. Per element 2 B of state and 4 B of counts read,
// 2 B written: 8 B against ~60 integer operations of Philox shared by four
// elements; at [10,000 x 33,696] that is 2.7 GB, 0.8 ms at 3.35 TB/s.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // Philox multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;  // Weyl key increments

struct Words {
  uint32_t v[4];
};

__device__ __forceinline__ Words philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                               uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  return {{c0, c1, c2, c3}};
}

// i, r, counts: flat views of [trials * sims, n]; per_trial = sims * n elements
// belong to one trial. blockIdx.y is the trial, blockIdx.x walks the trial's
// elements four to a thread, so a thread's four elements share one Philox
// counter and nothing is divided. VEC: every pointer and every trial's first
// element is aligned for 4-element accesses.
template <typename CountT, bool VEC>
__global__ void __launch_bounds__(kThreads)
sir_step_kernel(const int8_t* __restrict__ i_in, const int8_t* __restrict__ r_in,
                const CountT* __restrict__ counts, const float* __restrict__ log1m_beta,
                const float* __restrict__ gamma16, const long long* __restrict__ seeds,
                int8_t* __restrict__ i_out, int8_t* __restrict__ r_out,
                uint32_t* __restrict__ words_out, long long per_trial, uint32_t step) {
  const long long e0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (e0 >= per_trial) return;
  const int trial = blockIdx.y;
  const long long g0 = trial * per_trial + e0;
  const int cnt = static_cast<int>(min(4LL, per_trial - e0));
  const bool vec = VEC && cnt == 4;

  // constant indices under the unrolls keep these arrays in registers
  int8_t iv[4] = {0, 0, 0, 0}, rv[4] = {0, 0, 0, 0};
  float cv[4] = {0.f, 0.f, 0.f, 0.f};
  if (vec) {
    const char4 a = *reinterpret_cast<const char4*>(i_in + g0);
    const char4 b = *reinterpret_cast<const char4*>(r_in + g0);
    iv[0] = a.x, iv[1] = a.y, iv[2] = a.z, iv[3] = a.w;
    rv[0] = b.x, rv[1] = b.y, rv[2] = b.z, rv[3] = b.w;
    if constexpr (std::is_same<CountT, int>::value) {
      const int4 c = *reinterpret_cast<const int4*>(counts + g0);
      cv[0] = static_cast<float>(c.x), cv[1] = static_cast<float>(c.y);
      cv[2] = static_cast<float>(c.z), cv[3] = static_cast<float>(c.w);
    } else {
      const float4 c = *reinterpret_cast<const float4*>(counts + g0);
      cv[0] = c.x, cv[1] = c.y, cv[2] = c.z, cv[3] = c.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < cnt) {
        iv[k] = i_in[g0 + k];
        rv[k] = r_in[g0 + k];
        cv[k] = static_cast<float>(counts[g0 + k]);
      }
    }
  }

  const float lb = __ldg(log1m_beta + trial);
  const float g16 = __ldg(gamma16 + trial);
  const unsigned long long seed = static_cast<unsigned long long>(__ldg(seeds + trial));
  const long long q = e0 >> 2;
  const Words w =
      philox4x32_10(static_cast<uint32_t>(q), static_cast<uint32_t>(q >> 32), step, 0u,
                    static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
  int8_t io[4] = {0, 0, 0, 0}, ro[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float p_inf = -expm1f(__fmul_rn(cv[k], lb));
    const float u = static_cast<float>(w.v[k] & 0xFFFFu);
    const float v = static_cast<float>(w.v[k] >> 16);
    const int s = 1 - iv[k] - rv[k];
    const int new_inf = s * static_cast<int>(u < __fmul_rn(p_inf, 65536.0f));
    const int new_rec = iv[k] * static_cast<int>(v < g16);
    io[k] = static_cast<int8_t>(iv[k] + new_inf - new_rec);
    ro[k] = static_cast<int8_t>(rv[k] + new_rec);
  }

  if (vec) {
    *reinterpret_cast<char4*>(i_out + g0) = make_char4(io[0], io[1], io[2], io[3]);
    *reinterpret_cast<char4*>(r_out + g0) = make_char4(ro[0], ro[1], ro[2], ro[3]);
    if (words_out != nullptr) {
      *reinterpret_cast<uint4*>(words_out + g0) = make_uint4(w.v[0], w.v[1], w.v[2], w.v[3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < cnt) {
        i_out[g0 + k] = io[k];
        r_out[g0 + k] = ro[k];
        if (words_out != nullptr) words_out[g0 + k] = w.v[k];
      }
    }
  }
}

inline bool aligned(const void* p, uintptr_t a) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % a == 0;
}

template <typename CountT>
cudaError_t launch_typed(const void* i_in, const void* r_in, const void* counts,
                         const void* log1m_beta, const void* gamma16, const void* seeds,
                         void* i_out, void* r_out, void* words_out, long long trials,
                         long long per_trial, uint32_t step, cudaStream_t stream) {
  const long long threads = (per_trial + 3) / 4;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > INT_MAX || trials > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(trials));
  const dim3 block(kThreads);
  const bool vec = (trials == 1 || per_trial % 4 == 0) && aligned(i_in, 4) &&
                   aligned(r_in, 4) && aligned(i_out, 4) && aligned(r_out, 4) &&
                   aligned(counts, 16) && aligned(words_out, 16);
  const auto* ip = static_cast<const int8_t*>(i_in);
  const auto* rp = static_cast<const int8_t*>(r_in);
  const auto* cp = static_cast<const CountT*>(counts);
  const auto* lp = static_cast<const float*>(log1m_beta);
  const auto* gp = static_cast<const float*>(gamma16);
  const auto* sp = static_cast<const long long*>(seeds);
  auto* io = static_cast<int8_t*>(i_out);
  auto* ro = static_cast<int8_t*>(r_out);
  auto* wo = static_cast<uint32_t*>(words_out);
  if (vec) {
    sir_step_kernel<CountT, true><<<grid, block, 0, stream>>>(
        ip, rp, cp, lp, gp, sp, io, ro, wo, per_trial, step);
  } else {
    sir_step_kernel<CountT, false><<<grid, block, 0, stream>>>(
        ip, rp, cp, lp, gp, sp, io, ro, wo, per_trial, step);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). i_in, r_in: int8 [rows, n];
// counts: f32 or (counts_int32) int32 [rows, n]; log1m_beta, gamma16: f32
// [rows / sims]; seeds: int64 [rows / sims] (the Philox key, as unsigned);
// i_out, r_out: int8 [rows, n]; words_out: uint32 [rows, n] or null (the
// words the kernel drew, for checking). All contiguous on the current
// device. Returns the cudaError_t of the launch (0 = ok).
extern "C" int gnode_sir_step(const void* i_in, const void* r_in, const void* counts,
                              int counts_int32, const void* log1m_beta,
                              const void* gamma16, const void* seeds, void* i_out,
                              void* r_out, void* words_out, long long rows, int n,
                              int sims, unsigned int step, void* stream) {
  if (rows <= 0 || n <= 0 || sims <= 0 || rows % sims != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long trials = rows / sims;
  const long long per_trial = static_cast<long long>(sims) * n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      counts_int32
          ? launch_typed<int>(i_in, r_in, counts, log1m_beta, gamma16, seeds, i_out, r_out,
                              words_out, trials, per_trial, step, s)
          : launch_typed<float>(i_in, r_in, counts, log1m_beta, gamma16, seeds, i_out,
                                r_out, words_out, trials, per_trial, step, s);
  return static_cast<int>(err);
}
