// graphcore — native host-side graph preprocessing (the port's own copy of
// gn_ode_sir_tpu/native/graphcore.cc, built by gn_ode_sir_tpu_torch/native).
//
// The reference delegates its native work to external wheels; the part that
// runs on the HOST (building/coalescing edge lists, CSR conversion, reverse-
// edge maps) lives in torch-geometric/torch-sparse C++ there. This is our
// equivalent: a small, dependency-free C++ core for the data-loader path,
// called from Python via ctypes with raw int32 buffers. Each function is a
// flat-array transform so the Python side stays zero-copy numpy.
//
// Exposed C ABI:
//   gc_coalesce_undirected : raw (u,v) pairs -> symmetrized, deduplicated,
//                            (dst, src)-sorted directed COO
//                            (replaces the networkx walk at ode_nn.py:32-38)
//   gc_csr_offsets         : dst-sorted COO -> CSR row offsets
//   gc_reverse_edge_index  : directed COO -> index of each edge's reverse
//                            (the DMP "cave" index, dmp.py:36-50)
//   gc_degrees             : dst counts

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Input: pairs[2*m] = u0,v0,u1,v1,...  Output buffers sized >= 2*m each.
// Returns the number of directed edges written (E), or -1 on error.
int64_t gc_coalesce_undirected(const int32_t* pairs, int64_t m, int64_t n,
                               int32_t* out_src, int32_t* out_dst) {
  if (m < 0 || n <= 0) return -1;
  std::vector<int64_t> codes;
  codes.reserve(2 * m);
  for (int64_t i = 0; i < m; ++i) {
    int64_t u = pairs[2 * i], v = pairs[2 * i + 1];
    if (u < 0 || v < 0 || u >= n || v >= n) return -1;
    // canonical undirected key (min, max)
    int64_t a = u < v ? u : v, b = u < v ? v : u;
    codes.push_back(a * n + b);
  }
  std::sort(codes.begin(), codes.end());
  codes.erase(std::unique(codes.begin(), codes.end()), codes.end());

  std::vector<int64_t> directed;
  directed.reserve(2 * codes.size());
  for (int64_t c : codes) {
    int64_t a = c / n, b = c % n;
    // emit both directions keyed (dst, src); self-loops once
    directed.push_back(b * n + a);  // dst=b, src=a
    if (a != b) directed.push_back(a * n + b);
  }
  std::sort(directed.begin(), directed.end());
  int64_t e = static_cast<int64_t>(directed.size());
  for (int64_t i = 0; i < e; ++i) {
    out_dst[i] = static_cast<int32_t>(directed[i] / n);
    out_src[i] = static_cast<int32_t>(directed[i] % n);
  }
  return e;
}

// offsets must have n+1 slots; dst must be sorted ascending.
int64_t gc_csr_offsets(const int32_t* dst, int64_t e, int64_t n,
                       int64_t* offsets) {
  if (e < 0 || n <= 0) return -1;
  int64_t row = 0;
  offsets[0] = 0;
  for (int64_t i = 0; i < e; ++i) {
    int32_t d = dst[i];
    if (d < 0 || d >= n || (i > 0 && d < dst[i - 1])) return -1;
    while (row < d) offsets[++row] = i;
  }
  while (row < n) offsets[++row] = e;
  return 0;
}

// cave[i] = index j with (src[j], dst[j]) == (dst[i], src[i]), else e.
int64_t gc_reverse_edge_index(const int32_t* src, const int32_t* dst,
                              int64_t e, int64_t n, int32_t* cave) {
  if (e < 0 || n <= 0) return -1;
  std::vector<std::pair<int64_t, int32_t>> keyed(e);
  for (int64_t i = 0; i < e; ++i) {
    keyed[i] = {static_cast<int64_t>(src[i]) * n + dst[i],
                static_cast<int32_t>(i)};
  }
  std::sort(keyed.begin(), keyed.end());
  for (int64_t i = 0; i < e; ++i) {
    int64_t want = static_cast<int64_t>(dst[i]) * n + src[i];
    auto it = std::lower_bound(
        keyed.begin(), keyed.end(), std::make_pair(want, INT32_C(-1)),
        [](const std::pair<int64_t, int32_t>& a,
           const std::pair<int64_t, int32_t>& b) { return a.first < b.first; });
    cave[i] = (it != keyed.end() && it->first == want)
                  ? it->second
                  : static_cast<int32_t>(e);
  }
  return 0;
}

// Greedy (<=k edges, <r destination rows) chunking of a dst-sorted edge
// list — the host-side "compile" step of the Pallas SpMM v2 kernel
// (ops/pallas_spmm2.py::SpmmPlan.build). Two-phase C ABI:
//   gc_spmm_chunk_count  : number of chunks C (or -1 on unsorted input)
//   gc_spmm_plan_fill    : fill src_padded [C*k], dst_local [C*k] (sentinel
//                          r for padding), row_base [C], and optionally
//                          w_padded [C*k] (0 for padding)
int64_t gc_spmm_chunk_count(const int32_t* dst, int64_t e, int64_t k,
                            int64_t r) {
  if (e < 0 || k <= 0 || r <= 0) return -1;
  int64_t c = 0;
  int64_t i = 0;
  while (i < e) {
    int32_t r0 = dst[i];
    int64_t hi = (i + k < e) ? i + k : e;
    int64_t j = i;
    while (j < hi) {
      if (j > i && dst[j] < dst[j - 1]) return -1;  // must be sorted
      if (dst[j] >= r0 + r) break;
      ++j;
    }
    i = j;
    ++c;
  }
  return c;
}

int64_t gc_spmm_plan_fill(const int32_t* src, const int32_t* dst,
                          const float* w, int64_t e, int64_t k, int64_t r,
                          int32_t* src_padded, int32_t* dst_local,
                          int32_t* row_base, float* w_padded) {
  if (e < 0 || k <= 0 || r <= 0) return -1;
  int64_t c = 0;
  int64_t i = 0;
  while (i < e) {
    int32_t r0 = dst[i];
    int64_t hi = (i + k < e) ? i + k : e;
    int64_t j = i;
    while (j < hi && dst[j] < r0 + r) ++j;
    row_base[c] = r0;
    int64_t off = c * k;
    for (int64_t t = 0; t < k; ++t) {
      if (i + t < j) {
        src_padded[off + t] = src[i + t];
        dst_local[off + t] = dst[i + t] - r0;
        if (w_padded) w_padded[off + t] = w[i + t];
      } else {
        src_padded[off + t] = 0;
        dst_local[off + t] = static_cast<int32_t>(r);  // sentinel
        if (w_padded) w_padded[off + t] = 0.0f;
      }
    }
    i = j;
    ++c;
  }
  return c;
}

int64_t gc_degrees(const int32_t* dst, int64_t e, int64_t n, int32_t* deg) {
  if (e < 0 || n <= 0) return -1;
  for (int64_t i = 0; i < n; ++i) deg[i] = 0;
  for (int64_t i = 0; i < e; ++i) {
    if (dst[i] < 0 || dst[i] >= n) return -1;
    deg[dst[i]] += 1;
  }
  return 0;
}

}  // extern "C"
