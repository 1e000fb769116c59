// Kernel A and the id-keyed segment sum: sorted-COO segment sums into f32.
//
//   csr      out[n, :] = sum_{e in [row_ptr[n], row_ptr[n+1])} data[e, :]
//   windows  out[n, :] = sum_c sum_{e in [row_ptr[c*N+n], row_ptr[c*N+n+1])} data[e, :]
//   ids      out[n, :] = sum_{e : ids[e] == n} data[e, :]     (ids non-decreasing)
//
// They replace the TPU kernels of ignnition_tpu/ops/pallas/segment_kernels.py:
// `_packed_impl` (csr; `windows` is its use by the windowed slice-gather
// backward, C sums and a [C, N, D] reduction there, one launch here) and
// `_sorted_segment_sum_impl` (ids). The contract is theirs: bf16 or f32 in,
// f32 sums, f32 out, any width D, an empty row is zero, edges outside the
// row pointers (padding) are never read; the id-keyed sum counts every edge
// whose id lies in [0, n_rows), padding included. The TPU kernels' lane
// packing, f32 id column and one-hot MXU contraction are layout devices of
// that machine and are not carried over.
//
// What bounds them on an H100. Each edge row is read once and each output
// row written once, with one add per element: device-memory bytes are the
// floor (0.003 ms for the 8 MB of [131072, 32] bf16). Short of that floor
// the shapes of the models differ in what holds them back:
//   * few rows (2,048 rows of ~64 edges): too few bytes in flight. A warp
//     that reads one 64-byte row per load keeps 256 B in flight;
//     3.35 TB/s at ~0.6 us of latency needs some 2 MB on the whole card.
//     At this size the time is the launch and two dependent memory round
//     trips (a row's bounds, then its edges), not bytes.
//   * narrow rows (width 8: 16 bytes): a lane per column leaves three
//     quarters of a warp idle.
//   * many short rows (8,192 rows and more): how many CTAs an SM holds at
//     once, since each lives for those two round trips: registers (64
//     against 76 is worth 10% at [524288, 32]; the CTA's barriers are worth
//     nothing measurable), then bytes.
//   * skewed rows: the longest row, if one warp owns a row.
//
// The design, one kernel body behind the two entries (row pointers of one
// or several windows; sorted ids):
//   * Lanes cover (edge, 16-byte column group), not columns: a row is G
//     vectors of V bytes (V = 16, or 8, 4 or the element size where the
//     row bytes or the base address do not divide), and one load of a warp
//     reads 32 / G consecutive edges, 512 contiguous bytes, whatever the
//     width (bf16: 32 edges at width 8, 8 at width 32, 4 at width 64).
//     A row wider than 32 groups takes one pass per 32 groups. Each lane
//     sums its column group in f32 over the edges it sees; the lanes that
//     hold the same columns are combined by a fixed shuffle tree.
//   * A batch is UN such loads: a lane has its UN vector loads under way
//     before the first add. UN is 8 (4 KB in flight per warp), or 2 where
//     a mean row needs no more than two such loads, which halves the
//     registers and lets an SM hold more CTAs.
//   * A row's windows are read as one run of edges (a lane walks the
//     windows' prefix lengths in shared memory), so a windowed row of 64
//     edges is one batch like any other.
//   * A CTA of 4 warps owns up to 4 consecutive rows. A row is cut into
//     chunks of four batches; the chunks of the CTA's rows, numbered in
//     order, are dealt to its warps in turn. A row of one chunk (nearly
//     every row of the models' graphs) belongs to one warp, which writes it
//     straight to the output. A longer row gets all four warps, whose
//     partial sums meet in shared memory and are added in warp order by one
//     thread per column group. This is the choice between the two ways to
//     keep one long row from setting the kernel's time: the CTA loops its
//     warps over the row. A row never leaves its CTA, so a row that holds a
//     large share of all edges is still bounded by what one SM pulls (some
//     30 GB/s here); splitting it over CTAs needs a second pass or float
//     atomics, and the latter would cost the next point.
//   * No float atomics, a fixed shuffle tree, a fixed warp order: two calls
//     on the same input agree bit for bit.
//   * How many rows a CTA owns and which UN it runs come from the shapes
//     alone (edges / rows bounds the mean row length; no device sync).
//   * ids: the CTA finds the bounds of its rows itself. Its rows are
//     consecutive, so it needs rows + 1 lower bounds; each is a 32-way
//     search by one warp (4 rounds of independent probes at 131,072 edges,
//     where a binary search is 17 dependent reads). The row-parallel body
//     then runs unchanged. The edge-parallel alternative (fixed edge chunks
//     per warp, runs of equal ids, a fix-up of the chunks' first and last
//     rows) does not depend on row lengths at all, but needs either a
//     zeroed output and a second ordered pass or atomics; with the search
//     at 4 round trips the row-parallel form stays one launch with one
//     body and is kept.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, in a replayed CUDA graph
// (chip_smoke.py; PERF.md has the table), bf16: 0.005 ms at [131072, 32] ->
// [2048, 32] and 0.013 ms at [524288, 32] -> [8192, 32] (0.019 ms with a cold
// L2: 54% of the byte bound); the id-keyed sum 0.0075 and 0.020 ms. What is
// left: a long row across CTAs, rows of a few edges (4 rows a CTA is coarse
// for 65,536 rows of 2 edges), and one wave of CTAs at 8,192 rows, where a
// kernel of 32 registers with a warp per row is 18% faster while the L2 is
// hot.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;            // warps of a CTA
constexpr int kMinCtas8 = 8;         // CTAs an SM should hold at 8 loads a lane (64 registers) ...
constexpr int kMinCtas2 = 10;        // ... and at 2 (51): measured against 6 and, with 8 warps, 3 to 5
constexpr int kChunkBatches = 4;     // batches of one row a warp runs before the next warp's turn
constexpr int kMaxSegments = 1024;   // (row, window) ranges a CTA stages

template <int V> struct VecOf;
template <> struct VecOf<16> { using type = uint4; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<4> { using type = unsigned int; };
template <> struct VecOf<2> { using type = unsigned short; };

template <typename T, int V>
__device__ __forceinline__ void add_vec(float (&acc)[V / (int)sizeof(T)],
                                        typename VecOf<V>::type v) {
  const T* p = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int i = 0; i < V / (int)sizeof(T); ++i) acc[i] += ign::to_f32(p[i]);
}

template <int NV>
__device__ __forceinline__ void store_vals(float* dst, const float (&v)[NV]) {
  if constexpr (NV % 4 == 0) {
#pragma unroll
    for (int j = 0; j < NV / 4; ++j)
      reinterpret_cast<float4*>(dst)[j] =
          make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < NV; ++i) dst[i] = v[i];
  }
}

__device__ __forceinline__ long long id_at(const void* ids, int id64, long long i) {
  return id64 ? static_cast<const long long*>(ids)[i]
              : static_cast<long long>(static_cast<const int*>(ids)[i]);
}

// The first index in [from, n) whose id reaches `key`, n if none, given
// that no id before `from` does: a 32-way search, every lane of the warp
// calls it. [lo, hi] always holds the answer. A search that starts from an
// earlier bound of the same CTA (from > 0) first looks at the next 128 ids,
// where the bound of a key a few rows on nearly always lies.
__device__ int warp_lower_bound(const void* ids, int id64, int from, int n,
                                long long key, int lane) {
  int lo = from, hi = n;
  if (from > 0 && hi - lo > 128) {
    const int probe = lo + (lane + 1) * 4 - 1;
    const unsigned found = __ballot_sync(0xffffffffu, id_at(ids, id64, probe) >= key);
    if (found == 0) {
      lo += 128;
    } else {
      const int first = __ffs(found) - 1;
      hi = lo + (first + 1) * 4 - 1;
      lo += first * 4;
    }
  }
  while (hi > lo) {
    const int step = (hi - lo + 31) >> 5;
    const long long probe = (long long)lo + (long long)(lane + 1) * step - 1;
    const bool reached = probe >= hi || id_at(ids, id64, probe) >= key;
    const unsigned found = __ballot_sync(0xffffffffu, reached);
    if (found == 0) return hi;
    const int first = __ffs(found) - 1;
    const long long at = (long long)lo + (long long)(first + 1) * step - 1;
    lo += first * step;
    if (at < hi) hi = (int)at;
  }
  return lo;
}

// T: the data's type; V: bytes of a lane's load; UN: loads of a lane before
// its first add. id_mode 1 (int32 ids) or 2 (int64): the rows' bounds come
// from a search of the sorted ids, not from row pointers (n_win is 1 then).
template <typename T, int V, int UN>
__global__ void __launch_bounds__(kWarps * 32, UN == 8 ? kMinCtas8 : kMinCtas2)
segment_sum_kernel(const char* __restrict__ data, const int* __restrict__ row_ptr,
                   const void* __restrict__ ids, int id_mode, int n_edges,
                   float* __restrict__ out, int n_rows, int d, int n_win,
                   int rows_per_cta) {
  using VecT = typename VecOf<V>::type;
  constexpr int NV = V / (int)sizeof(T);  // columns of a lane
  // dynamic shared memory: per (row, window) its first edge and where it
  // starts in the row's run of edges; per row the run's length and a mask
  // of the warps that hold a partial sum of it; the partial sums
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_seg = rows_per_cta * n_win;
  int* s_lo = reinterpret_cast<int*>(smem);
  int* s_pre = s_lo + n_seg;
  int* s_len = s_pre + n_seg;
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_len + rows_per_cta);
  float* part = reinterpret_cast<float*>(s_mask + rows_per_cta);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * rows_per_cta;

  // stage each range's first edge in s_lo and, for now, its end in s_pre
  if (id_mode != 0) {
    // rows_per_cta + 1 bounds, one search each: bound j ends row j - 1 and
    // begins row j
    int b = 0;  // keys grow with j: the next search starts at this bound
    for (int j = warp; j <= rows_per_cta; j += kWarps) {
      const int key = min(row0 + j, n_rows);
      b = warp_lower_bound(ids, id_mode == 2, b, n_edges, key, lane);
      if (lane == 0) {
        if (j < rows_per_cta) s_lo[j] = b;
        if (j > 0) s_pre[j - 1] = b;
      }
    }
  } else {
    for (int s = threadIdx.x; s < n_seg; s += blockDim.x) {
      const int r = s / n_win, c = s - r * n_win;
      const int row = row0 + r;
      int lo = 0, hi = 0;
      if (row < n_rows) {
        const int* rp = row_ptr + (long long)c * n_rows + row;
        lo = rp[0];
        hi = rp[1];
      }
      s_lo[s] = lo;
      s_pre[s] = hi;
      if (n_win == 1) {  // the row is this one range: no second stage
        s_pre[s] = 0;
        s_len[s] = hi > lo ? hi - lo : 0;
        s_mask[s] = 0u;
      }
    }
  }
  __syncthreads();
  if (id_mode != 0 || n_win > 1) {  // uniform over the CTA
    for (int r = threadIdx.x; r < rows_per_cta; r += blockDim.x) {
      int run = 0;
      for (int s = r * n_win; s < (r + 1) * n_win; ++s) {
        const int n = s_pre[s] - s_lo[s];
        s_pre[s] = run;
        run += n > 0 ? n : 0;
      }
      s_len[r] = run;
      s_mask[r] = 0u;
    }
    __syncthreads();
  }

  const int groups = d * (int)sizeof(T) / V;  // vectors of a data row
  const long long row_bytes = (long long)groups * V;
  for (int g0 = 0; g0 < groups; g0 += 32) {
    const int gc = min(32, groups - g0);  // column groups of this pass
    const int epi = 32 / gc;              // edges that one load of the warp covers
    const int eo = lane / gc, g = lane - eo * gc;
    const bool lane_on = eo < epi;
    const int batch = epi * UN;
    const int chunk = batch * kChunkBatches;
    const char* col = data + (long long)(g0 + g) * V;
    int tree = 1;
    while (tree < epi) tree <<= 1;

    float acc[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = 0.f;
    int held = -1;         // the row whose sum acc holds
    bool whole = false;    // this warp holds all of that row

    // adds the lanes of one column group in a fixed tree; a whole row goes
    // to the output, a partial sum of row `held` to shared memory
    auto flush = [&]() {
      for (int s = tree >> 1; s >= 1; s >>= 1) {
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const float other = __shfl_down_sync(0xffffffffu, acc[i], s * gc);
          if (eo + s < epi) acc[i] += other;
        }
      }
      if (whole) {
        if (lane < gc)
          store_vals<NV>(out + (long long)(row0 + held) * d + (long long)(g0 + g) * NV, acc);
      } else {
        if (lane < gc) {
          float* p = part + ((long long)(held * kWarps + warp) * NV) * gc + g;
#pragma unroll
          for (int i = 0; i < NV; ++i) p[i * gc] = acc[i];
        }
        if (lane == 0) atomicOr(&s_mask[held], 1u << warp);
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[i] = 0.f;
    };

    // chunks of the CTA's rows, numbered in order (an empty row counts one):
    // this warp takes warp, warp + kWarps, ...; every branch but the loads'
    // own is uniform over the warp
    int item = warp, before = 0;
    for (int r = 0; r < rows_per_cta && row0 + r < n_rows; ++r) {
      const int len = s_len[r];
      const int n_chunks = len > chunk ? (len + chunk - 1) / chunk : 1;
      const int* lo_r = s_lo + r * n_win;
      const int* pre_r = s_pre + r * n_win;
      while (item < before + n_chunks) {
        if (r != held) {
          if (held >= 0) flush();
          held = r;
          whole = n_chunks == 1;
        }
        const int v0 = (item - before) * chunk;
        for (int vb = v0; vb < v0 + chunk && vb < len; vb += batch) {
          VecT buf[UN];
          if (n_win == 1) {
            const long long e0 = (long long)lo_r[0] + vb + eo;
#pragma unroll
            for (int k = 0; k < UN; ++k) {
              if (lane_on && vb + k * epi + eo < len)
                buf[k] = __ldg(reinterpret_cast<const VecT*>(col + (e0 + k * epi) * row_bytes));
              else
                buf[k] = VecT{};
            }
          } else {
            int c = 0;  // the window of this lane's edge, found by walking on
#pragma unroll
            for (int k = 0; k < UN; ++k) {
              const int v = vb + k * epi + eo;
              if (lane_on && v < len) {
                while (c + 1 < n_win && v >= pre_r[c + 1]) ++c;
                const long long e = (long long)lo_r[c] + (v - pre_r[c]);
                buf[k] = __ldg(reinterpret_cast<const VecT*>(col + e * row_bytes));
              } else {
                buf[k] = VecT{};
              }
            }
          }
#pragma unroll
          for (int k = 0; k < UN; ++k) add_vec<T, V>(acc, buf[k]);
        }
        item += kWarps;
      }
      before += n_chunks;
    }
    if (held >= 0) flush();
    __syncthreads();

    // warp r adds the partial sums of row r, where there are any, in warp
    // order and writes the row
    for (int r = warp; r < rows_per_cta; r += kWarps) {
      const unsigned mask = s_mask[r];
      if (mask == 0u || lane >= gc) continue;
      float tot[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) tot[i] = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        if (!(mask >> w & 1u)) continue;
        const float* p = part + ((long long)(r * kWarps + w) * NV) * gc + g;
#pragma unroll
        for (int i = 0; i < NV; ++i) tot[i] += p[i * gc];
      }
      store_vals<NV>(out + (long long)(row0 + r) * d + (long long)(g0 + g) * NV, tot);
    }
    if (g0 + 32 < groups) {  // the next pass reuses the masks and part
      __syncthreads();
      for (int r = threadIdx.x; r < rows_per_cta; r += blockDim.x) s_mask[r] = 0u;
      __syncthreads();
    }
  }
}

struct Call {
  const void* data;
  const int* row_ptr;
  const void* ids;
  int id_mode;  // 0: row pointers; 1: int32 ids; 2: int64 ids
  long long n_edges;
  float* out;
  int n_rows, d, n_win;
  cudaStream_t stream;
};

template <typename T, int V, int UN>
int launch(const Call& c, int rows_per_cta) {
  constexpr int NV = V / (int)sizeof(T);
  const int groups = c.d * (int)sizeof(T) / V;
  const int gc = groups < 32 ? groups : 32;
  const size_t smem = (size_t)rows_per_cta * c.n_win * 8 + (size_t)rows_per_cta * 8 +
                      (size_t)rows_per_cta * kWarps * NV * gc * 4;
  const int blocks = (c.n_rows + rows_per_cta - 1) / rows_per_cta;
  segment_sum_kernel<T, V, UN><<<blocks, kWarps * 32, smem, c.stream>>>(
      static_cast<const char*>(c.data), c.row_ptr, c.ids, c.id_mode, (int)c.n_edges, c.out,
      c.n_rows, c.d, c.n_win, rows_per_cta);
  return static_cast<int>(cudaGetLastError());
}

// How deep a lane loads and how many rows a CTA owns, from the shapes alone:
// the edge count bounds the mean row length, so no device value is read.
template <typename T, int V>
int plan(const Call& c) {
  const int groups = c.d * (int)sizeof(T) / V;
  const int epi = 32 / (groups < 32 ? groups : 32);
  const long long per_row = (c.n_edges + c.n_rows - 1) / c.n_rows;
  const bool shallow = per_row <= 2 * epi;  // a mean row is at most two loads of a warp
  const long long chunk = (long long)epi * (shallow ? 2 : 8) * kChunkBatches;
  long long per_row_chunks = (per_row + chunk - 1) / chunk;
  if (per_row_chunks < 1) per_row_chunks = 1;
  // about one chunk per warp, within the ranges the CTA's shared memory holds
  long long rows = kWarps / per_row_chunks;
  if (rows > kMaxSegments / c.n_win) rows = kMaxSegments / c.n_win;
  if (rows > c.n_rows) rows = c.n_rows;
  if (rows < 1) rows = 1;
  if (rows * c.n_win > kMaxSegments) return static_cast<int>(cudaErrorInvalidValue);
  return shallow ? launch<T, V, 2>(c, (int)rows) : launch<T, V, 8>(c, (int)rows);
}

// The widest load that the row bytes and the base address divide.
int dispatch(const Call& c, int dtype) {
  if (c.n_rows <= 0 || c.d <= 0 || c.n_win <= 0 || c.n_edges < 0 ||
      c.n_edges > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int es = dtype == ign::kBFloat16 ? 2 : 4;
  const long long row_bytes = (long long)c.d * es;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(c.data);
  int v = es;
  for (int cand = 16; cand > es; cand >>= 1) {
    if (row_bytes % cand == 0 && addr % cand == 0) {
      v = cand;
      break;
    }
  }
  if (dtype == ign::kFloat32) {
    switch (v) {
      case 16: return plan<float, 16>(c);
      case 8: return plan<float, 8>(c);
      default: return plan<float, 4>(c);
    }
  }
  if (dtype == ign::kBFloat16) {
    switch (v) {
      case 16: return plan<__nv_bfloat16, 16>(c);
      case 8: return plan<__nv_bfloat16, 8>(c);
      case 4: return plan<__nv_bfloat16, 4>(c);
      default: return plan<__nv_bfloat16, 2>(c);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// out [n_rows, d] f32 = sums of data [n_edges, d] over the row pointers of
// n_win windows: row_ptr [n_win * n_rows + 1] holds the windows' pointers
// one after another, with offsets into the whole of data; out[n] adds row n
// of every window. One window is the plain CSR sum over row_ptr [n_rows + 1].
extern "C" int ign_csr_segment_sum(const void* data, const void* row_ptr, void* out,
                                   long long n_edges, int n_rows, int n_win, int d,
                                   int dtype, void* stream) {
  const Call c{data, static_cast<const int*>(row_ptr), nullptr, 0, n_edges,
               static_cast<float*>(out), n_rows, d, n_win,
               static_cast<cudaStream_t>(stream)};
  return dispatch(c, dtype);
}

// out [n_rows, d] f32 = sums of data [n_edges, d] by non-decreasing ids
// [n_edges] (int32, or int64 with id64 != 0); ids outside [0, n_rows) do
// not count.
extern "C" int ign_segment_sum_ids(const void* data, const void* ids, void* out,
                                   long long n_edges, int n_rows, int d, int dtype,
                                   int id64, void* stream) {
  const Call c{data, nullptr, ids, id64 ? 2 : 1, n_edges, static_cast<float*>(out),
               n_rows, d, 1, static_cast<cudaStream_t>(stream)};
  return dispatch(c, dtype);
}
