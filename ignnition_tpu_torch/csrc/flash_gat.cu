// Kernels D and E: flash-style dense GAT attention over an incidence matrix,
// forward and backward.
//
//   z[d, s]  = m[d, s] * exp(lrelu(sdst[d] + ssrc[s]) - stab[d])
//   out[d,:] = (sum_s z[d, s] x[s, :]) / max(sum_s z[d, s], 1e-30)     (D)
//   a = z / max(den, 1e-30), da[d, s] = ct[d,:] . x[s,:],
//   dp = a * lrelu'(pre) * (da - srow[d])
//   d_table[s,:] = sum_d a[d, s] ct[d,:],  d_ssrc[s] = sum_d dp[d, s],
//   d_sdst[d]    = sum_s dp[d, s]                                       (E)
//
// They replace the TPU kernels of ignnition_tpu/ops/pallas/
// attention_kernels.py, `flash_gat_forward` / `_fwd_kernel` and
// `flash_gat_backward` / `_bwd_kernel`, and keep their numerics: lrelu as
// max(pre, 0.2 pre), exp in f32, every operand of a product rounded to x's
// type first (z in the forward; a and ct in the backward), f32 sums, the
// denominator as the sum of the rounded z, an empty row gives exactly 0.
// m is int8 or bf16 and is upcast in registers. A leading graph axis G
// (block-diagonal merged batches) is gridDim.y; G = 1 is the dense case.
//
// What bounds them on an H100: device-memory bytes, the one read of m per
// pass. The incidence matrix of a graph is almost empty (the flagship's
// [2048, 16384] holds 131,072 non-zeros in 33.5M entries) and z is 0
// wherever m is, so only the non-zero entries cost the D-wide work: the TPU
// kernel's dense [TD, TS] tiles and MXU contractions are not carried over.
//
// Design. A warp scans m in 16-byte loads per lane (16 int8 or 8 bf16
// entries; element-wise loads at ragged or unaligned edges), votes on which
// lanes met a non-zero, and handles each such entry with all 32 lanes over
// the D columns (lane j owns columns j, j+32, ...), in index order.
//   D  forward:  one warp per destination row, or `split` warps of a CTA on
//      equal column ranges of one row when there are few rows; the partial
//      sums meet in shared memory and are added in range order.
//   E  backward: two grids, because CTAs share nothing and the TPU kernel's
//      resident [n_src, D+1] accumulator has no counterpart.
//      rows:    the forward's walk; d_sdst[d] needs one row only.
//      columns: a warp owns a strip of 16 bytes of columns and walks down a
//      range of destination rows, lane r reading row base+r; it adds a^T ct
//      and dp into its own [strip, D+1] block of shared memory. The warps of
//      a CTA that share a strip (one per row range) are added in range order
//      at the end. m is read a second time (from L2 when it fits there).
// No atomics anywhere: every sum has a fixed order, so results repeat
// bitwise from run to run.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr float kSlope = 0.2f;     // LeakyReLU negative slope
constexpr float kDenFloor = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWarps = 4;       // warps of a CTA in the row-wise kernels
constexpr int kColWarps = 8;       // warps of a CTA in the column-wise kernel
constexpr int kTargetWarps = 8192; // warps wanted in flight before splitting stops

// m's storage types: int8 as uint8_t, bf16 as uint16_t (raw bits).
template <typename M>
struct Entry;
template <>
struct Entry<uint8_t> {
  static __device__ __forceinline__ float value(uint32_t bits) {
    return static_cast<float>(static_cast<signed char>(bits));
  }
  static __device__ __forceinline__ bool nonzero(uint32_t bits) { return bits != 0; }
};
template <>
struct Entry<uint16_t> {
  static __device__ __forceinline__ float value(uint32_t bits) {
    return __uint_as_float(bits << 16);
  }
  static __device__ __forceinline__ bool nonzero(uint32_t bits) {
    return (bits & 0x7fffu) != 0;
  }
};

// 16 bytes of row[col0 : col0 + 16 / sizeof(M)], zeros past n_cols.
template <typename M>
__device__ __forceinline__ uint4 load_chunk(const M* __restrict__ row, int col0,
                                            int n_cols) {
  constexpr int kVec = 16 / sizeof(M);
  constexpr int kPerWord = 4 / sizeof(M);
  const M* p = row + col0;
  if (col0 + kVec <= n_cols && (reinterpret_cast<uintptr_t>(p) & 15) == 0)
    return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (col0 + i < n_cols)
      w[i / kPerWord] |= static_cast<uint32_t>(p[i]) << (8 * sizeof(M) * (i % kPerWord));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ bool any_bits(const uint4& c) {
  return (c.x | c.y | c.z | c.w) != 0u;
}

// Lane `src_lane`'s chunk, in every lane.
__device__ __forceinline__ uint4 broadcast_chunk(const uint4& c, int src_lane) {
  return make_uint4(__shfl_sync(kFull, c.x, src_lane), __shfl_sync(kFull, c.y, src_lane),
                    __shfl_sync(kFull, c.z, src_lane), __shfl_sync(kFull, c.w, src_lane));
}

// Calls f(i, value) for each non-zero entry i of a chunk, in index order.
// The chunk is the same in every lane, so the warp stays converged.
template <typename M, typename F>
__device__ __forceinline__ void for_each_nonzero(const uint4& c, F&& f) {
  constexpr int kVec = 16 / sizeof(M);
  constexpr int kPerWord = 4 / sizeof(M);
  constexpr uint32_t kMask = sizeof(M) == 1 ? 0xffu : 0xffffu;
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
  uint32_t live = 0u;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const uint32_t bits = (w[i / kPerWord] >> (8 * sizeof(M) * (i % kPerWord))) & kMask;
    if (Entry<M>::nonzero(bits)) live |= 1u << i;
  }
  while (live) {
    const int i = __ffs(live) - 1;
    live &= live - 1;
    const int q = i / kPerWord;
    const uint32_t word = q == 0 ? c.x : q == 1 ? c.y : q == 2 ? c.z : c.w;
    const uint32_t bits = (word >> (8 * sizeof(M) * (i % kPerWord))) & kMask;
    f(i, Entry<M>::value(bits));
  }
}

// Calls f(col, value) for every non-zero entry of row[col_begin:col_end), in
// column order, with the whole warp converged at each call.
template <typename M, typename F>
__device__ __forceinline__ void walk_row(const M* __restrict__ row, int col_begin,
                                         int col_end, int lane, F&& f) {
  constexpr int kVec = 16 / sizeof(M);
  constexpr int kStep = 32 * kVec;
  uint4 cur = load_chunk<M>(row, col_begin + lane * kVec, col_end);
  for (int base = col_begin; base < col_end; base += kStep) {
    // the next chunk is on its way while this one is handled
    const uint4 nxt = load_chunk<M>(row, base + kStep + lane * kVec, col_end);
    unsigned hits = __ballot_sync(kFull, any_bits(cur));
    while (hits) {
      const int src_lane = __ffs(hits) - 1;
      hits &= hits - 1;
      const uint4 c = broadcast_chunk(cur, src_lane);
      const int c0 = base + src_lane * kVec;
      for_each_nonzero<M>(c, [&](int i, float mv) { f(c0 + i, mv); });
    }
    cur = nxt;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;  // the same bits in every lane: each level adds the same pairs
}

__device__ __forceinline__ int round_up(int v, int to) { return (v + to - 1) / to * to; }

// The column range of `part` of `split` equal parts of a row of `bs` entries,
// each a whole number of warp steps.
template <typename M>
__device__ __forceinline__ void part_range(int bs, int split, int part, int* c0, int* c1) {
  constexpr int kStep = 32 * (16 / sizeof(M));
  const int len = round_up((bs + split - 1) / split, kStep);
  *c0 = min(bs, part * len);
  *c1 = min(bs, *c0 + len);
}

// ---------------------------------------------------------------- kernel D

template <typename T, typename M, int KD>
__global__ void __launch_bounds__(kRowWarps * 32)
flash_gat_fwd_kernel(const float* __restrict__ ssrc, const float* __restrict__ sdst,
                     const float* __restrict__ stab, const T* __restrict__ x,
                     const M* __restrict__ m, T* __restrict__ out,
                     float* __restrict__ den, int bd, int bs, int d, int split) {
  extern __shared__ float smem[];  // [kRowWarps][d + 1] partial sums when split > 1
  const int g = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kRowWarps / split) + warp / split;
  const int part = warp % split;
  const bool live = row < bd;
  const size_t grow = static_cast<size_t>(g) * bd + row;

  float acc[KD];
#pragma unroll
  for (int k = 0; k < KD; ++k) acc[k] = 0.f;
  float dsum = 0.f;
  if (live) {
    const float* ss = ssrc + static_cast<size_t>(g) * bs;
    const T* xg = x + static_cast<size_t>(g) * bs * d;
    const float sd = sdst[grow], st = stab[grow];
    int c0, c1;
    part_range<M>(bs, split, part, &c0, &c1);
    walk_row<M>(m + grow * bs, c0, c1, lane, [&](int s, float mv) {
      const float pre = sd + ss[s];
      const float e = fmaxf(pre, kSlope * pre);
      const float z = ign::round_to<T>(expf(e - st) * mv);
      dsum += z;
      const T* xs = xg + static_cast<size_t>(s) * d;
#pragma unroll
      for (int k = 0; k < KD; ++k) {
        const int j = lane + 32 * k;
        if (j < d) acc[k] = fmaf(z, ign::to_f32(xs[j]), acc[k]);
      }
    });
  }
  if (split > 1) {
    float* mine = smem + warp * (d + 1);
#pragma unroll
    for (int k = 0; k < KD; ++k) {
      const int j = lane + 32 * k;
      if (j < d) mine[j] = acc[k];
    }
    if (lane == 0) mine[d] = dsum;
    __syncthreads();
    if (part != 0) return;
    dsum = 0.f;
#pragma unroll
    for (int k = 0; k < KD; ++k) acc[k] = 0.f;
    for (int p = 0; p < split; ++p) {  // in range order
      const float* other = smem + (warp + p) * (d + 1);
#pragma unroll
      for (int k = 0; k < KD; ++k) {
        const int j = lane + 32 * k;
        if (j < d) acc[k] += other[j];
      }
      dsum += other[d];
    }
  }
  if (!live) return;
  const float denom = fmaxf(dsum, kDenFloor);
#pragma unroll
  for (int k = 0; k < KD; ++k) {
    const int j = lane + 32 * k;
    if (j < d) out[grow * d + j] = ign::from_f32<T>(acc[k] / denom);
  }
  if (lane == 0) den[grow] = dsum;
}

// ---------------------------------------------------------------- kernel E

// One non-zero entry's backward terms: a (f32) and dp. `ctv` holds the
// lane's columns of ct[d, :], already in T.
template <typename T, int KD>
__device__ __forceinline__ void entry_backward(float mv, float pre, float st, float dn,
                                               float sr, const float (&ctv)[KD],
                                               const T* __restrict__ xs, int d, int lane,
                                               float* a_out, float* dp_out) {
  const float e = fmaxf(pre, kSlope * pre);
  const float a = expf(e - st) * mv / fmaxf(dn, kDenFloor);
  float part = 0.f;
#pragma unroll
  for (int k = 0; k < KD; ++k) {
    const int j = lane + 32 * k;
    if (j < d) part = fmaf(ctv[k], ign::to_f32(xs[j]), part);
  }
  const float da = warp_sum(part);
  *a_out = a;
  *dp_out = a * (pre > 0.f ? 1.f : kSlope) * (da - sr);
}

template <typename T, typename M, int KD>
__global__ void __launch_bounds__(kRowWarps * 32)
flash_gat_bwd_rows_kernel(const float* __restrict__ ssrc, const float* __restrict__ sdst,
                          const float* __restrict__ stab, const float* __restrict__ den,
                          const float* __restrict__ srow, const T* __restrict__ x,
                          const T* __restrict__ ct, const M* __restrict__ m,
                          float* __restrict__ d_sdst, int bd, int bs, int d, int split) {
  __shared__ float partial[kRowWarps];
  const int g = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kRowWarps / split) + warp / split;
  const int part = warp % split;
  const bool live = row < bd;
  const size_t grow = static_cast<size_t>(g) * bd + row;

  float dsd = 0.f;
  if (live) {
    const float* ss = ssrc + static_cast<size_t>(g) * bs;
    const T* xg = x + static_cast<size_t>(g) * bs * d;
    const float sd = sdst[grow], st = stab[grow], dn = den[grow], sr = srow[grow];
    float ctv[KD];
#pragma unroll
    for (int k = 0; k < KD; ++k) {
      const int j = lane + 32 * k;
      ctv[k] = j < d ? ign::to_f32(ct[grow * d + j]) : 0.f;
    }
    int c0, c1;
    part_range<M>(bs, split, part, &c0, &c1);
    walk_row<M>(m + grow * bs, c0, c1, lane, [&](int s, float mv) {
      float a, dp;
      entry_backward<T, KD>(mv, sd + ss[s], st, dn, sr, ctv,
                            xg + static_cast<size_t>(s) * d, d, lane, &a, &dp);
      dsd += dp;
    });
  }
  if (split > 1) {
    if (lane == 0) partial[warp] = dsd;
    __syncthreads();
    if (part != 0) return;
    dsd = 0.f;
    for (int p = 0; p < split; ++p) dsd += partial[warp + p];  // in range order
  }
  if (live && lane == 0) d_sdst[grow] = dsd;
}

template <typename T, typename M, int KD>
__global__ void __launch_bounds__(kColWarps * 32)
flash_gat_bwd_cols_kernel(const float* __restrict__ ssrc, const float* __restrict__ sdst,
                          const float* __restrict__ stab, const float* __restrict__ den,
                          const float* __restrict__ srow, const T* __restrict__ x,
                          const T* __restrict__ ct, const M* __restrict__ m,
                          float* __restrict__ dtab_plus, int bd, int bs, int d,
                          int row_ranges) {
  constexpr int kVec = 16 / sizeof(M);
  extern __shared__ float smem[];  // [kColWarps][kVec][d + 1]
  const int g = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int strips_per_cta = kColWarps / row_ranges;
  const int col0 = (blockIdx.x * strips_per_cta + warp / row_ranges) * kVec;
  const int range = warp % row_ranges;
  const int width = d + 1;

  float* acc = smem + warp * kVec * width;
  for (int i = lane; i < kVec * width; i += 32) acc[i] = 0.f;
  __syncwarp();

  if (col0 < bs) {
    const int len = round_up((bd + row_ranges - 1) / row_ranges, 32);
    const int r0 = min(bd, range * len), r1 = min(bd, r0 + len);
    const size_t g_rows = static_cast<size_t>(g) * bd;
    const M* mg = m + g_rows * bs;
    const float* ss = ssrc + static_cast<size_t>(g) * bs;
    const T* xg = x + static_cast<size_t>(g) * bs * d;
    auto load = [&](int r) {
      return r < r1 ? load_chunk<M>(mg + static_cast<size_t>(r) * bs, col0, bs)
                    : make_uint4(0u, 0u, 0u, 0u);
    };
    uint4 cur = load(r0 + lane);
    for (int base = r0; base < r1; base += 32) {
      const uint4 nxt = load(base + 32 + lane);
      unsigned hits = __ballot_sync(kFull, any_bits(cur));
      while (hits) {  // rows in order
        const int src_lane = __ffs(hits) - 1;
        hits &= hits - 1;
        const uint4 c = broadcast_chunk(cur, src_lane);
        const size_t grow = g_rows + base + src_lane;
        const float sd = sdst[grow], st = stab[grow], dn = den[grow], sr = srow[grow];
        float ctv[KD];
#pragma unroll
        for (int k = 0; k < KD; ++k) {
          const int j = lane + 32 * k;
          ctv[k] = j < d ? ign::to_f32(ct[grow * d + j]) : 0.f;
        }
        for_each_nonzero<M>(c, [&](int i, float mv) {
          const int s = col0 + i;
          float a, dp;
          entry_backward<T, KD>(mv, sd + ss[s], st, dn, sr, ctv,
                                xg + static_cast<size_t>(s) * d, d, lane, &a, &dp);
          const float ab = ign::round_to<T>(a);
          float* mine = acc + i * width;
#pragma unroll
          for (int k = 0; k < KD; ++k) {
            const int j = lane + 32 * k;
            if (j < d) mine[j] = fmaf(ab, ctv[k], mine[j]);
          }
          if (lane == 0) mine[d] += dp;
        });
      }
      cur = nxt;
    }
  }
  __syncthreads();
  // add the row ranges of each strip in range order and write every column
  const int per_strip = kVec * width;
  for (int idx = threadIdx.x; idx < strips_per_cta * per_strip; idx += blockDim.x) {
    const int strip = idx / per_strip, rem = idx % per_strip;
    const int col = (blockIdx.x * strips_per_cta + strip) * kVec + rem / width;
    if (col >= bs) continue;
    float sum = 0.f;
    for (int r = 0; r < row_ranges; ++r)
      sum += smem[(strip * row_ranges + r) * per_strip + rem];
    dtab_plus[(static_cast<size_t>(g) * bs + col) * width + rem % width] = sum;
  }
}

// ------------------------------------------------------------- host side

struct Args {
  const float *ssrc, *sdst, *stab, *den, *srow;
  const void *x, *ct, *m;
  void* out;
  float *den_out, *dtab_plus, *d_sdst;
  int g, bd, bs, d;
  cudaStream_t stream;
};

// Warps on one row (or row ranges on one strip): the smallest power of two
// up to `most` that puts kTargetWarps warps in flight, each with at least
// `least` of its `extent` entries to walk.
int pick_split(long long units, int extent, int least, int most) {
  int split = 1;
  while (split < most && units * split < kTargetWarps && extent / (2 * split) >= least)
    split *= 2;
  return split;
}

template <typename T, typename M, int KD>
struct Forward {
  static int run(const Args& a) {
    constexpr int kStep = 32 * (16 / sizeof(M));
    const int split = pick_split(static_cast<long long>(a.g) * a.bd, a.bs, kStep, kRowWarps);
    const int rows_per_cta = kRowWarps / split;
    const dim3 grid((a.bd + rows_per_cta - 1) / rows_per_cta, a.g);
    const size_t smem = split > 1 ? sizeof(float) * kRowWarps * (a.d + 1) : 0;
    flash_gat_fwd_kernel<T, M, KD><<<grid, kRowWarps * 32, smem, a.stream>>>(
        a.ssrc, a.sdst, a.stab, static_cast<const T*>(a.x), static_cast<const M*>(a.m),
        static_cast<T*>(a.out), a.den_out, a.bd, a.bs, a.d, split);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, typename M, int KD>
struct Backward {
  static int run(const Args& a) {
    constexpr int kVec = 16 / sizeof(M);
    const T* x = static_cast<const T*>(a.x);
    const T* ct = static_cast<const T*>(a.ct);
    const M* m = static_cast<const M*>(a.m);

    const int split =
        pick_split(static_cast<long long>(a.g) * a.bd, a.bs, 32 * kVec, kRowWarps);
    const int rows_per_cta = kRowWarps / split;
    const dim3 row_grid((a.bd + rows_per_cta - 1) / rows_per_cta, a.g);
    flash_gat_bwd_rows_kernel<T, M, KD><<<row_grid, kRowWarps * 32, 0, a.stream>>>(
        a.ssrc, a.sdst, a.stab, a.den, a.srow, x, ct, m, a.d_sdst, a.bd, a.bs, a.d, split);
    int code = static_cast<int>(cudaGetLastError());
    if (code != 0) return code;

    const int strips = (a.bs + kVec - 1) / kVec;
    const int ranges =
        pick_split(static_cast<long long>(a.g) * strips, a.bd, 32, kColWarps);
    const int strips_per_cta = kColWarps / ranges;
    const dim3 col_grid((strips + strips_per_cta - 1) / strips_per_cta, a.g);
    const size_t smem = sizeof(float) * kColWarps * kVec * (a.d + 1);
    auto kernel = flash_gat_bwd_cols_kernel<T, M, KD>;
    if (smem > 48 * 1024) {
      code = static_cast<int>(cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
      if (code != 0) return code;
    }
    kernel<<<col_grid, kColWarps * 32, smem, a.stream>>>(
        a.ssrc, a.sdst, a.stab, a.den, a.srow, x, ct, m, a.dtab_plus, a.bd, a.bs, a.d,
        ranges);
    return static_cast<int>(cudaGetLastError());
  }
};

template <template <typename, typename, int> class Op, typename T, typename M>
int dispatch_width(const Args& a) {
  if (a.d <= 32) return Op<T, M, 1>::run(a);
  if (a.d <= 64) return Op<T, M, 2>::run(a);
  return Op<T, M, 4>::run(a);
}

template <template <typename, typename, int> class Op>
int dispatch(const Args& a, int x_dtype, int m_dtype) {
  if (a.g <= 0 || a.bd <= 0 || a.bs <= 0 || a.d <= 0 || a.d > 128 || a.g > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool m_int8 = m_dtype == ign::kInt8;
  if (!m_int8 && m_dtype != ign::kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
  switch (x_dtype) {
    case ign::kFloat32:
      return m_int8 ? dispatch_width<Op, float, uint8_t>(a)
                    : dispatch_width<Op, float, uint16_t>(a);
    case ign::kBFloat16:
      return m_int8 ? dispatch_width<Op, __nv_bfloat16, uint8_t>(a)
                    : dispatch_width<Op, __nv_bfloat16, uint16_t>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// out [g, bd, d] in x's type and den [g, bd] f32 from ssrc [g, bs], sdst and
// stab [g, bd] (f32), x [g, bs, d] (f32 or bf16) and m [g, bd, bs] (int8 or
// bf16); d up to 128.
extern "C" int ign_flash_gat_fwd(const void* ssrc, const void* sdst, const void* stab,
                                 const void* x, const void* m, void* out, void* den, int g,
                                 int bd, int bs, int d, int x_dtype, int m_dtype,
                                 void* stream) {
  Args a{};
  a.ssrc = static_cast<const float*>(ssrc);
  a.sdst = static_cast<const float*>(sdst);
  a.stab = static_cast<const float*>(stab);
  a.x = x;
  a.m = m;
  a.out = out;
  a.den_out = static_cast<float*>(den);
  a.g = g, a.bd = bd, a.bs = bs, a.d = d;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<Forward>(a, x_dtype, m_dtype);
}

// dtab_plus [g, bs, d + 1] f32 ([..., :d] = d_table, [..., d] = d_ssrc) and
// d_sdst [g, bd] f32; den and srow [g, bd] f32, ct [g, bd, d] in x's type.
extern "C" int ign_flash_gat_bwd(const void* ssrc, const void* sdst, const void* stab,
                                 const void* den, const void* srow, const void* x,
                                 const void* ct, const void* m, void* dtab_plus,
                                 void* d_sdst, int g, int bd, int bs, int d, int x_dtype,
                                 int m_dtype, void* stream) {
  Args a{};
  a.ssrc = static_cast<const float*>(ssrc);
  a.sdst = static_cast<const float*>(sdst);
  a.stab = static_cast<const float*>(stab);
  a.den = static_cast<const float*>(den);
  a.srow = static_cast<const float*>(srow);
  a.x = x;
  a.ct = ct;
  a.m = m;
  a.dtab_plus = static_cast<float*>(dtab_plus);
  a.d_sdst = static_cast<float*>(d_sdst);
  a.g = g, a.bd = bd, a.bs = bs, a.d = d;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<Backward>(a, x_dtype, m_dtype);
}
