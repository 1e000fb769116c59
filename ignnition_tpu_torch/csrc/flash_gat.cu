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
// Design of D: one streamed pass over m, one launch.
//   row blocks  a CTA of 8 warps owns R consecutive rows of one graph over
//      all bs columns and writes their out and den itself. R is 8, a row a
//      warp, unless that leaves fewer CTAs than the card has SMs: then R
//      halves, down to 1, and the `split` = 8 / R warps of a row walk equal
//      column ranges of it (whole 512-byte steps), whose partial sums meet in
//      shared memory and are added in range order. 256 CTAs of 8 rows at the
//      flagship and at [4, 512, 4096], 2 an SM.
//   the ring  each warp streams its range of m through a ring of its own of
//      4 stages of 2 KB, by 16-byte cp.async copies: 6 KB in flight a warp,
//      96 KB an SM at 2 CTAs (Little's law asks ~25 KB at 3.35 TB/s). Lane l
//      copies and later reads chunks 32 q + l of a stage, so each instruction
//      covers 512 contiguous bytes, a warp's shared-memory reads hit no bank
//      twice, and no lane waits for another's copies. cp.async and not TMA:
//      the library stays plain C. Rows that cannot take 16-byte copies (bs *
//      item size not a multiple of 16, an unaligned base) take element loads
//      into the same ring.
//   batches  a lane turns its four chunks of a stage into a bit mask of
//      their non-zeros (byte or half-word compares); a warp scan of the
//      counts appends (column, m value) to the warp's list in shared memory,
//      in (lane, chunk, entry) order. The list holds 128, two flagship rows'
//      worth, so most rows are handled once, at their end; a denser row is
//      handled whenever the list is full, while the ring's copies stay in
//      flight. Handling: groups of D * item / 16 lanes (4 at bf16 D = 32, a
//      lane 16 bytes of a row) issue the x-row loads of a round (8 a lane)
//      first; meanwhile one lane per non-zero loads ssrc[s] and forms z (32
//      exps an instruction), which replaces m in the list; then each group
//      adds its non-zeros. A row of x whose bytes are not a multiple of 16
//      (D = 20 at bf16) takes scalar loads in the same groups. A full row
//      only runs more batches: no shape is refused.
//   fixed-order sums  each group adds its non-zeros (every ng-th of the
//      list) in list order into f32 registers, and each lane the z of its
//      list slots; at the range's end a fixed shuffle tree adds the groups
//      and a butterfly the lanes. No atomics.
//   Each batch costs one round trip for its ssrc and x rows, and the stream
//   goes on in the other warps meanwhile: what is left is the read of m, the
//   fill of the ring and each row's last batch (PERF.md §6). Batches of 32,
//   each a round trip, cost 10-20% more; prefetching x or each listed
//   non-zero's row into L2, 6 stages, and L2 prefetch hints on the copies
//   gained nothing.
//
// Design of E: one streamed pass over m, two launches.
//   strips  a CTA owns a strip of 64 bytes of columns (64 int8 or 32 bf16
//      entries: two 32-byte sectors a row) of one graph over all bd rows, so
//      it writes d_table and d_ssrc of its columns itself (256 CTAs at the
//      flagship, 2 an SM). 256 threads walk the rows in tiles of 256 rows
//      (16 KB), streamed by 16-byte cp.async copies into a ring of 4 stages:
//      48 KB of m in flight a CTA, 2 CTAs an SM at D <= 32, 1 past that
//      (Little's law asks ~25 KB an SM at 3.35 TB/s). cp.async and not
//      TMA: the library stays plain C with no
//      `cuTensorMapEncodeTiled` tensor map, and each row's four chunks land
//      permuted by (row / 2) % 4, so that the thread of a row reads it
//      without bank conflicts. Rows that cannot take 16-byte copies (bs *
//      item size not a multiple of 16, an unaligned base) take element loads
//      into the same ring.
//   the list  thread t turns row t of a tile into a bit mask of its
//      non-zeros (byte or half-word compares gathered by one multiply); a
//      block scan of the counts appends them to a shared list of the strip
//      in row-major order (row and column in arrays of their own, so any bd
//      fits). The list is handled ("flushed") when it holds as many as the
//      113 KB of shared memory of 2 CTAs an SM leave room for, and at the
//      end: `cap` of `bwd_layout`, which `ign_flash_gat_bwd_layout` reports
//      (544 at D = 32 with bf16 x, 320 with f32 x; a flagship strip holds
//      ~511 on average).
//   a flush, lane-parallel  one thread per non-zero forms pre, a, a rounded
//      to x's type and dp, with da = ct[d] . x[s] from 16-byte loads of both
//      rows, and keeps the ct row beside the list; meanwhile one warp sorts
//      the list by column, stably (match_any ranks, a scan of the counts).
//      Then each column's group of 4 (int8) or 8 (bf16 m) lanes, a lane a
//      slice of D, adds ab * ct[d, slice] and dp of its column's non-zeros
//      in row order into registers, and the first thread of each row's run
//      adds the run's dp in column order into the strip's partial of d_sdst.
//   fixed-order sums  the partials go to a scratch [strips, G, bd] (2 MB at
//      the flagship); a second kernel sums each row's partials in strip
//      order (16 warps a CTA on 32 rows, each on a sixteenth of the strips,
//      then the warps in order).
//   m is read once, each partial written and read once; the bound counts one
//   read of m. On the card a flush is the tail that the stream does not hide
//   (PERF.md §6).
// No atomics anywhere: every sum has a fixed order, so results repeat
// bitwise from run to run.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr float kSlope = 0.2f;     // LeakyReLU negative slope
constexpr float kDenFloor = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFwdWarps = 8;      // warps of a CTA of kernel D: up to 8 rows
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kFwdChunks = 4;     // 16-byte chunks a lane copies into each stage
constexpr int kSliceBytes = 32 * 16 * kFwdChunks;  // bytes of m a warp's stage holds
constexpr int kFwdStages = 4;     // stages of a warp's ring: three in flight while one is read
constexpr int kBatch = 128;       // non-zeros a warp lists, then handles together
constexpr int kInFlight = 8;      // x-row loads a lane issues before its first fma

// m's storage types: int8 as uint8_t, bf16 as uint16_t (raw bits).
template <typename M>
struct Entry;
template <>
struct Entry<uint8_t> {
  static __device__ __forceinline__ float value(uint32_t bits) {
    return static_cast<float>(static_cast<signed char>(bits));
  }
};
template <>
struct Entry<uint16_t> {
  static __device__ __forceinline__ float value(uint32_t bits) {
    return __uint_as_float(bits << 16);
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bit i set where entry i of a 16-byte chunk of m is non-zero (16 / sizeof(M)
// bits).
template <typename M>
__device__ __forceinline__ uint32_t chunk_mask(const uint4& q) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  uint32_t mask = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t bits;
    if (sizeof(M) == 1) {  // the top bit of each byte's compare, gathered into 4 bits
      bits = ((__vcmpne4(w[k], 0u) & 0x80808080u) * 0x00204081u) >> 28;
    } else {  // a bf16 of either sign that is not zero
      const uint32_t h = __vcmpne2(w[k] & 0x7fff7fffu, 0u);
      bits = (h & 1u) | ((h >> 15) & 2u);
    }
    mask |= bits << (k * (4 / sizeof(M)));
  }
  return mask;
}

// The values of a 16-byte chunk as floats: 8 bf16 or 4 f32, told apart by
// the length of `f`.
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// 16 bytes of T from 16 / sizeof(T) floats, each rounded to nearest.
__device__ __forceinline__ uint4 pack16(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ uint4 pack16(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

__device__ __forceinline__ int round_up(int v, int to) { return (v + to - 1) / to * to; }

// ---------------------------------------------------------------- kernel D

// Shared memory of kernel D at width d: the warps' rings, their lists
// (column, m value) and the partial sums of split rows ([warp][d + 1]).
constexpr size_t fwd_smem_bytes(int d) {
  return static_cast<size_t>(kFwdWarps) *
         (kFwdStages * kSliceBytes + kBatch * (sizeof(int) + sizeof(float)) +
          sizeof(float) * (d + 1));
}

// One CTA: rows blockIdx.x * R .. + R of graph blockIdx.y, R = kFwdWarps /
// split; warp w walks part w % split of row w / split (every column when
// split is 1). `aligned`: rows of whole 16-byte chunks at a 16-byte aligned
// base (cp.async copies); `vec`: x rows and out rows of whole 16-byte
// chunks at aligned bases (16-byte loads and stores).
template <typename T, typename M>
__global__ void __launch_bounds__(kFwdThreads, 2)
flash_gat_fwd_kernel(const float* __restrict__ ssrc, const float* __restrict__ sdst,
                     const float* __restrict__ stab, const T* __restrict__ x,
                     const M* __restrict__ m, T* __restrict__ out,
                     float* __restrict__ den, int bd, int bs, int d, int split, bool aligned,
                     bool vec) {
  constexpr int kVec = 16 / sizeof(M);            // entries of m in a chunk
  constexpr int kPer = 16 / sizeof(T);            // values of x in a chunk
  constexpr int kW = kSliceBytes / sizeof(M);     // entries of m in a stage
  extern __shared__ uint4 smem_u4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem_u4) + warp * (kFwdStages * kSliceBytes);
  float* lists = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(smem_u4) +
                                          kFwdWarps * (kFwdStages * kSliceBytes));
  int* list_col = reinterpret_cast<int*>(lists) + warp * kBatch;
  float* list_mv = lists + (kFwdWarps + warp) * kBatch;
  float* partial = lists + 2 * kFwdWarps * kBatch;

  const int g = blockIdx.y;
  const int row = blockIdx.x * (kFwdWarps / split) + warp / split;
  const int part = warp % split;
  const bool live = row < bd;
  const size_t grow = static_cast<size_t>(g) * bd + row;

  // x rows are read by groups of lg lanes, lane `slice` of a group holding
  // values j0 .. j0 + kPer of the row; ng groups a warp, the rest idle
  const int lg = (d + kPer - 1) / kPer;
  const int ng = 32 / lg;
  const int grp = lane / lg, slice = lane % lg;
  const int j0 = slice * kPer;
  float acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = 0.f;
  float dsum = 0.f;  // the z of this lane's list slots

  if (live) {
    const float* ss = ssrc + static_cast<size_t>(g) * bs;
    const T* xg = x + static_cast<size_t>(g) * bs * d;
    const M* mrow = m + grow * bs;
    const float sd = sdst[grow], st = stab[grow];
    const int len = round_up((bs + split - 1) / split, 32 * kVec);
    const int c0 = min(bs, part * len), c1 = min(bs, c0 + len);
    const int n_stages = (c1 - c0 + kW - 1) / kW;

    // stage t: entries c0 + t * kW .. of the range; lane copies chunks
    // q * 32 + lane, zeros past c1
    auto load_stage = [&](int t) {
      uint8_t* slot = ring + (t % kFwdStages) * kSliceBytes;
#pragma unroll
      for (int q = 0; q < kFwdChunks; ++q) {
        const int i = q * 32 + lane;
        const int e = c0 + t * kW + i * kVec;
        uint8_t* dst = slot + i * 16;
        if (aligned)
          cp_async16(dst, e < c1 ? static_cast<const void*>(mrow + e) : mrow, e < c1 ? 16 : 0);
        else
          *reinterpret_cast<uint4*>(dst) =
              e < c1 ? load_chunk<M>(mrow, e, c1) : make_uint4(0u, 0u, 0u, 0u);
      }
    };

    // the n listed non-zeros: z one lane each (z replaces m in the list), x
    // rows by lane groups, the loads of a round issued before its first fma
    auto handle = [&](int n) {
      __syncwarp();  // the list is complete
      for (int base = 0; base < n; base += ng * kInFlight) {
        uint4 u[kInFlight];
#pragma unroll
        for (int t = 0; t < kInFlight; ++t) {
          const int j = base + grp + ng * t;
          u[t] = make_uint4(0u, 0u, 0u, 0u);
          if (vec && grp < ng && j < n)
            u[t] = __ldg(reinterpret_cast<const uint4*>(
                xg + static_cast<size_t>(list_col[j]) * d + j0));
        }
        if (base == 0) {  // while the first round's x rows are on their way
          float sv[kBatch / 32];
#pragma unroll
          for (int r = 0; r < kBatch / 32; ++r) {
            const int i = r * 32 + lane;
            sv[r] = i < n ? __ldg(ss + list_col[i]) : 0.f;
          }
#pragma unroll
          for (int r = 0; r < kBatch / 32; ++r) {
            const int i = r * 32 + lane;
            if (i >= n) continue;
            const float pre = sd + sv[r];
            const float e = fmaxf(pre, kSlope * pre);
            const float z = ign::round_to<T>(expf(e - st) * list_mv[i]);
            list_mv[i] = z;
            dsum += z;
          }
          __syncwarp();
        }
#pragma unroll
        for (int t = 0; t < kInFlight; ++t) {
          const int j = base + grp + ng * t;
          if (grp >= ng || j >= n) continue;
          const float zj = list_mv[j];
          if (vec) {
            float f[kPer];
            unpack16(u[t], f);
#pragma unroll
            for (int k = 0; k < kPer; ++k) acc[k] = fmaf(zj, f[k], acc[k]);
          } else {
            const T* xr = xg + static_cast<size_t>(list_col[j]) * d;
#pragma unroll
            for (int k = 0; k < kPer; ++k)
              if (j0 + k < d) acc[k] = fmaf(zj, ign::to_f32(xr[j0 + k]), acc[k]);
          }
        }
      }
      __syncwarp();  // the list may be written again
    };

#pragma unroll
    for (int t = 0; t < kFwdStages - 1; ++t) {
      if (t < n_stages) load_stage(t);
      cp_async_commit();
    }
    int listed = 0;  // entries in the list; the same in every lane
    for (int t = 0; t < n_stages; ++t) {
      cp_async_wait<kFwdStages - 2>();  // this lane's copies of stage t have landed
      if (t + kFwdStages - 1 < n_stages) load_stage(t + kFwdStages - 1);
      cp_async_commit();

      // this lane's non-zeros of the stage: bit q * kVec + b is entry b of
      // chunk q * 32 + lane
      const uint8_t* slot = ring + (t % kFwdStages) * kSliceBytes;
      unsigned long long mask = 0ull;
#pragma unroll
      for (int q = 0; q < kFwdChunks; ++q) {
        const uint4 c = *reinterpret_cast<const uint4*>(slot + (q * 32 + lane) * 16);
        if ((c.x | c.y | c.z | c.w) != 0u)
          mask |= static_cast<unsigned long long>(chunk_mask<M>(c)) << (q * kVec);
      }
      const int cnt = __popcll(mask);
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      const int total = __shfl_sync(kFull, incl, 31);
      // append the stage's entries [b0, b0 + take) at `listed`, a batch at a time
      int k = incl - cnt;  // this lane's next entry, by its rank in the stage
      for (int b0 = 0; b0 < total;) {
        const int take = min(total - b0, kBatch - listed);
        for (; mask != 0ull && k < b0 + take; ++k) {
          const int bit = __ffsll(static_cast<long long>(mask)) - 1;
          mask &= mask - 1;
          const int i = (bit / kVec) * 32 + lane, b = bit % kVec;
          list_col[listed + k - b0] = c0 + t * kW + i * kVec + b;
          list_mv[listed + k - b0] =
              Entry<M>::value(*reinterpret_cast<const M*>(slot + i * 16 + b * sizeof(M)));
        }
        listed += take;
        b0 += take;
        if (listed == kBatch) {
          handle(kBatch);
          listed = 0;
        }
      }
    }
    cp_async_wait<0>();
    if (listed > 0) handle(listed);
  }

  // the lanes' z in a fixed butterfly; the groups' sums into group 0
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dsum += __shfl_xor_sync(kFull, dsum, o);
  for (int o = 1; o < ng; o <<= 1) {
    const bool adds = grp % (2 * o) == 0 && grp + o < ng;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const float v = __shfl_down_sync(kFull, acc[k], o * lg);
      if (adds) acc[k] += v;
    }
  }
  if (split > 1) {  // the ranges' partial sums, added in range order
    float* mine = partial + warp * (d + 1);
    if (grp == 0) {
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        if (j0 + k < d) mine[j0 + k] = acc[k];
    }
    if (lane == 0) mine[d] = dsum;
    __syncthreads();
    if (part != 0) return;
    dsum = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) acc[k] = 0.f;
    for (int p = 0; p < split; ++p) {
      const float* other = partial + (warp + p) * (d + 1);
      if (grp == 0) {
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          if (j0 + k < d) acc[k] += other[j0 + k];
      }
      dsum += other[d];
    }
  }
  if (!live) return;
  if (grp == 0) {
    const float denom = fmaxf(dsum, kDenFloor);
    float v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[k] = acc[k] / denom;
    T* o = out + grow * d + j0;
    if (vec) {
      *reinterpret_cast<uint4*>(o) = pack16(v);
    } else {
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        if (j0 + k < d) o[k] = ign::from_f32<T>(v[k]);
    }
  }
  if (lane == 0) den[grow] = dsum;
}

// ---------------------------------------------------------------- kernel E

constexpr int kStripBytes = 64;   // bytes of each row of m that one CTA's strip holds
constexpr int kTileRows = 256;    // rows of m a pipeline stage holds: one per thread
constexpr int kBwdThreads = kTileRows;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kStages = 4;        // tiles in the ring: three in flight while one is read
constexpr int kStageBytes = kTileRows * kStripBytes;
constexpr int kListMax = 1024;    // non-zeros a strip lists before it handles them
constexpr int kSmemPerCta = 113 * 1024;  // 2 CTAs an SM
constexpr int kSumWarps = 16;     // warps of a CTA of the row-sum kernel, 32 rows a CTA

// Where 16-byte chunk `chunk` of row `r` of a stage lies: the chunks of a row
// are permuted by (r / 2) % 4, so that eight threads reading chunk q of
// eight neighbouring rows hit eight different groups of banks.
__device__ __forceinline__ int chunk_at(int r, int chunk) {
  return r * kStripBytes + 16 * (chunk ^ ((r >> 1) & 3));
}

// Rows row0 .. row0 + kTileRows of the strip that starts at column col0 into
// a stage of the ring, zeros past bd and bs. `aligned` (rows of whole 16-byte
// chunks at a 16-byte aligned base): 16-byte cp.async copies that land while
// the CTA works on earlier tiles; otherwise element loads, stored at once.
template <typename M>
__device__ __forceinline__ void load_tile(uint8_t* stage, const M* __restrict__ mg, int row0,
                                          int bd, int bs, int col0, bool aligned) {
  constexpr int kChunks = kStripBytes / 16;
  constexpr int kVec = 16 / sizeof(M);
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    const int i = threadIdx.x + q * kBwdThreads;  // 4 neighbouring threads a row
    const int r = i / kChunks, c = col0 + (i % kChunks) * kVec;
    const int row = row0 + r;
    uint8_t* dst = stage + chunk_at(r, i % kChunks);
    const bool in = row < bd && c < bs;
    const M* src = mg + static_cast<size_t>(row) * bs;
    if (aligned)
      cp_async16(dst, in ? static_cast<const void*>(src + c) : mg, in ? 16 : 0);
    else
      *reinterpret_cast<uint4*>(dst) =
          in ? load_chunk<M>(src, c, bs) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Bit c set where entry c of row r of a stage is non-zero.
template <typename M>
__device__ __forceinline__ unsigned long long nonzero_mask(const uint8_t* stage, int r) {
  unsigned long long mask = 0ull;
#pragma unroll
  for (int i = 0; i < kStripBytes / 16; ++i) {
    const uint4 q = *reinterpret_cast<const uint4*>(stage + chunk_at(r, i));
    if ((q.x | q.y | q.z | q.w) == 0u) continue;
    mask |= static_cast<unsigned long long>(chunk_mask<M>(q)) << (i * (16 / sizeof(M)));
  }
  return mask;
}

// s + a . b over the 16 bytes of two chunks of T.
template <typename T>
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b, float s);
template <>
__device__ __forceinline__ float dot16<__nv_bfloat16>(const uint4& a, const uint4& b,
                                                      float s) {
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(pa[i]), fb = __bfloat1622float2(pb[i]);
    s = fmaf(fa.x, fb.x, s);
    s = fmaf(fa.y, fb.y, s);
  }
  return s;
}
template <>
__device__ __forceinline__ float dot16<float>(const uint4& a, const uint4& b, float s) {
  s = fmaf(__uint_as_float(a.x), __uint_as_float(b.x), s);
  s = fmaf(__uint_as_float(a.y), __uint_as_float(b.y), s);
  s = fmaf(__uint_as_float(a.z), __uint_as_float(b.z), s);
  return fmaf(__uint_as_float(a.w), __uint_as_float(b.w), s);
}

// Shared memory of the strip kernel with a list of `cap` non-zeros: the
// ring, the ct rows of the listed non-zeros (cap x d items of `item` bytes),
// the list (row, m, a rounded to T, dp, the rank among its column's
// non-zeros, the list in column order), the columns' counts and starts, the
// warps' counts, the carried row sum, and the list's columns (a byte each).
constexpr size_t bwd_smem_bytes(int cap, int d, int item) {
  return static_cast<size_t>(kStages) * kStageBytes + static_cast<size_t>(cap) * d * item +
         (6 * sizeof(float) + 1) * cap +
         sizeof(int) * (2 * (kStripBytes + 1) + kBwdWarps) + 4 * sizeof(float);
}

// The strip kernel's layout: the strips of a graph's bs columns (`part` is
// [strips, G, bd] f32) and the non-zeros a strip's list holds, the most (a
// multiple of 32, up to kListMax) that leave 2 CTAs an SM.
struct BwdLayout {
  int strips, cap;
};
BwdLayout bwd_layout(int bs, int d, int x_item, int m_item) {
  const int w = kStripBytes / m_item;
  const long long base = static_cast<long long>(bwd_smem_bytes(0, d, x_item));
  const long long per_entry = static_cast<long long>(bwd_smem_bytes(1, d, x_item)) - base;
  const long long room = kSmemPerCta - base;
  const long long cap =
      std::min<long long>(kListMax, std::max<long long>(32, room / per_entry / 32 * 32));
  return {(bs + w - 1) / w, static_cast<int>(cap)};
}

// One CTA: the strip of W = kStripBytes / sizeof(M) columns at blockIdx.x of
// graph blockIdx.y, over all bd rows, in tiles of kTileRows rows streamed
// through a ring of kStages stages.
//   scan     (per tile) thread t reads row t of the tile into a bit mask of
//            its non-zeros; a block-wide scan of the counts appends them to
//            the strip's list in row-major order (rows, then columns,
//            ascending). A row without any writes its partial 0.
//   flush    (when the list holds `cap` non-zeros, and at the end):
//     entries  one thread per non-zero (all warps but the last): pre, a, a
//              rounded to T, lrelu'(pre), da = ct[d] . x[s] from 16-byte
//              loads, dp; the ct row is kept in shared memory beside the
//              list; meanwhile the last warp sorts the list by column,
//              stably (rows stay ascending);
//     columns  warp w owns W / 8 columns, a group of 32 / (W / 8) lanes
//              each, a lane a slice of D; the group adds ab * ct[d, slice]
//              and dp of its column's non-zeros into registers, rows
//              ascending;
//     rows     the first thread of each row's run in the list adds its dp in
//              column order and writes the strip's partial of d_sdst; a run
//              that reaches the list's end is carried into the next flush.
// Each lane group writes its column of d_table and d_ssrc at the end: nothing
// is summed across CTAs but `part`, which flash_gat_bwd_rowsum_kernel sums in
// strip order.
template <typename T, typename M, int KD>
// 2 CTAs an SM (128 registers) at D <= 32; past that the sums (16 or 32 a
// lane where m is int8) spill at 128, so 1 CTA an SM
__global__ void __launch_bounds__(kBwdThreads, KD == 1 ? 2 : 1)
flash_gat_bwd_strip_kernel(const float* __restrict__ ssrc, const float* __restrict__ sdst,
                           const float* __restrict__ stab, const float* __restrict__ den,
                           const float* __restrict__ srow, const T* __restrict__ x,
                           const T* __restrict__ ct, const M* __restrict__ m,
                           float* __restrict__ dtab_plus, float* __restrict__ part, int bd,
                           int bs, int d, int cap, bool aligned, bool vec) {
  constexpr int W = kStripBytes / sizeof(M);
  constexpr int kCols = W / kBwdWarps;  // columns whose sums a warp owns
  extern __shared__ uint4 smem_u4[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem_u4);
  T* stash = reinterpret_cast<T*>(ring + kStages * kStageBytes);  // [cap][d]
  int* list_row = reinterpret_cast<int*>(stash + static_cast<size_t>(cap) * d);
  float* list_mv = reinterpret_cast<float*>(list_row + cap);
  float* list_ab = list_mv + cap;
  float* list_dp = list_ab + cap;
  int* col_rank = reinterpret_cast<int*>(list_dp + cap);
  int* by_col = col_rank + cap;  // list indices, column by column
  int* col_count = by_col + cap;  // [W + 1]: the last one counts past-the-end lanes
  int* col_start = col_count + kStripBytes + 1;  // [W + 1]
  int* warp_total = col_start + kStripBytes + 1;
  int* carry_row = warp_total + kBwdWarps;  // [2]: into this flush, out of it
  float* carry_sum = reinterpret_cast<float*>(carry_row + 2);
  uint8_t* list_col = reinterpret_cast<uint8_t*>(carry_sum + 2);  // column in the strip

  const int g = blockIdx.y;
  const int col0 = blockIdx.x * W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t g_rows = static_cast<size_t>(g) * bd;
  const M* mg = m + g_rows * bs;
  const float* ss = ssrc + static_cast<size_t>(g) * bs;
  const T* xg = x + static_cast<size_t>(g) * bs * d;
  const T* ctg = ct + g_rows * d;
  float* part_g = part + (static_cast<size_t>(blockIdx.x) * gridDim.y + g) * bd;

  // lane group `mine_col` of kLanes lanes holds column warp * kCols + mine_col
  // of d_table, each lane kVals values from j0 on, and (lane j0 = 0) d_ssrc
  constexpr int kLanes = 32 / kCols;
  constexpr int kVals = 32 * KD / kLanes;
  const int mine_col = lane / kLanes, j0 = (lane % kLanes) * kVals;
  float acc[kVals], acc_ss = 0.f;
#pragma unroll
  for (int v = 0; v < kVals; ++v) acc[v] = 0.f;
  if (tid == 0) carry_row[0] = -1;

  auto flush = [&](int n) {
    __syncthreads();  // the list is complete
    if (warp == kBwdWarps - 1) {
      // ---- the list in column order: a stable counting sort
      for (int c = lane; c <= W; c += 32) col_count[c] = 0;
      __syncwarp();
      for (int base = 0; base < n; base += 32) {
        const int i = base + lane;
        const int c = i < n ? list_col[i] : W;
        const unsigned same = __match_any_sync(kFull, c);
        const int rank = __popc(same & ((1u << lane) - 1u));
        const int before = col_count[c];
        __syncwarp();
        if (i < n) col_rank[i] = before + rank;
        if (rank == 0) col_count[c] = before + __popc(same);
        __syncwarp();
      }
      int sum = 0;  // exclusive scan of the counts, 32 columns at a time
      for (int c0 = 0; c0 < W; c0 += 32) {
        const int v = col_count[c0 + lane];
        int incl = v;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += u;
        }
        col_start[c0 + lane] = sum + incl - v;
        sum += __shfl_sync(kFull, incl, 31);
      }
      if (lane == 0) col_start[W] = sum;
      __syncwarp();
      for (int i = lane; i < n; i += 32) by_col[col_start[list_col[i]] + col_rank[i]] = i;
    } else {
      // ---- entries: one thread per non-zero
      for (int i = tid; i < n; i += kBwdThreads - 32) {
        const int r = list_row[i], s = col0 + list_col[i];
        const size_t grow = g_rows + r;
        const float pre = sdst[grow] + ss[s];
        const float st = stab[grow], dn = den[grow], sr = srow[grow];
        const T* ctr = ctg + static_cast<size_t>(r) * d;
        const T* xr = xg + static_cast<size_t>(s) * d;
        T* kept = stash + static_cast<size_t>(i) * d;
        float da = 0.f;
        if (vec) {
          const int nq = d * static_cast<int>(sizeof(T)) / 16;
#pragma unroll 1  // more in flight costs registers past 2 CTAs an SM
          for (int q = 0; q < nq; ++q) {
            const uint4 u = __ldg(reinterpret_cast<const uint4*>(ctr) + q);
            reinterpret_cast<uint4*>(kept)[q] = u;
            da = dot16<T>(u, __ldg(reinterpret_cast<const uint4*>(xr) + q), da);
          }
        } else {
          for (int j = 0; j < d; ++j) {
            const T cv = ctr[j];
            kept[j] = cv;
            da = fmaf(ign::to_f32(cv), ign::to_f32(xr[j]), da);
          }
        }
        const float e = fmaxf(pre, kSlope * pre);
        const float a = expf(e - st) * list_mv[i] / fmaxf(dn, kDenFloor);
        list_ab[i] = ign::round_to<T>(a);
        list_dp[i] = a * (pre > 0.f ? 1.f : kSlope) * (da - sr);
      }
    }
    __syncthreads();
    // ---- columns: each lane group adds its column's non-zeros in list order
    const bool vec_slice = vec && (kVals * sizeof(T)) % 16 == 0 && j0 + kVals <= d;
    const int my_col = warp * kCols + mine_col;
    for (int k = col_start[my_col]; k < col_start[my_col + 1]; ++k) {
      const int j = by_col[k];
      const float ab = list_ab[j];
      const T* kept = stash + static_cast<size_t>(j) * d + j0;
      if (vec_slice) {
        constexpr int kPer = 16 / sizeof(T);
#pragma unroll
        for (int q = 0; q < kVals / kPer; ++q) {
          float f[kPer];
          unpack16(reinterpret_cast<const uint4*>(kept)[q], f);
#pragma unroll
          for (int v = 0; v < kPer; ++v) acc[q * kPer + v] = fmaf(ab, f[v], acc[q * kPer + v]);
        }
      } else {
#pragma unroll
        for (int v = 0; v < kVals; ++v)
          if (j0 + v < d) acc[v] = fmaf(ab, ign::to_f32(kept[v]), acc[v]);
      }
      if (j0 == 0) acc_ss += list_dp[j];
    }
    // ---- rows: the first thread of each row's run adds the run in order
    for (int i = tid; i < n; i += kBwdThreads) {
      const int r = list_row[i];
      if (i > 0 && list_row[i - 1] == r) continue;
      float sum = 0.f;
      if (i == 0) {
        if (carry_row[0] == r)
          sum = carry_sum[0];
        else if (carry_row[0] >= 0)
          part_g[carry_row[0]] = carry_sum[0];
      }
      int j = i;
      for (; j < n && list_row[j] == r; ++j) sum += list_dp[j];
      if (j == n) {  // the run may go on in the next flush
        carry_row[1] = r;
        carry_sum[1] = sum;
      } else {
        part_g[r] = sum;
      }
    }
    __syncthreads();
    if (tid == 0) {
      carry_row[0] = carry_row[1];
      carry_sum[0] = carry_sum[1];
    }
  };

  const int n_tiles = (bd + kTileRows - 1) / kTileRows;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles)
      load_tile<M>(ring + t * kStageBytes, mg, t * kTileRows, bd, bs, col0, aligned);
    cp_async_commit();
  }
  int listed = 0;  // non-zeros in the list; the same in every thread
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // the tile is in shared memory, and every thread is done with the last
    const int ahead = tile + kStages - 1;  // into the stage of the last tile
    if (ahead < n_tiles)
      load_tile<M>(ring + (ahead % kStages) * kStageBytes, mg, ahead * kTileRows, bd, bs,
                   col0, aligned);
    cp_async_commit();

    // ---- scan: this thread's row, its count and its place in the tile
    const int row = tile * kTileRows + tid;
    const uint8_t* stage = ring + (tile % kStages) * kStageBytes;
    const unsigned long long nz = nonzero_mask<M>(stage, tid);
    const int cnt = __popcll(nz);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    int off = incl - cnt, total = 0;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) {
      const int v = warp_total[w];
      off += w < warp ? v : 0;
      total += v;
    }
    if (cnt == 0 && row < bd) part_g[row] = 0.f;

    // ---- append the tile's non-zeros [b0, b0 + take) at `listed`
    for (int b0 = 0; b0 < total;) {
      if (listed == cap) {
        flush(cap);
        listed = 0;
      }
      const int take = min(total - b0, cap - listed);
      if (cnt > 0 && off < b0 + take && off + cnt > b0) {
        unsigned long long left = nz;
        for (int k = off; left != 0ull && k < b0 + take; ++k) {  // columns ascending
          const int c = __ffsll(static_cast<long long>(left)) - 1;
          left &= left - 1;
          if (k < b0) continue;
          constexpr int kVec = 16 / sizeof(M);
          const uint32_t bits = *reinterpret_cast<const M*>(
              stage + chunk_at(tid, c / kVec) + (c % kVec) * sizeof(M));
          list_row[listed + k - b0] = row;
          list_col[listed + k - b0] = static_cast<uint8_t>(c);
          list_mv[listed + k - b0] = Entry<M>::value(bits);
        }
      }
      listed += take;
      b0 += take;
    }
  }
  cp_async_wait<0>();
  if (listed > 0) flush(listed);
  __syncthreads();
  if (tid == 0 && carry_row[0] >= 0) part_g[carry_row[0]] = carry_sum[0];

  // each lane's values of its column of dtab_plus: d_table, then d_ssrc
  const int col = col0 + warp * kCols + mine_col;
  if (col < bs) {
    float* out = dtab_plus + (static_cast<size_t>(g) * bs + col) * (d + 1);
#pragma unroll
    for (int v = 0; v < kVals; ++v)
      if (j0 + v < d) out[j0 + v] = acc[v];
    if (j0 == 0) out[d] = acc_ss;
  }
}

// d_sdst[g, row] = the strips' partials summed in strip order: warp w of a
// CTA adds strips [w * per, (w + 1) * per) for 32 rows (lane = row), then
// warp 0 adds the warps' sums in warp order.
__global__ void __launch_bounds__(kSumWarps * 32)
flash_gat_bwd_rowsum_kernel(const float* __restrict__ part, float* __restrict__ d_sdst,
                            int bd, int n_strips) {
  __shared__ float partial[kSumWarps][32];
  const int g = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 32 + lane;
  const int per = (n_strips + kSumWarps - 1) / kSumWarps;
  const int p0 = min(n_strips, warp * per), p1 = min(n_strips, p0 + per);
  const size_t stride = static_cast<size_t>(gridDim.y) * bd;
  float sum = 0.f;
  if (row < bd) {
    const float* src = part + static_cast<size_t>(g) * bd + row;
#pragma unroll 8
    for (int p = p0; p < p1; ++p) sum += src[p * stride];
  }
  partial[warp][lane] = sum;
  __syncthreads();
  if (warp != 0 || row >= bd) return;
  float total = 0.f;
  for (int w = 0; w < kSumWarps; ++w) total += partial[w][lane];
  d_sdst[static_cast<size_t>(g) * bd + row] = total;
}

// ------------------------------------------------------------- host side

struct Args {
  const float *ssrc, *sdst, *stab, *den, *srow;
  const void *x, *ct, *m;
  void* out;
  float *den_out, *dtab_plus, *d_sdst, *part;
  int g, bd, bs, d;
  cudaStream_t stream;
};

bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }

template <typename T, typename M>
struct Forward {
  static int run(const Args& a) {
    // rows a CTA: 8, halved while that leaves an SM without a CTA
    int rows_per_cta = kFwdWarps;
    while (rows_per_cta > 1 &&
           static_cast<long long>(a.g) * ((a.bd + rows_per_cta - 1) / rows_per_cta) <
               ign::sm_count())
      rows_per_cta /= 2;
    const int split = kFwdWarps / rows_per_cta;
    const bool aligned =
        (static_cast<long long>(a.bs) * sizeof(M)) % 16 == 0 && !misaligned(a.m);
    const bool vec = (a.d * sizeof(T)) % 16 == 0 && !misaligned(a.x) && !misaligned(a.out);
    const size_t smem = fwd_smem_bytes(a.d);
    auto kernel = flash_gat_fwd_kernel<T, M>;
    const int code = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
    if (code != 0) return code;
    const dim3 grid((a.bd + rows_per_cta - 1) / rows_per_cta, a.g);
    kernel<<<grid, kFwdThreads, smem, a.stream>>>(
        a.ssrc, a.sdst, a.stab, static_cast<const T*>(a.x), static_cast<const M*>(a.m),
        static_cast<T*>(a.out), a.den_out, a.bd, a.bs, a.d, split, aligned, vec);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, typename M, int KD>
int run_backward(const Args& a) {
  const BwdLayout lay = bwd_layout(a.bs, a.d, sizeof(T), sizeof(M));
  const bool aligned =
      (static_cast<long long>(a.bs) * sizeof(M)) % 16 == 0 && !misaligned(a.m);
  const bool vec = (a.d * sizeof(T)) % 16 == 0 && !misaligned(a.x) && !misaligned(a.ct);
  const size_t smem = bwd_smem_bytes(lay.cap, a.d, sizeof(T));
  auto kernel = flash_gat_bwd_strip_kernel<T, M, KD>;
  int code = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (code != 0) return code;
  kernel<<<dim3(lay.strips, a.g), kBwdThreads, smem, a.stream>>>(
      a.ssrc, a.sdst, a.stab, a.den, a.srow, static_cast<const T*>(a.x),
      static_cast<const T*>(a.ct), static_cast<const M*>(a.m), a.dtab_plus, a.part, a.bd,
      a.bs, a.d, lay.cap, aligned, vec);
  code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  flash_gat_bwd_rowsum_kernel<<<dim3((a.bd + 31) / 32, a.g), kSumWarps * 32, 0, a.stream>>>(
      a.part, a.d_sdst, a.bd, lay.strips);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename M>
struct Backward {
  static int run(const Args& a) {
    if (a.d <= 32) return run_backward<T, M, 1>(a);
    if (a.d <= 64) return run_backward<T, M, 2>(a);
    return run_backward<T, M, 4>(a);
  }
};

template <template <typename, typename> class Op>
int dispatch(const Args& a, int x_dtype, int m_dtype) {
  if (a.g <= 0 || a.bd <= 0 || a.bs <= 0 || a.d <= 0 || a.d > 128 || a.g > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool m_int8 = m_dtype == ign::kInt8;
  if (!m_int8 && m_dtype != ign::kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
  switch (x_dtype) {
    case ign::kFloat32:
      return m_int8 ? Op<float, uint8_t>::run(a) : Op<float, uint16_t>::run(a);
    case ign::kBFloat16:
      return m_int8 ? Op<__nv_bfloat16, uint8_t>::run(a) : Op<__nv_bfloat16, uint16_t>::run(a);
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
// `part` is scratch of [strips, g, bd] f32, strips as
// `ign_flash_gat_bwd_layout` gives them: each strip's partial of d_sdst.
extern "C" int ign_flash_gat_bwd(const void* ssrc, const void* sdst, const void* stab,
                                 const void* den, const void* srow, const void* x,
                                 const void* ct, const void* m, void* dtab_plus,
                                 void* d_sdst, void* part, int g, int bd, int bs, int d,
                                 int x_dtype, int m_dtype, void* stream) {
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
  a.part = static_cast<float*>(part);
  a.g = g, a.bd = bd, a.bs = bs, a.d = d;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<Backward>(a, x_dtype, m_dtype);
}

// Kernel E's layout for bs columns at width d: *strips, the strip CTAs of a
// graph (the first axis of `part`), and *cap, the non-zeros a strip's list
// holds before it is handled.
extern "C" int ign_flash_gat_bwd_layout(int bs, int d, int x_dtype, int m_dtype, int* strips,
                                        int* cap) {
  if (bs <= 0 || d <= 0 || d > 128) return static_cast<int>(cudaErrorInvalidValue);
  const int x_item = x_dtype == ign::kFloat32 ? 4 : x_dtype == ign::kBFloat16 ? 2 : 0;
  const int m_item = m_dtype == ign::kInt8 ? 1 : m_dtype == ign::kBFloat16 ? 2 : 0;
  if (x_item == 0 || m_item == 0) return static_cast<int>(cudaErrorInvalidValue);
  const BwdLayout lay = bwd_layout(bs, d, x_item, m_item);
  *strips = lay.strips;
  *cap = lay.cap;
  return 0;
}
