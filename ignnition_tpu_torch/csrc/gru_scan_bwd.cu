// Kernel C: backward of the masked GRU scan (kernel B, gru_scan.cu).
//
// Given the forward's inputs and the cotangent ct [N, u] of the final h:
//   d_xs [L, N, D] (input type), d_h0 [N, u] (f32),
//   d_wx [D, 3u], d_wh [u, 3u], d_b [2, 3u] (f32).
//
// Replaces the TPU kernel of ignnition_tpu/ops/pallas/rnn_kernels.py,
// `_bwd_call` / `_make_bwd_kernel`. It is the backward of stage1's update in
// every message-passing iteration of a training step.
//
// Numerics follow the TPU kernel: the forward is recomputed (f32 carry and
// gates, operands rounded to the input type); in the reverse sweep the gate
// gradients and the previous carry are rounded to the input type before each
// product, products sum in f32, and the bias gradients sum the unrounded f32
// gate gradients. A step with t >= lens[n] passes dh through unchanged and
// gives zero d_xs[t, n] and no weight gradient.
//
// The TPU kernel walks 2,048-row tiles one after another and adds the weight
// gradients into a block that stays in fast memory across grid steps; CTAs
// run in parallel and share nothing, so the work is three kernels:
//   1. sweep: recompute the forward, walk time in reverse, write d_xs[t, n],
//      d_h0 and, for the weight gradients, the rounded gate gradients
//      dg[t, n] = [da_z, da_r, da_c, dhh] and the rounded carry hprev[t, n]
//      to device scratch (zero rows for masked steps); bias gradients are
//      summed per lane in registers, then per block in a fixed order, into
//      one partial per block;
//   2. wgrad: d_wx = xs^T dg[:, z|r|c] and d_wh = hprev^T dg[:, z|r|hh] over
//      the L*N rows. Each CTA reduces one chunk of rows into one 32x32 tile
//      of the result (operands through shared memory, sums in registers) and
//      writes a partial;
//   3. finalize: adds the partials of every chunk and block in index order,
//      so the result is the same from run to run (no atomics).
//
// The sweep has two instances, chosen by (dtype, u) before launch (the
// dispatch of `launch_all`; `rnn_kernels.backward_instance` names the rule
// in Python and the profiler's kernel name witnesses it):
//
// * bf16, u <= 32: tensor cores (`gru_bwd_sweep_mma_kernel`). One warp owns
//   16 destination rows, as in kernel B, and recomputes the forward with B's
//   own tile step (gru_tile_mma.cuh: the same instructions, so the carry is
//   B's to the bit), storing each step's f32 carry h_t to a device scratch
//   `hstash` [L][ceil(N/16)][4 n8 tiles][32 lanes] of float4 (a lane's own
//   16 C-fragment values; each access 512 contiguous bytes a warp; 16.8 MB
//   at the flagship shape, held by the 50 MB L2). The reverse step reloads
//   h_t (prefetched a step ahead), reruns the step's products to get the
//   z, r, x and h pre-activations in C-fragment layout, and forms the gate
//   gradients elementwise in registers: (row, unit) sits in the same lane and
//   slot in every accumulator and in dh, so it needs no shuffle and no shared
//   memory. The gate gradients, rounded to bf16, repack into A fragments as
//   the carry does, and the two transposed products run on mma.sync:
//   d_xs_t [16, D] = [da_z|da_r|da_c] wx^T and dh [16, u] = [da_z|da_r|dhh]
//   wh^T + dh_upd z + dh_carry (the C fragments of dh keep the carry's layout,
//   so the next step needs no repack). wx, wh, wx^T and wh^T are staged once
//   per block in shared memory in B-fragment order (6 KB each at D = u =
//   32). dg, hprev and d_xs are stored from fragments as bf16x2.
//   Bound on an H100 at the flagship shape (L=8, N=16,384, D=u=32): the
//   sweep does 1.4 GFLOP of recompute and 3.2 GFLOP of reverse products
//   (0.005 ms at 989 TFLOP/s) and writes 50 MB of dg, hprev and d_xs
//   (0.015 ms at 3.35 TB/s); like B it is bound by the serial chain of a
//   step (products, gates, gate gradients, products) with ~8 warps an SM to
//   hide it. The forward skips the last step's update (h_L is never read).
// * f32 (u <= 128) and bf16 at u > 32: CUDA cores (`gru_bwd_sweep_kernel`).
//   One warp per destination row, lane j owns unit j, weights staged once
//   per block in shared memory (row stride 3u+1, so both the forward's
//   column reads and the reverse sweep's row reads are free of bank
//   conflicts). The warp recomputes its row's forward, stashing hprev, z, r,
//   hcand and hh per step in shared memory (5*L*u floats per warp), then
//   walks time in reverse; its transposed products broadcast each gate
//   gradient with __shfl_sync, one shuffle and one shared load an FMA, and
//   are bound by instruction issue (at the flagship shape 1.6 GFLOP for the
//   recompute and 1.6 for the transposed products).
//
// The weight-gradient kernel (1.6 GFLOP, on the CUDA cores) reads the 33.5 MB
// of dg at the flagship shape and is the same for both instances.
#include <algorithm>
#include <type_traits>

#include "gru_step.cuh"
#include "gru_tile_mma.cuh"

namespace {

constexpr int kWgradThreads = 256;  // 8 warps x 4 result rows each = 32 rows
constexpr int kTile = 32;

// ---------------------------------------------------------------- sweep

template <typename T, int UC>
__global__ void gru_bwd_sweep_kernel(
    const T* __restrict__ xs, const int* __restrict__ lens, const T* __restrict__ h0,
    const T* __restrict__ wx, const T* __restrict__ wh, const T* __restrict__ bias,
    const T* __restrict__ ct, T* __restrict__ d_xs, float* __restrict__ d_h0,
    T* __restrict__ dg, T* __restrict__ hprev_out, float* __restrict__ bias_part,
    int L, int N, int D, int U) {
  extern __shared__ float smem[];
  const int G = 3 * U;
  const int GP = G + 1;  // padded row stride
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* s_wx = smem;                       // [D][GP]
  float* s_wh = s_wx + D * GP;              // [U][GP]
  float* s_b = s_wh + U * GP;               // [2][G]
  float* s_stash = s_b + 2 * G;             // [warps][L][5][U]
  float* s_red = s_stash + (size_t)warps * L * 5 * U;  // [warps][4U]
  ign::stage_gru_weights(wx, wh, bias, s_wx, s_wh, s_b, D, U, GP);
  __syncthreads();

  float* stash = s_stash + (size_t)warp * L * 5 * U;
  float bz[UC], br[UC], bc[UC], bh[UC];  // bias-gradient sums of this lane
#pragma unroll
  for (int c = 0; c < UC; ++c) bz[c] = br[c] = bc[c] = bh[c] = 0.f;

  for (int n = blockIdx.x * warps + warp; n < N; n += gridDim.x * warps) {
    const int len = max(0, min(lens[n], L));

    // ---- forward recompute, stashing the per-step tensors ----
    float h[UC];
#pragma unroll
    for (int c = 0; c < UC; ++c) {
      const int j = lane + 32 * c;
      h[c] = j < U ? ign::to_f32(h0[(long long)n * U + j]) : 0.f;
    }
    for (int t = 0; t < len; ++t) {
      const T* x = xs + ((long long)t * N + n) * D;
      float az[UC], ar[UC], ac[UC], gz[UC], gr[UC], gc[UC];
      ign::gru_project<T, UC>(x, h, s_wx, s_wh, s_b, D, U, GP, lane, az, ar, ac, gz, gr, gc);
      float* st = stash + (size_t)t * 5 * U;
#pragma unroll
      for (int c = 0; c < UC; ++c) {
        const int j = lane + 32 * c;
        if (j < U) {
          const float z = ign::sigmoidf_(az[c] + gz[c]);
          const float r = ign::sigmoidf_(ar[c] + gr[c]);
          const float hc = tanhf(ac[c] + r * gc[c]);
          st[j] = h[c];
          st[U + j] = z;
          st[2 * U + j] = r;
          st[3 * U + j] = hc;
          st[4 * U + j] = gc[c];
          h[c] = z * h[c] + (1.f - z) * hc;
        }
      }
    }
    __syncwarp();

    // ---- masked steps: zero d_xs, dg and hprev ----
    for (int t = len; t < L; ++t) {
      const long long row = (long long)t * N + n;
      for (int k = lane; k < D; k += 32) d_xs[row * D + k] = ign::from_f32<T>(0.f);
      for (int k = lane; k < 4 * U; k += 32) dg[row * 4 * U + k] = ign::from_f32<T>(0.f);
      for (int k = lane; k < U; k += 32) hprev_out[row * U + k] = ign::from_f32<T>(0.f);
    }

    // ---- reverse sweep over the real steps ----
    float dh[UC];
#pragma unroll
    for (int c = 0; c < UC; ++c) {
      const int j = lane + 32 * c;
      dh[c] = j < U ? ign::to_f32(ct[(long long)n * U + j]) : 0.f;
    }
    for (int t = len - 1; t >= 0; --t) {
      const long long row = (long long)t * N + n;
      const float* st = stash + (size_t)t * 5 * U;
      float qz[UC], qr[UC], qc[UC], qh[UC], keep[UC];  // rounded gate gradients
#pragma unroll
      for (int c = 0; c < UC; ++c) {
        const int j = lane + 32 * c;
        qz[c] = qr[c] = qc[c] = qh[c] = keep[c] = 0.f;
        if (j < U) {
          const float hp = st[j], z = st[U + j], r = st[2 * U + j];
          const float hc = st[3 * U + j], hh = st[4 * U + j];
          const float dz = dh[c] * (hp - hc);
          const float da_c = dh[c] * (1.f - z) * (1.f - hc * hc);
          const float dhh = da_c * r;
          const float da_z = dz * z * (1.f - z);
          const float da_r = da_c * hh * r * (1.f - r);
          bz[c] += da_z;
          br[c] += da_r;
          bc[c] += da_c;
          bh[c] += dhh;
          const T tz = ign::from_f32<T>(da_z), tr = ign::from_f32<T>(da_r);
          const T tc = ign::from_f32<T>(da_c), th = ign::from_f32<T>(dhh);
          T* g = dg + row * 4 * U;
          g[j] = tz;
          g[U + j] = tr;
          g[2 * U + j] = tc;
          g[3 * U + j] = th;
          hprev_out[row * U + j] = ign::from_f32<T>(hp);
          qz[c] = ign::to_f32(tz);
          qr[c] = ign::to_f32(tr);
          qc[c] = ign::to_f32(tc);
          qh[c] = ign::to_f32(th);
          keep[c] = dh[c] * z;
        }
      }
      // d_xs[t, n, k] = sum_j d_xw[j] * wx[k, j]; lane k owns column k
      for (int k0 = 0; k0 < D; k0 += 32) {
        const int k = min(k0 + lane, D - 1);
        const float* w = s_wx + k * GP;
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < UC; ++c) {
          const int jn = min(32, U - 32 * c);
          for (int jj = 0; jj < jn; ++jj) {
            const int j = 32 * c + jj;
            acc = fmaf(__shfl_sync(ign::kFullMask, qz[c], jj), w[j], acc);
            acc = fmaf(__shfl_sync(ign::kFullMask, qr[c], jj), w[U + j], acc);
            acc = fmaf(__shfl_sync(ign::kFullMask, qc[c], jj), w[2 * U + j], acc);
          }
        }
        if (k0 + lane < D) d_xs[row * D + k0 + lane] = ign::from_f32<T>(acc);
      }
      // dh[k] = sum_j d_hw[j] * wh[k, j] + dh[k] * z[k]
      float dh_new[UC];
#pragma unroll
      for (int kc = 0; kc < UC; ++kc) {
        const int k = min(32 * kc + lane, U - 1);
        const float* w = s_wh + k * GP;
        float acc = keep[kc];
#pragma unroll
        for (int c = 0; c < UC; ++c) {
          const int jn = min(32, U - 32 * c);
          for (int jj = 0; jj < jn; ++jj) {
            const int j = 32 * c + jj;
            acc = fmaf(__shfl_sync(ign::kFullMask, qz[c], jj), w[j], acc);
            acc = fmaf(__shfl_sync(ign::kFullMask, qr[c], jj), w[U + j], acc);
            acc = fmaf(__shfl_sync(ign::kFullMask, qh[c], jj), w[2 * U + j], acc);
          }
        }
        dh_new[kc] = acc;
      }
#pragma unroll
      for (int c = 0; c < UC; ++c) dh[c] = dh_new[c];
    }
#pragma unroll
    for (int c = 0; c < UC; ++c) {
      const int j = lane + 32 * c;
      if (j < U) d_h0[(long long)n * U + j] = dh[c];
    }
    __syncwarp();  // the stash is reused by this warp's next row
  }

  // ---- bias partial of this block: warps added in index order ----
  float* red = s_red + warp * 4 * U;
#pragma unroll
  for (int c = 0; c < UC; ++c) {
    const int j = lane + 32 * c;
    if (j < U) {
      red[j] = bz[c];
      red[U + j] = br[c];
      red[2 * U + j] = bc[c];
      red[3 * U + j] = bh[c];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 4 * U; i += blockDim.x) {
    float acc = 0.f;
    for (int w = 0; w < warps; ++w) acc += s_red[w * 4 * U + i];
    bias_part[(long long)blockIdx.x * 4 * U + i] = acc;
  }
}

// ------------------------------------------- sweep on tensor cores (bf16, u <= 32)

constexpr int kSweepMmaWarps = 4;
using bf16 = __nv_bfloat16;

// Columns c and c + 1 of a bf16 row segment `p` from a packed pair, each
// stored while < limit. paired: p + c is 4-byte aligned for every even c, so
// the pair is one 32-bit store.
__device__ __forceinline__ void store_pair(bf16* p, int c, int limit, uint32_t v, bool paired) {
  if (paired) {
    if (c < limit) *reinterpret_cast<uint32_t*>(p + c) = v;
    return;
  }
  unsigned short* s = reinterpret_cast<unsigned short*>(p);
  if (c < limit) s[c] = static_cast<unsigned short>(v & 0xffffu);
  if (c + 1 < limit) s[c + 1] = static_cast<unsigned short>(v >> 16);
}

__device__ __forceinline__ void zero_fill(bf16* p, int n, int lane) {
  unsigned short* s = reinterpret_cast<unsigned short*>(p);
  for (int k = lane; k < n; k += 32) s[k] = 0;
}

template <int UC, bool VEC>
__global__ void __launch_bounds__(kSweepMmaWarps * 32)
gru_bwd_sweep_mma_kernel(const bf16* __restrict__ xs, const int* __restrict__ lens,
                         const bf16* __restrict__ h0, const bf16* __restrict__ wx,
                         const bf16* __restrict__ wh, const bf16* __restrict__ bias,
                         const bf16* __restrict__ ct, bf16* __restrict__ d_xs,
                         float* __restrict__ d_h0, bf16* __restrict__ dg,
                         bf16* __restrict__ hprev_out, float4* __restrict__ hstash,
                         float* __restrict__ bias_part, int L, int N, int D, int U) {
  static_assert(UC == 1, "the transposed products cover one chunk of 32 units");
  using namespace ign::tile;
  using Lay = TileLayout<UC>;
  extern __shared__ uint4 smem4[];
  const int KX = Lay::x_chunks(D);
  uint4* s_wx = smem4;
  uint4* s_wh = s_wx + Lay::wx_slots(D);
  uint4* s_wxt = s_wh + Lay::wh_slots();
  uint4* s_wht = s_wxt + transposed_slots(D);
  float* s_b = reinterpret_cast<float*>(s_wht + transposed_slots(U));
  // each lane's running bias-gradient sums over its two rows, [warps][32
  // sums][32 lanes]: sum k = 8q + 2j + e of gate q (z, r, c, hh), n8 tile j,
  // unit 8j + 2tq + e (kept here, not in 32 registers)
  float* s_sums = s_b + 4 * Lay::kUnits;
  float* s_red = s_sums + (size_t)(blockDim.x >> 5) * 32 * 32;  // [warps][4 gates][32 units]
  stage_tile_weights<UC>(wx, wh, bias, s_wx, s_wh, s_b, D, U);
  stage_transposed_weights(wx, wh, s_wxt, s_wht, D, U);
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const uint4 no_wh_regs[1] = {make_uint4(0u, 0u, 0u, 0u)};
  const bool u_pairs = U % 2 == 0, d_pairs = D % 2 == 0;
  const int tiles = (N + kRows - 1) / kRows;
  const long long stash_step = (long long)tiles * 4 * 32;  // float4s of one step
  float* sums = s_sums + warp * 32 * 32 + lane;  // this lane's sum k at sums[32 k]
#pragma unroll
  for (int k = 0; k < 32; ++k) sums[32 * k] = 0.f;

  for (int tile = blockIdx.x * warps + warp; tile < tiles; tile += gridDim.x * warps) {
    const int r0 = tile * kRows + g, r1 = r0 + 8;
    const bool in0 = r0 < N, in1 = r1 < N;
    const int len0 = in0 ? min(max(lens[r0], 0), L) : 0;
    const int len1 = in1 ? min(max(lens[r1], 0), L) : 0;
    const int steps = __reduce_max_sync(ign::kFullMask, max(len0, len1));
    // rows past N read row N - 1 (never stored, len 0)
    const long long x0 = min(r0, N - 1), x1 = min(r1, N - 1);
    auto row_of = [&](int t, long long x) { return xs + ((long long)t * N + x) * D; };
    float4* stash = hstash + (long long)tile * 4 * 32 + lane;

    // ---- forward recompute: kernel B's tile step, h_t stashed before step t ----
    float h[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i < 2 ? r0 : r1, unit = 8 * j + 2 * tq + (i & 1);
        h[j][i] = row < N && unit < U ? ign::to_f32(h0[(long long)row * U + unit]) : 0.f;
      }
    }
    uint32_t h_a[2][4];
    uint4 xg = make_uint4(0u, 0u, 0u, 0u), xg8 = xg;
    if (steps > 1) {
      xg = load_row8<VEC>(row_of(0, x0), 8 * tq, D);
      xg8 = load_row8<VEC>(row_of(0, x1), 8 * tq, D);
    }
    for (int t = 0; t + 1 < steps; ++t) {  // h_{steps} is never read
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        stash[t * stash_step + j * 32] = make_float4(h[j][0], h[j][1], h[j][2], h[j][3]);
      }
      uint4 ng = xg, ng8 = xg8;
      if (t + 2 < steps) {
        ng = load_row8<VEC>(row_of(t + 1, x0), 8 * tq, D);
        ng8 = load_row8<VEC>(row_of(t + 1, x1), 8 * tq, D);
      }
      const uint4 cg = xg, cg8 = xg8;
      auto x_chunk = [&](int kx, uint32_t(&a)[2][4]) {
        if (kx == 0) {
          x_to_a(cg, cg8, a);
        } else {
          x_to_a(load_row8<VEC>(row_of(t, x0), 32 * kx + 8 * tq, D),
                 load_row8<VEC>(row_of(t, x1), 32 * kx + 8 * tq, D), a);
        }
      };
      carry_to_a<UC>(h, h_a);
      float acc[4][4][4];
      chunk_products<UC, false>(acc, 0, KX, x_chunk, h_a, s_wx, s_wh, no_wh_regs, s_b, lane);
      chunk_update<UC>(acc, h, 0, t < len0, t < len1);
      xg = ng;
      xg8 = ng8;
    }

    // ---- steps past the tile's longest row: zero d_xs, dg and hprev ----
    const int nrows = min(kRows, N - tile * kRows);
    for (int t = steps; t < L; ++t) {
      const long long base = (long long)t * N + (long long)tile * kRows;
      zero_fill(d_xs + base * D, nrows * D, lane);
      zero_fill(dg + base * 4 * U, nrows * 4 * U, lane);
      zero_fill(hprev_out + base * U, nrows * U, lane);
    }

    // ---- reverse sweep; h holds h_{steps-1} ----
    float dh[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i < 2 ? r0 : r1, unit = 8 * j + 2 * tq + (i & 1);
        dh[j][i] = row < N && unit < U ? ign::to_f32(ct[(long long)row * U + unit]) : 0.f;
      }
    }
    if (steps > 0) {
      xg = load_row8<VEC>(row_of(steps - 1, x0), 8 * tq, D);
      xg8 = load_row8<VEC>(row_of(steps - 1, x1), 8 * tq, D);
    }
    for (int t = steps - 1; t >= 0; --t) {
      // h_{t-1} and x_{t-1}'s first chunk are in flight while step t computes
      float4 hn[4];
      uint4 ng = xg, ng8 = xg8;
      if (t > 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) hn[j] = stash[(t - 1) * stash_step + j * 32];
        ng = load_row8<VEC>(row_of(t - 1, x0), 8 * tq, D);
        ng8 = load_row8<VEC>(row_of(t - 1, x1), 8 * tq, D);
      }
      const uint4 cg = xg, cg8 = xg8;
      auto x_chunk = [&](int kx, uint32_t(&a)[2][4]) {
        if (kx == 0) {
          x_to_a(cg, cg8, a);
        } else {
          x_to_a(load_row8<VEC>(row_of(t, x0), 32 * kx + 8 * tq, D),
                 load_row8<VEC>(row_of(t, x1), 32 * kx + 8 * tq, D), a);
        }
      };
      carry_to_a<UC>(h, h_a);
      const bool v0 = t < len0, v1 = t < len1;
      // the gate gradients of step t (zero on masked rows), summed unrounded
      // into the bias sums and packed as bf16 A fragments, gate (z, r, c, hh)
      uint32_t qa[4][2][4];
      {
        float acc[4][4][4];
        chunk_products<UC, false>(acc, 0, KX, x_chunk, h_a, s_wx, s_wh, no_wh_regs, s_b, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float gv[4][4];  // gate, slot
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool valid = i < 2 ? v0 : v1;
            const float z = sigmoid_fast(acc[0][j][i]);
            const float r = sigmoid_fast(acc[1][j][i]);
            const float hh = acc[3][j][i];
            const float hc = tanh_fast(fmaf(r, hh, acc[2][j][i]));
            const float d = valid ? dh[j][i] : 0.f;  // dh_upd
            const float dz = d * (h[j][i] - hc);
            const float da_c = d * (1.f - z) * (1.f - hc * hc);
            gv[0][i] = valid ? dz * z * (1.f - z) : 0.f;
            gv[1][i] = valid ? da_c * hh * r * (1.f - r) : 0.f;
            gv[2][i] = valid ? da_c : 0.f;
            gv[3][i] = valid ? da_c * r : 0.f;
            // the C fragment the dh product starts from: dh_upd z + dh_carry
            dh[j][i] = valid ? d * z : dh[j][i];
          }
          // n8 tiles 2k and 2k + 1 are the A fragment of k16 tile k, as in
          // `carry_to_a`
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            sums[32 * (8 * q + 2 * j)] += gv[q][0] + gv[q][2];
            sums[32 * (8 * q + 2 * j + 1)] += gv[q][1] + gv[q][3];
            qa[q][j >> 1][2 * (j & 1)] = pack_bf16x2(gv[q][0], gv[q][1]);
            qa[q][j >> 1][2 * (j & 1) + 1] = pack_bf16x2(gv[q][2], gv[q][3]);
          }
        }
      }

      // scratch of the weight-gradient kernel: dg[t, n] and hprev[t, n]
      const long long row0 = (long long)t * N + r0, row1 = (long long)t * N + r1;
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const bool second = s & 1;
          if (second ? !in1 : !in0) continue;
          const long long row = second ? row1 : row0;
          const int unit = 16 * kh + 8 * (s >> 1) + 2 * tq;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            store_pair(dg + row * 4 * U + q * U, unit, U, qa[q][kh][s], u_pairs);
          }
          store_pair(hprev_out + row * U, unit, U, (second ? v1 : v0) ? h_a[kh][s] : 0u,
                     u_pairs);
        }
      }

      // d_xs_t = [da_z|da_r|da_c] wx^T, 32 columns at a time
      for (int kx = 0; kx < KX; ++kx) {
        float dx[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) dx[j][0] = dx[j][1] = dx[j][2] = dx[j][3] = 0.f;
#pragma unroll
        for (int kt = 0; kt < kTKTiles; ++kt) {
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const uint4 b = s_wxt[((kx * 2 + p) * kTKTiles + kt) * 32 + lane];
            mma_bf16(dx[2 * p], qa[kt >> 1][kt & 1], b.x, b.y);
            mma_bf16(dx[2 * p + 1], qa[kt >> 1][kt & 1], b.z, b.w);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = 32 * kx + 8 * j + 2 * tq;
          if (in0) store_pair(d_xs + row0 * D, col, D, pack_bf16x2(dx[j][0], dx[j][1]), d_pairs);
          if (in1) store_pair(d_xs + row1 * D, col, D, pack_bf16x2(dx[j][2], dx[j][3]), d_pairs);
        }
      }

      // dh_{t-1} = [da_z|da_r|dhh] wh^T + dh_upd z + dh_carry
#pragma unroll
      for (int kt = 0; kt < kTKTiles; ++kt) {
        const int q = kt >> 1 == 2 ? 3 : kt >> 1;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const uint4 b = s_wht[(p * kTKTiles + kt) * 32 + lane];
          mma_bf16(dh[2 * p], qa[q][kt & 1], b.x, b.y);
          mma_bf16(dh[2 * p + 1], qa[q][kt & 1], b.z, b.w);
        }
      }

      if (t > 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          h[j][0] = hn[j].x;
          h[j][1] = hn[j].y;
          h[j][2] = hn[j].z;
          h[j][3] = hn[j].w;
        }
        xg = ng;
        xg8 = ng8;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i < 2 ? r0 : r1, unit = 8 * j + 2 * tq + (i & 1);
        if (row < N && unit < U) d_h0[(long long)row * U + unit] = dh[j][i];
      }
    }
  }

  // ---- bias partial of this block: lanes of one unit by a fixed shuffle
  // tree, then warps in index order ----
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = sums[32 * (8 * q + 2 * j + e)];
        v += __shfl_xor_sync(ign::kFullMask, v, 4);
        v += __shfl_xor_sync(ign::kFullMask, v, 8);
        v += __shfl_xor_sync(ign::kFullMask, v, 16);
        if (g == 0) s_red[(warp * 4 + q) * 32 + 8 * j + 2 * tq + e] = v;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 4 * U; i += blockDim.x) {
    const int q = i / U, unit = i % U;
    float acc = 0.f;
    for (int w = 0; w < warps; ++w) acc += s_red[(w * 4 + q) * 32 + unit];
    bias_part[(long long)blockIdx.x * 4 * U + i] = acc;
  }
}

// ---------------------------------------------------------------- wgrad

// blockIdx.x: chunk of rows; blockIdx.y: result tile. The first
// tiles_x * j_tiles tiles belong to d_wx (A = xs, K = D), the rest to d_wh
// (A = hprev, K = U). Partials: part[chunk][D + U][3U].
template <typename T>
__global__ void __launch_bounds__(kWgradThreads)
gru_bwd_wgrad_kernel(const T* __restrict__ xs, const T* __restrict__ hprev,
                     const T* __restrict__ dg, float* __restrict__ part,
                     long long rows, int D, int U, int rows_per_chunk, int tiles_x,
                     int j_tiles) {
  __shared__ float s_a[kTile][kTile + 1];
  __shared__ float s_b[kTile][kTile + 1];
  const int G = 3 * U;
  int tile = blockIdx.y;
  const bool is_h = tile >= tiles_x * j_tiles;
  if (is_h) tile -= tiles_x * j_tiles;
  const int k0 = (tile / j_tiles) * kTile;
  const int j0 = (tile % j_tiles) * kTile;
  const T* a = is_h ? hprev : xs;
  const int K = is_h ? U : D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const long long r_begin = (long long)blockIdx.x * rows_per_chunk;
  const long long r_end = min(rows, r_begin + rows_per_chunk);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (long long r0 = r_begin; r0 < r_end; r0 += kTile) {
    for (int i = threadIdx.x; i < kTile * kTile; i += kWgradThreads) {
      const int r = i >> 5, c = i & 31;
      const long long row = r0 + r;
      const bool live = row < r_end;
      const int k = k0 + c;
      s_a[r][c] = live && k < K ? ign::to_f32(a[row * K + k]) : 0.f;
      const int j = j0 + c;
      // d_wh's third gate block reads dhh, the fourth block of dg
      const int col = is_h && j >= 2 * U ? j + U : j;
      s_b[r][c] = live && j < G ? ign::to_f32(dg[row * 4 * U + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kTile; ++r) {
      const float b = s_b[r][lane];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(s_a[r][4 * warp + i], b, acc[i]);
    }
    __syncthreads();
  }
  float* out = part + (long long)blockIdx.x * (D + U) * G;
  const int j = j0 + lane;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * warp + i;
    if (k < K && j < G) out[(long long)((is_h ? D : 0) + k) * G + j] = acc[i];
  }
}

// ---------------------------------------------------------------- finalize

// wgrad [(D + U), 3U] = sum over chunks of part; d_b [2, 3U] = sum over sweep
// blocks of bias_part [4U] (d_bx = z|r|c, d_bh = z|r|hh). Fixed order.
__global__ void gru_bwd_finalize_kernel(const float* __restrict__ part, int n_chunks,
                                        const float* __restrict__ bias_part,
                                        int n_blocks, float* __restrict__ wgrad,
                                        float* __restrict__ d_b, int D, int U) {
  const int G = 3 * U;
  const int n_w = (D + U) * G;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_w) {
    float acc = 0.f;
    for (int c = 0; c < n_chunks; ++c) acc += part[(long long)c * n_w + i];
    wgrad[i] = acc;
  } else if (i < n_w + 2 * G) {
    const int e = i - n_w;
    const int j = e % G;
    const int col = e >= G && j >= 2 * U ? j + U : j;
    float acc = 0.f;
    for (int b = 0; b < n_blocks; ++b) acc += bias_part[(long long)b * 4 * U + col];
    d_b[e] = acc;
  }
}

// ---------------------------------------------------------------- launch

size_t sweep_smem_bytes(int L, int D, int U, int warps) {
  const size_t G = 3 * (size_t)U;
  return sizeof(float) *
         ((size_t)(D + U) * (G + 1) + 2 * G + (size_t)warps * L * 5 * U + (size_t)warps * 4 * U);
}

template <typename T, int UC>
int launch_sweep(const void* xs, const int* lens, const void* h0, const void* wx,
                 const void* wh, const void* b, const void* ct, void* d_xs, float* d_h0,
                 void* dg, void* hprev, float* bias_part, int L, int N, int D, int U,
                 int warps, int blocks, cudaStream_t stream) {
  const size_t smem = sweep_smem_bytes(L, D, U, warps);
  auto kernel = gru_bwd_sweep_kernel<T, UC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, warps * 32, smem, stream>>>(
      static_cast<const T*>(xs), lens, static_cast<const T*>(h0),
      static_cast<const T*>(wx), static_cast<const T*>(wh), static_cast<const T*>(b),
      static_cast<const T*>(ct), static_cast<T*>(d_xs), d_h0, static_cast<T*>(dg),
      static_cast<T*>(hprev), bias_part, L, N, D, U);
  return static_cast<int>(cudaGetLastError());
}

size_t sweep_mma_smem_bytes(int D, int U, int warps) {
  using Lay = ign::tile::TileLayout<1>;
  return sizeof(uint4) * (size_t)(Lay::wx_slots(D) + Lay::wh_slots() +
                                  ign::tile::transposed_slots(D) +
                                  ign::tile::transposed_slots(U)) +
         sizeof(float) * (4 * (size_t)Lay::kUnits + (size_t)warps * (32 * 32 + 4 * Lay::kUnits));
}

// The tensor-core sweep on at most `*blocks` blocks (fewer when fewer are
// resident at once: it walks its tiles by a grid-stride loop); `*blocks`
// becomes the grid launched, the count of bias partials written.
template <bool VEC>
int launch_sweep_mma(const void* xs, const int* lens, const void* h0, const void* wx,
                     const void* wh, const void* b, const void* ct, void* d_xs, float* d_h0,
                     void* dg, void* hprev, void* hstash, float* bias_part, int L, int N,
                     int D, int U, int warps, int* blocks, cudaStream_t stream) {
  const size_t smem = sweep_mma_smem_bytes(D, U, warps);
  auto kernel = gru_bwd_sweep_mma_kernel<1, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int per_sm = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = std::min(*blocks, std::max(per_sm, 1) * ign::sm_count());
  kernel<<<*blocks, warps * 32, smem, stream>>>(
      static_cast<const bf16*>(xs), lens, static_cast<const bf16*>(h0),
      static_cast<const bf16*>(wx), static_cast<const bf16*>(wh), static_cast<const bf16*>(b),
      static_cast<const bf16*>(ct), static_cast<bf16*>(d_xs), d_h0, static_cast<bf16*>(dg),
      static_cast<bf16*>(hprev), static_cast<float4*>(hstash), bias_part, L, N, D, U);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_all(const void* xs, const int* lens, const void* h0, const void* wx,
               const void* wh, const void* b, const void* ct, void* d_xs, float* d_h0,
               void* dg, void* hprev, void* hstash, float* bias_part, float* part,
               float* wgrad, float* d_b, int L, int N, int D, int U, int warps, int blocks,
               int n_chunks, int rows_per_chunk, cudaStream_t s) {
  int err;
  // the (dtype, u) -> sweep instance rule (`rnn_kernels.backward_instance`):
  // tensor cores for bf16 at u <= 32, the CUDA cores otherwise
  if (std::is_same<T, bf16>::value && U <= 32) {
    if (hstash == nullptr || warps > kSweepMmaWarps)
      return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = D % 8 == 0 && reinterpret_cast<uintptr_t>(xs) % 16 == 0;
    err = vec ? launch_sweep_mma<true>(xs, lens, h0, wx, wh, b, ct, d_xs, d_h0, dg, hprev,
                                       hstash, bias_part, L, N, D, U, warps, &blocks, s)
              : launch_sweep_mma<false>(xs, lens, h0, wx, wh, b, ct, d_xs, d_h0, dg, hprev,
                                        hstash, bias_part, L, N, D, U, warps, &blocks, s);
  } else if (U <= 32)
    err = launch_sweep<T, 1>(xs, lens, h0, wx, wh, b, ct, d_xs, d_h0, dg, hprev,
                             bias_part, L, N, D, U, warps, blocks, s);
  else if (U <= 64)
    err = launch_sweep<T, 2>(xs, lens, h0, wx, wh, b, ct, d_xs, d_h0, dg, hprev,
                             bias_part, L, N, D, U, warps, blocks, s);
  else if (U <= 128)
    err = launch_sweep<T, 4>(xs, lens, h0, wx, wh, b, ct, d_xs, d_h0, dg, hprev,
                             bias_part, L, N, D, U, warps, blocks, s);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;

  const int tiles_x = (D + kTile - 1) / kTile;
  const int tiles_h = (U + kTile - 1) / kTile;
  const int j_tiles = (3 * U + kTile - 1) / kTile;
  const dim3 grid(n_chunks, (tiles_x + tiles_h) * j_tiles);
  gru_bwd_wgrad_kernel<T><<<grid, kWgradThreads, 0, s>>>(
      static_cast<const T*>(xs), static_cast<const T*>(hprev),
      static_cast<const T*>(dg), part, (long long)L * N, D, U, rows_per_chunk, tiles_x,
      j_tiles);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  const int total = (D + U) * 3 * U + 2 * 3 * U;
  gru_bwd_finalize_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      part, n_chunks, bias_part, blocks, wgrad, d_b, D, U);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory the sweep kernel needs for `warps` warps per block, in bytes
// (the wrapper picks the warp count that fits a Hopper block).
extern "C" long long ign_masked_gru_scan_bwd_smem(int L, int D, int U, int warps) {
  return static_cast<long long>(sweep_smem_bytes(L, D, U, warps));
}

// Scratch the caller allocates: dg [L, N, 4U] and hprev [L, N, U] in the input
// type; bias_part [blocks, 4U] and part [n_chunks, D + U, 3U] in f32; for the
// tensor-core sweep (bf16, U <= 32; at most kSweepMmaWarps warps a block)
// hstash [L, ceil(N / 16), 4, 32, 4] in f32, else null. Outputs:
// d_xs [L, N, D] in the input type; d_h0 [N, U], wgrad [D + U, 3U] (d_wx then
// d_wh) and d_b [2, 3U] in f32. rows_per_chunk * n_chunks >= L * N.
extern "C" int ign_masked_gru_scan_bwd(
    const void* xs, const void* lens, const void* h0, const void* wx, const void* wh,
    const void* b, const void* ct, void* d_xs, void* d_h0, void* dg, void* hprev,
    void* hstash, void* bias_part, void* part, void* wgrad, void* d_b, int L, int N, int D,
    int U,
    int warps, int blocks, int n_chunks, int rows_per_chunk, int dtype, void* stream) {
  const int* ln = static_cast<const int*>(lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L <= 0 || N <= 0 || D <= 0 || U <= 0 || warps <= 0 || warps > 32 || blocks <= 0 ||
      n_chunks <= 0 || rows_per_chunk <= 0 ||
      (long long)rows_per_chunk * n_chunks < (long long)L * N)
    return static_cast<int>(cudaErrorInvalidValue);
  float* f_h0 = static_cast<float*>(d_h0);
  float* f_bp = static_cast<float*>(bias_part);
  float* f_part = static_cast<float*>(part);
  float* f_wg = static_cast<float*>(wgrad);
  float* f_db = static_cast<float*>(d_b);
  switch (dtype) {
    case ign::kFloat32:
      return launch_all<float>(xs, ln, h0, wx, wh, b, ct, d_xs, f_h0, dg, hprev, hstash,
                               f_bp, f_part, f_wg, f_db, L, N, D, U, warps, blocks,
                               n_chunks, rows_per_chunk, s);
    case ign::kBFloat16:
      return launch_all<bf16>(xs, ln, h0, wx, wh, b, ct, d_xs, f_h0, dg, hprev, hstash, f_bp,
                              f_part, f_wg, f_db, L, N, D, U, warps, blocks, n_chunks,
                              rows_per_chunk, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
