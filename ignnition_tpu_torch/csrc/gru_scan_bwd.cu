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
// What bounds it on an H100: instruction issue on the CUDA cores, as for the
// forward. At the flagship shape (L=8, N=16,384, D=u=32) a call does the
// forward's 1.6 GFLOP again, 1.6 GFLOP of transposed products for d_xs and
// dh, and 1.6 GFLOP for the weight gradients, against 8.4 MB read and
// 8.4 MB written in bf16.
//
// Design. The TPU kernel walks 2,048-row tiles one after another and adds
// the weight gradients into a block that stays in fast memory across grid
// steps; CTAs run in parallel and share nothing, so the work is three
// kernels:
//   1. sweep: one warp per destination row, lane j owns unit j, weights
//      staged once per block in shared memory (row stride 3u+1, so both the
//      forward's column reads and the reverse sweep's row reads are free of
//      bank conflicts). The warp recomputes its row's forward, stashing
//      hprev, z, r, hcand and hh per step in shared memory (5*L*u floats per
//      warp), then walks time in reverse: it writes d_xs[t, n], and for the
//      weight gradients the rounded gate gradients dg[t, n] = [da_z, da_r,
//      da_c, dhh] and the rounded hprev[t, n] to device scratch. Bias
//      gradients are summed per lane in registers, then per block in a fixed
//      order, into one partial per block.
//   2. wgrad: d_wx = xs^T dg[:, z|r|c] and d_wh = hprev^T dg[:, z|r|hh] over
//      the L*N rows. Each CTA reduces one chunk of rows into one 32x32 tile
//      of the result (operands through shared memory, sums in registers) and
//      writes a partial.
//   3. finalize: adds the partials of every chunk and block in index order,
//      so the result is the same from run to run (no atomics).
#include "gru_step.cuh"

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

template <typename T>
int launch_all(const void* xs, const int* lens, const void* h0, const void* wx,
               const void* wh, const void* b, const void* ct, void* d_xs, float* d_h0,
               void* dg, void* hprev, float* bias_part, float* part, float* wgrad,
               float* d_b, int L, int N, int D, int U, int warps, int blocks,
               int n_chunks, int rows_per_chunk, cudaStream_t s) {
  int err;
  if (U <= 32)
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
// type; bias_part [blocks, 4U] and part [n_chunks, D + U, 3U] in f32. Outputs:
// d_xs [L, N, D] in the input type; d_h0 [N, U], wgrad [D + U, 3U] (d_wx then
// d_wh) and d_b [2, 3U] in f32. rows_per_chunk * n_chunks >= L * N.
extern "C" int ign_masked_gru_scan_bwd(
    const void* xs, const void* lens, const void* h0, const void* wx, const void* wh,
    const void* b, const void* ct, void* d_xs, void* d_h0, void* dg, void* hprev,
    void* bias_part, void* part, void* wgrad, void* d_b, int L, int N, int D, int U,
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
      return launch_all<float>(xs, ln, h0, wx, wh, b, ct, d_xs, f_h0, dg, hprev, f_bp,
                               f_part, f_wg, f_db, L, N, D, U, warps, blocks, n_chunks,
                               rows_per_chunk, s);
    case ign::kBFloat16:
      return launch_all<__nv_bfloat16>(xs, ln, h0, wx, wh, b, ct, d_xs, f_h0, dg, hprev,
                                       f_bp, f_part, f_wg, f_db, L, N, D, U, warps,
                                       blocks, n_chunks, rows_per_chunk, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
