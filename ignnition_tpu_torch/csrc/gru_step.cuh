// The gate code shared by the masked GRU scan's forward (gru_scan.cu) and
// backward (gru_scan_bwd.cu): one warp owns one destination row, lane j owns
// unit j (UC chunks of 32 units for u > 32, up to 128).
//
// Weights live in shared memory as f32, row k at `s_w + k * stride`, its
// three gate blocks [z | r | h] each U wide; `s_b` holds the two bias rows
// [2][3U] without padding.
#pragma once

#include "common.cuh"

namespace ign {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

// Stage wx [D][3U], wh [U][3U] and bias [2][3U] into shared memory as f32
// with `stride` floats per weight row. The caller synchronizes the block.
template <typename T>
__device__ __forceinline__ void stage_gru_weights(const T* __restrict__ wx,
                                                  const T* __restrict__ wh,
                                                  const T* __restrict__ bias,
                                                  float* s_wx, float* s_wh, float* s_b,
                                                  int D, int U, int stride) {
  const int G = 3 * U;
  for (int i = threadIdx.x; i < D * G; i += blockDim.x)
    s_wx[(i / G) * stride + i % G] = to_f32(wx[i]);
  for (int i = threadIdx.x; i < U * G; i += blockDim.x)
    s_wh[(i / G) * stride + i % G] = to_f32(wh[i]);
  for (int i = threadIdx.x; i < 2 * G; i += blockDim.x) s_b[i] = to_f32(bias[i]);
}

// The two gate projections of one step for the warp's row:
//   a* = x @ wx + b[0]   (x: one row of D values in T, read coalesced)
//   g* = round_T(h) @ wh + b[1]
// split by gate (z, r, candidate). Every lane of the warp must call it.
// The k loops are unrolled by 4: left to itself ptxas unrolls them 32 times
// for u <= 32 and spends 235 registers (40 this way), which halves the
// resident warps and makes the forward kernel 1.8x slower on an H100.
template <typename T, int UC>
__device__ __forceinline__ void gru_project(const T* __restrict__ x, const float (&h)[UC],
                                            const float* s_wx, const float* s_wh,
                                            const float* s_b, int D, int U, int stride,
                                            int lane, float (&az)[UC], float (&ar)[UC],
                                            float (&ac)[UC], float (&gz)[UC],
                                            float (&gr)[UC], float (&gc)[UC]) {
  const int G = 3 * U;
#pragma unroll
  for (int c = 0; c < UC; ++c) {
    const int j = min(lane + 32 * c, U - 1);
    az[c] = s_b[j];
    ar[c] = s_b[U + j];
    ac[c] = s_b[2 * U + j];
    gz[c] = s_b[G + j];
    gr[c] = s_b[G + U + j];
    gc[c] = s_b[G + 2 * U + j];
  }
  // input projection: x_t @ wx
  for (int k0 = 0; k0 < D; k0 += 32) {
    const float xv = k0 + lane < D ? to_f32(x[k0 + lane]) : 0.f;
    const int kn = min(32, D - k0);
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      const float xk = __shfl_sync(kFullMask, xv, kk);
      const float* w = s_wx + (k0 + kk) * stride;
#pragma unroll
      for (int c = 0; c < UC; ++c) {
        const int j = min(lane + 32 * c, U - 1);
        az[c] = fmaf(xk, w[j], az[c]);
        ar[c] = fmaf(xk, w[U + j], ar[c]);
        ac[c] = fmaf(xk, w[2 * U + j], ac[c]);
      }
    }
  }
  // recurrent projection: round(h) @ wh
#pragma unroll
  for (int kc = 0; kc < UC; ++kc) {
    const float hv = round_to<T>(h[kc]);
    const int kn = min(32, U - 32 * kc);
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      const float hk = __shfl_sync(kFullMask, hv, kk);
      const float* w = s_wh + (32 * kc + kk) * stride;
#pragma unroll
      for (int c = 0; c < UC; ++c) {
        const int j = min(lane + 32 * c, U - 1);
        gz[c] = fmaf(hk, w[j], gz[c]);
        gr[c] = fmaf(hk, w[U + j], gr[c]);
        gc[c] = fmaf(hk, w[2 * U + j], gc[c]);
      }
    }
  }
}

}  // namespace ign
