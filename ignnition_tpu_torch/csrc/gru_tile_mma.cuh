// The tensor-core tile of the masked GRU scan (bf16): one warp owns 16
// destination rows and runs each step's products as
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32.
//
// Fragment layouts of m16n8k16 (lane = 4 * g + t, g = lane >> 2, t = lane & 3):
//   A (16 x k16, bf16): r0 = A[g][2t, 2t+1], r1 = A[g+8][2t, 2t+1],
//                       r2 = A[g][2t+8, 2t+9], r3 = A[g+8][2t+8, 2t+9]
//   B (k16 x 8, bf16):  r0 = B[2t, 2t+1][g], r1 = B[2t+8, 2t+9][g]
//   C (16 x 8, f32):    c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1]
// (the lower k index in the lower 16 bits of a register).
//
// The carry never leaves the registers: the C fragments of n8 tiles 2k and
// 2k+1 hold exactly the A fragment of k16 tile k (`carry_to_a`), so each
// step's f32 h, rounded to bf16, is the next step's A operand of h @ wh.
//
// The input x_t is read from device memory 16 bytes a row at a time: lane
// (g, t) reads columns [8t, 8t + 8) of rows g and g + 8 within each 32-wide
// chunk of x. The k index of x @ wx is permuted to match (a product does not
// care in which order it sums): logical k = 16 kk + 8 hf + 2t + e of the
// chunk's k16 tile kk is physical column 8t + 4 kk + 2 hf + e. The staged wx
// fragments apply the same permutation.
//
// Per step and per 32-unit chunk a lane holds four accumulators of 4 n8
// tiles each: z = x wx_z + h wh_z + b0_z + b1_z, r likewise, xh = x wx_h +
// b0_h and hh = h wh_h + b1_h (kept apart: the reset gate multiplies it).
// One (row, unit) has all four in the same lane and register slot, so the
// gate math is elementwise in registers.
//
// Shared by kernel B (gru_scan.cu) and the tensor-core sweep of kernel C
// (gru_scan_bwd.cu), which also stages the transposed weights below.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace ign {
namespace tile {

constexpr int kRows = 16;  // destination rows of one warp's tile
// wh's B fragments at u <= 32, held in registers: 2 k16 tiles x 3 gates x
// 2 pairs of n8 tiles, one uint4 each (48 registers a lane)
constexpr int kWhRegSlots = 12;

// d += a @ b on one m16n8k16 tile, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even) in one register, `lo` in the
// lower half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// Gates from ex2.approx and a fast reciprocal (__expf, __fdividef): errors
// of ~1e-6. tanh.approx.f32 (2^-11) is cheaper but flips about a quarter of
// the carry's bf16 roundings against exact gates, and the recurrence
// amplifies each flip.
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

__device__ __forceinline__ float tanh_fast(float x) {
  return fmaf(2.f, sigmoid_fast(2.f * x), -1.f);
}

// The A fragments of round_bf16(h) from its f32 C fragments: h[j] is n8
// tile j of the warp's [16, 32 * UC] carry.
template <int UC>
__device__ __forceinline__ void carry_to_a(const float (&h)[UC * 4][4],
                                           uint32_t (&a)[UC * 2][4]) {
#pragma unroll
  for (int k = 0; k < UC * 2; ++k) {
    a[k][0] = pack_bf16x2(h[2 * k][0], h[2 * k][1]);
    a[k][1] = pack_bf16x2(h[2 * k][2], h[2 * k][3]);
    a[k][2] = pack_bf16x2(h[2 * k + 1][0], h[2 * k + 1][1]);
    a[k][3] = pack_bf16x2(h[2 * k + 1][2], h[2 * k + 1][3]);
  }
}

// The A fragments of k16 tiles 2c and 2c + 1 of one 32-wide x chunk from
// the lane's two 16-byte reads (row g and row g + 8), k permuted as above.
__device__ __forceinline__ void x_to_a(const uint4& rg, const uint4& rg8,
                                       uint32_t (&a)[2][4]) {
  a[0][0] = rg.x;
  a[0][1] = rg8.x;
  a[0][2] = rg.y;
  a[0][3] = rg8.y;
  a[1][0] = rg.z;
  a[1][1] = rg8.z;
  a[1][2] = rg.w;
  a[1][3] = rg8.w;
}

// Columns [col, col + 8) of one bf16 row of width D, zero past D. VEC: D is
// a multiple of 8 and the row 16-byte aligned, so a group lies wholly
// inside or outside the row and is one 16-byte load.
template <bool VEC>
__device__ __forceinline__ uint4 load_row8(const __nv_bfloat16* __restrict__ row, int col,
                                           int D) {
  if (VEC) {
    if (col >= D) return make_uint4(0u, 0u, 0u, 0u);
    return __ldg(reinterpret_cast<const uint4*>(row + col));
  }
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = col + 2 * i;
    const uint32_t lo = c < D ? __ldg(r + c) : 0u;
    const uint32_t hi = c + 1 < D ? __ldg(r + c + 1) : 0u;
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Shared-memory layout of the weights, in B-fragment order. Gates are
// padded to UP = 32 * UC units (zero columns past U), so a gate is NT = UP
// / 8 n8 tiles; one uint4 holds a lane's B fragments of two adjacent n8
// tiles (pair p = tiles 2p, 2p+1), so a warp reads 512 contiguous bytes.
//   wx: [KX chunks of 32 k][2 k16 tiles][3 gates][NT / 2 pairs][32 lanes]
//   wh: [UP / 16 k16 tiles][3 gates][NT / 2 pairs][32 lanes]
//   bias (f32): [4][UP]: b0_z + b1_z, b0_r + b1_r, b0_h, b1_h
template <int UC>
struct TileLayout {
  static constexpr int kUnits = 32 * UC;     // UP
  static constexpr int kPairs = 2 * UC;      // n8-tile pairs per gate
  static constexpr int kHTiles = 2 * UC;     // k16 tiles of h
  static __host__ __device__ int x_chunks(int D) { return (D + 31) / 32; }
  static __host__ __device__ int wx_slots(int D) { return x_chunks(D) * 2 * 3 * kPairs * 32; }
  static __host__ __device__ int wh_slots() { return kHTiles * 3 * kPairs * 32; }
  static __host__ __device__ size_t smem_bytes(int D) {
    return sizeof(uint4) * (size_t)(wx_slots(D) + wh_slots()) + sizeof(float) * 4 * kUnits;
  }
};

// One lane's two-tile B fragment of w [K][3U] (row-major, bf16) for gate
// `gate`, pair p, with k(hf, e) giving the row of half hf, element e.
template <typename KOf>
__device__ __forceinline__ uint4 gather_b_pair(const __nv_bfloat16* __restrict__ w, int K, int U,
                                               int gate, int p, int g, KOf k_of) {
  const unsigned short* ws = reinterpret_cast<const unsigned short*>(w);
  uint32_t r[4];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int unit = 8 * (2 * p + q) + g;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      uint32_t v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = k_of(hf, e);
        v[e] = (unit < U && k < K) ? ws[(size_t)k * 3 * U + gate * U + unit] : 0u;
      }
      r[2 * q + hf] = v[0] | (v[1] << 16);
    }
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// Stage wx [D][3U], wh [U][3U] and bias [2][3U] (bf16) into shared memory
// in the layout above. The caller synchronizes the block.
template <int UC>
__device__ void stage_tile_weights(const __nv_bfloat16* __restrict__ wx,
                                   const __nv_bfloat16* __restrict__ wh,
                                   const __nv_bfloat16* __restrict__ bias, uint4* s_wx,
                                   uint4* s_wh, float* s_b, int D, int U) {
  using Lay = TileLayout<UC>;
  constexpr int NP = Lay::kPairs;
  const int nx = Lay::wx_slots(D);
  for (int s = threadIdx.x; s < nx; s += blockDim.x) {
    const int lane = s & 31, g = lane >> 2, t = lane & 3;
    int rest = s >> 5;
    const int p = rest % NP;
    rest /= NP;
    const int gate = rest % 3;
    rest /= 3;
    const int kk = rest & 1, kx = rest >> 1;
    s_wx[s] = gather_b_pair(wx, D, U, gate, p, g, [&](int hf, int e) {
      return 32 * kx + 8 * t + 4 * kk + 2 * hf + e;
    });
  }
  for (int s = threadIdx.x; s < Lay::wh_slots(); s += blockDim.x) {
    const int lane = s & 31, g = lane >> 2, t = lane & 3;
    int rest = s >> 5;
    const int p = rest % NP;
    rest /= NP;
    const int gate = rest % 3;
    const int kt = rest / 3;
    s_wh[s] = gather_b_pair(wh, U, U, gate, p, g, [&](int hf, int e) {
      return 16 * kt + 8 * hf + 2 * t + e;
    });
  }
  const int G = 3 * U;
  for (int i = threadIdx.x; i < 4 * Lay::kUnits; i += blockDim.x) {
    const int which = i / Lay::kUnits, unit = i % Lay::kUnits;
    float v = 0.f;
    if (unit < U) {
      if (which < 2) {
        v = to_f32(bias[which * U + unit]) + to_f32(bias[G + which * U + unit]);
      } else {
        v = to_f32(bias[(which - 2) * G + 2 * U + unit]);
      }
    }
    s_b[i] = v;
  }
}

// Shared-memory layout of the transposed weights of the backward's products
// at u <= 32 (gates padded to 32 units): d_xs = [da_z|da_r|da_c] wx^T and
// dh = [da_z|da_r|dhh] wh^T. Their k index is a gate's unit j (6 k16 tiles:
// gate q, half kh, tile kt = 2q + kh; the standard order, as `carry_to_a`
// packs the gate gradients), their n index a row of w (a column of d_xs, a
// unit of dh), n8 tiles paired as above:
//   wT: [ceil(R / 32) chunks of 32 rows][2 pairs][6 k16 tiles][32 lanes]
constexpr int kTKTiles = 6;
__host__ __device__ inline int transposed_slots(int R) {
  return ((R + 31) / 32) * 2 * kTKTiles * 32;
}

// One lane's two-tile B fragment of w^T for w [R][3U] (row-major, bf16):
// rows n = 8 (2p + q) + g of w and units j = 16 kh + 8 hf + 2t + e of gate
// `gate`, zero past R and U.
__device__ __forceinline__ uint4 gather_bt_pair(const __nv_bfloat16* __restrict__ w, int R, int U,
                                                int gate, int kh, int p, int g, int t) {
  const unsigned short* ws = reinterpret_cast<const unsigned short*>(w);
  uint32_t r[4];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int n = 8 * (2 * p + q) + g;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      uint32_t v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 16 * kh + 8 * hf + 2 * t + e;
        v[e] = (n < R && j < U) ? ws[(size_t)n * 3 * U + gate * U + j] : 0u;
      }
      r[2 * q + hf] = v[0] | (v[1] << 16);
    }
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// Stage wx^T and wh^T (u <= 32) into shared memory in the layout above. The
// caller synchronizes the block.
__device__ inline void stage_transposed_weights(const __nv_bfloat16* __restrict__ wx,
                                                const __nv_bfloat16* __restrict__ wh,
                                                uint4* s_wxt, uint4* s_wht, int D, int U) {
  for (int s = threadIdx.x; s < transposed_slots(D); s += blockDim.x) {
    const int lane = s & 31, kt = (s >> 5) % kTKTiles, p = (s >> 5) / kTKTiles;
    s_wxt[s] = gather_bt_pair(wx, D, U, kt >> 1, kt & 1, p, lane >> 2, lane & 3);
  }
  for (int s = threadIdx.x; s < transposed_slots(U); s += blockDim.x) {
    const int lane = s & 31, kt = (s >> 5) % kTKTiles, p = (s >> 5) / kTKTiles;
    s_wht[s] = gather_bt_pair(wh, U, U, kt >> 1, kt & 1, p, lane >> 2, lane & 3);
  }
}

// One step's four accumulators of 32-unit chunk c for the warp's 16 rows:
// acc[0] = z, acc[1] = r, acc[2] = xh, acc[3] = hh, each 4 n8 tiles. The
// bias is the initial C fragment; x_a holds the k16 A fragments of x_t
// (2 per 32-wide chunk, `KX` chunks), h_a those of round_bf16(h). B
// fragments come from shared memory, or for wh from `wh_regs` when
// WH_REGS (one 32-unit chunk).
template <int UC, bool WH_REGS, typename XChunk>
__device__ __forceinline__ void chunk_products(float (&acc)[4][4][4], int c, int KX,
                                               XChunk x_chunk, const uint32_t (&h_a)[UC * 2][4],
                                               const uint4* __restrict__ s_wx,
                                               const uint4* __restrict__ s_wh,
                                               const uint4 (&wh_regs)[WH_REGS ? kWhRegSlots : 1],
                                               const float* __restrict__ s_b, int lane) {
  using Lay = TileLayout<UC>;
  constexpr int NP = Lay::kPairs;
  const int t = lane & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(s_b + q * Lay::kUnits + 32 * c + 8 * j +
                                                        2 * t);
      acc[q][j][0] = b.x;
      acc[q][j][1] = b.y;
      acc[q][j][2] = b.x;
      acc[q][j][3] = b.y;
    }
  }
  for (int kx = 0; kx < KX; ++kx) {
    uint32_t a[2][4];
    x_chunk(kx, a);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const uint4 b = s_wx[(((kx * 2 + kk) * 3 + gate) * NP + 2 * c + p) * 32 + lane];
          mma_bf16(acc[gate][2 * p], a[kk], b.x, b.y);
          mma_bf16(acc[gate][2 * p + 1], a[kk], b.z, b.w);
        }
      }
    }
  }
#pragma unroll
  for (int kt = 0; kt < UC * 2; ++kt) {
#pragma unroll
    for (int gate = 0; gate < 3; ++gate) {
      const int dst = gate == 2 ? 3 : gate;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint4 b;
        if constexpr (WH_REGS) {
          b = wh_regs[(kt * 3 + gate) * 2 + p];
        } else {
          b = s_wh[((kt * 3 + gate) * NP + 2 * c + p) * 32 + lane];
        }
        mma_bf16(acc[dst][2 * p], h_a[kt], b.x, b.y);
        mma_bf16(acc[dst][2 * p + 1], h_a[kt], b.z, b.w);
      }
    }
  }
}

// The GRU update of chunk c from its accumulators, in place on the f32
// carry h (n8 tiles 4c .. 4c + 3). Rows g (slots 0, 1) and g + 8 (slots 2,
// 3) take the step only while `live0` / `live1`; otherwise h stays exactly.
template <int UC>
__device__ __forceinline__ void chunk_update(const float (&acc)[4][4][4], float (&h)[UC * 4][4],
                                             int c, bool live0, bool live1) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float z = sigmoid_fast(acc[0][j][i]);
      const float r = sigmoid_fast(acc[1][j][i]);
      const float hc = tanh_fast(fmaf(r, acc[3][j][i], acc[2][j][i]));
      const float old = h[4 * c + j][i];
      const float hn = fmaf(z, old - hc, hc);  // z * h + (1 - z) * hc
      h[4 * c + j][i] = (i < 2 ? live0 : live1) ? hn : old;
    }
  }
}

}  // namespace tile
}  // namespace ign
