// Kernel B: masked GRU scan, forward (Keras reset_after formulation).
//
//   for t in [0, L): if t < lens[n]:
//     xw = x[t, n] @ wx + b[0];  hw = h @ wh + b[1]
//     z = sigmoid(xw_z + hw_z);  r = sigmoid(xw_r + hw_r)
//     h = z * h + (1 - z) * tanh(xw_h + r * hw_h)
//   out[n] = h
//
// Replaces the TPU kernel of ignnition_tpu/ops/pallas/rnn_kernels.py,
// `_fwd_call` / `_make_fwd_kernel`. It is stage1's update (link states read
// in path order, fed through the GRU) in every message-passing iteration.
//
// Numerics follow the TPU kernel: h is carried in f32; each step rounds h to
// the input type before its product with wx/wh, as the TPU kernel's
// `h.astype(dtype)` does; products of input-type operands are summed in f32;
// gates are f32; the output is stored in the input type. Steps with
// t >= lens[n] leave h unchanged.
//
// Two instances, chosen by (dtype, u) before launch (the dispatch of
// `ign_masked_gru_scan`; `rnn_kernels.forward_instance` names the rule in
// Python and the profiler's kernel name witnesses it):
//
// * bf16, u <= 128: tensor cores (`masked_gru_scan_mma_kernel`; the tile
//   step is in gru_tile_mma.cuh). One warp owns 16 destination rows and runs
//   a step as mma.sync m16n8k16 products: [16, D] x [D, 3u] and
//   [16, u] x [u, 3u], the TPU kernel's two `dot_general`s on the MXU. The
//   carry stays in registers (its f32 C fragments repack into the next
//   step's bf16 A fragments); wx and the biases are staged once per block in
//   shared memory in fragment order; at u <= 32 wh is held in registers
//   (48 a lane). x_{t+1}'s first 32 columns are read while step t computes.
//   The warp runs to the longest of its 16 rows; a row past its length keeps
//   its h by a select. Gates use ex2.approx and a fast reciprocal (errors of
//   ~1e-6; tanh.approx's 2^-11 took the output 0.1 from the plain version at
//   u=128 on an H100).
//   Bound on an H100 at the flagship shape (L=8, N=16,384, D=u=32): 1.6
//   GFLOP on 989 TFLOP/s (0.0016 ms) and 8.4 MB of input (0.0025 ms); the
//   kernel is bound by the serial chain of a step (products, then gates) with
//   ~8 warps an SM to hide it.
// * f32 (any u <= 128): CUDA cores (`masked_gru_scan_kernel`), since TF32
//   tensor cores would not hold the TPU kernel's Precision.HIGHEST. One warp
//   per destination row (a grid-stride loop over rows), lane j owns unit j
//   (chunks of 32 for u > 32). wx, wh and both bias rows are staged once per
//   block in shared memory as f32, laid out [k][3u] so lane j's three gate
//   columns are bank-conflict free. Each step reads one x_t row, coalesced
//   (lane k holds x[k]), and broadcasts its elements with __shfl_sync; the
//   rounded carry is broadcast the same way; the warp stops at lens[n]. It
//   is bound by instruction issue (1.6 GFLOP of FMAs with operands from
//   shared memory and shuffles). The per-step gate projections are in
//   gru_step.cuh, shared with the backward kernel (gru_scan_bwd.cu).
#include "gru_step.cuh"
#include "gru_tile_mma.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int UC>
__global__ void __launch_bounds__(kThreads)
masked_gru_scan_kernel(const T* __restrict__ xs, const int* __restrict__ lens,
                       const T* __restrict__ h0, const T* __restrict__ wx,
                       const T* __restrict__ wh, const T* __restrict__ bias,
                       T* __restrict__ out, int L, int N, int D, int U) {
  extern __shared__ float smem[];
  const int G = 3 * U;
  float* s_wx = smem;            // [D][3U]
  float* s_wh = s_wx + D * G;    // [U][3U]
  float* s_b = s_wh + U * G;     // [2][3U]
  ign::stage_gru_weights(wx, wh, bias, s_wx, s_wh, s_b, D, U, G);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int n = blockIdx.x * warps + (threadIdx.x >> 5); n < N; n += gridDim.x * warps) {
    float h[UC];
#pragma unroll
    for (int c = 0; c < UC; ++c) {
      const int j = lane + 32 * c;
      h[c] = j < U ? ign::to_f32(h0[(long long)n * U + j]) : 0.f;
    }
    const int len = min(lens[n], L);
    for (int t = 0; t < len; ++t) {
      const T* x = xs + ((long long)t * N + n) * D;
      float az[UC], ar[UC], ac[UC], gz[UC], gr[UC], gc[UC];
      ign::gru_project<T, UC>(x, h, s_wx, s_wh, s_b, D, U, G, lane, az, ar, ac, gz, gr, gc);
#pragma unroll
      for (int c = 0; c < UC; ++c) {
        if (lane + 32 * c < U) {
          const float z = ign::sigmoidf_(az[c] + gz[c]);
          const float r = ign::sigmoidf_(ar[c] + gr[c]);
          const float hc = tanhf(ac[c] + r * gc[c]);
          h[c] = z * h[c] + (1.f - z) * hc;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < UC; ++c) {
      const int j = lane + 32 * c;
      if (j < U) out[(long long)n * U + j] = ign::from_f32<T>(h[c]);
    }
  }
}

template <typename T, int UC>
int launch(const void* xs, const int* lens, const void* h0, const void* wx,
           const void* wh, const void* b, void* out, int L, int N, int D, int U,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(D + U + 2) * 3 * U;
  auto kernel = masked_gru_scan_kernel<T, UC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int per_sm = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) per_sm = 1;
  const int warps = kThreads / 32;
  int blocks = (N + warps - 1) / warps;
  const int resident = per_sm * ign::sm_count();
  if (blocks > resident) blocks = resident;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(xs), lens, static_cast<const T*>(h0),
      static_cast<const T*>(wx), static_cast<const T*>(wh),
      static_cast<const T*>(b), static_cast<T*>(out), L, N, D, U);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_units(const void* xs, const int* lens, const void* h0, const void* wx,
                   const void* wh, const void* b, void* out, int L, int N, int D,
                   int U, cudaStream_t s) {
  if (U <= 32) return launch<T, 1>(xs, lens, h0, wx, wh, b, out, L, N, D, U, s);
  if (U <= 64) return launch<T, 2>(xs, lens, h0, wx, wh, b, out, L, N, D, U, s);
  if (U <= 128) return launch<T, 4>(xs, lens, h0, wx, wh, b, out, L, N, D, U, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- bf16 on tensor cores ----

constexpr int kMmaThreads = 128;  // 4 warps, one 16-row tile each at a time

template <int UC, bool VEC>
__global__ void __launch_bounds__(kMmaThreads)
masked_gru_scan_mma_kernel(const __nv_bfloat16* __restrict__ xs, const int* __restrict__ lens,
                           const __nv_bfloat16* __restrict__ h0,
                           const __nv_bfloat16* __restrict__ wx,
                           const __nv_bfloat16* __restrict__ wh,
                           const __nv_bfloat16* __restrict__ bias,
                           __nv_bfloat16* __restrict__ out, int L, int N, int D, int U) {
  using namespace ign::tile;
  using Lay = TileLayout<UC>;
  constexpr bool kWhRegs = UC == 1;
  extern __shared__ uint4 smem4[];
  const int KX = Lay::x_chunks(D);
  uint4* s_wx = smem4;
  uint4* s_wh = s_wx + Lay::wx_slots(D);
  float* s_b = reinterpret_cast<float*>(s_wh + Lay::wh_slots());
  stage_tile_weights<UC>(wx, wh, bias, s_wx, s_wh, s_b, D, U);
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  uint4 wh_regs[kWhRegs ? kWhRegSlots : 1];
  if constexpr (kWhRegs) {
#pragma unroll
    for (int i = 0; i < kWhRegSlots; ++i) wh_regs[i] = s_wh[i * 32 + lane];
  }
  const int warps = blockDim.x >> 5;
  const int tiles = (N + kRows - 1) / kRows;
  for (int tile = blockIdx.x * warps + (threadIdx.x >> 5); tile < tiles;
       tile += gridDim.x * warps) {
    const int r0 = tile * kRows + g, r1 = r0 + 8;
    const int len0 = r0 < N ? min(max(lens[r0], 0), L) : 0;
    const int len1 = r1 < N ? min(max(lens[r1], 0), L) : 0;
    const int steps = __reduce_max_sync(ign::kFullMask, max(len0, len1));
    // rows past N read row N - 1 (never stored, len 0)
    const long long x0 = min(r0, N - 1), x1 = min(r1, N - 1);

    float h[UC * 4][4];
#pragma unroll
    for (int j = 0; j < UC * 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i < 2 ? r0 : r1, unit = 8 * j + 2 * tq + (i & 1);
        h[j][i] = row < N && unit < U ? ign::to_f32(h0[(long long)row * U + unit]) : 0.f;
      }
    }
    uint32_t h_a[UC * 2][4];
    carry_to_a<UC>(h, h_a);

    auto row_of = [&](int t, long long x) { return xs + ((long long)t * N + x) * D; };
    uint4 xg = make_uint4(0u, 0u, 0u, 0u), xg8 = xg;
    if (steps > 0) {
      xg = load_row8<VEC>(row_of(0, x0), 8 * tq, D);
      xg8 = load_row8<VEC>(row_of(0, x1), 8 * tq, D);
    }
    for (int t = 0; t < steps; ++t) {
      // x_{t+1}'s first chunk is in flight while step t computes
      uint4 ng = xg, ng8 = xg8;
      if (t + 1 < steps) {
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
#pragma unroll
      for (int c = 0; c < UC; ++c) {
        float acc[4][4][4];
        chunk_products<UC, kWhRegs>(acc, c, KX, x_chunk, h_a, s_wx, s_wh, wh_regs, s_b, lane);
        chunk_update<UC>(acc, h, c, t < len0, t < len1);
      }
      carry_to_a<UC>(h, h_a);
      xg = ng;
      xg8 = ng8;
    }
#pragma unroll
    for (int j = 0; j < UC * 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i < 2 ? r0 : r1, unit = 8 * j + 2 * tq + (i & 1);
        if (row < N && unit < U) {
          out[(long long)row * U + unit] = ign::from_f32<__nv_bfloat16>(h[j][i]);
        }
      }
    }
  }
}

template <int UC, bool VEC>
int launch_mma(const void* xs, const int* lens, const void* h0, const void* wx, const void* wh,
               const void* b, void* out, int L, int N, int D, int U, cudaStream_t stream) {
  const size_t smem = ign::tile::TileLayout<UC>::smem_bytes(D);
  auto kernel = masked_gru_scan_mma_kernel<UC, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int per_sm = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMmaThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) per_sm = 1;
  const int warps = kMmaThreads / 32;
  const int tiles = (N + ign::tile::kRows - 1) / ign::tile::kRows;
  int blocks = (tiles + warps - 1) / warps;
  const int resident = per_sm * ign::sm_count();
  if (blocks > resident) blocks = resident;
  using bf16 = __nv_bfloat16;
  kernel<<<blocks, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(xs), lens, static_cast<const bf16*>(h0),
      static_cast<const bf16*>(wx), static_cast<const bf16*>(wh), static_cast<const bf16*>(b),
      static_cast<bf16*>(out), L, N, D, U);
  return static_cast<int>(cudaGetLastError());
}

template <int UC>
int launch_mma_x(const void* xs, const int* lens, const void* h0, const void* wx, const void* wh,
                 const void* b, void* out, int L, int N, int D, int U, cudaStream_t s) {
  const bool vec = D % 8 == 0 && reinterpret_cast<uintptr_t>(xs) % 16 == 0;
  return vec ? launch_mma<UC, true>(xs, lens, h0, wx, wh, b, out, L, N, D, U, s)
             : launch_mma<UC, false>(xs, lens, h0, wx, wh, b, out, L, N, D, U, s);
}

// The (dtype, u) -> instance rule: unit chunks of 32 (1, 2 or 4) and
// whether the tensor-core kernel serves the call. 0 for an unsupported call.
int instance(int dtype, int U, bool* tensor_cores) {
  *tensor_cores = dtype == ign::kBFloat16;
  if (U <= 0 || U > 128 || (dtype != ign::kFloat32 && dtype != ign::kBFloat16)) return 0;
  return U <= 32 ? 1 : U <= 64 ? 2 : 4;
}

}  // namespace

extern "C" int ign_masked_gru_scan(const void* xs, const void* lens, const void* h0,
                                   const void* wx, const void* wh, const void* b,
                                   void* out, int L, int N, int D, int U, int dtype,
                                   void* stream) {
  const int* ln = static_cast<const int*>(lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool tensor_cores = false;
  const int chunks = instance(dtype, U, &tensor_cores);
  if (L <= 0 || N <= 0 || D <= 0 || chunks == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (tensor_cores) {
    switch (chunks) {
      case 1: return launch_mma_x<1>(xs, ln, h0, wx, wh, b, out, L, N, D, U, s);
      case 2: return launch_mma_x<2>(xs, ln, h0, wx, wh, b, out, L, N, D, U, s);
      default: return launch_mma_x<4>(xs, ln, h0, wx, wh, b, out, L, N, D, U, s);
    }
  }
  return dispatch_units<float>(xs, ln, h0, wx, wh, b, out, L, N, D, U, s);
}

// Dynamic shared memory of the instance serving (dtype, D, u), in bytes.
extern "C" long long ign_masked_gru_scan_smem(int dtype, int D, int U) {
  bool tensor_cores = false;
  const int chunks = instance(dtype, U, &tensor_cores);
  if (chunks == 0 || D <= 0) return -1;
  if (!tensor_cores) return (long long)sizeof(float) * (D + U + 2) * 3 * U;
  switch (chunks) {
    case 1: return (long long)ign::tile::TileLayout<1>::smem_bytes(D);
    case 2: return (long long)ign::tile::TileLayout<2>::smem_bytes(D);
    default: return (long long)ign::tile::TileLayout<4>::smem_bytes(D);
  }
}
