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
// t >= lens[n] leave h unchanged, and since the mask is a prefix the warp
// simply stops at lens[n].
//
// What bounds it on an H100: instruction issue on the CUDA cores. At the
// flagship shape (L=8, N=16,384 paths, D=u=32) a call does
// 2*L*N*(D+u)*3u = 1.6 GFLOP against 8.4 MB of bf16 input, far above the
// byte bound; the simple kernel below runs its FMAs on CUDA cores with
// operands from shared memory and warp shuffles, not on tensor cores.
//
// Design: one warp per destination row (a grid-stride loop over rows), lane
// j owns unit j (chunks of 32 for u > 32, up to 128). wx, wh and both bias
// rows are staged once per block in shared memory as f32 (25 KB at u=32),
// laid out [k][3u] so lane j's three gate columns are bank-conflict free.
// Each step reads one x_t row, coalesced (lane k holds x[k]), and
// broadcasts its elements with __shfl_sync; the rounded carry is broadcast
// the same way. The L loop runs inside the kernel; no per-step tensors
// touch device memory. The per-step gate projections are in gru_step.cuh,
// shared with the backward kernel (gru_scan_bwd.cu).
#include "gru_step.cuh"

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

}  // namespace

extern "C" int ign_masked_gru_scan(const void* xs, const void* lens, const void* h0,
                                   const void* wx, const void* wh, const void* b,
                                   void* out, int L, int N, int D, int U, int dtype,
                                   void* stream) {
  const int* ln = static_cast<const int*>(lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L <= 0 || N <= 0 || D <= 0 || U <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case ign::kFloat32:
      return dispatch_units<float>(xs, ln, h0, wx, wh, b, out, L, N, D, U, s);
    case ign::kBFloat16:
      return dispatch_units<__nv_bfloat16>(xs, ln, h0, wx, wh, b, out, L, N, D, U, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
