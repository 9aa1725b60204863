// Cached-expert SwiGLU FFN read straight from the device slot buffer:
//   y[n] = sum_k w[n,k] * (silu(x[n] Wg[s]) * (x[n] Wu[s])) Wd[s],
//   s = slot_idx[n,k],  float32 accumulation, output in x's dtype.
//
// Replaces: the TPU kernel `expert_ffn` (repro/kernels/expert_ffn.py, body
// `_kernel`) and the (lane, k) slot gather the reference engine's
// `expert_from_slots` materialises around it (repro/serving/engine.py).
//
// Bound on this card: bytes. Each (lane, k) pair reads one expert's
// 3*D*F weights (17.3 MB in bf16 at D=2048, F=1408) for 6*D*F operations,
// about 1.5 operations per byte, far below the ~295 the tensor cores need.
//
// Design (simple first): three launches on the caller's stream.
//   1. gate/up: one CTA per (pair, 128 columns of F); x[n] is staged in
//      shared memory as f32, each thread walks D for one column, so a warp
//      reads 32 neighbouring columns of a row (coalesced). h = silu(g)*u
//      goes to the f32 scratch (N, k, F).
//   2. down: one CTA per (pair, 128 columns of D); each thread walks F for
//      one output column, writing the unweighted partial y_k to the f32
//      scratch (N, k, D).
//   3. combine: y[n] = sum_k w[n,k] * y_k in k order (deterministic, no
//      atomics), cast to x's dtype.
// The slot index is read per CTA, so the (N, k, D, F) gather never exists.
// A slot shared by several pairs is streamed once per pair; reading each
// distinct slot once (and wgmma over the pairs that share it) is later work.
#include "common.cuh"

namespace {

constexpr int kCols = 128;

template <typename T>
__global__ void gate_up_kernel(const T* __restrict__ x,
                               const int* __restrict__ slot_idx,
                               const T* __restrict__ wg,
                               const T* __restrict__ wu,
                               float* __restrict__ h, int K, int D, int F) {
  extern __shared__ float xs[];
  const int pair = blockIdx.y;
  const int n = pair / K;
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    xs[d] = to_f32(x[(size_t)n * D + d]);
  __syncthreads();
  const int f = blockIdx.x * kCols + threadIdx.x;
  if (f >= F) return;
  const size_t s = (size_t)slot_idx[pair];
  const T* gp = wg + s * D * F + f;
  const T* up = wu + s * D * F + f;
  float g = 0.f, u = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float xv = xs[d];
    g += xv * to_f32(gp[(size_t)d * F]);
    u += xv * to_f32(up[(size_t)d * F]);
  }
  h[(size_t)pair * F + f] = g / (1.f + expf(-g)) * u;  // silu(g) * u
}

template <typename T>
__global__ void down_kernel(const float* __restrict__ h,
                            const int* __restrict__ slot_idx,
                            const T* __restrict__ wd, float* __restrict__ yk,
                            int D, int F) {
  const int pair = blockIdx.y;
  const int d = blockIdx.x * kCols + threadIdx.x;
  if (d >= D) return;
  const size_t s = (size_t)slot_idx[pair];
  const float* hp = h + (size_t)pair * F;
  const T* wp = wd + s * F * D + d;
  float acc = 0.f;
#pragma unroll 4
  for (int f = 0; f < F; ++f) acc += hp[f] * to_f32(wp[(size_t)f * D]);
  yk[(size_t)pair * D + d] = acc;
}

template <typename T>
__global__ void combine_kernel(const float* __restrict__ yk,
                               const float* __restrict__ weights,
                               T* __restrict__ out, int N, int K, int D) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)N * D) return;
  const int n = (int)(i / D);
  const int d = (int)(i % D);
  float y = 0.f;
  for (int j = 0; j < K; ++j)
    y += weights[n * K + j] * yk[((size_t)n * K + j) * D + d];
  out[i] = from_f32<T>(y);
}

template <typename T>
int launch(const void* x, const void* weights, const void* slot_idx,
           const void* wg, const void* wu, const void* wd, void* scratch,
           void* out, int N, int K, int D, int F, cudaStream_t st) {
  float* h = (float*)scratch;                   // (N, K, F)
  float* yk = h + (size_t)N * K * F;            // (N, K, D)
  const size_t smem = sizeof(float) * (size_t)D;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gate_up_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gate_up_kernel<T><<<dim3((F + kCols - 1) / kCols, N * K), kCols, smem,
                      st>>>((const T*)x, (const int*)slot_idx, (const T*)wg,
                            (const T*)wu, h, K, D, F);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  down_kernel<T><<<dim3((D + kCols - 1) / kCols, N * K), kCols, 0, st>>>(
      h, (const int*)slot_idx, (const T*)wd, yk, D, F);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)N * D;
  combine_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      yk, (const float*)weights, (T*)out, N, K, D);
  return (int)cudaGetLastError();
}

}  // namespace

// scratch: N*K*(F+D) floats allocated by the caller
extern "C" int expert_ffn_launch(const void* x, const void* weights,
                                 const void* slot_idx, const void* wg,
                                 const void* wu, const void* wd,
                                 void* scratch, void* out, int N, int K,
                                 int D, int F, int dtype, void* stream) {
  if (N <= 0 || K <= 0) return (int)cudaSuccess;
  DISPATCH_DTYPE(dtype, T,
                 return launch<T>(x, weights, slot_idx, wg, wu, wd, scratch,
                                  out, N, K, D, F, (cudaStream_t)stream));
  return (int)cudaErrorInvalidValue;
}
