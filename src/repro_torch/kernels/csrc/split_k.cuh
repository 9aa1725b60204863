// Shared pieces of the split-K decode-attention kernels (paged_attention.cu,
// flash_decode.cu): 4-element loads and stores, 16-byte cp.async staging,
// and the fixed-order merge of the splits' partials.
//
// A split kernel writes, per output row (lane, kv head, query head) and
// split, the partial (m, l) to `ws_ml` and acc[DV] to `ws_acc` (f32); a
// split that holds no live key writes m = -1e30, l = 0 and no acc. The
// live splits of a row are always a prefix of its splits.
#pragma once

#include <math.h>

#include "common.cuh"

namespace {

constexpr float kSplitNeg = -1e30f;

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 x;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// One thread per (output row, 4-column chunk): merges the live splits of
// its row in a fixed order (no atomics, so two calls on the same inputs
// are bit-identical) and writes acc / max(l, 1e-30) in the output type.
// The partials are read by every SM's worth of threads at once.
template <typename T>
__global__ void __launch_bounds__(128) split_combine_kernel(
    const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
    T* __restrict__ out, int rows, int S, int DV) {
  const int nv = DV / 4;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * nv) return;
  const int row = t / nv, c = t - row * nv;
  const float2* ml = reinterpret_cast<const float2*>(ws_ml) + (size_t)row * S;
  float mx = kSplitNeg;
  int n_live = 0;
  for (int s = 0; s < S; ++s) {
    const float2 v = ml[s];
    if (v.y > 0.f) {
      mx = fmaxf(mx, v.x);
      ++n_live;
    }
  }
  float lsum = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
  const float* ap = ws_acc + (size_t)row * S * DV + 4 * c;
#pragma unroll 4
  for (int s = 0; s < n_live; ++s) {     // fixed order
    const float2 v = ml[s];
    const float w = expf(v.x - mx);
    float x[4];
    load4(ap + (size_t)s * DV, x);
    lsum += w * v.y;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += w * x[e];
  }
  const float den = fmaxf(lsum, 1e-30f);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] /= den;
  store4(out + (size_t)row * DV + 4 * c, acc);
}

// Launch the merge of `rows` output rows of DV columns over S splits.
template <typename T>
cudaError_t launch_split_combine(const float* ws_acc, const float* ws_ml,
                                 void* out, int rows, int S, int DV,
                                 cudaStream_t st) {
  split_combine_kernel<T><<<(rows * (DV / 4) + 127) / 128, 128, 0, st>>>(
      ws_acc, ws_ml, (T*)out, rows, S, DV);
  return cudaGetLastError();
}

}  // namespace
