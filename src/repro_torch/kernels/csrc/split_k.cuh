// Shared piece of the split-K decode-attention kernels (paged_attention.cu,
// flash_decode.cu): the fixed-order merge of the splits' partials.
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
