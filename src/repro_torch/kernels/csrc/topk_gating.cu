// MoE router: softmax over E experts, k rounds of argmax (lowest index on
// ties), renormalise with +1e-9.
//
// Replaces: the TPU kernel `topk_gating` (repro/kernels/topk_gating.py,
// body `_kernel`), which fused the same steps in VMEM per token block.
//
// Bound on this card: at the main path's shapes (T <= 8 rows, E = 64,
// k = 6) the work is a few hundred bytes and a few thousand operations,
// so the launch itself is the cost; neither the memory rate nor the
// arithmetic rate binds.
//
// Design: one warp per token row. Each lane holds up to 8 logits in
// registers (E <= 256), the softmax max and sum are warp shuffles, and
// each of the k rounds is a warp-wide reduction on (value desc, index asc),
// which is a total order, so every lane agrees on the winner and equal
// probabilities resolve to the lowest expert id exactly as lax.top_k does.
// Taken entries are set to -1, below any probability, so an underflowed
// probability of 0 is still selectable in index order. The logits never
// leave registers; nothing is allocated.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxPerLane = 8;
constexpr int kWarpsPerBlock = 4;

__global__ void topk_gating_kernel(const float* __restrict__ logits,
                                   float* __restrict__ w_out,
                                   int* __restrict__ idx_out, int T, int E,
                                   int K) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= T) return;
  const float* x = logits + (size_t)row * E;

  float v[kMaxPerLane];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int e = lane + 32 * i;
    v[i] = (e < E) ? x[e] : -INFINITY;
    m = fmaxf(m, v[i]);
  }
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int e = lane + 32 * i;
    v[i] = (e < E) ? expf(v[i] - m) : 0.f;
    s += v[i];
  }
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int e = lane + 32 * i;
    v[i] = (e < E) ? v[i] / s : -1.f;
  }

  float tot = 0.f;
  for (int r = 0; r < K; ++r) {
    float best = -2.f;
    int bi = 0x7fffffff;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      if (v[i] > best) {  // ascending e within the lane: lowest index wins
        best = v[i];
        bi = lane + 32 * i;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ob > best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
      }
    }
    if (lane == 0) {
      w_out[(size_t)row * K + r] = best;
      idx_out[(size_t)row * K + r] = bi;
    }
    tot += best;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i)
      if (lane + 32 * i == bi) v[i] = -1.f;
  }
  if (lane == 0) {
    const float denom = tot + 1e-9f;
    for (int r = 0; r < K; ++r) w_out[(size_t)row * K + r] /= denom;
  }
}

}  // namespace

extern "C" int topk_gating_launch(const void* logits, void* w_out,
                                  void* idx_out, int T, int E, int K,
                                  void* stream) {
  if (E > 32 * kMaxPerLane || K < 1 || K > E) return (int)cudaErrorInvalidValue;
  const int blocks = (T + kWarpsPerBlock - 1) / kWarpsPerBlock;
  topk_gating_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                       (cudaStream_t)stream>>>(
      (const float*)logits, (float*)w_out, (int*)idx_out, T, E, K);
  return (int)cudaGetLastError();
}
