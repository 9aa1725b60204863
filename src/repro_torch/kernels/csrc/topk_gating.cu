// MoE router: softmax over E experts, the k largest probabilities (lowest
// expert id first among equal ones), renormalised by their sum + 1e-9.
//
// Replaces: the TPU kernel `topk_gating` (repro/kernels/topk_gating.py,
// body `_kernel`), which fused the same steps in VMEM per token block and
// selected by k rounds of argmax and mask.
//
// Bound on this card: at the main path's shapes (T <= 8 rows, E 64 and
// k 6, or E 16 and k 1) the work is a few hundred bytes and a few
// thousand operations, so neither the memory rate nor the arithmetic rate
// binds. A launch is the cost, and what the kernel adds to it is the
// latency of one row's chain of dependent steps: load, max, exp, sum,
// divide, select, sum, divide, store.
//
// Design: one CTA of 4 warps per token row (one warp per SM
// sub-partition). Each lane holds S = ceil(E / 32) logits in registers
// (expert lane + 32 i in slot i); the kernel is a template on S, so no
// lane scans a slot it does not hold. Every warp forms the probabilities
// with the first version's arithmetic, bit for bit: the max (one
// `redux.sync` on an order-keeping integer image of the floats; a max does
// not depend on order), per-lane expf(v - m) summed in ascending slot
// order, the xor butterfly (16, 8, 4, 2, 1) for the row sum, and v / s.
// Selection is by rank in place of k serial rounds: a probability p >= 0
// orders as its bits, so the rank of expert e (the number of j with
// p_j > p_e, or p_j == p_e and j < e: lax.top_k's total order) is a count
// of integer comparisons. The four warps count over a quarter of the row
// each, in a loop of branch-free subtractions whose sign bit is the
// count, against a threshold that lets ties count in the blocks of 32
// below e's and not in its own or above; warp 0 adds the ties in e's own
// block at lower lanes (one match.any per slot). The values of rank r < k
// land in slot r of a shared array, the k weights are summed in slot
// order 0..k-1 (the first version's round order, so the same bits), and
// lanes 0..k-1 store one weight and one id each: one coalesced store of
// each, nothing read back from device memory. Probabilities that
// underflow to 0 tie, so they go in id order. At k = 1 the rank is not
// needed: warp 0 takes the lowest id of the largest probability with two
// `redux.sync` and stores it, and the other warps exit at once.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarpsPerRow = 4;  // one per SM sub-partition
constexpr int kMaxSlots = 8;     // E <= 256

// The warp's max of m, through an integer image that keeps float order.
__device__ __forceinline__ float warp_max(float m) {
  unsigned u = __float_as_uint(m);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  u = __reduce_max_sync(0xffffffffu, u);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

template <int S>
__global__ void __launch_bounds__(32 * kWarpsPerRow)
    topk_gating_kernel(const float* __restrict__ logits,
                       float* __restrict__ w_out, int* __restrict__ idx_out,
                       int E, int K) {
  __shared__ __align__(16) int keys[kWarpsPerRow][32 * S];
  __shared__ int part[kWarpsPerRow][32 * S];
  __shared__ float sel_w[32 * S];
  __shared__ int sel_i[32 * S];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x;
  if (K == 1 && warp != 0) return;
  const float* x = logits + (size_t)row * E;

  // every warp forms the row's probabilities, the same bits in each
  float v[S];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int e = lane + 32 * i;
    v[i] = (e < E) ? x[e] : -INFINITY;
    m = fmaxf(m, v[i]);
  }
  m = warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    v[i] = expf(v[i] - m);             // 0 past E, as the first version's
    s += v[i];
  }
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);

  int twice[S];                        // 2 bits(p): p >= 0 orders as its bits
#pragma unroll
  for (int i = 0; i < S; ++i) {
    v[i] = v[i] / s;
    twice[i] = 2 * __float_as_int(v[i]);
  }
  if (K == 1) {                        // the lowest id of the largest p
    int best = -1, slot = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int t = (lane + 32 * i < E) ? twice[i] : -1;
      if (t > best) {
        best = t;
        slot = i;
      }
    }
    const int top = __reduce_max_sync(0xffffffffu, best);
    const int id = (int)__reduce_min_sync(
        0xffffffffu, best == top ? (unsigned)(lane + 32 * slot) : ~0u);
    if (lane == 0) {
      const float p = __int_as_float(top / 2);
      w_out[row] = p / (p + 1e-9f);  // the first version's 0 + p, + 1e-9
      idx_out[row] = id;
    }
    return;
  }
  int* key = keys[warp];               // 2 bits + 1 (< 2^31), -1 past E
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int e = lane + 32 * i;
    key[e] = (e < E) ? twice[i] + 1 : -1;
  }
  __syncwarp();

  // rank of expert e = lane + 32 i over this warp's quarter of the groups
  // of 4 experts: key_j > 2 bits_e + [j's block is not below e's], so
  // every j of a lower block that ties counts and no j of e's own or a
  // higher block that ties does; warp 0 adds the ties at lower lanes of
  // e's own block
  const int groups = (E + 3) / 4;
  const int per = (groups + kWarpsPerRow - 1) / kWarpsPerRow;
  const int g1 = min(groups, (warp + 1) * per);
  int rank[S];
#pragma unroll
  for (int i = 0; i < S; ++i) rank[i] = 0;
  if (warp == 0) {
    const unsigned lower = (1u << lane) - 1u;
#pragma unroll
    for (int i = 0; i < S; ++i)
      rank[i] = __popc(__match_any_sync(0xffffffffu, twice[i]) & lower);
  }
  for (int g = warp * per; g < g1; ++g) {
    const int4 q = *reinterpret_cast<const int4*>(key + 4 * g);
    const int b = g / 8;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int thr = twice[i] + (b >= i);
      rank[i] += ((unsigned)(thr - q.x) >> 31) + ((unsigned)(thr - q.y) >> 31) +
                 ((unsigned)(thr - q.z) >> 31) + ((unsigned)(thr - q.w) >> 31);
    }
  }
  if (warp != 0) {
#pragma unroll
    for (int i = 0; i < S; ++i) part[warp][lane + 32 * i] = rank[i];
  }
  __syncthreads();
  if (warp != 0) return;

#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int e = lane + 32 * i;
#pragma unroll
    for (int w = 1; w < kWarpsPerRow; ++w) rank[i] += part[w][e];
    if (e < E && rank[i] < K) {
      sel_w[rank[i]] = v[i];
      sel_i[rank[i]] = e;
    }
  }
  __syncwarp();

  // the k weights summed in slot order, the first version's round order;
  // loaded 8 at a time so the loads do not wait on the adds (+0 is exact)
  float tot = 0.f;
  for (int r0 = 0; r0 < K; r0 += 8) {
    float t[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) t[c] = (r0 + c < K) ? sel_w[r0 + c] : 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) tot += t[c];
  }
  const float denom = tot + 1e-9f;
  for (int r = lane; r < K; r += 32) {
    w_out[(size_t)row * K + r] = sel_w[r] / denom;
    idx_out[(size_t)row * K + r] = sel_i[r];
  }
}

template <int S>
int launch(const float* logits, float* w_out, int* idx_out, int T, int E,
           int K, cudaStream_t stream) {
  topk_gating_kernel<S><<<T, 32 * kWarpsPerRow, 0, stream>>>(logits, w_out,
                                                              idx_out, E, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int topk_gating_launch(const void* logits, void* w_out,
                                  void* idx_out, int T, int E, int K,
                                  void* stream) {
  if (T < 1 || E < 1 || E > 32 * kMaxSlots || K < 1 || K > E)
    return (int)cudaErrorInvalidValue;
  const float* x = (const float*)logits;
  float* w = (float*)w_out;
  int* idx = (int*)idx_out;
  cudaStream_t st = (cudaStream_t)stream;
  switch ((E + 31) / 32) {
    case 1: return launch<1>(x, w, idx, T, E, K, st);
    case 2: return launch<2>(x, w, idx, T, E, K, st);
    case 3: return launch<3>(x, w, idx, T, E, K, st);
    case 4: return launch<4>(x, w, idx, T, E, K, st);
    case 5: return launch<5>(x, w, idx, T, E, K, st);
    case 6: return launch<6>(x, w, idx, T, E, K, st);
    case 7: return launch<7>(x, w, idx, T, E, K, st);
    default: return launch<8>(x, w, idx, T, E, K, st);
  }
}
