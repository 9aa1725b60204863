// Flash-decode: one query token per lane against that lane's contiguous KV
// row, keys at positions >= valid_len masked, online softmax.
//
// Replaces: the TPU kernel `flash_decode` (repro/kernels/flash_attention.py,
// body `_kernel`), whose sequential grid axis walked the cache in `block_s`
// blocks, together with the row gather (`jnp.take` of each lane's row) the
// reference engine's batched row decode builds around it
// (repro/serving/engine.py, `attn_batched`): the kernel reads `rows` itself.
//
// Bound on this card: bytes. Each live key costs one read of its K and V
// rows, 2*hd values per kv head, for about 4*G*hd operations (G query heads
// share the read): about 5 operations per byte in bf16 at G=5, far below
// the ~295 the tensor cores need. At the main path's shapes (4 lanes,
// KVH=8, G=5, hd=128, valid_len <= 96) a call moves under a megabyte, so
// latency, not the memory rate, decides its time: the design spreads the
// live keys over the SMs.
//
// Design: split-K ("flash-decoding") in two kernels, so one call of
// `flash_decode_launch` is two CUDA launches.
//   1. `flash_split_kernel`, grid (split, lane, kv head x head group). The
//      split count comes from the wrapper's plan (`split_plan` in
//      flash_attention.py: about twice the SM count of CTAs, at most 32
//      splits). Only the prefix [0, valid_len) of a row is live (the
//      chunked ring holds 8192 slots, of which at most `pos % chunk + 1`
//      are), so a split fixed on the host would leave every live key in
//      split 0: each CTA derives its key range from valid_len on the
//      device instead (`keys_per_split`). A CTA whose range is empty
//      writes an empty partial (m = -1e30, l = 0) and reads nothing; the
//      others stage their keys' K and V rows in shared memory with 16-byte
//      cp.async copies (in turns when they exceed the stage). Each warp
//      owns one query head and keeps its q in registers (lane i owns the
//      4-element chunks i, i+32 of hd), scores 8 keys at a time with a
//      shuffle reduction that leaves every score in every lane, runs the
//      online softmax in registers, and accumulates its output row (lane i
//      owns the same chunks of V). The loops carry no runtime guard: chunk
//      and key indices are clamped to valid, live rows and a clamped key's
//      score is masked, so its weight is exactly 0. It writes the partial
//      (m, l, acc[hd]) in f32 to the wrapper's workspace.
//   2. `split_combine_kernel` (split_k.cuh, shared with the paged kernel)
//      merges the live splits in a fixed order and writes
//      acc / max(l, 1e-30) in q's dtype: two calls on the same inputs are
//      bit-identical.
// Every caller has valid_len >= 1 (the token being decoded is always
// live); with valid_len 0 every split is empty and the output is zero.
// Tensor cores are not used: per CTA the product is at most 8 heads x 8
// keys at a time; the time is latency.
#include <math.h>

#include <algorithm>

#include "common.cuh"
#include "split_k.cuh"

namespace {

constexpr int kMaxHeads = 8;     // query heads (warps) per CTA
constexpr int kKeys = 8;         // keys scored together
constexpr int kMaxSplits = 32;   // bounds the workspace
constexpr int kMaxHd = 256;      // two 4-element chunks per warp lane
constexpr int kStageBytes = 32 * 1024;

// Keys per split: ceil(vl / splits) rounded up to a multiple of 8, at
// least 8; split s walks [s * per, min((s + 1) * per, vl)). The same
// formula is `keys_per_split` in flash_attention.py, whose CPU tests check
// that the ranges cover [0, vl) once.
__device__ __forceinline__ int keys_per_split(int vl, int splits) {
  const int per = (vl + splits - 1) / splits;
  return max(kKeys, (per + kKeys - 1) / kKeys * kKeys);
}

// NS: 4-element chunks per lane, ceil(hd / 128).
template <typename T, int NS>
__global__ void __launch_bounds__(32 * kMaxHeads) flash_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const int* __restrict__ rows,
    const int* __restrict__ valid_len, float* __restrict__ ws_acc,
    float* __restrict__ ws_ml, int KVH, int G, int S, int HD, int SP,
    int HPC, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kVec = 16 / sizeof(T);         // elements per 16-byte piece
  const int split = blockIdx.x, NSPL = gridDim.x;
  const int lane_id = blockIdx.y;
  const int groups = gridDim.z / KVH;
  const int head = blockIdx.z / groups;
  const int g0 = (blockIdx.z % groups) * HPC;
  const int gn = min(HPC, G - g0);
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  const bool has_head = warp < gn;
  const size_t orow = ((size_t)lane_id * KVH + head) * G + g0 + warp;
  float* ml = ws_ml + (orow * NSPL + split) * 2;

  // the row, valid_len and q are loaded side by side
  const size_t r = (size_t)rows[lane_id];
  const int vl = min(valid_len[lane_id], S);
  const int nc = HD / 4;                       // 4-element chunks per row
  int cc[NS];                                  // this lane's chunks, clamped
  float qr[NS][4];
#pragma unroll
  for (int i = 0; i < NS; ++i) cc[i] = min(wl + 32 * i, nc - 1);
  if (has_head) {
    const T* qp = q + orow * HD;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      load4(qp + 4 * cc[i], qr[i]);
      if (wl + 32 * i >= nc)
#pragma unroll
        for (int e = 0; e < 4; ++e) qr[i][e] = 0.f;
    }
  }
  const int per = keys_per_split(vl, NSPL);
  const int k0 = split * per;
  const int nk = min(per, vl - k0);            // this split's live keys
  if (nk <= 0) {   // the whole CTA: its range holds no live key
    if (has_head && wl == 0) {
      ml[0] = kSplitNeg;
      ml[1] = 0.f;
    }
    return;
  }
  float acc[NS][4];
#pragma unroll
  for (int i = 0; i < NS; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m = kSplitNeg, l = 0.f;

  T* ks = reinterpret_cast<T*>(smem);          // SP rows of HD
  T* vs = ks + (size_t)SP * HD;                // SP rows of HD
  const size_t key_stride = (size_t)KVH * HD;  // keys lie KVH*hd apart
  const size_t first = ((r * S + k0) * KVH + head) * HD;
  const int pieces = HD / kVec;                // 16-byte pieces per row
  for (int st = 0; st < nk; st += SP) {
    const int live = min(SP, nk - st);         // rows of this stage
    if (st > 0) __syncthreads();   // the previous stage's readers are done
    for (int i = threadIdx.x; i < live * pieces; i += blockDim.x) {
      const int j = i / pieces, c = i - j * pieces;
      const size_t src = first + (size_t)(st + j) * key_stride + c * kVec;
      const size_t dst = (size_t)j * HD + c * kVec;
      cp_async16(ks + dst, k_cache + src);
      cp_async16(vs + dst, v_cache + src);
    }
    cp_async_wait_all();
    __syncthreads();
    if (!has_head) continue;
    for (int r0 = 0; r0 < live; r0 += kKeys) {
      float sc[kKeys];
#pragma unroll
      for (int k = 0; k < kKeys; ++k) {
        const T* kr = ks + (size_t)min(r0 + k, live - 1) * HD;
        sc[k] = 0.f;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          float kv[4];
          load4(kr + 4 * cc[i], kv);
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[k] += qr[i][e] * kv[e];
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int k = 0; k < kKeys; ++k)
          sc[k] += __shfl_xor_sync(0xffffffffu, sc[k], off);
      float mx = m;
#pragma unroll
      for (int k = 0; k < kKeys; ++k) {
        sc[k] = r0 + k < live ? sc[k] * scale : kSplitNeg;
        mx = fmaxf(mx, sc[k]);
      }
      const float alpha = expf(m - mx);
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kKeys; ++k) {
        sc[k] = expf(sc[k] - mx);          // exactly 0 for a masked key
        sum += sc[k];
      }
      l = l * alpha + sum;
      m = mx;
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] *= alpha;
#pragma unroll
      for (int k = 0; k < kKeys; ++k) {
        const T* vr = vs + (size_t)min(r0 + k, live - 1) * HD;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          float vv[4];
          load4(vr + 4 * cc[i], vv);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] += sc[k] * vv[e];
        }
      }
    }
  }
  if (!has_head) return;
  if (wl == 0) {
    ml[0] = m;
    ml[1] = l;
  }
  float* ap = ws_acc + (orow * NSPL + split) * HD;
#pragma unroll
  for (int i = 0; i < NS; ++i)
    if (wl + 32 * i < nc) store4(ap + 4 * cc[i], acc[i]);
}

template <typename T, int NS>
cudaError_t split_launch(dim3 grid, int threads, size_t smem, cudaStream_t st,
                         const void* q, const void* k_cache,
                         const void* v_cache, const void* rows,
                         const void* valid_len, float* ws_acc, float* ws_ml,
                         int KVH, int G, int S, int HD, int SP, int HPC,
                         float scale) {
  flash_split_kernel<T, NS><<<grid, threads, smem, st>>>(
      (const T*)q, (const T*)k_cache, (const T*)v_cache, (const int*)rows,
      (const int*)valid_len, ws_acc, ws_ml, KVH, G, S, HD, SP, HPC, scale);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* rows, const void* valid_len, void* ws, void* out,
           int N, int KVH, int G, int S, int HD, int NSPL, int HPC,
           float scale, cudaStream_t st) {
  if (HD % 8 || HD <= 0 || HD > kMaxHd || G <= 0 || S <= 0 || NSPL < 1 ||
      NSPL > kMaxSplits || HPC < 1 || HPC > kMaxHeads)
    return (int)cudaErrorInvalidValue;
  // stage rows: at most a split's keys, at most kStageBytes of K and V
  const int key_bytes = 2 * HD * (int)sizeof(T);
  const int per_max = std::max(8, ((S + NSPL - 1) / NSPL + 7) / 8 * 8);
  const int sp =
      std::min(per_max, std::max(8, kStageBytes / key_bytes / 8 * 8));
  const size_t smem = (size_t)sp * key_bytes;
  const int groups = (G + HPC - 1) / HPC;
  const int rows_out = N * KVH * G;
  float* ws_acc = static_cast<float*>(ws);
  float* ws_ml = ws_acc + (size_t)rows_out * NSPL * HD;
  const dim3 grid(NSPL, N, KVH * groups);
  cudaError_t e = HD > 128
      ? split_launch<T, 2>(grid, 32 * HPC, smem, st, q, k_cache, v_cache,
                           rows, valid_len, ws_acc, ws_ml, KVH, G, S, HD, sp,
                           HPC, scale)
      : split_launch<T, 1>(grid, 32 * HPC, smem, st, q, k_cache, v_cache,
                           rows, valid_len, ws_acc, ws_ml, KVH, G, S, HD, sp,
                           HPC, scale);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_split_combine<T>(ws_acc, ws_ml, out, rows_out, NSPL, HD,
                                      st);
}

}  // namespace

// ws: N*KVH*G*splits*(HD + 2) floats allocated by the caller
extern "C" int flash_decode_launch(const void* q, const void* k_cache,
                                   const void* v_cache, const void* rows,
                                   const void* valid_len, void* ws, void* out,
                                   int N, int KVH, int G, int S, int HD,
                                   int splits, int HPC, float scale,
                                   int dtype, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  DISPATCH_DTYPE(dtype, T,
                 return launch<T>(q, k_cache, v_cache, rows, valid_len, ws,
                                  out, N, KVH, G, S, HD, splits, HPC, scale,
                                  (cudaStream_t)stream));
  return (int)cudaErrorInvalidValue;
}
