// Paged flash-decode: one query token per lane against a block-paged KV
// pool, read in place through the lane's block table, online softmax.
//
// Replaces: the TPU kernel `paged_flash_decode_pallas`
// (repro/kernels/paged_attention.py, bodies `_online_step`, `_kernel`,
// `_kernel_shared`), whose sequential grid axis walked the table.
//
// Bound on this card: bytes, as chip_smoke.py counts them — the live
// pages of every lane read once (BS x KVH x (dk [+ dv in the GQA layout])
// elements each), q, the tables and pos read once, the output written
// once. At the main path's shapes that is 0.35-1.5 MB, 0.1-0.46 us at
// 3.35 TB/s; the operations (2 x (dk + dv) per live key and head) take
// less at the tensor-core rate. So a call is bound by
// latency: launches, dependent loads (pos -> table -> page) and the
// chain of work inside one CTA. The design spreads that chain over the SMs.
//
// Design: split-K ("flash-decoding") in two kernels, so one call of
// `paged_flash_decode_launch` is two CUDA launches.
//   1. `paged_split_kernel`, grid (split, lane, kv head x head group). The
//      wrapper's split plan (`split_plan` in paged_attention.py) gives each
//      split a contiguous range of `PPS` table entries and each CTA up to 8
//      query heads, one warp per head, so that about twice the SM count of
//      CTAs run. A CTA whose range starts past the lane's last live page
//      (pos / BS) writes an empty partial (m = -1e30, l = 0) and reads no
//      page; the others stage the live pages of their range in shared
//      memory with 16-byte cp.async copies (K rows, and V rows in the GQA
//      layout; in the MLA shared-page layout V is the first dv features of
//      the staged K row). Each warp keeps its head's q in registers (lane i
//      owns the 4-element chunks i, i+32, ... of dk), scores 8 keys at a
//      time with a shuffle reduction that leaves every score in every lane,
//      runs the online softmax in registers (no thread per head, no
//      barrier), and accumulates its dv-long output row (lane i owns the
//      4-column chunks i, i+32, ...: all 32 lanes busy at dv = 128). Keys
//      past pos are masked and pages wholly past pos are never read, so
//      scratch-padded table tails stay harmless. It writes the partial
//      (m, l, acc[dv]) in f32 to the wrapper's workspace.
//   2. `split_combine_kernel` (split_k.cuh, shared with flash_decode.cu),
//      one thread per (lane, kv head, head, 4 output columns): merges the
//      live splits in a fixed order and writes acc / max(l, 1e-30) in q's
//      dtype. Fixed orders everywhere and no atomics make two calls on the
//      same inputs bit-identical.
// What held the time, measured on an H100: a CTA's work is a chain of
// dependent latencies, not bytes. Runtime guards inside the unrolled key
// and chunk loops put every shared-memory load behind a branch, one after
// another; the loops below carry none (template NS, clamped indices), which
// took about two fifths off the split kernel (PERF.md).
// Tensor cores are not used: per CTA the product is at most 8 heads x 8
// keys per page, far below an mma tile's worth of work; the time is latency.
#include <math.h>

#include <algorithm>

#include "common.cuh"
#include "split_k.cuh"

namespace {

constexpr int kMaxHeads = 8;     // query heads (warps) per CTA
constexpr int kMaxChunks = 8;    // 4-element chunks per lane: dk, dv <= 1024
constexpr int kKeys = 8;         // keys scored together
constexpr int kMaxSplits = 32;   // bounds the workspace
constexpr int kStageBytes = 64 * 1024;
constexpr float kNeg = -1e30f;

// Copy `pieces` 16-byte pieces of one row, the warp's lanes side by side.
__device__ __forceinline__ void stage_row(void* dst, const void* src,
                                          int pieces, int wl) {
  for (int c = wl; c < pieces; c += 32)
    cp_async16(static_cast<char*>(dst) + 16 * c,
               static_cast<const char*>(src) + 16 * c);
}

// NS: 4-element chunks per lane, ceil(max(dk, dv) / 128). The hot loops
// carry no runtime guard, so the compiler issues all of a key group's
// shared-memory loads together: a lane's chunk index is clamped to the
// row (its q slot is 0 past dk, its acc slot is not stored past dv), and a
// key index past the live rows is clamped to the last live row (its score
// is masked, so its weight is exactly 0).
template <typename T, int NS>
__global__ void __launch_bounds__(32 * kMaxHeads) paged_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ pos, float* __restrict__ ws_acc,
    float* __restrict__ ws_ml, int KVH, int G, int DK, int DV, int DVP,
    int BS, int W, int PPS, int SP, int HPC, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kVec = 16 / sizeof(T);         // elements per 16-byte piece
  const int split = blockIdx.x, S = gridDim.x;
  const int lane_id = blockIdx.y;
  const int groups = gridDim.z / KVH;
  const int head = blockIdx.z / groups;
  const int g0 = (blockIdx.z % groups) * HPC;
  const int gn = min(HPC, G - g0);
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const bool gqa = v_pool != nullptr;
  const bool has_head = warp < gn;
  const int g = g0 + warp;
  const size_t row = ((size_t)lane_id * KVH + head) * G + g;  // output row
  float* ml = ws_ml + (row * S + split) * 2;

  // pos, the range's first table entry and q are loaded side by side
  const int p = pos[lane_id];
  const int p0 = split * PPS;                  // < W by the split plan
  const int* table = tables + (size_t)lane_id * W + p0;
  const int bid0 = table[0];
  const int nq = DK / 4, nv = DV / 4;          // 4-element chunks per row
  int cq[NS], cv[NS];                          // this lane's chunks, clamped
  float qr[NS][4];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    cq[i] = min(wl + 32 * i, nq - 1);
    cv[i] = min(wl + 32 * i, nv - 1);
  }
  if (has_head) {
    const T* qp = q + row * DK;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      load4(qp + 4 * cq[i], qr[i]);
      if (wl + 32 * i >= nq)
#pragma unroll
        for (int e = 0; e < 4; ++e) qr[i][e] = 0.f;
    }
  }
  const int n_pages = min(min(p0 + PPS, W), p / BS + 1) - p0;
  if (n_pages <= 0) {   // the whole CTA: its range holds no live key
    if (has_head && wl == 0) {
      ml[0] = kNeg;
      ml[1] = 0.f;
    }
    return;
  }
  float acc[NS][4];
#pragma unroll
  for (int i = 0; i < NS; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m = kNeg, l = 0.f;

  const int dvs = (DV + kVec - 1) / kVec * kVec;   // staged V row length
  T* ks = reinterpret_cast<T*>(smem);              // SP*BS rows of DK
  T* vs = ks + (size_t)SP * BS * DK;               // SP*BS rows of dvs
  const T* vbase = gqa ? vs : ks;
  const int vstride = gqa ? dvs : DK;
  for (int st = 0; st < n_pages; st += SP) {
    const int cnt = min(SP, n_pages - st);
    if (st > 0) __syncthreads();   // the previous stage's readers are done
    for (int r = warp; r < cnt * BS; r += nwarps) {
      const int j = r / BS, s = r - j * BS;
      const int bid = st + j == 0 ? bid0 : table[st + j];
      const size_t krow = ((size_t)bid * BS + s) * KVH + head;
      stage_row(ks + (size_t)r * DK, k_pool + krow * DK, DK / kVec, wl);
      if (gqa)
        stage_row(vs + (size_t)r * dvs, v_pool + krow * DVP, dvs / kVec, wl);
    }
    cp_async_wait_all();
    __syncthreads();
    // rows of this stage at positions <= pos (at least one)
    const int live = min(cnt * BS, p + 1 - (p0 + st) * BS);
    if (has_head) {
      for (int r0 = 0; r0 < live; r0 += kKeys) {
        float sc[kKeys];
#pragma unroll
        for (int k = 0; k < kKeys; ++k) {
          const T* kr = ks + (size_t)min(r0 + k, live - 1) * DK;
          sc[k] = 0.f;
#pragma unroll
          for (int i = 0; i < NS; ++i) {
            float kv[4];
            load4(kr + 4 * cq[i], kv);
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
          sc[k] = r0 + k < live ? sc[k] * scale : kNeg;
          mx = fmaxf(mx, sc[k]);
        }
        const float alpha = expf(m - mx);
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < kKeys; ++k) {
          sc[k] = expf(sc[k] - mx);        // exactly 0 for a masked key
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
          const T* vr = vbase + (size_t)min(r0 + k, live - 1) * vstride;
#pragma unroll
          for (int i = 0; i < NS; ++i) {
            float vv[4];
            load4(vr + 4 * cv[i], vv);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][e] += sc[k] * vv[e];
          }
        }
      }
    }
  }
  if (!has_head) return;
  if (wl == 0) {
    ml[0] = m;
    ml[1] = l;
  }
  float* ap = ws_acc + (row * S + split) * DV;
#pragma unroll
  for (int i = 0; i < NS; ++i)
    if (wl + 32 * i < nv) store4(ap + 4 * cv[i], acc[i]);
}

template <typename T, int NS>
cudaError_t split_launch(dim3 grid, int threads, size_t smem, cudaStream_t st,
                         const void* q, const void* k_pool, const void* v_pool,
                         const void* tables, const void* pos, float* ws_acc,
                         float* ws_ml, int KVH, int G, int DK, int DV, int DVP,
                         int BS, int W, int PPS, int SP, int HPC,
                         float scale) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel<T, NS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  paged_split_kernel<T, NS><<<grid, threads, smem, st>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool, (const int*)tables,
      (const int*)pos, ws_acc, ws_ml, KVH, G, DK, DV, DVP, BS, W, PPS, SP,
      HPC, scale);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* pos, void* ws, void* out, int N,
           int KVH, int G, int DK, int DV, int DVP, int BS, int W, int S,
           int PPS, int HPC, float scale, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const bool gqa = v_pool != nullptr;
  if (DK % kVec || DK > 4 * 32 * kMaxChunks || DV % 4 ||
      DV > 4 * 32 * kMaxChunks || DV > DVP || (gqa && DVP % kVec) ||
      S < 1 || S > kMaxSplits || PPS < 1 || (size_t)S * PPS < (size_t)W ||
      HPC < 1 || HPC > kMaxHeads || BS < 1)
    return (int)cudaErrorInvalidValue;
  const int dvs = (DV + kVec - 1) / kVec * kVec;
  const size_t page = (size_t)BS * (DK + (gqa ? dvs : 0)) * sizeof(T);
  const int sp = page >= (size_t)kStageBytes
                     ? 1
                     : std::min(PPS, (int)(kStageBytes / page));
  const size_t smem = (size_t)sp * page;
  const int groups = (G + HPC - 1) / HPC;
  const int rows = N * KVH * G;
  float* ws_acc = static_cast<float*>(ws);
  float* ws_ml = ws_acc + (size_t)rows * S * DV;
  const dim3 grid(S, N, KVH * groups);
  const int ns = (std::max(DK, DV) + 127) / 128;
  cudaError_t e = cudaSuccess;
  switch (ns) {
#define SPLIT_CASE(NS)                                                       \
  case NS:                                                                   \
    e = split_launch<T, NS>(grid, 32 * HPC, smem, st, q, k_pool, v_pool,    \
                            tables, pos, ws_acc, ws_ml, KVH, G, DK, DV, DVP, \
                            BS, W, PPS, sp, HPC, scale);                     \
    break;
    SPLIT_CASE(1) SPLIT_CASE(2) SPLIT_CASE(3) SPLIT_CASE(4)
    SPLIT_CASE(5) SPLIT_CASE(6) SPLIT_CASE(7) SPLIT_CASE(8)
#undef SPLIT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)launch_split_combine<T>(ws_acc, ws_ml, out, rows, S, DV, st);
}

}  // namespace

extern "C" int paged_flash_decode_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* pos, void* ws, void* out, int N, int KVH,
    int G, int DK, int DV, int DVP, int BS, int W, int S, int PPS, int HPC,
    float scale, int dtype, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  DISPATCH_DTYPE(dtype, T,
                 return launch<T>(q, k_pool, v_pool, tables, pos, ws, out, N,
                                  KVH, G, DK, DV, DVP, BS, W, S, PPS, HPC,
                                  scale, (cudaStream_t)stream));
  return (int)cudaErrorInvalidValue;
}
