// Paged flash-decode: one query token per lane against a block-paged KV
// pool, read in place through the lane's block table, online softmax.
//
// Replaces: the TPU kernel `paged_flash_decode_pallas`
// (repro/kernels/paged_attention.py, bodies `_online_step`, `_kernel`,
// `_kernel_shared`), whose sequential grid axis walked the table.
//
// Bound on this card: bytes. At the main path's shapes (MLA shared page:
// KVH=1, G=16 heads, dk=576, dv=512, BS=8, N <= 8 lanes) each lane reads
// its pages once, about 2*dk operations per byte per head group, and the
// whole call moves well under a megabyte, so at decode the launch and the
// serial walk over the table dominate, not the memory rate.
//
// Design (simple first): one CTA per (lane, kv-head, group of up to 16
// query heads) — at full width one CTA per lane holds all 16 heads, so a
// latent page is read once for all of them. A loop over the lane's table
// entries replaces the TPU's sequential grid axis; the CTA loads its own
// table row and pos. Blocks wholly past pos are skipped: masked keys
// contribute exactly 0 (p = exp(-1e30 - m) = 0, alpha = 1), so the skip
// changes nothing and scratch-padded table tails are never read. Per block:
//   1. the K page (and the V page in the GQA layout) is staged in shared
//      memory as f32, rows padded against bank conflicts; in the
//      shared-page layout V is the first dv features of the staged K page;
//   2. warp w scores key rows w, w+8, ...: its lanes split the dk-long dot
//      products of all heads (each K value read once, reused for every
//      head) and a shuffle reduction finishes each score;
//   3. one thread per head runs the online-softmax update;
//   4. each thread owns output columns tid, tid+256, ... of every head and
//      keeps their running sums in registers.
// dk=576 and dv=512 are not powers of two, so every loop is strided. Keys
// at positions > pos get -1e30 and the output is acc / max(l, 1e-30), as
// in the TPU kernel. With N <= 8 lanes at decode only N CTAs run and most
// of the 132 SMs are idle; splitting the table over CTAs is later work.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;      // query heads per CTA
constexpr int kMaxCols = 4;    // output columns per thread: dv <= 1024

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ pos, T* __restrict__ out, int KVH, int G, int DK,
    int DV, int DVP, int BS, int W, float scale) {
  extern __shared__ float smem[];
  const int lane_id = blockIdx.x;
  const int head = blockIdx.y;
  const int g0 = blockIdx.z * kMaxG;
  const int gn = min(kMaxG, G - g0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, wl = tid % 32;
  const int dkp = DK + 1;                       // padded row stride
  const bool shared_page = (v_pool == nullptr);
  float* qs = smem;                             // kMaxG x dkp
  float* ks = qs + kMaxG * dkp;                 // BS x dkp
  float* vs = ks + BS * dkp;                    // BS x DV (GQA layout only)
  float* sc = vs + (shared_page ? 0 : BS * DV); // kMaxG x BS scores/probs
  float* m = sc + kMaxG * BS;                   // running max
  float* l = m + kMaxG;                         // running sum
  float* alpha = l + kMaxG;                     // rescale of this block

  const int p = pos[lane_id];
  const int* table = tables + (size_t)lane_id * W;
  const T* qp = q + (((size_t)lane_id * KVH + head) * G + g0) * DK;
  for (int i = tid; i < gn * DK; i += kThreads)
    qs[(i / DK) * dkp + i % DK] = to_f32(qp[i]);
  if (tid < kMaxG) {
    m[tid] = -1e30f;
    l[tid] = 0.f;
  }
  float acc[kMaxG][kMaxCols];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) acc[g][j] = 0.f;
  const int n_blocks = min(W, p / BS + 1);

  for (int wb = 0; wb < n_blocks; ++wb) {
    const size_t bid = (size_t)table[wb];
    __syncthreads();  // previous block's readers of ks/vs/sc are done
    const T* kp = k_pool + (bid * BS * KVH + head) * DK;
    for (int i = tid; i < BS * DK; i += kThreads) {
      const int s = i / DK, d = i % DK;
      ks[s * dkp + d] = to_f32(kp[(size_t)s * KVH * DK + d]);
    }
    if (!shared_page) {
      const T* vp = v_pool + (bid * BS * KVH + head) * DVP;
      for (int i = tid; i < BS * DV; i += kThreads) {
        const int s = i / DV, c = i % DV;
        vs[s * DV + c] = to_f32(vp[(size_t)s * KVH * DVP + c]);
      }
    }
    __syncthreads();
    for (int s = warp; s < BS; s += kWarps) {
      float part[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
      const float* kr = ks + s * dkp;
      for (int d = wl; d < DK; d += 32) {
        const float kv = kr[d];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < gn) part[g] += qs[g * dkp + d] * kv;
      }
      const bool live = wb * BS + s <= p;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        float v = part[g];
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (wl == 0 && g < gn) sc[g * BS + s] = live ? v * scale : -1e30f;
      }
    }
    __syncthreads();
    if (tid < gn) {
      const int g = tid;
      const float mp = m[g];
      float mx = mp;
      for (int s = 0; s < BS; ++s) mx = fmaxf(mx, sc[g * BS + s]);
      float sum = 0.f;
      for (int s = 0; s < BS; ++s) {
        const float e = expf(sc[g * BS + s] - mx);
        sc[g * BS + s] = e;
        sum += e;
      }
      const float a = expf(mp - mx);
      l[g] = l[g] * a + sum;
      m[g] = mx;
      alpha[g] = a;
    }
    __syncthreads();
    const float* vsrc = shared_page ? ks : vs;
    const int vstride = shared_page ? dkp : DV;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      const int c = tid + j * kThreads;
      if (c < DV) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < gn) acc[g][j] *= alpha[g];
        for (int s = 0; s < BS; ++s) {
          const float v = vsrc[s * vstride + c];
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < gn) acc[g][j] += sc[g * BS + s] * v;
        }
      }
    }
  }
  __syncthreads();
  T* op = out + (((size_t)lane_id * KVH + head) * G + g0) * DV;
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    const int c = tid + j * kThreads;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (c < DV && g < gn)
        op[(size_t)g * DV + c] = from_f32<T>(acc[g][j] / fmaxf(l[g], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* pos, void* out, int N, int KVH,
           int G, int DK, int DV, int DVP, int BS, int W, float scale,
           cudaStream_t st) {
  if (DV > kMaxCols * kThreads) return (int)cudaErrorInvalidValue;
  const size_t floats = (size_t)(kMaxG + BS) * (DK + 1) +
                        (v_pool ? (size_t)BS * DV : 0) +
                        (size_t)kMaxG * BS + 3 * (size_t)kMaxG;
  const size_t smem = floats * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_flash_decode_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(N, KVH, (G + kMaxG - 1) / kMaxG);
  paged_flash_decode_kernel<T><<<grid, kThreads, smem, st>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool, (const int*)tables,
      (const int*)pos, (T*)out, KVH, G, DK, DV, DVP, BS, W, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_flash_decode_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* pos, void* out, int N, int KVH, int G,
    int DK, int DV, int DVP, int BS, int W, float scale, int dtype,
    void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  DISPATCH_DTYPE(dtype, T,
                 return launch<T>(q, k_pool, v_pool, tables, pos, out, N, KVH,
                                  G, DK, DV, DVP, BS, W, scale,
                                  (cudaStream_t)stream));
  return (int)cudaErrorInvalidValue;
}
