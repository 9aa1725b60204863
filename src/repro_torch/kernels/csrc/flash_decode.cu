// Flash-decode: one query token per lane against that lane's contiguous KV
// row, keys at positions >= valid_len masked, online softmax over tiles.
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
// latency, not the memory rate, decides its time.
//
// Design (simple first): one CTA per (lane, kv head, group of up to 16
// query heads), so each K/V tile is read once for all G heads. With 4
// lanes and 8 kv heads that is 32 CTAs on 132 SMs; splitting the keys over
// CTAs (split-K with a combine pass) is later work. A loop inside the CTA
// replaces the TPU's sequential grid axis, and it stops at valid_len: the
// chunked ring holds 8192 slots while at most `pos % chunk + 1` are live,
// and a fully masked tile would contribute exactly 0 (p = 0, alpha = 1).
// Per tile of 32 keys:
//   1. K and V are staged in shared memory as f32 (K rows padded against
//      bank conflicts); slots past S are zero and masked;
//   2. warp w scores keys w, w+8, ...: its lanes split each hd-long dot
//      product for all heads (each K value read once for every head) and a
//      shuffle reduction finishes each score; keys >= valid_len get -1e30;
//   3. one thread per head runs the online-softmax update;
//   4. thread t owns output column t % hd for the keys of part t / hd (with
//      hd=128, two parts of 16 keys each), keeping one running sum per head
//      in registers; the parts are summed in a fixed order at the end.
// The output is acc / max(l, 1e-30) in q's dtype, as in the TPU kernel.
// Every caller has valid_len >= 1 (the token being decoded is always
// live); with valid_len 0 the kernel writes zeros.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;      // query heads per CTA
constexpr int kTile = 32;      // keys per tile
constexpr int kMaxHd = 256;    // one output column per thread and part

__host__ __device__ inline int stage_floats(int hd) {
  const int parts = kThreads / hd;
  const int tiles = kTile * (2 * hd + 1);
  const int reduce = parts * kMaxG * hd;
  return tiles > reduce ? tiles : reduce;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const int* __restrict__ rows,
    const int* __restrict__ valid_len, T* __restrict__ out, int KVH, int G,
    int S, int HD, float scale) {
  extern __shared__ float smem[];
  const int lane_id = blockIdx.x;
  const int head = blockIdx.y;
  const int g0 = blockIdx.z * kMaxG;
  const int gn = min(kMaxG, G - g0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, wl = tid % 32;
  const int hdp = HD + 1;                       // padded K row stride
  const int parts = kThreads / HD;
  const int part = tid / HD, col = tid % HD;
  const bool active = part < parts;
  float* qs = smem;                             // kMaxG x hdp
  float* stage = qs + kMaxG * hdp;              // K/V tiles, then partials
  float* ks = stage;                            // kTile x hdp
  float* vs = ks + kTile * hdp;                 // kTile x HD
  float* sc = stage + stage_floats(HD);         // kMaxG x kTile scores/probs
  float* m = sc + kMaxG * kTile;                // running max
  float* l = m + kMaxG;                         // running sum
  float* alpha = l + kMaxG;                     // rescale of this tile

  const size_t row = (size_t)rows[lane_id];
  const int vl = min(valid_len[lane_id], S);
  const size_t qoff = ((size_t)lane_id * KVH * G + (size_t)head * G + g0) * HD;
  for (int i = tid; i < gn * HD; i += kThreads)
    qs[(i / HD) * hdp + i % HD] = to_f32(q[qoff + i]);
  if (tid < kMaxG) {
    m[tid] = -1e30f;
    l[tid] = 0.f;
  }
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
  const size_t key_stride = (size_t)KVH * HD;

  for (int t0 = 0; t0 < vl; t0 += kTile) {
    const int nt = min(kTile, S - t0);
    __syncthreads();  // previous tile's readers of ks/vs/sc are done
    const size_t base = ((row * S + t0) * KVH + head) * HD;
    for (int i = tid; i < kTile * HD; i += kThreads) {
      const int s = i / HD, d = i % HD;
      float kx = 0.f, vx = 0.f;
      if (s < nt) {
        kx = to_f32(k_cache[base + s * key_stride + d]);
        vx = to_f32(v_cache[base + s * key_stride + d]);
      }
      ks[s * hdp + d] = kx;
      vs[s * HD + d] = vx;
    }
    __syncthreads();
    for (int s = warp; s < kTile; s += kWarps) {
      float dot[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) dot[g] = 0.f;
      const float* kr = ks + s * hdp;
      for (int d = wl; d < HD; d += 32) {
        const float kx = kr[d];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < gn) dot[g] += qs[g * hdp + d] * kx;
      }
      const bool live = t0 + s < vl;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        float v = dot[g];
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (wl == 0 && g < gn) sc[g * kTile + s] = live ? v * scale : -1e30f;
      }
    }
    __syncthreads();
    if (tid < gn) {
      const int g = tid;
      const float mp = m[g];
      float mx = mp;
      for (int s = 0; s < kTile; ++s) mx = fmaxf(mx, sc[g * kTile + s]);
      float sum = 0.f;
      for (int s = 0; s < kTile; ++s) {
        const float e = expf(sc[g * kTile + s] - mx);
        sc[g * kTile + s] = e;
        sum += e;
      }
      const float a = expf(mp - mx);
      l[g] = l[g] * a + sum;
      m[g] = mx;
      alpha[g] = a;
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < gn) acc[g] *= alpha[g];
      for (int s = part; s < kTile; s += parts) {
        const float v = vs[s * HD + col];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < gn) acc[g] += sc[g * kTile + s] * v;
      }
    }
  }
  __syncthreads();  // the staging area now holds the per-part partials
  if (active) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < gn) stage[(part * kMaxG + g) * HD + col] = acc[g];
  }
  __syncthreads();
  for (int i = tid; i < gn * HD; i += kThreads) {
    const int g = i / HD, c = i % HD;
    float sum = 0.f;
    for (int p = 0; p < parts; ++p) sum += stage[(p * kMaxG + g) * HD + c];
    out[qoff + i] = from_f32<T>(sum / fmaxf(l[g], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* rows, const void* valid_len, void* out, int N,
           int KVH, int G, int S, int HD, float scale, cudaStream_t st) {
  if (HD <= 0 || HD > kMaxHd || G <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t floats = (size_t)kMaxG * (HD + 1) + stage_floats(HD) +
                        (size_t)kMaxG * kTile + 3 * (size_t)kMaxG;
  const size_t smem = floats * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(N, KVH, (G + kMaxG - 1) / kMaxG);
  flash_decode_kernel<T><<<grid, kThreads, smem, st>>>(
      (const T*)q, (const T*)k_cache, (const T*)v_cache, (const int*)rows,
      (const int*)valid_len, (T*)out, KVH, G, S, HD, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_decode_launch(const void* q, const void* k_cache,
                                   const void* v_cache, const void* rows,
                                   const void* valid_len, void* out, int N,
                                   int KVH, int G, int S, int HD, float scale,
                                   int dtype, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  DISPATCH_DTYPE(dtype, T,
                 return launch<T>(q, k_cache, v_cache, rows, valid_len, out,
                                  N, KVH, G, S, HD, scale,
                                  (cudaStream_t)stream));
  return (int)cudaErrorInvalidValue;
}
