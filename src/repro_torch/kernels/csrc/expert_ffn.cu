// Cached-expert SwiGLU FFN read straight from the device slot buffer:
//   y[n] = sum_k w[n,k] * (silu(x[n] Wg[s]) * (x[n] Wu[s])) Wd[s],
//   s = slot_idx[n,k],  float32 accumulation, output in x's dtype.
//
// Replaces: the TPU kernel `expert_ffn` (repro/kernels/expert_ffn.py, body
// `_kernel`) and the (lane, k) slot gather the reference engine's
// `expert_from_slots` materialises around it (repro/serving/engine.py).
//
// Bound on this card: bytes. Each distinct slot's 3*D*F weights (17.3 MB in
// bf16 at D=2048, F=1408) are read for 6*D*F operations per (lane, k) pair
// that uses it: a few operations per byte, far below the ~295 the tensor
// cores need. So the design aims at bytes: each distinct slot's weights
// are read once per call, with 16-byte loads, and enough CTAs that every
// SM keeps tens of KB in flight. CUDA-core FMAs in f32 keep up.
//
// Sharing a slot: the (lane, k) pairs that name one slot form groups of
// up to kMembers in pair order. Every CTA scans slot_idx (N*k <= 64
// entries) with one warp's ballots; the CTA of a group's first pair (its
// leader) computes for every member, and the CTAs of the other pairs exit
// at once. No host read of slot_idx, no host-side grouping: the call stays
// graph-capturable. A group's members beyond its size get x = 0 and h = 0
// (computed, never stored), so the loops carry no guard.
//
// Design: three launches on the caller's stream, split-K on both products.
//   1. `gate_up_kernel`, grid (F tile, D range, pair): a tile is 32 lanes x
//      16 bytes of a row (256 bf16 columns); each warp takes every 8th row
//      of the D range, kUnroll rows of Wg and of Wu in flight per thread,
//      x of every member staged in shared memory as f32 while the first
//      rows' loads are out. The 8 warps' sums are added in a fixed order
//      and written as f32 partials of g and u per D range.
//   2. `down_kernel`, grid (D tile, F range, pair): with its first rows'
//      loads out, the prologue sums the gate/up partials of its F range
//      over the D ranges in a fixed order, applies silu(g) * u and stages
//      h in shared memory; then the same 16-byte row loads of Wd; f32
//      partials per F range.
//   3. `combine_kernel`: y[n] = sum_k w[n,k] * (sum of the F-range
//      partials), in k order, cast to x's dtype. No atomics anywhere: two
//      calls on the same inputs are bit-identical.
// The tile index runs fastest, so CTAs that run together read neighbouring
// pieces of the same rows. Tile and range sizes come from the wrapper's
// plan (`ffn_plan` in expert_ffn.py): at least 4x the SM count of CTAs,
// in whole waves of two CTAs per SM where it can.
// What holds it (measured on an H100, PERF.md): the down kernel streams
// Wd at about three quarters of the memory rate, the gate/up kernel at
// 83-88%; twice the rows in flight, a third CTA per SM and an L2 256-byte
// prefetch hint on the loads gained nothing.
#include <math.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;       // rows in flight per thread
constexpr int kMembers = 4;      // pairs computed together by one CTA
constexpr int kMaxPairs = 64;    // N*k: two ballots of 32

// 16 bytes of weights as floats: 4 f32 or 8 bf16.
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[4]) {
  v[0] = __uint_as_float(r.x);
  v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z);
  v[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack(const uint4& r, float (&v)[8]) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {        // bf16 -> f32 is a 16-bit shift
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));   // streamed once
}

// Run by every thread of the CTA. Finds the group of pair p among the
// pairs that name its slot (in pair order, groups of kMembers): returns its
// size when p leads it, with the members' pair ids in mem[], else 0.
__device__ int find_group(const int* __restrict__ slot_idx, int P, int p,
                          int* mem, int* nm_s) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int s = slot_idx[p];
    int before = 0, rank = 0;
    unsigned bits[kMaxPairs / 32];
#pragma unroll
    for (int c = 0; c < kMaxPairs / 32; ++c) {
      const int q = 32 * c + lane;
      bits[c] = __ballot_sync(0xffffffffu, q < P && slot_idx[q] == s);
      if (p >= 32 * c && p < 32 * c + 32)
        rank = before + __popc(bits[c] & ((1u << (p - 32 * c)) - 1u));
      before += __popc(bits[c]);
    }
    const bool leader = rank % kMembers == 0;
    int seen = 0;
#pragma unroll
    for (int c = 0; c < kMaxPairs / 32; ++c) {
      const int r = seen + __popc(bits[c] & ((1u << lane) - 1u));
      if (leader && (bits[c] >> lane & 1u) && r >= rank &&
          r < rank + kMembers)
        mem[r - rank] = 32 * c + lane;
      seen += __popc(bits[c]);
    }
    if (lane == 0) *nm_s = leader ? min(kMembers, before - rank) : 0;
  }
  __syncthreads();
  return *nm_s;
}

// Partials of g and u: ws_g/ws_u [d range][pair][F].
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) gate_up_kernel(
    const T* __restrict__ x, const int* __restrict__ slot_idx,
    const T* __restrict__ wg, const T* __restrict__ wu,
    float* __restrict__ ws_g, float* __restrict__ ws_u, int P, int K, int D,
    int F, int DR) {
  constexpr int V = 16 / sizeof(T);   // weights per 16-byte load
  constexpr int TW = 32 * V;                   // tile columns
  extern __shared__ __align__(16) float smem[];
  __shared__ int mem[kMembers], nm_s;
  const int p = blockIdx.z;
  const int nm = find_group(slot_idx, P, p, mem, &nm_s);
  if (nm == 0) return;                         // another pair leads
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d0 = blockIdx.y * DR;
  const int d1 = min(d0 + DR, D);
  const int rows = (d1 - d0 + kWarps * kUnroll - 1) / (kWarps * kUnroll) *
                   (kWarps * kUnroll);         // padded: x is 0 past d1
  const size_t s = (size_t)slot_idx[p];
  const int c0 = blockIdx.x * TW + lane * V;
  const int c = min(c0, F - V);                // a lane past F loads F-V..
  const T* gp = wg + s * D * F + c;
  const T* up = wu + s * D * F + c;
  // the first rows' loads go out before x is staged
  uint4 a[kUnroll], b[kUnroll];
#pragma unroll
  for (int i = 0; i < kUnroll; ++i) {
    const size_t d = min(d0 + warp + kWarps * i, D - 1);
    a[i] = load16(gp + d * F);
    b[i] = load16(up + d * F);
  }
  // x of every member over the D range, [row][member], f32
  float* xs = smem;
  for (int i = threadIdx.x; i < rows * kMembers; i += kThreads) {
    const int m = i / rows, r = i - m * rows;  // a warp reads a run of x
    xs[r * kMembers + m] = m < nm && d0 + r < d1
                               ? to_f32(x[(size_t)(mem[m] / K) * D + d0 + r])
                               : 0.f;
  }
  __syncthreads();
  float g[kMembers][V], u[kMembers][V];
#pragma unroll
  for (int m = 0; m < kMembers; ++m)
#pragma unroll
    for (int e = 0; e < V; ++e) g[m][e] = u[m][e] = 0.f;
  for (int r0 = warp; r0 < rows; r0 += kWarps * kUnroll) {
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const float4 xm =
          *reinterpret_cast<const float4*>(xs + (r0 + kWarps * i) * kMembers);
      const float xv[kMembers] = {xm.x, xm.y, xm.z, xm.w};
      float fg[V], fu[V];
      unpack(a[i], fg);
      unpack(b[i], fu);
#pragma unroll
      for (int m = 0; m < kMembers; ++m)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          g[m][e] += xv[m] * fg[e];
          u[m][e] += xv[m] * fu[e];
        }
    }
    if (r0 + kWarps * kUnroll < rows) {        // the next rows' loads
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        const size_t d = min(d0 + r0 + kWarps * (kUnroll + i), D - 1);
        a[i] = load16(gp + d * F);
        b[i] = load16(up + d * F);
      }
    }
  }
  // the 8 warps' sums, added in warp order: g first, then u
  float* red = smem;                           // [warp][member][TW]
  for (int pass = 0; pass < 2; ++pass) {
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kMembers; ++m)
#pragma unroll
      for (int e = 0; e < V; ++e)
        red[(warp * kMembers + m) * TW + lane * V + e] =
            pass == 0 ? g[m][e] : u[m][e];
    __syncthreads();
    float* out = pass == 0 ? ws_g : ws_u;
    for (int i = threadIdx.x; i < kMembers * TW; i += kThreads) {
      const int m = i / TW, col = i - m * TW;
      const int f = blockIdx.x * TW + col;
      if (m >= nm || f >= F) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        sum += red[(w * kMembers + m) * TW + col];
      out[((size_t)blockIdx.y * P + mem[m]) * F + f] = sum;
    }
  }
}

// Partials of y per F range: ws_y [f range][pair][D].
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) down_kernel(
    const float* __restrict__ ws_g, const float* __restrict__ ws_u,
    const int* __restrict__ slot_idx, const T* __restrict__ wd,
    float* __restrict__ ws_y, int P, int D, int F, int FR, int RD) {
  constexpr int V = 16 / sizeof(T);   // weights per 16-byte load
  constexpr int TW = 32 * V;
  extern __shared__ __align__(16) float smem[];
  __shared__ int mem[kMembers], nm_s;
  const int p = blockIdx.z;
  const int nm = find_group(slot_idx, P, p, mem, &nm_s);
  if (nm == 0) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f0 = blockIdx.y * FR;
  const int f1 = min(f0 + FR, F);
  const int rows = (f1 - f0 + kWarps * kUnroll - 1) / (kWarps * kUnroll) *
                   (kWarps * kUnroll);
  const size_t s = (size_t)slot_idx[p];
  const int c = min(blockIdx.x * TW + lane * V, D - V);
  const T* dp = wd + s * F * D + c;
  // the first rows' loads go out before h is computed
  uint4 a[kUnroll];
#pragma unroll
  for (int i = 0; i < kUnroll; ++i)
    a[i] = load16(dp + (size_t)min(f0 + warp + kWarps * i, F - 1) * D);
  // h = silu(g) * u over the F range, the D-range partials summed in order
  float* hs = smem;                            // [row][member]
  const size_t plane = (size_t)P * F;
  for (int i = threadIdx.x; i < rows * kMembers; i += kThreads) {
    const int m = i / rows, r = i - m * rows;  // a warp reads runs of F
    float h = 0.f;
    if (m < nm && f0 + r < f1) {
      const size_t off = (size_t)mem[m] * F + f0 + r;
      float gs = 0.f, us = 0.f;
#pragma unroll 4
      for (int k = 0; k < RD; ++k) {
        gs += ws_g[k * plane + off];
        us += ws_u[k * plane + off];
      }
      h = gs / (1.f + expf(-gs)) * us;
    }
    hs[r * kMembers + m] = h;
  }
  __syncthreads();
  float y[kMembers][V];
#pragma unroll
  for (int m = 0; m < kMembers; ++m)
#pragma unroll
    for (int e = 0; e < V; ++e) y[m][e] = 0.f;
  for (int r0 = warp; r0 < rows; r0 += kWarps * kUnroll) {
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const float4 hm =
          *reinterpret_cast<const float4*>(hs + (r0 + kWarps * i) * kMembers);
      const float hv[kMembers] = {hm.x, hm.y, hm.z, hm.w};
      float fw[V];
      unpack(a[i], fw);
#pragma unroll
      for (int m = 0; m < kMembers; ++m)
#pragma unroll
        for (int e = 0; e < V; ++e) y[m][e] += hv[m] * fw[e];
    }
    if (r0 + kWarps * kUnroll < rows) {        // the next rows' loads
#pragma unroll
      for (int i = 0; i < kUnroll; ++i)
        a[i] = load16(dp + (size_t)min(f0 + r0 + kWarps * (kUnroll + i),
                                       F - 1) * D);
    }
  }
  __syncthreads();                             // hs is read by every warp
  float* red = smem;
#pragma unroll
  for (int m = 0; m < kMembers; ++m)
#pragma unroll
    for (int e = 0; e < V; ++e)
      red[(warp * kMembers + m) * TW + lane * V + e] = y[m][e];
  __syncthreads();
  for (int i = threadIdx.x; i < kMembers * TW; i += kThreads) {
    const int m = i / TW, col = i - m * TW;
    const int d = blockIdx.x * TW + col;
    if (m >= nm || d >= D) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      sum += red[(w * kMembers + m) * TW + col];
    ws_y[((size_t)blockIdx.y * P + mem[m]) * D + d] = sum;
  }
}

template <typename T>
__global__ void combine_kernel(const float* __restrict__ ws_y,
                               const float* __restrict__ weights,
                               T* __restrict__ out, int N, int K, int D,
                               int RF) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)N * D) return;
  const int n = (int)(i / D);
  const int d = (int)(i % D);
  const size_t plane = (size_t)N * K * D;
  float y = 0.f;
  for (int j = 0; j < K; ++j) {                // k order, then F ranges
    const float* yp = ws_y + ((size_t)n * K + j) * D + d;
    float yk = 0.f;
    for (int r = 0; r < RF; ++r) yk += yp[r * plane];
    y += weights[n * K + j] * yk;
  }
  out[i] = from_f32<T>(y);
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T>
int launch(const void* x, const void* weights, const void* slot_idx,
           const void* wg, const void* wu, const void* wd, void* ws,
           void* out, int N, int K, int D, int F, int DR, int FR,
           cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);   // weights per 16-byte load
  constexpr int TW = 32 * V;
  const int P = N * K;
  if (P > kMaxPairs || D % V || F % V || DR < 1 || FR < 1)
    return (int)cudaErrorInvalidValue;
  const int RD = (D + DR - 1) / DR, RF = (F + FR - 1) / FR;
  float* ws_g = static_cast<float*>(ws);               // RD x P x F
  float* ws_u = ws_g + (size_t)RD * P * F;             // RD x P x F
  float* ws_y = ws_u + (size_t)RD * P * F;             // RF x P x D
  const int pad = kWarps * kUnroll;
  const size_t red = (size_t)kWarps * kMembers * TW * sizeof(float);
  const size_t smem_gu = std::max(
      red, (size_t)(DR + pad) * kMembers * sizeof(float));
  const size_t smem_dn = std::max(
      red, (size_t)(FR + pad) * kMembers * sizeof(float));
  cudaError_t e = set_smem((const void*)gate_up_kernel<T>, smem_gu);
  if (e != cudaSuccess) return (int)e;
  e = set_smem((const void*)down_kernel<T>, smem_dn);
  if (e != cudaSuccess) return (int)e;
  gate_up_kernel<T><<<dim3((F + TW - 1) / TW, RD, P), kThreads, smem_gu,
                      st>>>((const T*)x, (const int*)slot_idx, (const T*)wg,
                            (const T*)wu, ws_g, ws_u, P, K, D, F, DR);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  down_kernel<T><<<dim3((D + TW - 1) / TW, RF, P), kThreads, smem_dn, st>>>(
      ws_g, ws_u, (const int*)slot_idx, (const T*)wd, ws_y, P, D, F, FR, RD);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)N * D;
  combine_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      ws_y, (const float*)weights, (T*)out, N, K, D, RF);
  return (int)cudaGetLastError();
}

}  // namespace

// ws: (2 * ceil(D / DR) * F + ceil(F / FR) * D) * N * K floats allocated by
// the caller; DR and FR: rows per D range and per F range
extern "C" int expert_ffn_launch(const void* x, const void* weights,
                                 const void* slot_idx, const void* wg,
                                 const void* wu, const void* wd, void* ws,
                                 void* out, int N, int K, int D, int F,
                                 int DR, int FR, int dtype, void* stream) {
  if (N <= 0 || K <= 0) return (int)cudaSuccess;
  DISPATCH_DTYPE(dtype, T,
                 return launch<T>(x, weights, slot_idx, wg, wu, wd, ws, out,
                                  N, K, D, F, DR, FR, (cudaStream_t)stream));
  return (int)cudaErrorInvalidValue;
}
