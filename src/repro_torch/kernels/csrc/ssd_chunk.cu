// Mamba-2 SSD within-chunk term: for each chunk g and head h,
//   y[g,h] = ((C[g] B[g]^T) * tril(exp(a_cum[g,h,l] - a_cum[g,h,s]))) xdt[g,h]
// with C, B (G, L, N) shared across heads, xdt (G, H, L, P), a_cum (G, H, L)
// float32, and the output (G, H, L, P) in xdt's dtype.
//
// Replaces: the TPU kernel `ssd_chunk` (repro/kernels/ssd_chunk.py, body
// `_kernel`), whose grid (G, H) formed C B^T again for every head.
//
// Bound on this card: bytes, with operations close behind. For mamba2-130m's
// prefill of 4 prompts of 4,000 tokens (G = 128 chunks, H = 24, L = 128,
// N = 128, P = 64, float32) the function must read C, B, xdt and a_cum and
// write the output once, about 219 MB, or 0.066 ms at 3.35 TB/s; the work
// it needs (C B^T once per chunk, the masked products over the lower
// triangle only) is about 3.5 GFLOP, or 0.053 ms at 67 TFLOP/s of float32
// FMA. That is about 16 operations per byte: the xdt tile read and the
// output written once per head dominate.
//
// Design (simple first: FP32 FMA from shared memory, no tensor cores):
// one CTA per (chunk, group of heads), 256 threads as 16 x 16. The group is
// all H heads when the chunks alone fill the card (the wrapper decides), so
// C B^T is formed once per chunk and reused for every head.
//   1. C B^T: C and B are staged k-major in shared memory, 32 columns of N
//      at a time (rows padded to L+1 floats against bank conflicts). Thread
//      (ty, tx) keeps rows ty*R..ty*R+R-1 and columns tx, tx+16, ... of the
//      L x L scores in registers (R = L/16), for the whole CTA's life.
//   2. per head: a_cum and xdt are staged; each thread writes its scores
//      times the decay into the shared L x L matrix M, computing the exp
//      only where s <= l. Above the diagonal a_cum[l] - a_cum[s] is
//      positive and grows with the chunk, so exp could overflow there and
//      inf * 0 would be NaN: those entries are written as 0 directly.
//   3. y = M xdt: thread (ty, tx) owns rows ty*R.. and columns tx, tx+16,
//      ... of the L x P output and stops its s loop after its last row
//      (M is 0 beyond it), so only the lower triangle is multiplied.
// The padded rows of the last chunk (dt = 0, so xdt = 0 and a flat a_cum)
// need no mask of their own. Results are deterministic: every sum runs in
// a fixed order, without atomics.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kSide = 16;
constexpr int kNc = 32;        // columns of N staged per step
constexpr int kMaxR = 8;       // rows (and score columns) per thread: L <= 128
constexpr int kMaxC = 4;       // output columns per thread: P <= 64

__host__ __device__ inline int m_floats(int L) {
  const int lp = L + 1;
  const int stage = 2 * kNc * lp;
  return L * lp > stage ? L * lp : stage;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssd_chunk_kernel(
    const T* __restrict__ c, const T* __restrict__ b,
    const T* __restrict__ xdt, const float* __restrict__ a_cum,
    T* __restrict__ out, int H, int L, int N, int P, int HG) {
  extern __shared__ float smem[];
  const int g = blockIdx.x;
  const int h0 = blockIdx.y * HG;
  const int h1 = min(H, h0 + HG);
  const int tid = threadIdx.x;
  const int ty = tid / kSide, tx = tid % kSide;
  const int R = L / kSide;
  const int CP = (P + kSide - 1) / kSide;
  const int lp = L + 1;
  float* ms = smem;                 // L x lp decayed scores M
  float* cs = smem;                 // kNc x lp, k-major (aliases ms)
  float* bs = smem + kNc * lp;      // kNc x lp, k-major (aliases ms)
  float* xs = smem + m_floats(L);   // L x P
  float* as = xs + L * P;           // L

  // 1. scores S = C B^T, kept in registers
  float sacc[kMaxR][kMaxR];
#pragma unroll
  for (int i = 0; i < kMaxR; ++i)
#pragma unroll
    for (int j = 0; j < kMaxR; ++j) sacc[i][j] = 0.f;
  const T* cg = c + (size_t)g * L * N;
  const T* bg = b + (size_t)g * L * N;
  for (int k0 = 0; k0 < N; k0 += kNc) {
    __syncthreads();  // previous step's readers of cs/bs are done
    for (int i = tid; i < L * kNc; i += kThreads) {
      const int r = i / kNc, k = i % kNc;
      float cv = 0.f, bv = 0.f;
      if (k0 + k < N) {
        cv = to_f32(cg[(size_t)r * N + k0 + k]);
        bv = to_f32(bg[(size_t)r * N + k0 + k]);
      }
      cs[k * lp + r] = cv;
      bs[k * lp + r] = bv;
    }
    __syncthreads();
    const int kn = min(kNc, N - k0);
    for (int k = 0; k < kn; ++k) {
      float cr[kMaxR], br[kMaxR];
#pragma unroll
      for (int i = 0; i < kMaxR; ++i) {
        cr[i] = i < R ? cs[k * lp + ty * R + i] : 0.f;
        br[i] = i < R ? bs[k * lp + tx + kSide * i] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kMaxR; ++i)
#pragma unroll
        for (int j = 0; j < kMaxR; ++j)
          sacc[i][j] = fmaf(cr[i], br[j], sacc[i][j]);
    }
  }

  for (int hh = h0; hh < h1; ++hh) {
    __syncthreads();  // readers of the staging area / last head's M are done
    const size_t gh = (size_t)g * H + hh;
    const float* ag = a_cum + gh * L;
    const T* xg = xdt + gh * L * P;
    for (int i = tid; i < L; i += kThreads) as[i] = ag[i];
    for (int i = tid; i < L * P; i += kThreads) xs[i] = to_f32(xg[i]);
    __syncthreads();
    // 2. M = S * decay, the exp taken only on and below the diagonal
#pragma unroll
    for (int i = 0; i < kMaxR; ++i) {
      if (i < R) {
        const int r = ty * R + i;
        const float ar = as[r];
#pragma unroll
        for (int j = 0; j < kMaxR; ++j) {
          if (j < R) {
            const int s = tx + kSide * j;
            ms[r * lp + s] = s <= r ? sacc[i][j] * expf(ar - as[s]) : 0.f;
          }
        }
      }
    }
    __syncthreads();
    // 3. y = M xdt over s <= the thread's last row
    float yacc[kMaxR][kMaxC];
#pragma unroll
    for (int i = 0; i < kMaxR; ++i)
#pragma unroll
      for (int j = 0; j < kMaxC; ++j) yacc[i][j] = 0.f;
    const int smax = ty * R + R;
    for (int s = 0; s < smax; ++s) {
      float xr[kMaxC];
#pragma unroll
      for (int j = 0; j < kMaxC; ++j) {
        const int col = tx + kSide * j;
        xr[j] = (j < CP && col < P) ? xs[s * P + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kMaxR; ++i) {
        if (i < R) {
          const float mv = ms[(ty * R + i) * lp + s];
#pragma unroll
          for (int j = 0; j < kMaxC; ++j)
            yacc[i][j] = fmaf(mv, xr[j], yacc[i][j]);
        }
      }
    }
    T* og = out + gh * L * P;
#pragma unroll
    for (int i = 0; i < kMaxR; ++i) {
      if (i < R) {
#pragma unroll
        for (int j = 0; j < kMaxC; ++j) {
          const int col = tx + kSide * j;
          if (j < CP && col < P)
            og[(size_t)(ty * R + i) * P + col] = from_f32<T>(yacc[i][j]);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* c, const void* b, const void* xdt, const void* a_cum,
           void* out, int G, int H, int L, int N, int P, int HG,
           cudaStream_t st) {
  if (L <= 0 || L % kSide || L > kSide * kMaxR || P <= 0 ||
      P > kSide * kMaxC || N <= 0 || HG <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t floats = (size_t)m_floats(L) + (size_t)L * P + L;
  const size_t smem = floats * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(G, (H + HG - 1) / HG);
  ssd_chunk_kernel<T><<<grid, kThreads, smem, st>>>(
      (const T*)c, (const T*)b, (const T*)xdt, (const float*)a_cum, (T*)out,
      H, L, N, P, HG);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssd_chunk_launch(const void* c, const void* b,
                                const void* xdt, const void* a_cum, void* out,
                                int G, int H, int L, int N, int P, int HG,
                                int dtype, void* stream) {
  if (G <= 0 || H <= 0) return (int)cudaSuccess;
  DISPATCH_DTYPE(dtype, T,
                 return launch<T>(c, b, xdt, a_cum, out, G, H, L, N, P, HG,
                                  (cudaStream_t)stream));
  return (int)cudaErrorInvalidValue;
}
