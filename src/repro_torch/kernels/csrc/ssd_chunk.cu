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
// FMA.
//
// Design: one CTA of 512 threads per SM, holding a chunk and a group of its
// heads (all H where the chunks alone fill the card: `cta_heads` in
// ssd_chunk.py plans the grid), so C B^T is formed once per chunk.
//   1. S^T = (C B^T)^T once per chunk, on the lower triangle only: C and B
//      are staged k-major (L/2 columns of N at a time, read with vector
//      loads); each of the first threads computes one 4 x 8 tile of S that
//      a row octet touching the triangle needs.
//   2. Heads run in a pipeline of three stages, one barrier apart: while
//      the CTA multiplies head k, it forms M^T of head k + 1 and copies
//      head k + 1's xdt tile and head k + 2's a_cum row in with 16-byte
//      cp.async, so device memory and the decay hide behind the products.
//   3. M^T[s][r] = S[r][s] * exp(a[r] - a[s]) on the 4-row quads of every
//      row octet that touches s <= r, 8 threads per pair of rows
//      (s, L-1-s), which always hold L/4 + 2 quads; the exponent is -inf
//      above the diagonal, so exp gives 0 there (never an overflow, never
//      inf * 0).
//   4. y = M xdt in float32 FMAs: warp w multiplies row octet o(w) (8 rows)
//      over s < 8 o + 8 only, so the CTA pays for the lower triangle, not
//      the square. `warp_octet` gives the four warps of each SM
//      sub-partition octets whose rows add up to the same length, so the
//      sub-partitions finish together. A lane holds an 8 x 8 tile (8 rows,
//      columns c..c+3 and c+32..c+35) and takes every 4th s of its warp's
//      range (its s-group), so the lanes of a warp share their loop bounds.
//      Per s it reads 8 M^T values (two 16-byte loads, shared by the 8
//      lanes of its s-group) and 8 xdt values (two 16-byte loads, 8 lanes
//      reading 128 contiguous bytes), for 64 FMAs. The 4 s-groups' sums
//      are added with warp shuffles in a fixed order, leaving each lane 2
//      rows x 8 columns to store, 16 bytes at a time in f32.
// Shared memory (f32, L 128, P 64: 172 KB): S^T and M^T of two heads as
// packed lower triangles (rows s and L-1-s share one stretch), two xdt
// tiles, three a_cum rows, and the row offsets of the packed layout.
// What it measured on an H100 (PERF.md): 0.170 ms at the shape above,
// about half of the float32 FMA rate in the products. Tried and measured
// slower: 4 x 4 and 16 x 2 tiles per thread (0.27, 0.19 ms); a warp pair
// sharing an octet pair so that every warp runs equally long (0.19 ms, the
// second shuffle sum and the pair barriers cost more than the tail they
// removed); the products on the tensor cores in 3xTF32 (mma.sync m16n8k8,
// 0.22 ms: three products per term, and the fragment loads and splits
// repeated for every 16 columns). One TF32 product alone keeps about three
// digits, short of float32's tolerance here.
// The padded rows of the last chunk (dt = 0, so xdt = 0 and a flat a_cum)
// need no mask of their own. Results are deterministic: every sum runs in
// a fixed order, without atomics. The same thread-to-work maps live in
// ssd_chunk.py (`score_tile`, `decay_items`, `product_tile`, `row_base`,
// `warp_octet`), where the CPU tests check that they cover the work
// exactly once.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr float kLog2e = 1.4426950408889634f;

// The packed lower triangle of S^T and M^T: rows s and L-1-s share a
// stretch of L/4 + 2 quads (4 floats each), the quads of the row octets
// that touch s <= r; the quad of rows 4 rq.. of row s is at
// row_base(s) + 4 rq.
__host__ __device__ inline int row_base(int s, int L) {
  const int nq = L / 4, p = min(s, L - 1 - s);
  const int j0 = s < L / 2 ? 0 : nq - 2 * (p / 8);
  return 4 * (p * (nq + 2) + j0 - 2 * (s / 8));
}

__host__ inline size_t smem_bytes(int L, int P, int itemsize) {
  const size_t tri = (size_t)(L / 2) * (L / 4 + 2) * 4 * sizeof(float);
  return 3 * tri + 2 * (size_t)L * P * itemsize +
         3 * (size_t)L * sizeof(float) + (size_t)L * sizeof(int);
}

// A lane's 8 xdt columns of one row, as floats: c and c + 32 (c = 4 l for
// lane column group l), 4 each, so that each 16-byte load of 8 lanes reads
// 128 contiguous bytes (no bank conflict). VEC: P % 4 == 0; the loads of
// a group past P are clamped into the row (their sums are not stored).
template <bool VEC, typename T>
__device__ __forceinline__ void load_x(const T* row, int c, int P,
                                       float (&v)[8]) {
  if (VEC) {
    load4(row + min(c, P - 4), v);
    load4(row + min(c + 32, P - 4), v + 4);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = to_f32(row[min(c + j, P - 1)]);
      v[4 + j] = to_f32(row[min(c + 32 + j, P - 1)]);
    }
  }
}

// The same 8 output columns of one row, 4 at a time where VEC (16 bytes
// in f32, 8 in bf16)
template <bool VEC, typename T>
__device__ __forceinline__ void store_y(T* row, int c, int P,
                                        const float (&v)[8]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int cc = c + 32 * half;
    if (VEC) {
      if (cc < P) store4(row + cc, v + 4 * half);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (cc + j < P) row[cc + j] = from_f32<T>(v[4 * half + j]);
    }
  }
}

// The row octet warp w multiplies. At L 128 (16 octets) the four warps of
// each SM sub-partition (w, w+4, w+8, w+12) take octets j, 15-j, 4+j and
// 11-j, whose lower-triangle rows add up to the same length for every j.
__device__ __forceinline__ int warp_octet(int w, int no) {
  if (no != 16) return w;
  const int j = w & 3, q = w >> 2;
  return q == 0 ? j : q == 1 ? 15 - j : q == 2 ? 4 + j : 11 - j;
}

// 16-byte cp.async copies of n bytes (a multiple of 16)
__device__ __forceinline__ void stage(void* dst, const void* src, int n,
                                      int tid) {
  for (int i = tid; i < n / 16; i += kThreads)
    cp_async16(static_cast<char*>(dst) + 16 * i,
               static_cast<const char*>(src) + 16 * i);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 1) ssd_chunk_kernel(
    const T* __restrict__ c, const T* __restrict__ b,
    const T* __restrict__ xdt, const float* __restrict__ a_cum,
    T* __restrict__ out, int H, int L, int N, int P, int HG) {
  extern __shared__ __align__(16) float smem[];
  const int g = blockIdx.x;
  const int h0 = blockIdx.y * HG;
  const int nh = min(H, h0 + HG) - h0;
  const int tid = threadIdx.x;
  const int nq = L / 4;                 // row quads
  const int qp = nq + 2;                // quads of a pair of rows
  const int tri = (L / 2) * qp * 4;     // floats of a packed triangle
  float* const mts = smem;              // M^T of two heads; C/B staging
  float* st = smem + 2 * tri;           // S^T
  T* const xs = reinterpret_cast<T*>(st + tri);           // 2 x L x P
  float* const as = reinterpret_cast<float*>(xs + 2 * L * P);  // 3 x L
  int* const rbase = reinterpret_cast<int*>(as + 3 * L);  // L

  const size_t gh0 = (size_t)g * H + h0;
  const int xbytes = L * P * (int)sizeof(T);
  stage(xs, xdt + gh0 * L * P, xbytes, tid);
  stage(as, a_cum + gh0 * L, L * 4, tid);
  if (nh > 1) stage(as + L, a_cum + (gh0 + 1) * L, L * 4, tid);
  cp_async_commit();
  for (int s = tid; s < L; s += kThreads) rbase[s] = row_base(s, L);

  // 1. S^T over the 4 x 8 tiles (row quad rq, column octet so) that touch
  //    the lower triangle: rq >= 2 so, numbered by so, then rq
  {
    const int no = L / 8;
    int so = 0, rem = tid;
    while (so < no && rem >= nq - 2 * so) {
      rem -= nq - 2 * so;
      ++so;
    }
    const bool tile = so < no;
    const int rq = tile ? 2 * so + rem : 0;
    const int kc = L / 2;               // columns of N staged per step
    const int LP = L + 4;               // staging rows, 16-byte aligned
    float* cs = smem;                   // kc x LP, k-major
    float* bs = smem + kc * LP;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    const T* cg = c + (size_t)g * L * N;
    const T* bg = b + (size_t)g * L * N;
    const bool n4 = N % 4 == 0;
    for (int k0 = 0; k0 < N; k0 += kc) {
      __syncthreads();                  // last step's readers are done
      // lanes over rows, 4 consecutive columns of N each (one vector
      // load where N % 4 == 0), written k-major without bank conflicts
      for (int i = tid; i < L * kc / 4; i += kThreads) {
        const int r = i % L, k = k0 + 4 * (i / L);
        float cv[4], bv[4];
        if (n4 && k < N) {
          load4(cg + (size_t)r * N + k, cv);
          load4(bg + (size_t)r * N + k, bv);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            cv[e] = k + e < N ? to_f32(cg[(size_t)r * N + k + e]) : 0.f;
            bv[e] = k + e < N ? to_f32(bg[(size_t)r * N + k + e]) : 0.f;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          cs[(k - k0 + e) * LP + r] = cv[e];
          bs[(k - k0 + e) * LP + r] = bv[e];
        }
      }
      __syncthreads();
      if (tile) {
        const int kn = min(kc, N - k0);
#pragma unroll 2
        for (int k = 0; k < kn; ++k) {
          float cv[4], bv[8];
          load4(cs + k * LP + 4 * rq, cv);
          load4(bs + k * LP + 8 * so, bv);
          load4(bs + k * LP + 8 * so + 4, bv + 4);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
        }
      }
    }
    if (tile) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v[4] = {acc[0][j], acc[1][j], acc[2][j], acc[3][j]};
        store4(st + rbase[8 * so + j] + 4 * rq, v);
      }
    }
  }

  // M^T's writers: 8 threads per pair of rows (sp, L-1-sp)
  const int sp = tid >> 3, sub = tid & 7;
  const int nlo = nq - 2 * (sp / 8);    // quads of row sp
  // 2. M^T of one head = S^T * decay, elementwise over the packed
  //    triangle (exp2 of -inf is 0 above the diagonal)
  auto decay = [&](float* mt, const float* a) {
    if (sp >= L / 2) return;
#pragma unroll 5
    for (int j = sub; j < qp; j += 8) {
      const int s = j < nlo ? sp : L - 1 - sp;
      const int rq = j < nlo ? 2 * (sp / 8) + j : 2 * (s / 8) + j - nlo;
      const int off = 4 * (sp * qp + j);
      float sv[4], ar[4], m[4];
      load4(st + off, sv);
      load4(a + 4 * rq, ar);
      const float as_ = a[s];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        m[e] = sv[e] * exp2_approx(s <= 4 * rq + e ? (ar[e] - as_) * kLog2e
                                                   : -INFINITY);
      store4(mt + off, m);
    }
  };

  // the product's tile: warp w multiplies row octet o (rows 8o..8o+7);
  // lane l takes columns c0..c0+3 and c0+32..c0+35 and every 4th s from
  // its s-group, and ends with rows ra + 2 b0, +1 after the fixed-order
  // sum over s-groups
  const int warp = tid >> 5, lane = tid & 31;
  const int no = L / 8;
  const int o = warp_octet(warp, no);
  const int c0 = 4 * (lane & 7);
  const int sg = lane >> 3, b1 = sg >> 1, b0 = sg & 1;
  const int ra = 8 * o + 4 * b1, rc = 8 * o + 4 * (1 - b1);

  cp_async_wait_all();
  __syncthreads();                      // S^T, x and a of heads 0 and 1
  decay(mts, as);
  int a_next = 1;                       // a buffer of head k + 1
  for (int k = 0; k < nh; ++k) {
    const size_t gh = gh0 + k;
    __syncthreads();                    // M^T of head k is complete
    const int a_far = a_next == 2 ? 0 : a_next + 1;   // head k + 2
    if (k + 1 < nh)
      stage(xs + ((k + 1) & 1) * L * P, xdt + (gh + 1) * L * P, xbytes, tid);
    if (k + 2 < nh) stage(as + a_far * L, a_cum + (gh + 2) * L, L * 4, tid);
    cp_async_commit();
    if (k + 1 < nh) decay(mts + ((k + 1) & 1) * tri, as + a_next * L);
    a_next = a_far;

    // 3. y = M xdt: octet o needs s < 8o + 8, 2o + 2 steps per s-group
    if (o < no) {
      const float* mt = mts + (k & 1) * tri;
      const T* x = xs + (k & 1) * L * P;
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 2
      for (int j = 0; j < 2 * o + 2; ++j) {
        const int s = sg + 4 * j;
        const float* mr = mt + rbase[s];
        float m[8], xv[8];
        load4(mr + ra, m);
        load4(mr + rc, m + 4);
        load_x<VEC>(x + s * P, c0, P, xv);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            acc[i][jj] = fmaf(m[i], xv[jj], acc[i][jj]);
      }
      // sum over the 4 s-groups: lanes 16 apart hold each other's rows in
      // swapped halves, then lanes 8 apart split the kept 4 rows in two
      float y[2][8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float k4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          k4[i] = acc[i][jj] + __shfl_xor_sync(0xffffffffu, acc[4 + i][jj], 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float mine = b0 ? k4[2 + i] : k4[i];
          const float give = b0 ? k4[i] : k4[2 + i];
          y[i][jj] = mine + __shfl_xor_sync(0xffffffffu, give, 8);
        }
      }
      if (c0 < P) {
        T* og = out + gh * L * P;
        store_y<VEC>(og + (size_t)(ra + 2 * b0) * P, c0, P, y[0]);
        store_y<VEC>(og + (size_t)(ra + 2 * b0 + 1) * P, c0, P, y[1]);
      }
    }
    cp_async_wait_all();                // x of head k + 1, a of head k + 2
  }
}

template <typename T, bool VEC>
int launch(const void* c, const void* b, const void* xdt, const void* a_cum,
           void* out, int G, int H, int L, int N, int P, int HG,
           cudaStream_t st) {
  const size_t smem = smem_bytes(L, P, (int)sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(G, (H + HG - 1) / HG);
  ssd_chunk_kernel<T, VEC><<<grid, kThreads, smem, st>>>(
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
  if (L <= 0 || L % 16 || L > 128 || P <= 0 || P > 64 || N <= 0 || HG <= 0)
    return (int)cudaErrorInvalidValue;
  const bool vec = P % 4 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  DISPATCH_DTYPE(dtype, T,
                 return vec ? launch<T, true>(c, b, xdt, a_cum, out, G, H, L,
                                              N, P, HG, st)
                            : launch<T, false>(c, b, xdt, a_cum, out, G, H,
                                               L, N, P, HG, st));
  return (int)cudaErrorInvalidValue;
}
