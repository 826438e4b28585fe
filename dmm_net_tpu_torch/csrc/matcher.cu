// Fused mask pooling + IoU/cosine cost + capped-column log-domain Sinkhorn
// (kernel B1), and the same without the pooling (kernel B3).
//
// B1 replaces the TPU kernel `_fused_pool_cost_match` / `_pool_matcher_kernel`
// (dmm_net_tpu/kernels/matcher.py).  Per batch element b:
//
//   pf[n]   = pmask_pool[n] @ emb / max(sum(pmask_pool[n]), 1e-6)
//   C[m,n]  = lam * (1 - IoU(tm[m], pm[n])) + (1 - lam) * (1 - cos(tf[m], pf[n]))
//   X       = Sinkhorn(C) over valid (row, col) pairs; padded entries exactly 0
//
// B3 replaces `_pallas_forward` / `_matcher_kernel` (public `fused_cost_match`,
// same file): the features arrive pooled, so it skips the first launch.
//
// Three launches on the caller's stream (B3: the last two), all float32 on
// FFMA (the reference pins Precision.HIGHEST):
//   1. matcher_pool_kernel, grid (N / PN, D / PD, B): pf tiles,
//      (PN x P) @ (P x PD).
//   2. matcher_cost_kernel, grid (N / NT, S + 1, B): blocks y < S each sum the
//      intersections and mask areas of an (M x NT) tile over one of S slices
//      of the Pc pixels; block y = S takes the cosine of the tile over D.
//      S is chosen so that B=4 fills the card as B=16 does (about 2 blocks
//      per SM).  The slices' partial sums go to a small scratch and are added
//      in a fixed order by launch 3, so the result does not change from run
//      to run (no float atomics).
//   3. matcher_sinkhorn_kernel, grid (B): builds C (M x N) in shared memory
//      from the partial sums and keeps it there, with f and g, for all
//      iterations.
// Launches 1 and 2 stream their operands through shared memory in tiles of
// PT = 64 pixels (or feature dims) with cp.async, double buffered: the next
// tile's copy runs under this tile's FMAs.  Each thread keeps an NT-strided
// register tile of up to 8 template rows against one proposal, reading the
// template rows as broadcasts and the proposal rows as conflict-free float4s.
//
// Sinkhorn: one warp per row for the row pass, each lane holding its
// columns' values in registers (the kernel is instantiated for N <= 32,
// 64, ..., 1024), and G lanes per column for the column pass (G = 4 at p3:
// 512 threads over 128 columns); each reduction is a warp shuffle, with two
// barriers per iteration.  The log-sum-exps run in base 2 with log2(e) / eps
// folded into one scale per iteration (no division in the inner loops), on
// the hardware's ex2 / lg2; a padded pair carries a cost of 1e30, so it
// drops out of every max and sum without a branch.  The rounding points
// stay the reference's: the max floored at NEG / 2, the sum at 1e-38, the
// column dual capped at 0, and the final exp clipped at 30 with the
// accurate expf.
//
// What bounds it on an H100.  By bytes the floor is ~15 us at p3 B=16 (it
// must read ~49 MB, pm_cost dominates, against ~0.8 GFLOP of f32 work) and
// ~3.7 us at B=4.  The pooling and cost launches are spread over the card
// at either batch; what sets the time at the main path's B=4 is the
// Sinkhorn's 31 dependent iterations on one block per batch element, a
// latency chain (two barriers, two warp reductions and the exponentials
// per iteration) that does not shrink with the batch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;    // pool and cost blocks
constexpr int PT = 64;          // pixels / feature dims per staged tile
constexpr int LDT = PT + 4;     // shared row stride: 16-byte rows, float4 reads conflict-free
constexpr int NT = 32;          // proposals per cost block (one per lane)
constexpr int MG = THREADS / NT;  // template-row groups (one per warp)
constexpr int MAX_M = 64;       // 8 template rows per thread
constexpr int MAX_N = 1024;     // 32 lanes x 32 columns in the Sinkhorn's row pass
constexpr int PN = 16;          // proposals per pooling block
constexpr int PD = 64;          // feature dims per pooling block (== PT)
constexpr int TARGET_BLOCKS = 264;   // ~2 cost blocks per SM of an H100
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.44269504088896341f;
constexpr float LN2 = 0.693147180559945309f;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy rows [0, rows) x cols [0, PT) of `src` (row stride ld; entries past
// nrow rows or ncol columns read as 0) into `dst` (row stride LDT) with
// cp.async.  `vec`: src and ld are 16-byte aligned, so whole 16-byte chunks
// go in one copy.  The caller commits the group.
__device__ __forceinline__ void stage_tile(float* dst, const float* src, int ld, int rows,
                                           int nrow, int ncol, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < rows * (PT / 4); e += blockDim.x) {
      const int r = e / (PT / 4), c = 4 * (e % (PT / 4));
      float* d = dst + r * LDT + c;
      const float* s = src + (size_t)r * ld + c;
      if (r < nrow && c + 4 <= ncol) {
        cp_async16(d, s);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (r < nrow && c + u < ncol) cp_async4(d + u, s + u);
          else d[u] = 0.f;
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows * PT; e += blockDim.x) {
      const int r = e / PT, c = e % PT;
      if (r < nrow && c < ncol) cp_async4(dst + r * LDT + c, src + (size_t)r * ld + c);
      else dst[r * LDT + c] = 0.f;
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p, int ld) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && ld % 4 == 0;
}

// ---- 1. pooling: pf[n, d] = sum_p pmask[n, p] * emb[p, d] / max(area_n, 1e-6)
__global__ void __launch_bounds__(THREADS)
matcher_pool_kernel(const float* __restrict__ emb,          // (B, P, D)
            const float* __restrict__ pmask_pool,   // (B, N, P)
            float* __restrict__ pf,                 // (B, N, D)
            int N, int P, int D) {
  extern __shared__ __align__(16) float smem[];
  // two stages of (PN mask rows, then PT embedding rows), row stride LDT
  constexpr int stage_floats = (PN + PT) * LDT;
  const int b = blockIdx.z, n0 = blockIdx.x * PN, d0 = blockIdx.y * PD;
  const int tid = threadIdx.x;
  const int i = tid / (PD / 4), dq = tid % (PD / 4);    // proposal, float4 of d
  const float* pm_b = pmask_pool + ((size_t)b * N + n0) * P;
  const float* e_b = emb + (size_t)b * P * D + d0;
  const bool vm = aligned16(pm_b, P), ve = aligned16(e_b, D);
  const int nrow = min(PN, N - n0), ncol = min(PD, D - d0);
  const int tiles = (P + PT - 1) / PT;

  auto load = [&](int t, int buf) {
    const int p0 = t * PT;
    float* st = smem + buf * stage_floats;
    stage_tile(st, pm_b + p0, P, PN, nrow, min(PT, P - p0), vm);
    stage_tile(st + PN * LDT, e_b + (size_t)p0 * D, D, PT, min(PT, P - p0), ncol, ve);
    cp_async_commit();
  };

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float area = 0.f;
  if (tiles > 0) load(0, 0);
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      load(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* mrow = smem + buf * stage_floats + i * LDT;
    const float* ecol = smem + buf * stage_floats + PN * LDT + 4 * dq;
#pragma unroll 8
    for (int j = 0; j < PT; ++j) {
      const float a = mrow[j];
      const float4 e = *reinterpret_cast<const float4*>(ecol + j * LDT);
      area += a;
      acc[0] = fmaf(a, e.x, acc[0]);
      acc[1] = fmaf(a, e.y, acc[1]);
      acc[2] = fmaf(a, e.z, acc[2]);
      acc[3] = fmaf(a, e.w, acc[3]);
    }
    __syncthreads();
  }
  if (i < nrow) {
    const float den = fmaxf(area, 1e-6f);
    float* o = pf + ((size_t)b * N + n0 + i) * D + d0;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (4 * dq + u < ncol) o[4 * dq + u] = acc[u] / den;
  }
}

// ---- 2. cost tile partial sums ---------------------------------------------
// Sums over columns [l0, l1) of A (M rows, stride lda) against B (nt rows,
// stride ldb), for R template rows per thread: dot[r] for row m = g + MG * r
// against proposal i; with SUM_A, ra[r] the row's sum; rb proposal i's sum
// (in warp 0 only, unless SQUARES).  SQUARES sums squares instead (norms).
template <int R, bool SQUARES, bool SUM_A>
__device__ __forceinline__ void pair_sums(const float* A, int lda, int M, const float* Bm,
                                          int ldb, int nt, int l0, int l1, float* smem,
                                          float dot[R], float ra[R], float& rb) {
  // two stages of (M template rows, then NT proposal rows), row stride LDT
  const int stage_floats = (M + NT) * LDT;
  const int i = threadIdx.x % NT, g = threadIdx.x / NT;
  const bool sum_b = SQUARES || g == 0;            // warp-uniform
  const bool va = aligned16(A + l0, lda), vb = aligned16(Bm + l0, ldb);
  const int tiles = l1 > l0 ? (l1 - l0 + PT - 1) / PT : 0;

  auto load = [&](int t, int buf) {
    const int c0 = l0 + t * PT, nc = min(PT, l1 - c0);
    float* st = smem + buf * stage_floats;
    stage_tile(st, A + c0, lda, M, M, nc, va);
    stage_tile(st + M * LDT, Bm + c0, ldb, NT, nt, nc, vb);
    cp_async_commit();
  };

  if (tiles > 0) load(0, 0);
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      load(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* s_a = smem + buf * stage_floats;
    const float* brow = s_a + (M + i) * LDT;
#pragma unroll 4
    for (int j = 0; j < PT; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(brow + j);
      if (sum_b)
        rb += SQUARES ? q.x * q.x + q.y * q.y + q.z * q.z + q.w * q.w : q.x + q.y + q.z + q.w;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int m = min(g + MG * r, M - 1);     // rows past M repeat row M - 1, unused
        const float4 a = *reinterpret_cast<const float4*>(s_a + m * LDT + j);
        float d = dot[r];
        d = fmaf(a.x, q.x, d);
        d = fmaf(a.y, q.y, d);
        d = fmaf(a.z, q.z, d);
        d = fmaf(a.w, q.w, d);
        dot[r] = d;
        if (SUM_A)
          ra[r] += SQUARES ? a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w
                           : a.x + a.y + a.z + a.w;
      }
    }
    __syncthreads();
  }
}

// Block (x, y, b): proposals n0 = x * NT .. of batch element b; R template
// rows per thread (M <= MG * R).
//   y < S:  intersections and mask areas over pixels [y * chunk, (y+1) * chunk)
//           -> inter_part (B, S, M, N), at_part (B, S, M) (blocks x == 0),
//              ap_part (B, S, N)
//   y == S: cosine over D -> cos (B, M, N)
template <int R>
__global__ void __launch_bounds__(THREADS)
matcher_cost_kernel(const float* __restrict__ tm,   // (B, M, Pc)
                    const float* __restrict__ pm,   // (B, N, Pc)
                    const float* __restrict__ tf,   // (B, M, D)
                    const float* __restrict__ pf,   // (B, N, D)
                    float* __restrict__ cos_out, float* __restrict__ inter_part,
                    float* __restrict__ at_part, float* __restrict__ ap_part,
                    int M, int N, int Pc, int D, int S, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z, y = blockIdx.y, n0 = blockIdx.x * NT;
  const int nt = min(NT, N - n0);
  const int i = threadIdx.x % NT, g = threadIdx.x / NT;
  float dot[R], ra[R], rb = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) dot[r] = ra[r] = 0.f;

  if (y == S) {
    pair_sums<R, true, true>(tf + (size_t)b * M * D, D, M, pf + ((size_t)b * N + n0) * D, D,
                             nt, 0, D, smem, dot, ra, rb);
    if (i < nt) {
      const float pn = rsqrtf(rb + 1e-12f);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int m = g + MG * r;
        if (m < M)
          cos_out[((size_t)b * M + m) * N + n0 + i] = dot[r] * rsqrtf(ra[r] + 1e-12f) * pn;
      }
    }
    return;
  }
  const int l0 = min(Pc, y * chunk), l1 = min(Pc, l0 + chunk);
  const float* tm_b = tm + (size_t)b * M * Pc;
  const float* pm_b = pm + ((size_t)b * N + n0) * Pc;
  if (blockIdx.x == 0)        // template areas: once per slice, from the first column tile
    pair_sums<R, false, true>(tm_b, Pc, M, pm_b, Pc, nt, l0, l1, smem, dot, ra, rb);
  else
    pair_sums<R, false, false>(tm_b, Pc, M, pm_b, Pc, nt, l0, l1, smem, dot, ra, rb);
  const size_t bs = (size_t)b * S + y;
  if (i < nt) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = g + MG * r;
      if (m < M) inter_part[(bs * M + m) * N + n0 + i] = dot[r];
    }
    if (g == 0) ap_part[bs * N + n0 + i] = rb;
  }
  if (blockIdx.x == 0 && i == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = g + MG * r;
      if (m < M) at_part[bs * M + m] = ra[r];
    }
  }
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int R>
int launch_cost(const float* tm, const float* pm, const float* tf, const float* pf,
                float* cosv, float* inter, float* at, float* ap, int B, int M, int N, int Pc,
                int D, int S, int chunk, cudaStream_t st) {
  const size_t smem = sizeof(float) * 2 * (size_t)(M + NT) * LDT;
  cudaError_t err = set_smem(reinterpret_cast<const void*>(matcher_cost_kernel<R>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  matcher_cost_kernel<R><<<dim3((N + NT - 1) / NT, S + 1, B), THREADS, smem, st>>>(
      tm, pm, tf, pf, cosv, inter, at, ap, M, N, Pc, D, S, chunk);
  return static_cast<int>(cudaGetLastError());
}

// ---- 3. Sinkhorn -----------------------------------------------------------
// Masked log-sum-exp, as the reference: mx = max(max_valid(z), NEG / 2);
// s = sum_valid exp(z - mx); lse = mx + log(max(s, 1e-38)).  Here z is kept
// in base 2 (z2 = z * log2 e), so lse = ln 2 * (mx2 + log2(max(s, 1e-38))),
// with the hardware's ex2 / lg2 (relative error ~2^-22).  A padded pair
// carries the cost PAD_COST, so its z lies far below NEG / 2: it never sets
// the max and its exp is exactly 0, which is the reference's mask without a
// branch.

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float PAD_COST = 1e30f;

// NPL: columns per lane in the row pass (N <= 32 * NPL), held in registers.
template <int NPL>
__global__ void matcher_sinkhorn_kernel(const float* __restrict__ cos_in,      // (B, M, N)
                                        const float* __restrict__ inter_part,  // (B, S, M, N)
                                        const float* __restrict__ at_part,     // (B, S, M)
                                        const float* __restrict__ ap_part,     // (B, S, N)
                                        const float* __restrict__ rm,          // (B, M) 0/1
                                        const float* __restrict__ cm,          // (B, N) 0/1
                                        float* __restrict__ X,                 // (B, M, N)
                                        int M, int N, int S, int ldc, int G, float iou_weight,
                                        float epsilon, int iters, int anneal,
                                        float epsilon_init, float log_decay) {
  extern __shared__ float smem[];
  float* s_c = smem;                     // M x ldc
  float* s_f = s_c + (size_t)M * ldc;    // M
  float* s_g = s_f + M;                  // N
  float* s_rv = s_g + N;                 // M
  float* s_cv = s_rv + M;                // N
  float* s_at = s_cv + N;                // M
  float* s_ap = s_at + M;                // N

  const int b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;

  // areas: the slices' partial sums, in slice order
  for (int m = tid; m < M; m += T) {
    float a = 0.f;
    for (int y = 0; y < S; ++y) a += at_part[((size_t)b * S + y) * M + m];
    s_at[m] = a;
    s_rv[m] = rm[(size_t)b * M + m] > 0.5f ? 1.f : 0.f;
    s_f[m] = 0.f;
  }
  for (int n = tid; n < N; n += T) {
    float a = 0.f;
    for (int y = 0; y < S; ++y) a += ap_part[((size_t)b * S + y) * N + n];
    s_ap[n] = a;
    s_cv[n] = cm[(size_t)b * N + n] > 0.5f ? 1.f : 0.f;
    s_g[n] = 0.f;
  }
  __syncthreads();
  for (int e = tid; e < M * N; e += T) {
    const int m = e / N, n = e % N;
    float inter = 0.f;
    for (int y = 0; y < S; ++y) inter += inter_part[((size_t)b * S + y) * M * N + e];
    const float uni = fmaxf(s_at[m] + s_ap[n] - inter, 1e-6f);
    const float iou = inter / uni;
    const float c = iou_weight * (1.f - iou) +
                    (1.f - iou_weight) * (1.f - cos_in[(size_t)b * M * N + e]);
    s_c[m * ldc + n] = (s_rv[m] > 0.5f && s_cv[n] > 0.5f) ? c : PAD_COST;
  }
  __syncthreads();

  // f[m] = valid_row ? -eps * lse_n((g - C) / eps) : 0, one warp per row,
  // lane l holding columns l, l + 32, ...
  auto row_update = [&](float eps) {
    const float sc = LOG2E / eps;
    for (int m = warp; m < M; m += nwarps) {
      const float* crow = s_c + m * ldc;
      float z[NPL];
      float mx = NEG;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int n = lane + 32 * i;
        z[i] = n < N ? (s_g[n] - crow[n]) * sc : NEG;
        mx = fmaxf(mx, z[i]);
      }
      mx = fmaxf(warp_max(mx), NEG / 2);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < NPL; ++i) s += ex2(z[i] - mx);
      s = warp_sum(s);
      if (lane == 0) s_f[m] = s_rv[m] > 0.5f ? -eps * LN2 * (mx + lg2(fmaxf(s, 1e-38f))) : 0.f;
    }
  };

  const int cols_per_pass = T / G;
  const int q = tid % G;
  for (int k = 0; k < iters; ++k) {
    const float eps = anneal ? fmaxf(epsilon_init * expf((float)k * log_decay), epsilon)
                             : epsilon;
    row_update(eps);
    __syncthreads();
    // g[n] = valid_col ? min(0, -eps * lse_m((f - C) / eps)) : 0, G lanes per column
    const float sc = LOG2E / eps;
    for (int n0 = 0; n0 < N; n0 += cols_per_pass) {
      const int n = n0 + tid / G;
      const int nn = min(n, N - 1);          // lanes past N compute a copy, unused
      float mx = NEG;
#pragma unroll 4
      for (int m = q; m < M; m += G) mx = fmaxf(mx, (s_f[m] - s_c[m * ldc + nn]) * sc);
      for (int o = G >> 1; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mx = fmaxf(mx, NEG / 2);
      float s = 0.f;
#pragma unroll 4
      for (int m = q; m < M; m += G) s += ex2((s_f[m] - s_c[m * ldc + nn]) * sc - mx);
      for (int o = G >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (q == 0 && n < N)
        s_g[n] = s_cv[n] > 0.5f ? fminf(0.f, -eps * LN2 * (mx + lg2(fmaxf(s, 1e-38f)))) : 0.f;
    }
    __syncthreads();
  }
  row_update(epsilon);
  __syncthreads();

  float* x_b = X + (size_t)b * M * N;
  for (int e = tid; e < M * N; e += T) {
    const int m = e / N, n = e % N;
    float v = 0.f;
    if (s_rv[m] > 0.5f && s_cv[n] > 0.5f)
      v = expf(fminf((s_f[m] + s_g[n] - s_c[m * ldc + n]) / epsilon, 30.f));
    x_b[e] = v;
  }
}

template <int NPL>
int launch_sinkhorn(const float* cosv, const float* inter, const float* at, const float* ap,
                    const float* rm, const float* cm, float* X, int B, int M, int N, int S,
                    float iou_weight, float epsilon, int iters, int anneal, float epsilon_init,
                    float log_decay, cudaStream_t st) {
  // one warp per row, up to 1024 threads; G lanes per column in the column pass
  const int T = std::min(1024, std::max(256, 32 * M));
  int G = 1;
  while (G < 32 && 2 * G * N <= T && G < M) G *= 2;
  int ldc = N + 1;                         // column pass: rows of a warp land on other banks
  if (G > 1)
    while (ldc % 32 != 32 / G) ++ldc;
  const size_t smem = sizeof(float) * ((size_t)M * ldc + 3 * (size_t)M + 3 * (size_t)N);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(matcher_sinkhorn_kernel<NPL>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  matcher_sinkhorn_kernel<NPL><<<B, T, smem, st>>>(cosv, inter, at, ap, rm, cm, X, M, N, S,
                                                    ldc, G, iou_weight, epsilon, iters,
                                                    anneal, epsilon_init, log_decay);
  return static_cast<int>(cudaGetLastError());
}

// ---- host side ---------------------------------------------------------------

int cdiv(int a, int b) { return (a + b - 1) / b; }

// Pixels per slice of the cost phase: a multiple of PT.
int slice_len(int Pc, int s) { return cdiv(cdiv(Pc, s), PT) * PT; }

// Pixel slices of the cost phase: enough blocks that B=4 fills the card.
int pixel_slices(int B, int N, int Pc) {
  const int want = cdiv(TARGET_BLOCKS, cdiv(N, NT) * B);
  const int s = std::max(1, std::min(want, cdiv(Pc, PT)));
  return cdiv(Pc, slice_len(Pc, s));
}

bool bad_sizes(int B, int M, int N, int Pc, int D) {
  return B < 1 || M < 1 || M > MAX_M || N < 1 || N > MAX_N || Pc < 1 || D < 1;
}

// Scratch floats after pf: cos (B, M, N), inter (B, S, M, N), at (B, S, M), ap (B, S, N).
size_t cost_scratch(int B, int M, int N, int S) {
  return (size_t)B * M * N + (size_t)B * S * ((size_t)M * N + M + N);
}

int launch_cost_and_sinkhorn(const float* tm, const float* pm, const float* tf,
                             const float* pf, const float* rm, const float* cm, float* scratch,
                             float* X, int B, int M, int N, int Pc, int D, float epsilon,
                             int iters, float iou_weight, int anneal, float epsilon_init,
                             float log_decay, cudaStream_t st) {
  const int S = pixel_slices(B, N, Pc);
  const int chunk = slice_len(Pc, S);
  float* cosv = scratch;
  float* inter = cosv + (size_t)B * M * N;
  float* at = inter + (size_t)B * S * M * N;
  float* ap = at + (size_t)B * S * M;

  const int rows = cdiv(M, MG);             // template rows per thread
  int err = static_cast<int>(cudaErrorInvalidValue);
#define DMM_COST(R)                                                                     \
  else if (rows <= R) err = launch_cost<R>(tm, pm, tf, pf, cosv, inter, at, ap, B, M, N, \
                                           Pc, D, S, chunk, st);
  if (false) {}
  DMM_COST(1) DMM_COST(2) DMM_COST(4) DMM_COST(8)
#undef DMM_COST
  if (err != 0) return err;

  const int npl = cdiv(N, 32);
#define DMM_SINKHORN(P)                                                                  \
  if (npl <= P)                                                                          \
    return launch_sinkhorn<P>(cosv, inter, at, ap, rm, cm, X, B, M, N, S, iou_weight,    \
                              epsilon, iters, anneal, epsilon_init, log_decay, st);
  DMM_SINKHORN(1) DMM_SINKHORN(2) DMM_SINKHORN(4) DMM_SINKHORN(8) DMM_SINKHORN(16)
  DMM_SINKHORN(32)
#undef DMM_SINKHORN
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Floats of scratch the wrapper allocates for one call (pooling: B1, with pf).
extern "C" long long dmm_matcher_scratch_floats(int B, int M, int N, int Pc, int D,
                                                int pooling) {
  if (bad_sizes(B, M, N, Pc, D)) return -1;
  const int S = pixel_slices(B, N, Pc);
  return static_cast<long long>(cost_scratch(B, M, N, S) +
                                (pooling ? (size_t)B * N * D : 0));
}

extern "C" int dmm_fused_pool_cost_match(
    const float* emb, const float* pmask_pool, const float* tm, const float* pm,
    const float* tf, const float* rm, const float* cm, float* scratch, float* X, int B,
    int M, int N, int P, int Pc, int D, float epsilon, int iters, float iou_weight,
    int anneal, float epsilon_init, float log_decay, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_sizes(B, M, N, Pc, D) || P < 1 || cdiv(D, PD) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  float* pf = scratch;
  const size_t pool_smem = sizeof(float) * 2 * (size_t)(PN + PT) * LDT;
  matcher_pool_kernel<<<dim3(cdiv(N, PN), cdiv(D, PD), B), THREADS, pool_smem, st>>>(
      emb, pmask_pool, pf, N, P, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_cost_and_sinkhorn(tm, pm, tf, pf, rm, cm, scratch + (size_t)B * N * D, X, B,
                                  M, N, Pc, D, epsilon, iters, iou_weight, anneal,
                                  epsilon_init, log_decay, st);
}

// Kernel B3: cost from pooled features, then Sinkhorn at a fixed epsilon.
extern "C" int dmm_fused_cost_match(const float* tm, const float* pm, const float* tf,
                                    const float* pf, const float* rm, const float* cm,
                                    float* scratch, float* X, int B, int M, int N, int P,
                                    int D, float epsilon, int iters, float iou_weight,
                                    void* stream) {
  if (bad_sizes(B, M, N, P, D)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_cost_and_sinkhorn(tm, pm, tf, pf, rm, cm, scratch, X, B, M, N, P, D, epsilon,
                                  iters, iou_weight, 0, 0.f, 0.f,
                                  static_cast<cudaStream_t>(stream));
}
