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
// B1', B1's backward, replaces the JAX package's `_fpcm_bwd` (same file, a
// VJP of the jnp reference): one launch, matcher_backward_kernel (section 4),
// on B1's scratch.
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
// 512 threads over 128 columns; at most 512 threads a block for N > 256,
// whose builds need ~70 registers a thread); each reduction is a warp
// shuffle, with two barriers per iteration.  When an input needs a gradient
// the kernel's KEEP build also writes each pass's duals for B1'.  The log-sum-exps run in base 2 with log2(e) / eps
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

// Clamps that keep a NaN, as the plain version's clamp_min / clamp_max and
// the JAX package's jnp.maximum / jnp.minimum do: fmaxf / fminf return the
// other operand, which would turn a NaN in an input into a finite X.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
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
    const float den = nan_max(area, 1e-6f);
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
constexpr int DPL = 8;          // feature dims a lane keeps in flight in B1''s cosine tail

// The Sinkhorn launch's shared memory: C (M x ldc; PAD_COST on padded
// pairs), then one value per row or column.
struct Sink {
  float* c;
  float* f;    // M: row duals
  float* g;    // N: column duals
  float* rv;   // M: 1 on a valid row
  float* cv;   // N: 1 on a valid column
  float* at;   // M: template mask areas
  float* ap;   // N: proposal mask areas
};

__device__ __forceinline__ Sink sink_layout(float* smem, int M, int N, int ldc) {
  Sink s;
  s.c = smem;
  s.f = s.c + (size_t)M * ldc;
  s.g = s.f + M;
  s.rv = s.g + N;
  s.cv = s.rv + M;
  s.at = s.cv + N;
  s.ap = s.at + M;
  return s;
}

// The areas and the validity from the cost phase's partial sums (added in
// slice order), f = g = 0, then C.
__device__ __forceinline__ void build_cost(const Sink& s, const float* __restrict__ cos_in,
                                           const float* __restrict__ inter_part,
                                           const float* __restrict__ at_part,
                                           const float* __restrict__ ap_part,
                                           const float* __restrict__ rm,
                                           const float* __restrict__ cm, int b, int M, int N,
                                           int S, int ldc, float iou_weight) {
  const int tid = threadIdx.x, T = blockDim.x;
  for (int m = tid; m < M; m += T) {
    float a = 0.f;
    for (int y = 0; y < S; ++y) a += at_part[((size_t)b * S + y) * M + m];
    s.at[m] = a;
    s.rv[m] = rm[(size_t)b * M + m] > 0.5f ? 1.f : 0.f;
    s.f[m] = 0.f;
  }
  for (int n = tid; n < N; n += T) {
    float a = 0.f;
    for (int y = 0; y < S; ++y) a += ap_part[((size_t)b * S + y) * N + n];
    s.ap[n] = a;
    s.cv[n] = cm[(size_t)b * N + n] > 0.5f ? 1.f : 0.f;
    s.g[n] = 0.f;
  }
  __syncthreads();
  for (int e = tid; e < M * N; e += T) {
    const int m = e / N, n = e % N;
    float inter = 0.f;
    for (int y = 0; y < S; ++y) inter += inter_part[((size_t)b * S + y) * M * N + e];
    const float uni = nan_max(s.at[m] + s.ap[n] - inter, 1e-6f);
    const float iou = inter / uni;
    const float c = iou_weight * (1.f - iou) +
                    (1.f - iou_weight) * (1.f - cos_in[(size_t)b * M * N + e]);
    s.c[m * ldc + n] = (s.rv[m] > 0.5f && s.cv[n] > 0.5f) ? c : PAD_COST;
  }
  __syncthreads();
}

__device__ __forceinline__ float sched_eps(int k, float epsilon, int anneal, float epsilon_init,
                                           float log_decay) {
  return anneal ? fmaxf(epsilon_init * expf((float)k * log_decay), epsilon) : epsilon;
}

// NPL: columns per lane in the row pass (N <= 32 * NPL), held in registers.
// KEEP: also write the duals' history for B1' to hist, (B, iters + 1, M + N):
// F[k] (f after row pass k; F[iters] the final one) at k * (M + N), H[k + 1]
// (column pass k's value before its cap) at (k + 1) * (M + N) + M.
template <int NPL, bool KEEP>
__global__ void matcher_sinkhorn_kernel(const float* __restrict__ cos_in,      // (B, M, N)
                                        const float* __restrict__ inter_part,  // (B, S, M, N)
                                        const float* __restrict__ at_part,     // (B, S, M)
                                        const float* __restrict__ ap_part,     // (B, S, N)
                                        const float* __restrict__ rm,          // (B, M) 0/1
                                        const float* __restrict__ cm,          // (B, N) 0/1
                                        float* __restrict__ X,                 // (B, M, N)
                                        float* __restrict__ hist,              // or null
                                        int M, int N, int S, int ldc, int G, float iou_weight,
                                        float epsilon, int iters, int anneal,
                                        float epsilon_init, float log_decay) {
  extern __shared__ float smem[];
  const Sink s = sink_layout(smem, M, N, ldc);
  const int b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const int MN = M + N;
  float* h_b = hist + (KEEP ? (size_t)b * (iters + 1) * MN : 0);
  build_cost(s, cos_in, inter_part, at_part, ap_part, rm, cm, b, M, N, S, ldc, iou_weight);

  // f[m] = valid_row ? -eps * lse_n((g - C) / eps) : 0, one warp per row,
  // lane l holding columns l, l + 32, ...
  auto row_update = [&](float eps, size_t off) {
    const float sc = LOG2E / eps;
    for (int m = warp; m < M; m += nwarps) {
      const float* crow = s.c + m * ldc;
      float z[NPL];
      float mx = NEG;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int n = lane + 32 * i;
        z[i] = n < N ? (s.g[n] - crow[n]) * sc : NEG;
        mx = fmaxf(mx, z[i]);
      }
      mx = fmaxf(warp_max(mx), NEG / 2);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < NPL; ++i) sum += ex2(z[i] - mx);
      sum = warp_sum(sum);
      if (lane == 0) {
        const float f = s.rv[m] > 0.5f ? -eps * LN2 * (mx + lg2(nan_max(sum, 1e-38f))) : 0.f;
        s.f[m] = f;
        if constexpr (KEEP) h_b[off + m] = f;
      }
    }
  };

  const int cols_per_pass = T / G;
  const int q = tid % G;
  for (int k = 0; k < iters; ++k) {
    const float eps = sched_eps(k, epsilon, anneal, epsilon_init, log_decay);
    row_update(eps, (size_t)k * MN);
    __syncthreads();
    // g[n] = valid_col ? min(0, h) : 0 with h = -eps * lse_m((f - C) / eps),
    // G lanes per column
    const float sc = LOG2E / eps;
    for (int n0 = 0; n0 < N; n0 += cols_per_pass) {
      const int n = n0 + tid / G;
      const int nn = min(n, N - 1);          // lanes past N compute a copy, unused
      float mx = NEG;
#pragma unroll 4
      for (int m = q; m < M; m += G) mx = fmaxf(mx, (s.f[m] - s.c[m * ldc + nn]) * sc);
      for (int o = G >> 1; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mx = fmaxf(mx, NEG / 2);
      float sum = 0.f;
#pragma unroll 4
      for (int m = q; m < M; m += G) sum += ex2((s.f[m] - s.c[m * ldc + nn]) * sc - mx);
      for (int o = G >> 1; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (q == 0 && n < N) {
        const float h = -eps * LN2 * (mx + lg2(nan_max(sum, 1e-38f)));
        s.g[n] = s.cv[n] > 0.5f ? nan_min(h, 0.f) : 0.f;
        if constexpr (KEEP) h_b[(size_t)(k + 1) * MN + M + n] = h;
      }
    }
    __syncthreads();
  }
  row_update(epsilon, (size_t)iters * MN);
  __syncthreads();

  float* x_b = X + (size_t)b * M * N;
  for (int e = tid; e < M * N; e += T) {
    const int m = e / N, n = e % N;
    float v = 0.f;
    if (s.rv[m] > 0.5f && s.cv[n] > 0.5f)
      v = expf(nan_min((s.f[m] + s.g[n] - s.c[m * ldc + n]) / epsilon, 30.f));
    x_b[e] = v;
  }
}

// The Sinkhorn launch's geometry: one warp per row, up to max_threads; G
// lanes per column in the column pass; C's row stride ldc.
void sink_geometry(int M, int N, int max_threads, int* T, int* G, int* ldc) {
  *T = std::min(max_threads, std::max(256, 32 * M));
  *G = 1;
  while (*G < 32 && 2 * *G * N <= *T && *G < M) *G *= 2;
  *ldc = N + 1;                            // column pass: rows of a warp land on other banks
  if (*G > 1)
    while (*ldc % 32 != 32 / *G) ++*ldc;
}

template <int NPL>
int launch_sinkhorn(const float* cosv, const float* inter, const float* at, const float* ap,
                    const float* rm, const float* cm, float* X, float* hist, int B, int M,
                    int N, int S, float iou_weight, float epsilon, int iters, int anneal,
                    float epsilon_init, float log_decay, cudaStream_t st) {
  // NPL >= 16 builds take up to ~70 registers a thread, too many for 1024
  // threads in the SM's 64K: 512 threads a block, a warp taking more rows
  int T, G, ldc;
  sink_geometry(M, N, NPL >= 16 ? 512 : 1024, &T, &G, &ldc);
  const size_t smem = sizeof(float) * ((size_t)M * ldc + 3 * (size_t)M + 3 * (size_t)N);
  auto kernel = hist ? matcher_sinkhorn_kernel<NPL, true> : matcher_sinkhorn_kernel<NPL, false>;
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, T, smem, st>>>(cosv, inter, at, ap, rm, cm, X, hist, M, N, S, ldc, G, iou_weight,
                             epsilon, iters, anneal, epsilon_init, log_decay);
  return static_cast<int>(cudaGetLastError());
}

// ---- 4. the backward (B1') -------------------------------------------------
// The exact gradient of B1's X with respect to emb, both pooling and cost
// masks and the template features, for an upstream gradient gX: the reverse
// of the unrolled Sinkhorn, then the cost's tail (IoU and cosine).  One block
// per batch element, on the forward's scratch (pf, the cosine, the slices'
// partial sums) and the duals its Sinkhorn kept (both kept by the wrapper
// from its forward call), one warp per row and G lanes per column as the
// forward's Sinkhorn, up to 1024 threads (64 registers a thread):
//   1. C again (build_cost), and the duals the forward kept (hist): F[k] (f
//      after row pass k; F[iters] the final one) and H[k] (column pass
//      k - 1's value before the cap at 0), (iters + 1) * (M + N) floats,
//      copied to shared memory where they fit.  So the duals, and the X
//      they give, are the ones the forward returned.
//   2. The reverse sweep.  Every dual enters the Sinkhorn as f + g - C, so
//      each step's increment of dC[m, n] is minus its increment of dg[n] and
//      of df[m]: a row pass adds dh[n] * Q[m, n] (Q the column pass's
//      weights, dh = dg where the cap let h through) and sums df, a column
//      pass adds df[m] * P[m, n] (P the row pass's weights) and sums dg.
//      P = exp((g - C + f) / eps) and Q = exp((f - C + h) / eps) come from
//      the kept duals, as ex2 in base 2.  dC stays in shared memory where it
//      fits beside C, else in a global scratch of B * M * N floats.
//   3. The tail: for each pair, dIoU and dcos from dC; coef = dinter - dunion
//      and the union's row and column sums for the two mask products, which
//      the wrapper runs (torch.bmm: (B, M, N) x (B, N, Pc) and its
//      transpose); the cosine's gradients through rsqrt(|t|^2 + 1e-12) for
//      tf (d_tf, final) and pf, and pf's through the pooling denominator
//      max(area, 1e-6) (d_pooled and d_area, for the wrapper's products with
//      emb and the pooling masks).
// Rounding points as the plain version's autograd: padded pairs take no
// gradient, none above the clip at 30, none through a column whose cap bound,
// none through the union or the denominator where their clamp at 1e-6 bound;
// a NaN travels on, as through autograd.  The bound: latency, as the
// forward's Sinkhorn (2 x 31 dependent passes a block, each a warp reduction
// and a barrier); its bytes (the saved inputs, gX, the outputs) are a few
// microseconds of the card's memory rate.
template <int NPL>
__global__ void __launch_bounds__(1024) matcher_backward_kernel(
    const float* __restrict__ cos_in, const float* __restrict__ inter_part,
    const float* __restrict__ at_part, const float* __restrict__ ap_part,
    const float* __restrict__ pf,          // (B, N, D) the forward's pooled features
    const float* __restrict__ pmask_pool,  // (B, N, P)
    const float* __restrict__ tf,          // (B, M, D)
    const float* __restrict__ rm, const float* __restrict__ cm,
    const float* __restrict__ gX,          // (B, M, N)
    const float* hist_g,                   // (B, iters + 1, M + N): the forward's duals
    float* dc_g,                           // (B, M, N), unless in shared memory
    float* __restrict__ coef,              // (B, M, N): d inter - d union
    float* __restrict__ urow,              // (B, M): d union summed over proposals
    float* __restrict__ ucol,              // (B, N): over templates
    float* __restrict__ d_tf,              // (B, M, D)
    float* __restrict__ d_pooled,          // (B, N, D): d pf / max(area, 1e-6)
    float* __restrict__ d_area,            // (B, N)
    int M, int N, int S, int P, int D, int ldc, int G, float iou_weight, float epsilon,
    int iters, int anneal, float epsilon_init, float log_decay, int dc_shared,
    int hist_shared) {
  extern __shared__ float smem[];
  const Sink s = sink_layout(smem, M, N, ldc);
  float* s_df = s.ap + N;      // M
  float* s_dg = s_df + M;      // N
  float* s_rt = s_dg + N;      // M: 1 / |tf|
  float* s_rp = s_rt + M;      // N: 1 / |pf|
  float* s_area = s_rp + N;    // N: pooling mask areas
  float* s_tail = s_area + N;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const int MN = M + N;
  float* dC = dc_shared ? s_tail : dc_g + (size_t)b * M * N;
  const int ldd = dc_shared ? ldc : N;
  const float* hist_b = hist_g + (size_t)b * (iters + 1) * MN;
  float* hist = hist_shared ? s_tail + (dc_shared ? (size_t)M * ldc : 0)
                            : const_cast<float*>(hist_b);

  // 1. C, the forward's duals (into shared memory where they fit), and the
  // final f and g
  build_cost(s, cos_in, inter_part, at_part, ap_part, rm, cm, b, M, N, S, ldc, iou_weight);
  if (hist_shared)
    for (int e = tid; e < (iters + 1) * MN; e += T) hist[e] = hist_b[e];
  __syncthreads();
  for (int m = tid; m < M; m += T) s.f[m] = hist[(size_t)iters * MN + m];
  for (int n = tid; n < N; n += T)
    s.g[n] = (iters == 0 || s.cv[n] <= 0.5f) ? 0.f
                                             : nan_min(hist[(size_t)iters * MN + M + n], 0.f);
  __syncthreads();

  // 2. the reverse sweep.  X = exp(min(L, 30)), L = (f + g - C) / epsilon on
  // valid pairs, so dL = gX * X where L <= 30, and C's increment is
  // -dL / epsilon; f's gradient is minus the row's sum
  const float* gX_b = gX + (size_t)b * M * N;
  for (int m = warp; m < M; m += nwarps) {
    float rs = 0.f;
    for (int n = lane; n < N; n += 32) {
      float inc = 0.f;
      if (s.rv[m] > 0.5f && s.cv[n] > 0.5f) {
        const float L = (s.f[m] + s.g[n] - s.c[m * ldc + n]) / epsilon;
        const float x = expf(nan_min(L, 30.f));
        if (L <= 30.f) inc = -(gX_b[(size_t)m * N + n] * x) / epsilon;
      }
      dC[m * ldd + n] = inc;
      rs += inc;
    }
    rs = warp_sum(rs);
    if (lane == 0) s_df[m] = s.rv[m] > 0.5f ? -rs : 0.f;
  }
  __syncthreads();

  const int cols_per_pass = T / G, q = tid % G;
  // column pass of step j: P from (F[j], g_j) at eps; dC += df[m] * P and
  // dg[n] = -(the column's increments, with dC's old entries when with_old:
  // the final step's g also met X directly)
  auto p_pass = [&](int j, float eps, bool with_old) {
    const float* f = hist + (size_t)j * MN;
    const float* hj = hist + (size_t)j * MN + M;
    const float sc = LOG2E / eps;
    for (int n0 = 0; n0 < N; n0 += cols_per_pass) {
      const int n = n0 + tid / G;
      const int nn = min(n, N - 1);          // lanes past N compute a copy, unused
      const float gn = (j == 0 || s.cv[nn] <= 0.5f) ? 0.f : nan_min(hj[nn], 0.f);
      float part = 0.f;
      for (int m = q; m < M; m += G) {
        float inc = 0.f;
        if (s.rv[m] > 0.5f && s.cv[nn] > 0.5f)
          inc = s_df[m] * ex2((gn - s.c[m * ldc + nn] + f[m]) * sc);
        float* d = dC + m * ldd + nn;
        if (with_old) part += *d;
        if (n < N) *d += inc;
        part += inc;
      }
      for (int o = G >> 1; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (q == 0 && n < N) s_dg[n] = -part;
    }
  };
  // row pass of step j: the column pass's weights Q from (F[j], H[j + 1]);
  // dC += dh[n] * Q with dh = dg where h <= 0 (the cap let it through);
  // df[m] = -(the row's increments) on valid rows
  auto q_pass = [&](int j, float eps) {
    const float* f = hist + (size_t)j * MN;
    const float* h = hist + (size_t)(j + 1) * MN + M;
    const float sc = LOG2E / eps;
    for (int m = warp; m < M; m += nwarps) {
      float rs = 0.f;
      for (int n = lane; n < N; n += 32) {
        float inc = 0.f;
        if (s.rv[m] > 0.5f && s.cv[n] > 0.5f) {
          const float hn = h[n];
          const float dh = hn <= 0.f ? s_dg[n] : 0.f;
          inc = dh * ex2((f[m] - s.c[m * ldc + n] + hn) * sc);
        }
        dC[m * ldd + n] += inc;
        rs += inc;
      }
      rs = warp_sum(rs);
      if (lane == 0) s_df[m] = s.rv[m] > 0.5f ? -rs : 0.f;
    }
  };
  p_pass(iters, epsilon, true);
  __syncthreads();
  for (int j = iters - 1; j >= 0; --j) {
    const float eps = sched_eps(j, epsilon, anneal, epsilon_init, log_decay);
    q_pass(j, eps);
    __syncthreads();
    p_pass(j, eps, false);
    __syncthreads();
  }

  // 3. the tail.  Per pair: C = lam (1 - iou) + (1 - lam)(1 - cos), iou =
  // inter / max(union, 1e-6); d union (kept in C's place for the sums), coef,
  // and dcos in dC's place
  for (int e = tid; e < M * N; e += T) {
    const int m = e / N, n = e % N;
    float inter = 0.f;
    for (int y = 0; y < S; ++y) inter += inter_part[((size_t)b * S + y) * M * N + e];
    const float uni = s.at[m] + s.ap[n] - inter;
    const float U = nan_max(uni, 1e-6f);
    const float dc = dC[m * ldd + n];
    const float d_iou = -(iou_weight * dc);
    const float du = uni >= 1e-6f ? -d_iou * ((inter / U) / U) : 0.f;
    coef[(size_t)b * M * N + e] = d_iou / U - du;
    s.c[m * ldc + n] = du;
    dC[m * ldd + n] = -((1.f - iou_weight) * dc);
  }
  __syncthreads();

  const float* tf_b = tf + (size_t)b * M * D;
  const float* pf_b = pf + (size_t)b * N * D;
  const float* pm_b = pmask_pool + (size_t)b * N * P;
  for (int m = warp; m < M; m += nwarps) {
    float u = 0.f, ss = 0.f;
    for (int n = lane; n < N; n += 32) u += s.c[m * ldc + n];
    for (int d = lane; d < D; d += 32) ss = fmaf(tf_b[(size_t)m * D + d], tf_b[(size_t)m * D + d], ss);
    u = warp_sum(u);
    ss = warp_sum(ss);
    if (lane == 0) {
      urow[(size_t)b * M + m] = u;
      s_rt[m] = rsqrtf(ss + 1e-12f);
    }
  }
  for (int n = warp; n < N; n += nwarps) {
    float u = 0.f, ss = 0.f, a = 0.f;
    for (int m = lane; m < M; m += 32) u += s.c[m * ldc + n];
    for (int d = lane; d < D; d += 32) ss = fmaf(pf_b[(size_t)n * D + d], pf_b[(size_t)n * D + d], ss);
    for (int p = lane; p < P; p += 32) a += pm_b[(size_t)n * P + p];
    u = warp_sum(u);
    ss = warp_sum(ss);
    a = warp_sum(a);
    if (lane == 0) {
      ucol[(size_t)b * N + n] = u;
      s_rp[n] = rsqrtf(ss + 1e-12f);
      s_area[n] = a;
    }
  }
  __syncthreads();

  // d_tf = rt * dtn - rt^3 (dtn . tf) tf with dtn = dcos @ (pf * rp), one
  // warp per template row, lanes over the feature dims, DPL of them a lane
  // at a time so that their loads are in flight together (dtn parked in d_tf)
  float* dtf_b = d_tf + (size_t)b * M * D;
  for (int m = warp; m < M; m += nwarps) {
    float dot = 0.f;
    for (int d0 = lane; d0 < D; d0 += 32 * DPL) {
      float acc[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
#pragma unroll 2
      for (int n = 0; n < N; ++n) {
        const float w = dC[m * ldd + n] * s_rp[n];
        const float* prow = pf_b + (size_t)n * D + d0;
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          if (d0 + 32 * i < D) acc[i] = fmaf(w, prow[32 * i], acc[i]);
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = d0 + 32 * i;
        if (d < D) {
          dtf_b[(size_t)m * D + d] = acc[i];
          dot = fmaf(acc[i], tf_b[(size_t)m * D + d], dot);
        }
      }
    }
    dot = warp_sum(dot);
    const float r = s_rt[m], r3 = r * r * r;
    for (int d = lane; d < D; d += 32) {
      const size_t i = (size_t)m * D + d;
      dtf_b[i] = r * dtf_b[i] - r3 * dot * tf_b[i];
    }
  }
  // d pf likewise from dpn = dcos^T @ (tf * rt), one warp per proposal; then
  // d_pooled = d pf / den and d_area = -sum(d pf * pf) / den where area >= 1e-6
  float* dpo_b = d_pooled + (size_t)b * N * D;
  for (int n = warp; n < N; n += nwarps) {
    float dot = 0.f;
    for (int d0 = lane; d0 < D; d0 += 32 * DPL) {
      float acc[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
#pragma unroll 2
      for (int m = 0; m < M; ++m) {
        const float w = dC[m * ldd + n] * s_rt[m];
        const float* trow = tf_b + (size_t)m * D + d0;
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          if (d0 + 32 * i < D) acc[i] = fmaf(w, trow[32 * i], acc[i]);
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = d0 + 32 * i;
        if (d < D) {
          dpo_b[(size_t)n * D + d] = acc[i];
          dot = fmaf(acc[i], pf_b[(size_t)n * D + d], dot);
        }
      }
    }
    dot = warp_sum(dot);
    const float r = s_rp[n], r3 = r * r * r;
    const float area = s_area[n], den = nan_max(area, 1e-6f);
    float dd = 0.f;
    for (int d = lane; d < D; d += 32) {
      const size_t i = (size_t)n * D + d;
      const float dpf = r * dpo_b[i] - r3 * dot * pf_b[i];
      dpo_b[i] = dpf / den;
      dd = fmaf(dpf, pf_b[i], dd);
    }
    dd = warp_sum(dd);
    if (lane == 0) d_area[(size_t)b * N + n] = area >= 1e-6f ? -dd / den : 0.f;
  }
}

template <int NPL>
int launch_backward(const float* cosv, const float* inter, const float* at, const float* ap,
                    const float* pf, const float* pmask_pool, const float* tf, const float* rm,
                    const float* cm, const float* gX, const float* hist, float* dC, float* coef,
                    float* urow, float* ucol, float* d_tf, float* d_pooled, float* d_area,
                    int B, int M, int N, int S, int P, int D, float iou_weight, float epsilon,
                    int iters, int anneal, float epsilon_init, float log_decay,
                    cudaStream_t st) {
  int T, G, ldc;
  sink_geometry(M, N, 1024, &T, &G, &ldc);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // C and the row / column values, then dC and the history where they fit
  size_t floats = (size_t)M * ldc + 5 * (size_t)M + 6 * (size_t)N;
  int dc_shared = 0, hist_shared = 0;
  if (sizeof(float) * (floats + (size_t)M * ldc) <= (size_t)optin) {
    floats += (size_t)M * ldc;
    dc_shared = 1;
  }
  const size_t hist_floats = (size_t)(iters + 1) * (M + N);
  if (sizeof(float) * (floats + hist_floats) <= (size_t)optin) {
    floats += hist_floats;
    hist_shared = 1;
  }
  const size_t smem = sizeof(float) * floats;
  err = set_smem(reinterpret_cast<const void*>(matcher_backward_kernel<NPL>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  matcher_backward_kernel<NPL><<<B, T, smem, st>>>(
      cosv, inter, at, ap, pf, pmask_pool, tf, rm, cm, gX, hist, dC, coef, urow, ucol, d_tf,
      d_pooled, d_area, M, N, S, P, D, ldc, G, iou_weight, epsilon, iters, anneal,
      epsilon_init, log_decay, dc_shared, hist_shared);
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
                             float* X, float* hist, int B, int M, int N, int Pc, int D,
                             float epsilon,
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
    return launch_sinkhorn<P>(cosv, inter, at, ap, rm, cm, X, hist, B, M, N, S,          \
                              iou_weight, epsilon, iters, anneal, epsilon_init, log_decay, \
                              st);
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

// hist: null, or B * (iters + 1) * (M + N) floats for the Sinkhorn's duals,
// which B1' reads.
extern "C" int dmm_fused_pool_cost_match(
    const float* emb, const float* pmask_pool, const float* tm, const float* pm,
    const float* tf, const float* rm, const float* cm, float* scratch, float* X, float* hist,
    int B, int M, int N, int P, int Pc, int D, float epsilon, int iters, float iou_weight,
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
  return launch_cost_and_sinkhorn(tm, pm, tf, pf, rm, cm, scratch + (size_t)B * N * D, X,
                                  hist, B, M, N, Pc, D, epsilon, iters, iou_weight, anneal,
                                  epsilon_init, log_decay, st);
}

// Kernel B3: cost from pooled features, then Sinkhorn at a fixed epsilon.
extern "C" int dmm_fused_cost_match(const float* tm, const float* pm, const float* tf,
                                    const float* pf, const float* rm, const float* cm,
                                    float* scratch, float* X, int B, int M, int N, int P,
                                    int D, float epsilon, int iters, float iou_weight,
                                    void* stream) {
  if (bad_sizes(B, M, N, P, D)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_cost_and_sinkhorn(tm, pm, tf, pf, rm, cm, scratch, X, nullptr, B, M, N, P, D,
                                  epsilon, iters, iou_weight, 0, 0.f, 0.f,
                                  static_cast<cudaStream_t>(stream));
}

// Kernel B1': the backward of B1 on its forward's scratch (pf, then the cost
// phase's cosine and partial sums) and duals (hist: B * (iters + 1) * (M + N)
// floats), as dmm_fused_pool_cost_match left them.  dC: B * M * N floats,
// used where it does not fit in shared memory.  Writes coef (B, M, N), urow
// (B, M), ucol (B, N), d_tf (B, M, D), d_pooled (B, N, D), d_area (B, N).
extern "C" int dmm_fused_pool_cost_match_backward(
    const float* pmask_pool, const float* tf, const float* rm, const float* cm,
    const float* gX, const float* scratch, const float* hist, float* dC, float* coef,
    float* urow,
    float* ucol, float* d_tf, float* d_pooled, float* d_area, int B, int M, int N, int P,
    int Pc, int D, float epsilon, int iters, float iou_weight, int anneal, float epsilon_init,
    float log_decay, void* stream) {
  if (bad_sizes(B, M, N, Pc, D) || P < 1 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int S = pixel_slices(B, N, Pc);
  const float* pf = scratch;
  const float* cosv = pf + (size_t)B * N * D;
  const float* inter = cosv + (size_t)B * M * N;
  const float* at = inter + (size_t)B * S * M * N;
  const float* ap = at + (size_t)B * S * M;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int npl = cdiv(N, 32);
#define DMM_BACKWARD(NP)                                                                    \
  if (npl <= NP)                                                                            \
    return launch_backward<NP>(cosv, inter, at, ap, pf, pmask_pool, tf, rm, cm, gX, hist, dC, \
                               coef, urow, ucol, d_tf, d_pooled, d_area, B, M, N, S, P, D,  \
                               iou_weight, epsilon, iters, anneal, epsilon_init, log_decay, \
                               st);
  DMM_BACKWARD(1) DMM_BACKWARD(2) DMM_BACKWARD(4) DMM_BACKWARD(8) DMM_BACKWARD(16)
  DMM_BACKWARD(32)
#undef DMM_BACKWARD
  return static_cast<int>(cudaErrorInvalidValue);
}
