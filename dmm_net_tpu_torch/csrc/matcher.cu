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
// VJP of the jnp reference): two launches, matcher_sweep_kernel and
// matcher_tail_kernel (section 4), on B1's scratch and what its forward kept.
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
// the kernel's KEEP build also writes each pass's duals, C, the
// intersections and the mask areas for B1'.  The pooling launch keeps the
// masks' areas and the cost launch the cosine's inverse norms in the scratch
// for it too.  The log-sum-exps run in base 2 with log2(e) / eps
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

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
            float* __restrict__ area_out,           // (B, N): the mask areas for B1', or null
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
    if (area_out && blockIdx.y == 0 && dq == 0) area_out[(size_t)b * N + n0 + i] = area;
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
//   y == S: cosine over D -> cos (B, M, N), and the inverse norms the cosine
//           used, rt (B, M) (blocks x == 0) and rp (B, N), for B1' (where
//           rt_out and rp_out are not null)
template <int R>
__global__ void __launch_bounds__(THREADS)
matcher_cost_kernel(const float* __restrict__ tm,   // (B, M, Pc)
                    const float* __restrict__ pm,   // (B, N, Pc)
                    const float* __restrict__ tf,   // (B, M, D)
                    const float* __restrict__ pf,   // (B, N, D)
                    float* __restrict__ cos_out, float* __restrict__ inter_part,
                    float* __restrict__ at_part, float* __restrict__ ap_part,
                    float* __restrict__ rt_out, float* __restrict__ rp_out,
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
      if (rp_out && g == 0) rp_out[(size_t)b * N + n0 + i] = pn;
    }
    if (rt_out && blockIdx.x == 0 && i == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int m = g + MG * r;
        if (m < M) rt_out[(size_t)b * M + m] = rsqrtf(ra[r] + 1e-12f);
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
                float* cosv, float* inter, float* at, float* ap, float* rt, float* rp, int B,
                int M, int N, int Pc, int D, int S, int chunk, cudaStream_t st) {
  const size_t smem = sizeof(float) * 2 * (size_t)(M + NT) * LDT;
  cudaError_t err = set_smem(reinterpret_cast<const void*>(matcher_cost_kernel<R>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  matcher_cost_kernel<R><<<dim3((N + NT - 1) / NT, S + 1, B), THREADS, smem, st>>>(
      tm, pm, tf, pf, cosv, inter, at, ap, rt, rp, M, N, Pc, D, S, chunk);
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

// What B1''s forward keeps of its cost for B1' (KEEP builds), each batch
// element's part: C as built (PAD_COST on padded pairs), the intersections
// and both mask areas summed over the slices.
struct Kept {
  float* c;       // M x N
  float* inter;   // M x N
  float* at;      // M
  float* ap;      // N
};

// The areas and the validity from the cost phase's partial sums (added in
// slice order), f = g = 0, then C; KEEP builds also write them to `kept`.
template <bool KEEP>
__device__ __forceinline__ void build_cost(const Sink& s, const Kept& kept,
                                           const float* __restrict__ cos_in,
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
    if constexpr (KEEP) kept.at[m] = a;
    s.rv[m] = rm[(size_t)b * M + m] > 0.5f ? 1.f : 0.f;
    s.f[m] = 0.f;
  }
  for (int n = tid; n < N; n += T) {
    float a = 0.f;
    for (int y = 0; y < S; ++y) a += ap_part[((size_t)b * S + y) * N + n];
    s.ap[n] = a;
    if constexpr (KEEP) kept.ap[n] = a;
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
    if constexpr (KEEP) {
      kept.c[e] = s.c[m * ldc + n];
      kept.inter[e] = inter;
    }
  }
  __syncthreads();
}

// Batch element b's Kept parts in a kept buffer of B elements.
__host__ __device__ __forceinline__ Kept kept_parts(float* kept, int b, int B, int M, int N,
                                                     int iters) {
  float* c = kept + (size_t)B * (iters + 1) * (M + N);
  float* inter = c + (size_t)B * M * N;
  float* at = inter + (size_t)B * M * N;
  float* ap = at + (size_t)B * M;
  const size_t mn = (size_t)b * M * N;
  return Kept{c + mn, inter + mn, at + (size_t)b * M, ap + (size_t)b * N};
}

__device__ __forceinline__ float sched_eps(int k, float epsilon, int anneal, float epsilon_init,
                                           float log_decay) {
  return anneal ? fmaxf(epsilon_init * expf((float)k * log_decay), epsilon) : epsilon;
}

// NPL: columns per lane in the row pass (N <= 32 * NPL), held in registers.
// KEEP: also write what B1' reads to hist (kept_floats): first the duals'
// history, (B, iters + 1, M + N): F[k] (f after row pass k; F[iters] the
// final one) at k * (M + N), H[k + 1] (column pass k's value before its cap)
// at (k + 1) * (M + N) + M; then the cost's Kept parts, (B, M, N) C, (B, M,
// N) intersections, (B, M) and (B, N) mask areas.
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
  Kept kept{};
  if constexpr (KEEP) kept = kept_parts(hist, b, gridDim.x, M, N, iters);
  build_cost<KEEP>(s, kept, cos_in, inter_part, at_part, ap_part, rm, cm, b, M, N, S, ldc,
                   iou_weight);

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
// of the unrolled Sinkhorn, then the cost's tail (IoU and cosine).  Two
// launches on what B1's forward kept when an input needed a gradient (the
// scratch: pf, the cosine's inverse norms, the pooling masks' areas; the
// kept buffer: the Sinkhorn's duals F[k] and H[k], C as built, the
// intersections and both mask areas summed over the slices), so nothing of
// the forward is computed again:
//   4. matcher_sweep_kernel, the reverse sweep -> dC (B, M, N).  Every dual
//      enters the Sinkhorn as f + g - C, so each step's increment of dC[m, n]
//      is minus its increment of dg[n] and of df[m]: a row pass adds
//      dh[n] * Q[m, n] (Q the column pass's weights, dh = dg where the cap
//      let h through) and sums df, a column pass adds df[m] * P[m, n] (P the
//      row pass's weights) and sums dg; P and Q come from the kept duals, as
//      ex2 in base 2.  The launch is sized to the pairs: a batch element
//      takes as many warps as own its columns (a cluster of `cluster` blocks
//      of them where one block cannot hold its pairs), and a thread owns one
//      whole column with all its rows' C and dC in registers.  A column's sum
//      stays inside its thread; a row's sum is a reduce-scatter over the
//      warp's shuffles and, across warps, one barrier of the element's own
//      group (its block's, or its cluster's with the warps' partial sums
//      read through distributed shared memory), added in a fixed order.
//      The duals' history is staged in shared memory, so the 2 x iters + 2
//      dependent passes read no device memory.  At p5 (8 x 64 pairs) two
//      warps hold an element, 8 pairs a thread.
//   5. matcher_tail_kernel, the cost's tail, blocks of four template rows or
//      four proposals of each element, across the card: per pair dIoU and
//      dcos from dC; coef = dinter - dunion and the union's row and column
//      sums for the two mask products, which the wrapper runs (torch.bmm:
//      (B, M, N) x (B, N, Pc) and its transpose); the cosine's gradients
//      through the forward's inverse norms for tf (d_tf, final) and pf, and
//      pf's through the pooling denominator max(area, 1e-6) (d_pooled and
//      d_area, for the wrapper's products with emb and the pooling masks).
//      Each feature row a block loads serves its four rows.
// Rounding points as the plain version's autograd: padded pairs take no
// gradient, none above the clip at 30, none through a column whose cap bound,
// none through the union or the denominator where their clamp at 1e-6 bound;
// a NaN travels on, as through autograd.  Every sum is taken in a fixed
// order, so two backwards give the same bits.
//
// What bounds it on an H100: the sweep is a latency chain of 2 x iters + 2
// dependent passes per element, each its pairs' exponentials and a row
// reduction (shuffles, and a barrier where warps share an element); its
// ~0.6 us a step at p5 are its two warps running their instructions in
// order, not the card's rates.  The tail's bytes (pf, tf, the kept pairs, the outputs) are
// a few microseconds of the card's memory rate at most.

// The most threads a sweep block of row capacity R takes: each holds C and
// dC of R pairs in registers.
__host__ __device__ constexpr int sweep_max_threads(int R) {
  return R <= 8 ? 1024 : R <= 16 ? 512 : 256;
}

constexpr size_t SWEEP_HIST_BYTES = 96 * 1024;   // the duals' history in shared memory, at most

// A warp's reduce-scatter of R row sums, one value a row per lane: after it
// lane l holds the warp's sum of rows l * R / 32 + i, i < max(R / 32, 1)
// (for R < 32 the 32 / R lanes of a row hold the same value).  Halving steps
// while a lane holds more than one row, then whole xor steps; the order of
// every addition is fixed.
template <int R, int O>
__device__ __forceinline__ void reduce_scatter(float (&v)[R], int lane) {
  if constexpr (O >= 1) {
    constexpr int h = R * O / 32;
    if constexpr (h >= 1) {
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const float send = up ? v[i] : v[i + h];
        const float keep = up ? v[i + h] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
    }
    reduce_scatter<R, O / 2>(v, lane);
  }
}

// R: row capacity (M <= R, a power of two >= 8); thread tid of rank `rank`
// owns column n = rank * T + tid (a warp's loads of a row are contiguous);
// GROUP: more than one warp holds an element (warps x cluster > 1).  Block
// x = b * cluster + rank.  Shared memory: the warps' row sums and each
// warp's copy of df, both by the parity of the step (so one barrier a step
// suffices), the steps' scales log2(e) / eps, then `chunk` rows of the
// duals' history, row k as F[k] (M) and H[k] of the block's T columns,
// copied in with cp.async before the steps that read them: the steps read
// no device memory.  Every pass computes all its pairs' terms and selects
// the valid ones: no branch (and no reconvergence) sits in the chain of
// dependent sums.
template <int R, bool GROUP>
__global__ void __launch_bounds__(sweep_max_threads(R))
matcher_sweep_kernel(const float* __restrict__ hist,   // (B, iters + 1, M + N): F, H
                     const float* __restrict__ kc,     // (B, M, N): C as the forward built it
                     const float* __restrict__ rm, const float* __restrict__ cm,
                     const float* __restrict__ gX,     // (B, M, N)
                     float* __restrict__ dC_out,       // (B, M, N)
                     int M, int N, int cluster, float epsilon, int iters, int anneal,
                     float epsilon_init, float log_decay, int chunk) {
  extern __shared__ __align__(16) float smem[];
  constexpr int KR = R >= 32 ? R / 32 : 1;       // rows a lane holds after the reduce-scatter
  constexpr int LPR = R >= 32 ? 1 : 32 / R;      // lanes that hold a row (R < 32)
  const int T = blockDim.x, W = T >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / cluster, rank = blockIdx.x % cluster;
  const int MN = M + N, hw = M + T;
  const int row0 = R >= 32 ? lane * KR : lane / LPR;
  const bool writer = lane % LPR == 0;
  float* s_part = smem;                          // [2][W][R]
  float* s_df = s_part + 2 * W * R;              // [2][W][R]
  float* s_sc = s_df + 2 * W * R;                // [iters + 1], padded to 4
  float* s_hist = s_sc + ((iters + 4) & ~3);     // [chunk][hw]
  const float* hist_b = hist + (size_t)b * (iters + 1) * MN;
  const int n = rank * T + tid;
  const bool cv = n < N && cm[(size_t)b * N + n] > 0.5f;
  // history rows [first, last] into shared memory (the caller syncs)
  int lo = 0;
  auto load_rows = [&](int first, int last) {
    lo = first;
    for (int r = 0; r <= last - first; ++r) {
      const float* src = hist_b + (size_t)(first + r) * MN;
      float* dst = s_hist + r * hw;
      for (int i = tid; i < M; i += T) cp_async4(dst + i, src + i);
      if (n < N) cp_async4(dst + M + tid, src + M + n);
      else dst[M + tid] = 0.f;
    }
    cp_async_commit();
  };
  load_rows(max(0, iters + 1 - chunk), iters);
  for (int k = tid; k < iters; k += T)
    s_sc[k] = LOG2E / sched_eps(k, epsilon, anneal, epsilon_init, log_decay);

  // the valid rows (bit m), C and gX of this thread's column in registers
  const unsigned lo_rows = __ballot_sync(0xffffffffu, lane < M && rm[(size_t)b * M + lane] > 0.5f);
  const unsigned hi_rows =
      __ballot_sync(0xffffffffu, lane + 32 < M && rm[(size_t)b * M + lane + 32] > 0.5f);
  const unsigned long long rows = lo_rows | (unsigned long long)hi_rows << 32;
  const float* kc_b = kc + (size_t)b * M * N;
  const float* gX_b = gX + (size_t)b * M * N;
  float c[R], d[R], v[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const bool in = m < M && n < N;
    c[m] = in ? kc_b[(size_t)m * N + n] : 0.f;
    d[m] = in ? gX_b[(size_t)m * N + n] : 0.f;
  }

  auto pair = [&](int m) { return cv & (((rows >> m) & 1ull) != 0); };
  const float* hk = nullptr;             // history row k in shared memory
  auto fk = [&](int m) { return m < M ? hk[m] : 0.f; };
  // g_k = min(H[k], 0) on a valid column, 0 at k = 0
  auto g_of = [&](int k) { return (k == 0 || !cv) ? 0.f : nan_min(hk[M + tid], 0.f); };
  // df[m] = -(row m's sum of v) on valid rows, into this warp's copy s_df[par]
  auto row_sums = [&](int par) {
    reduce_scatter<R, 16>(v, lane);
    float tot[KR];
#pragma unroll
    for (int i = 0; i < KR; ++i) tot[i] = v[i];
    if constexpr (GROUP) {
      float* part = s_part + par * W * R;
      if (writer)
#pragma unroll
        for (int i = 0; i < KR; ++i) part[warp * R + row0 + i] = v[i];
      if (cluster > 1) cg::this_cluster().sync();
      else __syncthreads();
#pragma unroll
      for (int i = 0; i < KR; ++i) tot[i] = 0.f;
      for (int r = 0; r < cluster; ++r) {
        const float* pr = cluster > 1 ? cg::this_cluster().map_shared_rank(part, r) : part;
        for (int w = 0; w < W; ++w)
#pragma unroll
          for (int i = 0; i < KR; ++i) tot[i] += pr[w * R + row0 + i];
      }
    }
    float* dst = s_df + (par * W + warp) * R;
    if (writer)
#pragma unroll
      for (int i = 0; i < KR; ++i) dst[row0 + i] = (rows >> (row0 + i) & 1) ? -tot[i] : 0.f;
    __syncwarp();
  };
  // column pass k reversed: dC += df[m] * P with P from (F[k], g_k); dg =
  // -(the column's increments, with dC's old entries when with_old: the
  // final g also met X)
  float g = 0.f, dg = 0.f;
  auto p_pass = [&](float sc, int par, bool with_old) {
    const float* df = s_df + (par * W + warp) * R;
    float cs = 0.f;
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const float pw = ex2((g - c[m] + fk(m)) * sc);
      const float inc = pair(m) ? df[m] * pw : 0.f;
      cs += with_old ? d[m] : 0.f;
      d[m] += inc;
      cs += inc;
    }
    dg = -cs;
  };
  cp_async_wait<0>();
  __syncthreads();

  // X = exp(min(L, 30)), L = (f + g - C) / epsilon on valid pairs, so dL =
  // gX * X where L <= 30, and C's increment is -dL / epsilon; f's gradient
  // is minus the row's sum (d holds gX until here)
  hk = s_hist + (iters - lo) * hw;
  g = g_of(iters);
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const float L = (fk(m) + g - c[m]) / epsilon;
    const float x = expf(nan_min(L, 30.f));
    const float inc = pair(m) && L <= 30.f ? -(d[m] * x) / epsilon : 0.f;
    d[m] = inc;
    v[m] = inc;
  }
  row_sums(iters & 1);
  p_pass(LOG2E / epsilon, iters & 1, true);
  for (int k = iters - 1; k >= 0; --k) {
    if (k < lo) {                        // the next chunk of the history
      __syncthreads();
      load_rows(max(0, k + 2 - chunk), k + 1);
      cp_async_wait<0>();
      __syncthreads();
      hk = s_hist + (k + 1 - lo) * hw;
    }
    const float sc = s_sc[k];
    const float h = hk[M + tid];          // H[k + 1]
    hk -= hw;                             // row k from here on
    g = g_of(k);
    // row pass k reversed: dC += dh[n] * Q with Q from (F[k], H[k + 1]) and
    // dh = dg where h <= 0 (the cap let it through); df = -(the row's sum)
    const float dh = h <= 0.f ? dg : 0.f;
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const float qw = ex2((fk(m) - c[m] + h) * sc);
      const float inc = pair(m) ? dh * qw : 0.f;
      d[m] += inc;
      v[m] = inc;
    }
    row_sums(k & 1);
    p_pass(sc, k & 1, false);
  }

  float* o = dC_out + (size_t)b * M * N;
#pragma unroll
  for (int m = 0; m < R; ++m)
    if (m < M && n < N) o[(size_t)m * N + n] = d[m];
  if (GROUP && cluster > 1) cg::this_cluster().sync();   // no block leaves while another reads
}

constexpr int TAIL_WARPS = 4;          // rows a block, one a warp; quarters of the pairs
constexpr int TAIL_THREADS = 32 * TAIL_WARPS;
constexpr int TAIL_DC = 32 * DPL;      // feature dims a pass, DPL a lane

// Block (x, b): TAIL_WARPS template rows m = 4x.. (x < ceil(M / 4)), or
// proposals n = 4(x - ceil(M / 4)).. of element b.
//   1. Warp r takes its row's pairs (lanes over the row's proposals, or the
//      proposal's rows): du, coef (template rows only), the union's sum,
//      and w = dcos * (the other side's inverse norm) into shared memory.
//   2. The four rows' acc[d] = sum over the pairs of w * (the other side's
//      feature d): warp q takes a quarter of the pairs for all four rows,
//      each feature row it loads used four times, DPL dims a lane per pass;
//      the quarters meet in shared memory and warp r adds its row's in
//      quarter order.  Then the row's own features x: r * acc - r^3
//      (acc . x) x, and for proposals pf's pooling denominator.
__global__ void __launch_bounds__(TAIL_THREADS)
matcher_tail_kernel(const float* __restrict__ dC, const float* __restrict__ k_inter,
                    const float* __restrict__ k_at, const float* __restrict__ k_ap,
                    const float* __restrict__ rt, const float* __restrict__ rp,
                    const float* __restrict__ area, const float* __restrict__ pf,
                    const float* __restrict__ tf, float* __restrict__ coef,
                    float* __restrict__ urow, float* __restrict__ ucol,
                    float* __restrict__ d_tf, float* __restrict__ d_pooled,
                    float* __restrict__ d_area, int M, int N, int D, float iou_weight) {
  __shared__ float s_w[TAIL_WARPS][MAX_N];
  __shared__ float s_acc[TAIL_WARPS][TAIL_WARPS][TAIL_DC];   // [quarter][row][dim]
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tblocks = (M + TAIL_WARPS - 1) / TAIL_WARPS;
  const bool trow = (int)blockIdx.x < tblocks;
  const int first = ((int)blockIdx.x - (trow ? 0 : tblocks)) * TAIL_WARPS;
  const int nrows = trow ? M : N, len = trow ? N : M;
  const int row = first + warp;
  const bool live = row < nrows;

  float u = 0.f;
  for (int e = lane; e < len; e += 32) {
    float w = 0.f;
    if (live) {
      const int m = trow ? row : e, n = trow ? e : row;
      const size_t pi = ((size_t)b * M + m) * N + n;
      const float inter = k_inter[pi];
      const float uni = k_at[(size_t)b * M + m] + k_ap[(size_t)b * N + n] - inter;
      const float U = nan_max(uni, 1e-6f);
      const float dc = dC[pi];
      const float d_iou = -(iou_weight * dc);
      const float du = uni >= 1e-6f ? -d_iou * ((inter / U) / U) : 0.f;
      if (trow) coef[pi] = d_iou / U - du;
      u += du;
      w = -((1.f - iou_weight) * dc) * (trow ? rp[(size_t)b * N + n] : rt[(size_t)b * M + m]);
    }
    s_w[warp][e] = w;
  }
  u = warp_sum(u);
  if (live && lane == 0) {
    if (trow) urow[(size_t)b * M + row] = u;
    else ucol[(size_t)b * N + row] = u;
  }
  __syncthreads();

  const float* other = trow ? pf + (size_t)b * N * D : tf + (size_t)b * M * D;
  const float* x = (trow ? tf + (size_t)b * M * D : pf + (size_t)b * N * D) + (size_t)row * D;
  float* out = (trow ? d_tf + (size_t)b * M * D : d_pooled + (size_t)b * N * D) + (size_t)row * D;
  const int e0 = len * warp / TAIL_WARPS, e1 = len * (warp + 1) / TAIL_WARPS;
  float dot = 0.f;
  for (int dc = 0; dc < D; dc += TAIL_DC) {
    float acc[TAIL_WARPS][DPL];
#pragma unroll
    for (int r = 0; r < TAIL_WARPS; ++r)
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
#pragma unroll 2
    for (int e = e0; e < e1; ++e) {
      float o[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = dc + lane + 32 * i;
        o[i] = d < D ? other[(size_t)e * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < TAIL_WARPS; ++r) {
        const float w = s_w[r][e];
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(w, o[i], acc[r][i]);
      }
    }
#pragma unroll
    for (int r = 0; r < TAIL_WARPS; ++r)
#pragma unroll
      for (int i = 0; i < DPL; ++i) s_acc[warp][r][lane + 32 * i] = acc[r][i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = dc + lane + 32 * i;
      float t = s_acc[0][warp][lane + 32 * i];
#pragma unroll
      for (int q = 1; q < TAIL_WARPS; ++q) t += s_acc[q][warp][lane + 32 * i];
      if (live && d < D) {
        out[d] = t;
        dot = fmaf(t, x[d], dot);
      }
    }
    __syncthreads();                   // s_acc is free for the next pass
  }
  if (!live) return;
  dot = warp_sum(dot);
  const float r = trow ? rt[(size_t)b * M + row] : rp[(size_t)b * N + row];
  const float r3 = r * r * r;
  if (trow) {
    for (int d = lane; d < D; d += 32) out[d] = r * out[d] - r3 * dot * x[d];
    return;
  }
  // d pf, then d_pooled = d pf / den and d_area = -sum(d pf * pf) / den
  // where area >= 1e-6
  const float a = area[(size_t)b * N + row], den = nan_max(a, 1e-6f);
  float dd = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float dpf = r * out[d] - r3 * dot * x[d];
    out[d] = dpf / den;
    dd = fmaf(dpf, x[d], dd);
  }
  dd = warp_sum(dd);
  if (lane == 0) d_area[(size_t)b * N + row] = a >= 1e-6f ? -dd / den : 0.f;
}

template <int R>
cudaError_t launch_sweep(const float* hist, const float* kc, const float* rm, const float* cm,
                         const float* gX, float* dC, int B, int M, int N, int warps,
                         int cluster, float epsilon, int iters, int anneal, float epsilon_init,
                         float log_decay, size_t optin, cudaStream_t st) {
  const int T = 32 * warps;
  // the history's rows in chunks of as many as fit (at least the 2 a step reads)
  const size_t hw = (size_t)M + (size_t)T;
  const size_t fixed = 4 * (size_t)warps * R + ((iters + 4) & ~3);
  const size_t room = std::min(optin, SWEEP_HIST_BYTES) / sizeof(float);
  const int chunk = static_cast<int>(std::min<size_t>(iters + 1, room > fixed ? (room - fixed) / hw : 0));
  if (chunk < std::min(iters + 1, 2)) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (fixed + chunk * hw);
  auto kernel = warps * cluster > 1 ? matcher_sweep_kernel<R, true>
                                    : matcher_sweep_kernel<R, false>;
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cluster);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, hist, kc, rm, cm, gX, dC, M, N, cluster, epsilon,
                            iters, anneal, epsilon_init, log_decay, chunk);
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

// The scratch after pf: the cost phase's cosine (B, M, N) and per-slice
// partial sums, inter (B, S, M, N), at (B, S, M), ap (B, S, N); the
// cosine's inverse norms rt (B, M) and rp (B, N); the pooling masks' areas
// (B, N), which only the pooling launch writes.  B1' reads pf, rt, rp and
// area.
struct CostScratch {
  float *cosv, *inter, *at, *ap, *rt, *rp, *area;
};

CostScratch cost_parts(float* base, int B, int M, int N, int S) {
  CostScratch c;
  c.cosv = base;
  c.inter = c.cosv + (size_t)B * M * N;
  c.at = c.inter + (size_t)B * S * M * N;
  c.ap = c.at + (size_t)B * S * M;
  c.rt = c.ap + (size_t)B * S * N;
  c.rp = c.rt + (size_t)B * M;
  c.area = c.rp + (size_t)B * N;
  return c;
}

size_t cost_scratch(int B, int M, int N, int S) {
  return (size_t)B * M * N + (size_t)B * S * ((size_t)M * N + M + N) +
         (size_t)B * (M + 2 * (size_t)N);
}

int launch_cost_and_sinkhorn(const float* tm, const float* pm, const float* tf,
                             const float* pf, const float* rm, const float* cm, float* scratch,
                             float* X, float* hist, int B, int M, int N, int Pc, int D,
                             float epsilon,
                             int iters, float iou_weight, int anneal, float epsilon_init,
                             float log_decay, cudaStream_t st) {
  const int S = pixel_slices(B, N, Pc);
  const int chunk = slice_len(Pc, S);
  const CostScratch cs = cost_parts(scratch, B, M, N, S);
  float* rt = hist ? cs.rt : nullptr;       // the inverse norms, only for B1'
  float* rp = hist ? cs.rp : nullptr;

  const int rows = cdiv(M, MG);             // template rows per thread
  int err = static_cast<int>(cudaErrorInvalidValue);
#define DMM_COST(R)                                                                          \
  else if (rows <= R) err = launch_cost<R>(tm, pm, tf, pf, cs.cosv, cs.inter, cs.at, cs.ap,  \
                                           rt, rp, B, M, N, Pc, D, S, chunk, st);
  if (false) {}
  DMM_COST(1) DMM_COST(2) DMM_COST(4) DMM_COST(8)
#undef DMM_COST
  if (err != 0) return err;

  const int npl = cdiv(N, 32);
#define DMM_SINKHORN(P)                                                                    \
  if (npl <= P)                                                                            \
    return launch_sinkhorn<P>(cs.cosv, cs.inter, cs.at, cs.ap, rm, cm, X, hist, B, M, N, S, \
                              iou_weight, epsilon, iters, anneal, epsilon_init, log_decay,   \
                              st);
  DMM_SINKHORN(1) DMM_SINKHORN(2) DMM_SINKHORN(4) DMM_SINKHORN(8) DMM_SINKHORN(16)
  DMM_SINKHORN(32)
#undef DMM_SINKHORN
  return static_cast<int>(cudaErrorInvalidValue);
}

// The sweep's row capacity: M rounded up to a power of two, at least 8.
int sweep_rows(int M) {
  int r = 8;
  while (r < M) r *= 2;
  return r;
}

// The sweep's launch for one batch element of M x N pairs: a thread owns one
// column with all its rows in registers, so the element takes as few warps
// as own its N columns, in one block of at most sweep_max_threads or, past
// that, a cluster of `cluster` such blocks.  p5 (8 x 64): 2 warps; p3 (16 x
// 128): 4; p4 (32 x 256): 8; 64 x 1024: a cluster of 4 blocks of 8 warps.
void sweep_geometry(int M, int N, int* warps, int* cluster) {
  const int need = cdiv(N, 32);
  *cluster = cdiv(need, sweep_max_threads(sweep_rows(M)) / 32);
  *warps = cdiv(need, *cluster);
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

// Floats of the buffer B1's forward keeps for B1' (its `hist` argument): the
// Sinkhorn's duals, B * (iters + 1) * (M + N), then C and the intersections,
// 2 * B * M * N, and both mask areas, B * (M + N).
extern "C" long long dmm_matcher_kept_floats(int B, int M, int N, int iters) {
  if (B < 1 || M < 1 || N < 1 || iters < 0) return -1;
  return static_cast<long long>((size_t)B * (iters + 1) * (M + N) + 2 * (size_t)B * M * N +
                                (size_t)B * (M + N));
}

// B1''s sweep for one batch element of M x N pairs: warps * 256 + cluster
// (sweep_geometry), or -1 for sizes B1 does not take.
extern "C" int dmm_matcher_sweep_geometry(int M, int N) {
  if (M < 1 || M > MAX_M || N < 1 || N > MAX_N) return -1;
  int warps, cluster;
  sweep_geometry(M, N, &warps, &cluster);
  return warps * 256 + cluster;
}

// hist: null, or dmm_matcher_kept_floats floats for what B1' reads (the
// launches then also keep the mask areas and inverse norms in the scratch).
extern "C" int dmm_fused_pool_cost_match(
    const float* emb, const float* pmask_pool, const float* tm, const float* pm,
    const float* tf, const float* rm, const float* cm, float* scratch, float* X, float* hist,
    int B, int M, int N, int P, int Pc, int D, float epsilon, int iters, float iou_weight,
    int anneal, float epsilon_init, float log_decay, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_sizes(B, M, N, Pc, D) || P < 1 || cdiv(D, PD) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  float* pf = scratch;
  const CostScratch cs = cost_parts(scratch + (size_t)B * N * D, B, M, N, pixel_slices(B, N, Pc));
  const size_t pool_smem = sizeof(float) * 2 * (size_t)(PN + PT) * LDT;
  matcher_pool_kernel<<<dim3(cdiv(N, PN), cdiv(D, PD), B), THREADS, pool_smem, st>>>(
      emb, pmask_pool, pf, hist ? cs.area : nullptr, N, P, D);
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
// phase's parts) and kept buffer (hist), as dmm_fused_pool_cost_match left
// them: the sweep (dC, B * M * N floats), then the tail, which writes coef
// (B, M, N), urow (B, M), ucol (B, N), d_tf (B, M, D), d_pooled (B, N, D),
// d_area (B, N).
extern "C" int dmm_fused_pool_cost_match_backward(
    const float* tf, const float* rm, const float* cm, const float* gX, const float* scratch,
    const float* hist, float* dC, float* coef, float* urow, float* ucol, float* d_tf,
    float* d_pooled, float* d_area, int B, int M, int N, int Pc, int D, float epsilon,
    int iters, float iou_weight, int anneal, float epsilon_init, float log_decay,
    void* stream) {
  if (bad_sizes(B, M, N, Pc, D) || iters < 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int S = pixel_slices(B, N, Pc);
  const float* pf = scratch;
  const CostScratch cs = cost_parts(const_cast<float*>(scratch) + (size_t)B * N * D, B, M, N, S);
  const Kept kept = kept_parts(const_cast<float*>(hist), 0, B, M, N, iters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int R = sweep_rows(M);
  int warps, cluster;
  sweep_geometry(M, N, &warps, &cluster);
  err = cudaErrorInvalidValue;
#define DMM_SWEEP(RR)                                                                       \
  else if (R == RR) err = launch_sweep<RR>(                                                 \
      hist, kept.c, rm, cm, gX, dC, B, M, N, warps, cluster, epsilon, iters, anneal,        \
      epsilon_init, log_decay, static_cast<size_t>(optin), st);
  if (false) {}
  DMM_SWEEP(8) DMM_SWEEP(16) DMM_SWEEP(32) DMM_SWEEP(64)
#undef DMM_SWEEP
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tblocks = (M + TAIL_WARPS - 1) / TAIL_WARPS, pblocks = (N + TAIL_WARPS - 1) / TAIL_WARPS;
  matcher_tail_kernel<<<dim3(tblocks + pblocks, B), TAIL_THREADS, 0, st>>>(
      dC, kept.inter, kept.at, kept.ap, cs.rt, cs.rp, cs.area, pf, tf, coef, urow, ucol, d_tf,
      d_pooled, d_area, M, N, D, iou_weight);
  return static_cast<int>(cudaGetLastError());
}
