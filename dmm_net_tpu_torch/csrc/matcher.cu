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
// Two launches on the caller's stream:
//   1. pool_cost_kernel, grid (ceil(N / NT), B): one block pools NT proposals
//      into the f32 scratch `pf` and writes their M x NT cost columns to the
//      f32 scratch `cost`.  The (M x PT) and (NT x PT) mask tiles of the IoU
//      product stream through shared memory.
//   2. sinkhorn_kernel, grid (B): C (M x N) lives in dynamic shared memory
//      for all iterations; row and column log-sum-exps are warp reductions.
//
// Everything is float32 (the reference pins Precision.HIGHEST), with the
// accurate expf/logf (no fast math).
//
// What bounds it on an H100: bytes.  At p3 (B=16, M=16, N=128, P=448,
// Pc=4096, D=256) it reads ~49 MB (pm_cost dominates) against ~0.77 GFLOP of
// f32 work, so the floor is ~15 us at 3.35 TB/s.  This first version reads
// the cost masks once per block and keeps C out of device memory during the
// iterations, but the Sinkhorn launch uses only B blocks (16 of 132 SMs at
// p3) and its iterations are latency-bound: that is the part a later change
// should spread over more SMs.
//
// B3 replaces the TPU kernel `_pallas_forward` / `_matcher_kernel` (public
// `fused_cost_match`, same file): the features arrive pooled, so its first
// launch, cost_kernel, runs only the cost phase (cost_tile, shared with B1)
// and its second is the same sinkhorn_kernel at a fixed epsilon.  Bound:
// bytes, ~40 MB read at B=16, M=16, N=128, P=4096, D=256 (~12 us).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 16;          // proposals per pool/cost block
constexpr int PT = 32;          // pixels per shared-memory tile
constexpr int POOL_THREADS = 256;
constexpr int MAX_PAIRS = 4;    // (M * NT) / POOL_THREADS, so M <= 64
constexpr int SINK_THREADS = 1024;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Cost columns n0 .. n0 + nt of batch element b from pooled features:
//   C[m, n] = lam * (1 - IoU(tm[m], pm[n])) + (1 - lam) * (1 - cos(tf[m], pf[n]))
// with the union floored at 1e-6 and each feature scaled by rsqrt(|f|^2 + 1e-12).
// pm_b and pf_b point at row n0.  Shared memory: s_a (M x (PT + 1)),
// s_b (NT x (PT + 1)), s_tn (M), s_pn (NT).  Called by every thread of the block.
__device__ void cost_tile(const float* __restrict__ tm_b, const float* __restrict__ pm_b,
                          const float* __restrict__ tf_b, const float* __restrict__ pf_b,
                          float* __restrict__ cost_b, int M, int N, int n0, int nt, int Pc,
                          int D, float iou_weight, float* smem) {
  float* s_a = smem;
  float* s_b = s_a + M * (PT + 1);
  float* s_tn = s_b + NT * (PT + 1);
  float* s_pn = s_tn + M;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;

  // ---- feature norms ------------------------------------------------------
  for (int r = warp; r < M + NT; r += nwarps) {
    const bool is_t = r < M;
    const int i = is_t ? r : r - M;
    float s = 0.f;
    if (is_t || i < nt) {
      const float* row = is_t ? tf_b + (size_t)i * D : pf_b + (size_t)i * D;
      for (int d = lane; d < D; d += 32) s = fmaf(row[d], row[d], s);
    }
    s = warp_sum(s);
    if (lane == 0) {
      if (is_t) s_tn[i] = rsqrtf(s + 1e-12f);
      else s_pn[i] = rsqrtf(s + 1e-12f);
    }
  }
  __syncthreads();

  // ---- cosine, intersection and areas over the cost grid ------------------
  // Thread pairs: q = tid + r * blockDim.x  ->  (m = q / NT, i = q % NT).
  const int npairs = M * NT;
  float cosv[MAX_PAIRS], inter[MAX_PAIRS], at[MAX_PAIRS], ap[MAX_PAIRS];
#pragma unroll
  for (int r = 0; r < MAX_PAIRS; ++r) {
    cosv[r] = inter[r] = at[r] = ap[r] = 0.f;
    const int q = tid + r * blockDim.x;
    if (q < npairs) {
      const int m = q / NT, i = q % NT;
      if (i < nt) {
        const float* t = tf_b + (size_t)m * D;
        const float* p = pf_b + (size_t)i * D;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(t[d] * s_tn[m], p[d] * s_pn[i], s);
        cosv[r] = s;
      }
    }
  }
  for (int p0 = 0; p0 < Pc; p0 += PT) {
    __syncthreads();
    for (int e = tid; e < M * PT; e += blockDim.x) {
      const int m = e / PT, j = e % PT;
      s_a[m * (PT + 1) + j] = (p0 + j < Pc) ? tm_b[(size_t)m * Pc + p0 + j] : 0.f;
    }
    for (int e = tid; e < NT * PT; e += blockDim.x) {
      const int i = e / PT, j = e % PT;
      s_b[i * (PT + 1) + j] =
          (i < nt && p0 + j < Pc) ? pm_b[(size_t)i * Pc + p0 + j] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < MAX_PAIRS; ++r) {
      const int q = tid + r * blockDim.x;
      if (q < npairs) {
        const float* a = s_a + (q / NT) * (PT + 1);
        const float* c = s_b + (q % NT) * (PT + 1);
        float s = inter[r], sa = at[r], sb = ap[r];
        for (int j = 0; j < PT; ++j) {
          s = fmaf(a[j], c[j], s);
          sa += a[j];
          sb += c[j];
        }
        inter[r] = s; at[r] = sa; ap[r] = sb;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MAX_PAIRS; ++r) {
    const int q = tid + r * blockDim.x;
    if (q < npairs) {
      const int m = q / NT, i = q % NT;
      if (i < nt) {
        const float uni = fmaxf(at[r] + ap[r] - inter[r], 1e-6f);
        const float iou = inter[r] / uni;
        cost_b[(size_t)m * N + n0 + i] =
            iou_weight * (1.f - iou) + (1.f - iou_weight) * (1.f - cosv[r]);
      }
    }
  }
}

__global__ void pool_cost_kernel(const float* __restrict__ emb,        // (B, P, D)
                                 const float* __restrict__ pmask_pool, // (B, N, P)
                                 const float* __restrict__ tm,         // (B, M, Pc)
                                 const float* __restrict__ pm,         // (B, N, Pc)
                                 const float* __restrict__ tf,         // (B, M, D)
                                 float* __restrict__ pf,               // (B, N, D) scratch
                                 float* __restrict__ cost,             // (B, M, N) scratch
                                 int M, int N, int P, int Pc, int D, float iou_weight) {
  extern __shared__ float smem[];
  float* s_b = smem + M * (PT + 1);                          // cost_tile's proposal tile
  float* s_rowsum = s_b + NT * (PT + 1) + M + NT;            // after cost_tile's region

  const int b = blockIdx.y;
  const int n0 = blockIdx.x * NT;
  const int nt = min(NT, N - n0);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;

  const float* emb_b = emb + (size_t)b * P * D;
  const float* pp_b = pmask_pool + ((size_t)b * N + n0) * P;
  float* pf_b = pf + ((size_t)b * N + n0) * D;

  // mask areas at the embedding grid (pooling denominators)
  for (int i = warp; i < NT; i += nwarps) {
    float s = 0.f;
    if (i < nt)
      for (int p = lane; p < P; p += 32) s += pp_b[(size_t)i * P + p];
    s = warp_sum(s);
    if (lane == 0) s_rowsum[i] = s;
  }

  // ---- pooling: pf[i, d] = sum_p pmask[i, p] * emb[p, d] / area -----------
  for (int d0 = 0; d0 < D; d0 += blockDim.x) {
    const int d = d0 + tid;
    float acc[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) acc[i] = 0.f;
    for (int p0 = 0; p0 < P; p0 += PT) {
      __syncthreads();
      for (int e = tid; e < NT * PT; e += blockDim.x) {
        const int i = e / PT, j = e % PT;
        s_b[i * (PT + 1) + j] =
            (i < nt && p0 + j < P) ? pp_b[(size_t)i * P + p0 + j] : 0.f;
      }
      __syncthreads();
      if (d < D) {
        const int pend = min(PT, P - p0);
        for (int j = 0; j < pend; ++j) {
          const float e = emb_b[(size_t)(p0 + j) * D + d];
#pragma unroll
          for (int i = 0; i < NT; ++i) acc[i] = fmaf(s_b[i * (PT + 1) + j], e, acc[i]);
        }
      }
    }
    if (d < D) {
#pragma unroll
      for (int i = 0; i < NT; ++i)
        if (i < nt) pf_b[(size_t)i * D + d] = acc[i] / fmaxf(s_rowsum[i], 1e-6f);
    }
  }
  __syncthreads();   // pf rows of this block are visible to all its threads

  cost_tile(tm + (size_t)b * M * Pc, pm + ((size_t)b * N + n0) * Pc,
            tf + (size_t)b * M * D, pf_b, cost + (size_t)b * M * N, M, N, n0, nt, Pc, D,
            iou_weight, smem);
}

// Kernel B3's first launch: the cost from already-pooled features.
__global__ void cost_kernel(const float* __restrict__ tm,   // (B, M, P)
                            const float* __restrict__ pm,   // (B, N, P)
                            const float* __restrict__ tf,   // (B, M, D)
                            const float* __restrict__ pf,   // (B, N, D)
                            float* __restrict__ cost,       // (B, M, N) scratch
                            int M, int N, int P, int D, float iou_weight) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * NT;
  cost_tile(tm + (size_t)b * M * P, pm + ((size_t)b * N + n0) * P, tf + (size_t)b * M * D,
            pf + ((size_t)b * N + n0) * D, cost + (size_t)b * M * N, M, N, n0,
            min(NT, N - n0), P, D, iou_weight, smem);
}

// Masked log-sum-exp pieces, mirroring the reference:
//   mx = max(max_valid(z), NEG / 2); s = sum_valid exp(z - mx);
//   lse = mx + log(max(s, 1e-38)).
__global__ void sinkhorn_kernel(const float* __restrict__ cost,  // (B, M, N)
                                const float* __restrict__ rm,    // (B, M) 0/1
                                const float* __restrict__ cm,    // (B, N) 0/1
                                float* __restrict__ X,           // (B, M, N)
                                int M, int N, float epsilon, int iters,
                                int anneal, float epsilon_init, float log_decay) {
  extern __shared__ float smem[];
  const int ldc = N + 1;                 // odd stride: column walks avoid bank conflicts
  float* s_c = smem;                     // M x ldc
  float* s_f = s_c + M * ldc;            // M
  float* s_g = s_f + M;                  // N
  float* s_rv = s_g + N;                 // M
  float* s_cv = s_rv + M;                // N

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const float* c_b = cost + (size_t)b * M * N;

  for (int e = tid; e < M * N; e += blockDim.x) s_c[(e / N) * ldc + e % N] = c_b[e];
  for (int m = tid; m < M; m += blockDim.x) s_rv[m] = rm[(size_t)b * M + m] > 0.5f ? 1.f : 0.f;
  for (int n = tid; n < N; n += blockDim.x) {
    s_cv[n] = cm[(size_t)b * N + n] > 0.5f ? 1.f : 0.f;
    s_g[n] = 0.f;
  }
  __syncthreads();

  // f[m] = valid_row ? -eps * lse_n((-C + g) / eps) : 0   (over valid pairs)
  auto row_update = [&](float eps) {
    for (int m = warp; m < M; m += nwarps) {
      const bool rv = s_rv[m] > 0.5f;
      float mx = NEG;
      for (int n = lane; n < N; n += 32)
        if (rv && s_cv[n] > 0.5f) mx = fmaxf(mx, -s_c[m * ldc + n] / eps + s_g[n] / eps);
      mx = fmaxf(warp_max(mx), NEG / 2);
      float s = 0.f;
      for (int n = lane; n < N; n += 32)
        if (rv && s_cv[n] > 0.5f) s += expf(-s_c[m * ldc + n] / eps + s_g[n] / eps - mx);
      s = warp_sum(s);
      if (lane == 0) s_f[m] = rv ? -eps * (mx + logf(fmaxf(s, 1e-38f))) : 0.f;
    }
  };

  for (int k = 0; k < iters; ++k) {
    const float eps = anneal ? fmaxf(epsilon_init * expf((float)k * log_decay), epsilon)
                             : epsilon;
    row_update(eps);
    __syncthreads();
    // g[n] = valid_col ? min(0, -eps * lse_m((-C + f) / eps)) : 0
    for (int n = warp; n < N; n += nwarps) {
      const bool cv = s_cv[n] > 0.5f;
      float mx = NEG;
      for (int m = lane; m < M; m += 32)
        if (cv && s_rv[m] > 0.5f) mx = fmaxf(mx, -s_c[m * ldc + n] / eps + s_f[m] / eps);
      mx = fmaxf(warp_max(mx), NEG / 2);
      float s = 0.f;
      for (int m = lane; m < M; m += 32)
        if (cv && s_rv[m] > 0.5f) s += expf(-s_c[m * ldc + n] / eps + s_f[m] / eps - mx);
      s = warp_sum(s);
      if (lane == 0)
        s_g[n] = cv ? fminf(0.f, -eps * (mx + logf(fmaxf(s, 1e-38f)))) : 0.f;
    }
    __syncthreads();
  }
  row_update(epsilon);
  __syncthreads();

  float* x_b = X + (size_t)b * M * N;
  for (int e = tid; e < M * N; e += blockDim.x) {
    const int m = e / N, n = e % N;
    float v = 0.f;
    if (s_rv[m] > 0.5f && s_cv[n] > 0.5f)
      v = expf(fminf((s_f[m] + s_g[n] - s_c[m * ldc + n]) / epsilon, 30.f));
    x_b[e] = v;
  }
}

// Shared memory of one cost tile (cost_tile), plus B1's pooling denominators.
size_t cost_smem(int M, bool pooling) {
  return sizeof(float) * ((size_t)M * (PT + 1) + NT * (PT + 1) + M + NT + (pooling ? NT : 0));
}

int launch_sinkhorn(const float* cost, const float* rm, const float* cm, float* X, int B,
                    int M, int N, float epsilon, int iters, int anneal, float epsilon_init,
                    float log_decay, cudaStream_t s) {
  const size_t smem = sizeof(float) * ((size_t)M * (N + 1) + 2 * (size_t)M + 2 * (size_t)N);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sinkhorn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sinkhorn_kernel<<<B, SINK_THREADS, smem, s>>>(cost, rm, cm, X, M, N, epsilon, iters, anneal,
                                               epsilon_init, log_decay);
  return static_cast<int>(cudaGetLastError());
}

bool bad_sizes(int B, int M, int N) {
  return M < 1 || M * NT > MAX_PAIRS * POOL_THREADS || N < 1 || B < 1;
}

}  // namespace

extern "C" int dmm_fused_pool_cost_match(
    const float* emb, const float* pmask_pool, const float* tm, const float* pm,
    const float* tf, const float* rm, const float* cm, float* pf_scratch,
    float* cost_scratch, float* X, int B, int M, int N, int P, int Pc, int D,
    float epsilon, int iters, float iou_weight, int anneal, float epsilon_init,
    float log_decay, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_sizes(B, M, N)) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + NT - 1) / NT, B);
  pool_cost_kernel<<<grid, POOL_THREADS, cost_smem(M, true), s>>>(
      emb, pmask_pool, tm, pm, tf, pf_scratch, cost_scratch, M, N, P, Pc, D, iou_weight);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sinkhorn(cost_scratch, rm, cm, X, B, M, N, epsilon, iters, anneal,
                         epsilon_init, log_decay, s);
}

// Kernel B3: cost from pooled features, then Sinkhorn at a fixed epsilon.
extern "C" int dmm_fused_cost_match(const float* tm, const float* pm, const float* tf,
                                    const float* pf, const float* rm, const float* cm,
                                    float* cost_scratch, float* X, int B, int M, int N,
                                    int P, int D, float epsilon, int iters,
                                    float iou_weight, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_sizes(B, M, N)) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + NT - 1) / NT, B);
  cost_kernel<<<grid, POOL_THREADS, cost_smem(M, false), s>>>(tm, pm, tf, pf, cost_scratch,
                                                             M, N, P, D, iou_weight);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sinkhorn(cost_scratch, rm, cm, X, B, M, N, epsilon, iters, 0, 0.f, 0.f, s);
}
