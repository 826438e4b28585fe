// Multi-level ROI-Align, aligned semantics (kernel B4), and its gradient with
// respect to the levels (kernel B4', at the end of this file).
//
// Replaces the TPU kernel `roi_align_pallas` / `_roi_align_kernel`
// (dmm_net_tpu/kernels/roi_align.py), which builds per-box interpolation
// matrices A_y (oh, H), A_x (ow, W) and computes A_y @ feat @ A_x^T on the
// matrix unit, and the detector's use of it (`_multilevel_roi_align`,
// dmm_net_tpu/models/proposal/maskrcnn.py), which aligns every box on all
// four FPN levels and keeps one.  Here each box is aligned on its own level
// only, all levels in one launch:
//
//   out[k, c, y, x] = 1/(s*s) * sum_{sy, sx} bilinear(feat_l[c], py(y, sy), px(x, sx))
//   py = clamp(y1 + (y*s + sy + 0.5) / (oh*s) * max(y2 - y1, 1e-3) - 0.5, 0, H-1)
//   l  = level[k]  (computed by the wrapper with the same torch expression as
//                   the plain version, so a box on a level boundary cannot move)
//
// with the box already multiplied by the level's spatial_scale, the floor
// taken after the clamp, and the second tap at min(p0 + 1, dim - 1), so a
// clamped edge puts full weight on the edge pixel (ops/roi_pool._interp_matrix).
//
// Layout: up to four levels (C, H_l, W_l) float32, boxes (K, 4) float32
// (x1, y1, x2, y2) in image coordinates, level (K,) int32 or null (all 0),
// out (K, C, oh, ow) float32; oh, ow <= 16, s <= 4.
//
// Design.  Grid (K, ceil(C / CB)); one block per (box, block of CB = 16
// channels), so K=128, C=256 gives 2048 blocks over the 132 SMs.  Thread t
// owns output column x = t % 2^lw and output row y = t / 2^lw (2^lw >= ow,
// 2^lh >= oh), so it computes its s column taps and s row taps (indices and
// weights, the clamp-before-floor rule) once, into registers.  Then, for
// each group of CG = 8 channels and each pass of up to RT = 64 rows of the
// box's window on its level:
//   1. along x: v[c][r][x] = sum of column x's 2s taps on window row r,
//      read straight from device memory (a warp's lanes read neighbouring
//      columns of a few rows, so its loads share sectors and L1 lines), into
//      shared memory;
//   2. along y: each thread adds its 2s row taps of v into its CG
//      accumulators, which are written with x fastest (coalesced) after the
//      group's last pass.
// This is the separable form of the plain version (`roi_align_mxu`), which
// sums along y first: the two agree to float32 rounding.
//
// What bounds it on an H100: bytes, in principle.  The detector's two heads
// read the pyramid (9.75 MB for p2..p5 at 256x448, C=256) and write 6.42 MB
// (box head, 7x7) and 25.69 MB (mask head, 14x14, K=128): about 15 us at
// 3.35 TB/s per image, against ~0.3 GFLOP of f32 work.  In practice the
// latency of each block's chain (box -> taps -> loads -> barrier -> y-pass)
// bounds it: a block does little work per step, and 32 warps an SM (64
// registers a thread keep the taps and accumulators) do not hide it.  A
// version that staged window tiles in shared memory with cp.async, double
// buffered, was no faster on the detector's boxes, and slower on boxes of
// mixed levels; more resident warps (32 registers) were slower.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int CB = 16;          // channels per block
constexpr int CG = 8;           // channels per pass
constexpr int RT = 64;          // window rows per pass
constexpr int MAX_OUT = 16;     // oh and ow: one (y, x) output per thread
constexpr int MAX_LEVELS = 4;

struct Levels {
  const float* feats[MAX_LEVELS];
  int H[MAX_LEVELS], W[MAX_LEVELS];
  float scale[MAX_LEVELS];
  int n;
};

__device__ __forceinline__ void sample_pos(float start, float size, int cell, int sub,
                                           int out, int s, int dim, int* i0, int* i1,
                                           float* d) {
  float pos = start + ((float)(cell * s + sub) + 0.5f) / (float)(out * s) * size - 0.5f;
  pos = fminf(fmaxf(pos, 0.f), (float)(dim - 1));
  const float p0 = floorf(pos);
  *d = pos - p0;
  *i0 = (int)p0;
  *i1 = min(*i0 + 1, dim - 1);
}

// SR: the sampling ratio s.  Thread t owns output column x = t % 2^lw and
// output row y = t / 2^lw (2^(lh + lw) <= THREADS), so its taps live in
// registers for the whole block.
template <int SR>
__global__ void __launch_bounds__(THREADS, 4)
roi_align_kernel(const __grid_constant__ Levels lv, const float* __restrict__ boxes,
                 const int* __restrict__ level, float* __restrict__ out, int C, int oh,
                 int ow, int lw) {
  __shared__ float s_v[CG * RT * MAX_OUT];   // [CG][RT][2^lw]: a warp's rows on distinct banks

  const int k = blockIdx.x;
  const int c_begin = blockIdx.y * CB;
  const int c_end = min(C, c_begin + CB);
  const int tid = threadIdx.x;
  int l = level ? level[k] : 0;
  l = min(max(l, 0), lv.n - 1);
  const int H = lv.H[l], W = lv.W[l];
  const float scale = lv.scale[l];
  const float* feats = lv.feats[l];

  // ---- this thread's taps, in registers -------------------------------------
  const float bx1 = boxes[4 * k + 0] * scale, by1 = boxes[4 * k + 1] * scale;
  const float bx2 = boxes[4 * k + 2] * scale, by2 = boxes[4 * k + 3] * scale;
  const float bw = fmaxf(bx2 - bx1, 1e-3f), bh = fmaxf(by2 - by1, 1e-3f);
  const int x = tid & ((1 << lw) - 1), y = tid >> lw;
  const bool has_x = x < ow, has_y = y < oh;
  int rx[SR][2], ry[SR][2];
  float wx[SR][2], wy[SR][2];
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    float d;
    sample_pos(bx1, bw, min(x, ow - 1), i, ow, SR, W, &rx[i][0], &rx[i][1], &d);
    wx[i][0] = 1.f - d; wx[i][1] = d;
    sample_pos(by1, bh, min(y, oh - 1), i, oh, SR, H, &ry[i][0], &ry[i][1], &d);
    wy[i][0] = 1.f - d; wy[i][1] = d;
  }
  // the window's rows: positions are monotone in the sample index, so the
  // first sample of cell 0 and the last of the last cell bound them
  int ylo, yhi;
  {
    int i0, i1;
    float d;
    sample_pos(by1, bh, 0, 0, oh, SR, H, &ylo, &i1, &d);
    sample_pos(by1, bh, oh - 1, SR - 1, oh, SR, H, &i0, &yhi, &d);
  }
  const int n_rt = (yhi - ylo + RT) / RT;
  const int n_steps = (c_end - c_begin + CG - 1) / CG * n_rt;
  const int rows_per_pass = THREADS >> lw;

  float acc[CG];
#pragma unroll
  for (int j = 0; j < CG; ++j) acc[j] = 0.f;
  const float inv = 1.f / (float)(SR * SR);

  // step q -> channel group q / n_rt, window rows [r0, r0 + nr)
  for (int q = 0; q < n_steps; ++q) {
    const int t = q % n_rt;
    const int c0 = c_begin + (q / n_rt) * CG;
    const int r0 = ylo + t * RT;
    const int nr = min(RT, yhi + 1 - r0);

    // along x, straight from device memory: v[j][r][x] = sum of column x's
    // taps on window row r (the 2 * SR taps of a warp's lanes are neighbours)
    if (has_x) {
      for (int r = y; r < nr; r += rows_per_pass) {
        const float* row = feats + ((size_t)c0 * H + r0 + r) * W;
#pragma unroll
        for (int j = 0; j < CG; ++j) {
          float v = 0.f;
          if (c0 + j < c_end) {
            const float* rj = row + (size_t)j * H * W;
#pragma unroll
            for (int i = 0; i < SR; ++i)
#pragma unroll
              for (int u = 0; u < 2; ++u) v = fmaf(wx[i][u], __ldg(rj + rx[i][u]), v);
          }
          s_v[((j * RT + r) << lw) + x] = v;
        }
      }
    }
    __syncthreads();

    // along y, into this thread's accumulators
    if (has_x && has_y) {
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int ra = ry[i][u] - r0;
          if (ra >= 0 && ra < nr) {
#pragma unroll
            for (int j = 0; j < CG; ++j)
              acc[j] = fmaf(wy[i][u], s_v[((j * RT + ra) << lw) + x], acc[j]);
          }
        }
    }
    if (t == n_rt - 1) {          // last rows of this channel group: write it out
      if (has_x && has_y) {
        float* o = out + ((size_t)k * C + c0) * oh * ow + y * ow + x;
#pragma unroll
        for (int j = 0; j < CG; ++j)
          if (c0 + j < c_end) o[(size_t)j * oh * ow] = acc[j] * inv;
      }
#pragma unroll
      for (int j = 0; j < CG; ++j) acc[j] = 0.f;
    }
    __syncthreads();              // s_v is free for the next step
  }
}

template <int SR>
cudaError_t launch(const Levels& lv, const float* boxes, const int* level, float* out, int K,
                   int C, int oh, int ow, int lw, cudaStream_t st) {
  roi_align_kernel<SR><<<dim3(K, (C + CB - 1) / CB), THREADS, 0, st>>>(lv, boxes, level, out,
                                                                     C, oh, ow, lw);
  return cudaGetLastError();
}

}  // namespace

// levels: n_levels maps (C, H_l, W_l) at feats[l] with scale[l]; level (K,)
// int32 per box, or null for level 0.  Returns cudaGetLastError().
extern "C" int dmm_roi_align(const float* f0, const float* f1, const float* f2,
                             const float* f3, int H0, int H1, int H2, int H3, int W0,
                             int W1, int W2, int W3, float sc0, float sc1, float sc2,
                             float sc3, int n_levels, const float* boxes, const int* level,
                             float* out, int K, int C, int oh, int ow, int s, void* stream) {
  int lh = 0, lw = 0;
  while ((1 << lh) < oh) ++lh;
  while ((1 << lw) < ow) ++lw;
  if (K < 0 || C < 1 || oh < 1 || ow < 1 || s < 1 || s > 4 || n_levels < 1 ||
      n_levels > MAX_LEVELS || oh > MAX_OUT || ow > MAX_OUT || (1 << (lh + lw)) > THREADS ||
      C > CB * 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (K == 0) return static_cast<int>(cudaSuccess);
  Levels lv;
  const float* fs[MAX_LEVELS] = {f0, f1, f2, f3};
  const int Hs[MAX_LEVELS] = {H0, H1, H2, H3}, Ws[MAX_LEVELS] = {W0, W1, W2, W3};
  const float scs[MAX_LEVELS] = {sc0, sc1, sc2, sc3};
  for (int l = 0; l < MAX_LEVELS; ++l) {
    const bool on = l < n_levels;
    if (on && (Hs[l] < 1 || Ws[l] < 1 || fs[l] == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    lv.feats[l] = on ? fs[l] : nullptr;
    lv.H[l] = on ? Hs[l] : 1;
    lv.W[l] = on ? Ws[l] : 1;
    lv.scale[l] = on ? scs[l] : 0.f;
  }
  lv.n = n_levels;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (s) {
    case 1: err = launch<1>(lv, boxes, level, out, K, C, oh, ow, lw, st); break;
    case 2: err = launch<2>(lv, boxes, level, out, K, C, oh, ow, lw, st); break;
    case 3: err = launch<3>(lv, boxes, level, out, K, C, oh, ow, lw, st); break;
    default: err = launch<4>(lv, boxes, level, out, K, C, oh, ow, lw, st); break;
  }
  return static_cast<int>(err);
}

// ---- the backward (B4') ------------------------------------------------------
// The gradient of the multi-level form with respect to the four levels:
//
//   grad_l[c, r, w] = sum over boxes k on level l of
//                     sum_{y, x} Ay_k[y, r] * Ax_k[x, w] * g[k, c, y, x]
//
// with Ay_k[y, r] = 1/s * sum_sy (the bilinear weight of row r at sample
// (y, sy)), Ax_k likewise: the same taps, clamp-before-floor rule and border
// tap as the forward.  It replaces XLA's gradient of the reference's
// `_multilevel_roi_align` (dmm_net_tpu/models/proposal/maskrcnn.py), which
// the JAX detector's training takes through `roi_align_mxu`'s dense
// interpolation matrices on all four levels.
//
// The gather form, two launches:
//   1. roi_align_backward_prep_kernel, one block per box: the box's level,
//      its tap window, each cell's first and last tap row, and its weights
//      as dense rows, Ax_k (ow x the level's width) and Ay_k (oh x its
//      height), zero outside the window; each computed once, not once per
//      (tile, channel block) that the box reaches.
//   2. roi_align_backward_kernel, grid (tiles of TR x TW = 8 x 32 level
//      pixels, blocks of BCB = 8 channels), coarse levels first so that the
//      busiest tiles start first.  Warp j takes channel c0 + j and lane w the tile's
//      column w, with the TR rows of that column in registers.  The block
//      lists, per chunk of THREADS boxes and in index order, the boxes on its
//      level whose window meets the tile (a ballot and a prefix over the
//      warps), with the cells whose taps reach the tile's rows.  Then a
//      two-stage cp.async pipeline: while box q is added, box q + 1's
//      gradient slab (BCB x oh x ow) and its weights on the tile (ow x TW,
//      oh x TR) are copied into shared memory, so a box costs its FMAs and
//      one barrier.  A box is added in the separable form in registers:
//      v = sum_x Ax[x][w] g[c][y][x] for each reaching cell row y (the slab
//      rows as broadcast float4s), then acc[r] += Ay[y][r] v.
//   A tile writes its pixels once, after all its boxes.  No memset, no
//   atomics, and the order of every sum is fixed: the gradient is the same
//   from run to run.  A tile that no box reaches writes its zeros.  (Cutting
//   a busy tile's list into parts added in a fixed order paid only past
//   ~12 boxes a tile, which only K=128 reaches; training sends K=32, at most
//   9 a tile, so tiles are not split.)
//
// What bounds it on an H100: bytes in principle (the upstream gradient and
// the boxes read, the four level gradients written: 11-16 MB per detector
// head at 256x448, C=256, a few microseconds at 3.35 TB/s).  Left after
// this design: with few boxes a tile (K=32: 0-9), each block's fixed
// latency (its listing, its first box's copy, its tile's write); with many
// (K=128: up to 34 on a p3 tile), the FMAs of the dense tile form, every
// cell column of a reaching cell row against ~2 taps a pixel (24 FMAs and
// 6 shared loads per cell row and lane).

namespace {

constexpr int TR = 8;           // level rows per tile (a lane's registers)
constexpr int TW = 32;          // level columns per tile (one per lane)
constexpr int BCB = THREADS / 32;   // channels per block (one per warp)
constexpr int INFO = 40;        // ints a box: level, window (4), 3 spare, cell rows' first and last taps

struct GradLevels {
  float* grads[MAX_LEVELS];
  int H[MAX_LEVELS], W[MAX_LEVELS];
  float scale[MAX_LEVELS];
  int tiles_w[MAX_LEVELS];
  int first_tile[MAX_LEVELS];   // first block x of level l; coarse levels first
  int tiles[MAX_LEVELS];
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// The tap window of box k on a level of (H, W) at `scale`: rows [*ylo, *yhi]
// and columns [*xlo, *xhi] (positions are monotone in the sample index).
__device__ __forceinline__ void box_window(float bx1, float by1, float bw, float bh, int H,
                                           int W, int oh, int ow, int s, int* ylo, int* yhi,
                                           int* xlo, int* xhi) {
  int i0, i1;
  float d;
  sample_pos(by1, bh, 0, 0, oh, s, H, ylo, &i1, &d);
  sample_pos(by1, bh, oh - 1, s - 1, oh, s, H, &i0, yhi, &d);
  sample_pos(bx1, bw, 0, 0, ow, s, W, xlo, &i1, &d);
  sample_pos(bx1, bw, ow - 1, s - 1, ow, s, W, &i0, xhi, &d);
}

// Column `col` of cell `cell`'s weights: 1/s * the bilinear weights of its
// samples' taps on it.
__device__ __forceinline__ float tap_weight(float start, float size, int cell, int out, int s,
                                            int dim, int col) {
  float a = 0.f;
  for (int i = 0; i < s; ++i) {
    int i0, i1;
    float d;
    sample_pos(start, size, cell, i, out, s, dim, &i0, &i1, &d);
    if (i0 == col) a += 1.f - d;
    if (i1 == col) a += d;
  }
  return a * (1.f / (float)s);
}

// Block k: box k's info (INFO ints: level, ylo, yhi, xlo, xhi, -, -, -, the
// first tap row of cells 0..15, the last tap row of cells 0..15) and its
// dense weights at taps + k * box_floats: Ax rows x < ow of stride wp over
// the level's columns rounded up to TW, then (at 16 * wp) Ay rows y < oh of
// stride hp over its rows rounded up to TR.
__global__ void __launch_bounds__(THREADS)
roi_align_backward_prep_kernel(const __grid_constant__ GradLevels lv,
                               const float* __restrict__ boxes, const int* __restrict__ level,
                               int* __restrict__ info, float* __restrict__ taps, int oh, int ow,
                               int s, int wp, int hp, int box_floats) {
  const int k = blockIdx.x, tid = threadIdx.x;
  const int l = level ? min(max(level[k], 0), MAX_LEVELS - 1) : 0;
  const int H = lv.H[l], W = lv.W[l];
  const float scale = lv.scale[l];
  const float bx1 = boxes[4 * k + 0] * scale, by1 = boxes[4 * k + 1] * scale;
  const float bw = fmaxf(boxes[4 * k + 2] * scale - bx1, 1e-3f);
  const float bh = fmaxf(boxes[4 * k + 3] * scale - by1, 1e-3f);
  int ylo, yhi, xlo, xhi;
  box_window(bx1, by1, bw, bh, H, W, oh, ow, s, &ylo, &yhi, &xlo, &xhi);
  int* in = info + (size_t)k * INFO;
  if (tid == 0) {
    in[0] = l;
    in[1] = ylo;
    in[2] = yhi;
    in[3] = xlo;
    in[4] = xhi;
  }
  if (tid < oh) {               // cell tid's rows: its first sample's tap to its last's
    int a0, b1, i0, i1;
    float d;
    sample_pos(by1, bh, tid, 0, oh, s, H, &a0, &i1, &d);
    sample_pos(by1, bh, tid, s - 1, oh, s, H, &i0, &b1, &d);
    in[8 + tid] = a0;
    in[24 + tid] = b1;
  }
  // the weights, one thread an entry; only the window's need the taps
  float* tk = taps + (size_t)k * box_floats;
  const int wl = (W + TW - 1) / TW * TW, hl = (H + TR - 1) / TR * TR;
  for (int e = tid; e < ow * wl; e += THREADS) {
    const int x = e / wl, col = e - x * wl;
    tk[x * wp + col] = col >= xlo && col <= xhi ? tap_weight(bx1, bw, x, ow, s, W, col) : 0.f;
  }
  for (int e = tid; e < oh * hl; e += THREADS) {
    const int y = e / hl, row = e - y * hl;
    tk[16 * wp + y * hp + row] =
        row >= ylo && row <= yhi ? tap_weight(by1, bh, y, oh, s, H, row) : 0.f;
  }
}

// XP: the staged slab's row stride, 8 (ow <= 8) or 16.
template <int XP>
__global__ void __launch_bounds__(THREADS)
roi_align_backward_kernel(const __grid_constant__ GradLevels lv, const int* __restrict__ info,
                          const float* __restrict__ taps, const float* __restrict__ g, int K,
                          int C, int oh, int ow, int wp, int hp, int box_floats) {
  constexpr int GS = BCB * 16 * XP;    // a stage's slab: [c][y][XP]
  __shared__ __align__(16) float s_g[2 * GS];
  __shared__ __align__(16) float s_ax[2 * 16 * TW];    // [x][w]
  __shared__ __align__(16) float s_ay[2 * 16 * TR];    // [y][r]
  __shared__ int s_list[THREADS], s_rng[THREADS];
  __shared__ int s_warp[THREADS / 32];

  int l = 0;
  while (l + 1 < MAX_LEVELS && ((int)blockIdx.x < lv.first_tile[l] ||
                                (int)blockIdx.x >= lv.first_tile[l] + lv.tiles[l]))
    ++l;
  const int t = blockIdx.x - lv.first_tile[l];
  const int H = lv.H[l], W = lv.W[l];
  const int r0 = (t / lv.tiles_w[l]) * TR, w0 = (t % lv.tiles_w[l]) * TW;
  const int c0 = blockIdx.y * BCB, nc = min(BCB, C - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ohw = oh * ow;

  for (int e = tid; e < 2 * GS; e += THREADS) s_g[e] = 0.f;     // the rows' pads stay 0
  for (int e = tid; e < 2 * 16 * TW; e += THREADS) s_ax[e] = 0.f;
  // a box's slab row by row: rows (c, y) c-major, XP threads a row, thread x
  // copying column x < ow
  constexpr int RPP = THREADS / XP;    // rows a pass
  const int sx = tid % XP, srow = tid / XP, slab_rows = nc * oh;
  const int sc0 = srow / oh, sy0 = srow - sc0 * oh;   // this thread's first row's (c, y)
  auto stage = [&](int q, int buf) {
    const int k = s_list[q];
    const float* gk = g + ((size_t)k * C + c0) * ohw;
    float* sg = s_g + buf * GS;
    if (sx < ow) {
      int c = sc0, y = sy0;
      for (int row = srow; row < slab_rows; row += RPP) {
        cp_async4(sg + (c * 16 + y) * XP + sx, gk + row * ow + sx);
        for (y += RPP; y >= oh; y -= oh) ++c;
      }
    }
    const float* tk = taps + (size_t)k * box_floats;
    if (tid < ow * (TW / 4)) {
      const int x = tid / (TW / 4), v = 4 * (tid % (TW / 4));
      cp_async16(s_ax + buf * 16 * TW + x * TW + v, tk + x * wp + w0 + v);
    } else if (tid >= 128 && tid < 128 + oh * (TR / 4)) {
      const int y = (tid - 128) / (TR / 4), v = 4 * ((tid - 128) % (TR / 4));
      cp_async16(s_ay + buf * 16 * TR + y * TR + v, tk + 16 * wp + y * hp + r0 + v);
    }
    cp_async_commit();
  };

  float acc[TR];
#pragma unroll
  for (int r = 0; r < TR; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < K; k0 += THREADS) {
    // the chunk's boxes on this level whose window meets the tile, in order
    const int kt = k0 + tid;
    const int4* in = reinterpret_cast<const int4*>(info + (size_t)min(kt, K - 1) * INFO);
    bool hit = false;
    if (kt < K) {
      const int4 h0 = in[0], h1 = in[1];      // level, ylo, yhi, xlo; xhi
      hit = h0.x == l && h0.z >= r0 && h0.y < r0 + TR && h1.x >= w0 && h0.w < w0 + TW;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    __syncthreads();              // the previous chunk's list and stages are used
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int base = 0, total = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      base += w < warp ? s_warp[w] : 0;
      total += s_warp[w];
    }
    if (hit) {                    // the cells whose taps reach the tile's rows
      int first[MAX_OUT], last[MAX_OUT];    // each cell's first and last tap row
#pragma unroll
      for (int v = 0; v < MAX_OUT / 4; ++v) {
        const int4 a = in[2 + v], b = in[6 + v];
        first[4 * v] = a.x; first[4 * v + 1] = a.y; first[4 * v + 2] = a.z; first[4 * v + 3] = a.w;
        last[4 * v] = b.x; last[4 * v + 1] = b.y; last[4 * v + 2] = b.z; last[4 * v + 3] = b.w;
      }
      int ya = oh, yb = -1;
#pragma unroll
      for (int y = 0; y < MAX_OUT; ++y)
        if (y < oh && last[y] >= r0 && first[y] < r0 + TR) {
          ya = min(ya, y);
          yb = y;
        }
      const int at = base + __popc(ballot & ((1u << lane) - 1u));
      s_list[at] = kt;
      s_rng[at] = ya | yb << 8;
    }
    __syncthreads();

    // the list through the two-stage pipeline
    if (total > 0) stage(0, 0);
    for (int q = 0; q < total; ++q) {
      const int buf = q & 1;
      cp_async_wait_all();
      __syncthreads();            // box q staged; box q - 1 added by every thread
      if (q + 1 < total) stage(q + 1, buf ^ 1);
      const float* sg = s_g + buf * GS + warp * 16 * XP;
      const float* sax = s_ax + buf * 16 * TW + lane;
      const float* say = s_ay + buf * 16 * TR;
      float ax[XP];
#pragma unroll
      for (int x = 0; x < XP; ++x) ax[x] = sax[x * TW];
      const int rq = s_rng[q], yb = rq >> 8;
      for (int y = rq & 255; y <= yb; ++y) {
        const float4* gr = reinterpret_cast<const float4*>(sg + y * XP);
        float v = 0.f;
#pragma unroll
        for (int x4 = 0; x4 < XP / 4; ++x4) {
          const float4 q4 = gr[x4];
          v = fmaf(ax[4 * x4 + 0], q4.x, v);
          v = fmaf(ax[4 * x4 + 1], q4.y, v);
          v = fmaf(ax[4 * x4 + 2], q4.z, v);
          v = fmaf(ax[4 * x4 + 3], q4.w, v);
        }
        const float4 a0 = *reinterpret_cast<const float4*>(say + y * TR);
        const float4 a1 = *reinterpret_cast<const float4*>(say + y * TR + 4);
        acc[0] = fmaf(a0.x, v, acc[0]);
        acc[1] = fmaf(a0.y, v, acc[1]);
        acc[2] = fmaf(a0.z, v, acc[2]);
        acc[3] = fmaf(a0.w, v, acc[3]);
        acc[4] = fmaf(a1.x, v, acc[4]);
        acc[5] = fmaf(a1.y, v, acc[5]);
        acc[6] = fmaf(a1.z, v, acc[6]);
        acc[7] = fmaf(a1.w, v, acc[7]);
      }
    }
  }

  const int c = c0 + warp, w = w0 + lane;
  if (c < C && w < W) {
    float* o = lv.grads[l] + ((size_t)c * H + r0) * W + w;
#pragma unroll
    for (int r = 0; r < TR; ++r)
      if (r0 + r < H) o[(size_t)r * W] = acc[r];
  }
}

struct BackwardScratch {
  int* info;
  float* taps;
  size_t bytes;
  int wp, hp, box_floats;
};

// The scratch of one call (carved from `base`, or only sized when base is
// null): each box's info and dense weights.
BackwardScratch backward_scratch(char* base, const int* Hs, const int* Ws, int K) {
  BackwardScratch b;
  int wmax = 1, hmax = 1;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    wmax = std::max(wmax, Ws[l]);
    hmax = std::max(hmax, Hs[l]);
  }
  b.wp = (wmax + TW - 1) / TW * TW;
  b.hp = (hmax + TR - 1) / TR * TR;
  b.box_floats = 16 * b.wp + 16 * b.hp;
  const size_t info_bytes = (sizeof(int) * (size_t)K * INFO + 255) / 256 * 256;
  b.info = reinterpret_cast<int*>(base);
  b.taps = base ? reinterpret_cast<float*>(base + info_bytes) : nullptr;
  b.bytes = info_bytes + sizeof(float) * (size_t)K * b.box_floats;
  return b;
}

bool bad_levels(const int* Hs, const int* Ws) {
  for (int l = 0; l < MAX_LEVELS; ++l)
    if (Hs[l] < 1 || Ws[l] < 1) return true;
  return false;
}

}  // namespace

// Bytes of scratch one B4' call needs (dmm_roi_align_backward's `scratch`).
extern "C" long long dmm_roi_align_backward_scratch_bytes(int H0, int H1, int H2, int H3, int W0,
                                                          int W1, int W2, int W3, int K) {
  const int Hs[MAX_LEVELS] = {H0, H1, H2, H3}, Ws[MAX_LEVELS] = {W0, W1, W2, W3};
  if (K < 0 || bad_levels(Hs, Ws)) return -1;
  return static_cast<long long>(backward_scratch(nullptr, Hs, Ws, K).bytes);
}

// The four level gradients (C, H_l, W_l) of the multi-level form, for the
// upstream gradient g (K, C, oh, ow) and the boxes' levels (K,) int32 (the
// forward's); every element of every grad_l is written.  scratch: the bytes
// dmm_roi_align_backward_scratch_bytes gives.  K = 0 launches nothing (the
// wrapper fills zeros).  Returns cudaGetLastError().
extern "C" int dmm_roi_align_backward(float* g0, float* g1, float* g2, float* g3, int H0,
                                      int H1, int H2, int H3, int W0, int W1, int W2, int W3,
                                      float sc0, float sc1, float sc2, float sc3,
                                      const float* boxes, const int* level, const float* g,
                                      void* scratch, int K, int C, int oh, int ow, int s,
                                      void* stream) {
  if (K < 0 || C < 1 || oh < 1 || ow < 1 || s < 1 || s > 4 || oh > MAX_OUT || ow > MAX_OUT)
    return static_cast<int>(cudaErrorInvalidValue);
  if (K == 0) return static_cast<int>(cudaSuccess);
  float* gs[MAX_LEVELS] = {g0, g1, g2, g3};
  const int Hs[MAX_LEVELS] = {H0, H1, H2, H3}, Ws[MAX_LEVELS] = {W0, W1, W2, W3};
  const float scs[MAX_LEVELS] = {sc0, sc1, sc2, sc3};
  if (bad_levels(Hs, Ws)) return static_cast<int>(cudaErrorInvalidValue);
  GradLevels lv;
  int tiles = 0;
  for (int l = MAX_LEVELS - 1; l >= 0; --l) {       // coarse levels first
    if (gs[l] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    lv.grads[l] = gs[l];
    lv.H[l] = Hs[l];
    lv.W[l] = Ws[l];
    lv.scale[l] = scs[l];
    lv.tiles_w[l] = (Ws[l] + TW - 1) / TW;
    lv.first_tile[l] = tiles;
    lv.tiles[l] = (Hs[l] + TR - 1) / TR * lv.tiles_w[l];
    tiles += lv.tiles[l];
  }
  const int cblocks = (C + BCB - 1) / BCB;
  if (cblocks > 65535 || K > (1 << 30) / INFO) return static_cast<int>(cudaErrorInvalidValue);
  const BackwardScratch sb = backward_scratch(static_cast<char*>(scratch), Hs, Ws, K);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  roi_align_backward_prep_kernel<<<K, THREADS, 0, st>>>(lv, boxes, level, sb.info, sb.taps, oh,
                                                        ow, s, sb.wp, sb.hp, sb.box_floats);
  const dim3 grid(tiles, cblocks);
  if (ow <= 8)
    roi_align_backward_kernel<8><<<grid, THREADS, 0, st>>>(lv, sb.info, sb.taps, g, K, C, oh, ow,
                                                           sb.wp, sb.hp, sb.box_floats);
  else
    roi_align_backward_kernel<16><<<grid, THREADS, 0, st>>>(lv, sb.info, sb.taps, g, K, C, oh,
                                                            ow, sb.wp, sb.hp, sb.box_floats);
  return static_cast<int>(cudaGetLastError());
}
