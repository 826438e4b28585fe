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
// The gather form: grid (tiles of TR x TW level pixels over all four levels,
// blocks of BCB channels); thread t owns pixel (t / TW, t % TW) of its tile
// and BCB accumulators.  The block takes the boxes in chunks of THREADS, one
// thread a box, and lists in index order those on its level whose tap
// window meets the tile (a ballot and a prefix over the warps).  For each
// listed box it stages the box's upstream gradient (BCB x oh x ow), the
// tile columns' weights Ax (ow x TW) and rows' weights Ay (oh x TR) in shared
// memory, then adds the box in the separable form over the cells whose taps
// reach the tile (the others weigh 0 on it): along x into shared memory,
// then along y into the accumulators.  Every level pixel and channel
// is written exactly once, by one thread, after all its boxes, so there is
// no memset, no atomic, and the sum's order is fixed: the gradient is the
// same from run to run.  A tile that no box touches writes its zeros.
//
// What bounds it on an H100: bytes in principle (the upstream gradient and
// the boxes read, the four level gradients written: 11-16 MB per detector
// head at 256x448, C=256, a few microseconds at 3.35 TB/s).  In practice the
// chain of each touching box (load its gradient, two barriers, the two
// passes) is latency, and the tiles of p5, which every large box touches,
// walk the most boxes.

namespace {

constexpr int TR = 8;           // level rows per tile
constexpr int TW = 32;          // level columns per tile
constexpr int BCB = 8;          // channels per block

struct GradLevels {
  float* grads[MAX_LEVELS];
  int H[MAX_LEVELS], W[MAX_LEVELS];
  float scale[MAX_LEVELS];
  int tiles_w[MAX_LEVELS];
  int first_tile[MAX_LEVELS + 1];
};

// The tap window of box k on a level of (H, W) at `scale`: rows [*ylo, *yhi]
// and columns [*xlo, *xhi] (positions are monotone in the sample index).
__device__ __forceinline__ void box_window(const float* boxes, int k, float scale, int H, int W,
                                           int oh, int ow, int s, int* ylo, int* yhi, int* xlo,
                                           int* xhi) {
  const float bx1 = boxes[4 * k + 0] * scale, by1 = boxes[4 * k + 1] * scale;
  const float bw = fmaxf(boxes[4 * k + 2] * scale - bx1, 1e-3f);
  const float bh = fmaxf(boxes[4 * k + 3] * scale - by1, 1e-3f);
  int i0, i1;
  float d;
  sample_pos(by1, bh, 0, 0, oh, s, H, ylo, &i1, &d);
  sample_pos(by1, bh, oh - 1, s - 1, oh, s, H, &i0, yhi, &d);
  sample_pos(bx1, bw, 0, 0, ow, s, W, xlo, &i1, &d);
  sample_pos(bx1, bw, ow - 1, s - 1, ow, s, W, &i0, xhi, &d);
}

__global__ void __launch_bounds__(THREADS)
roi_align_backward_kernel(const __grid_constant__ GradLevels lv, const float* __restrict__ boxes,
                          const int* __restrict__ level, const float* __restrict__ g, int K,
                          int C, int oh, int ow, int s) {
  __shared__ float s_g[BCB * MAX_OUT * MAX_OUT];   // [c][y][x] of one box
  __shared__ float s_v[BCB * MAX_OUT * TW];        // [c][y][w]: along x
  __shared__ float s_ax[MAX_OUT * TW];             // [x][w]
  __shared__ float s_ay[MAX_OUT * TR];             // [y][r]
  __shared__ int s_yt[MAX_OUT], s_xt[MAX_OUT];     // cells whose taps reach the tile
  __shared__ int s_list[THREADS];                  // this chunk's boxes that touch the tile
  __shared__ int s_warp[THREADS / 32];

  int l = 0;
  while (l + 1 < MAX_LEVELS && (int)blockIdx.x >= lv.first_tile[l + 1]) ++l;
  const int t = blockIdx.x - lv.first_tile[l];
  const int H = lv.H[l], W = lv.W[l];
  const float scale = lv.scale[l];
  const int r0 = (t / lv.tiles_w[l]) * TR, w0 = (t % lv.tiles_w[l]) * TW;
  const int c0 = blockIdx.y * BCB, nc = min(BCB, C - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rl = tid / TW, wl = tid % TW;
  const int ohw = oh * ow;
  const float inv_s = 1.f / (float)s;

  float acc[BCB];
#pragma unroll
  for (int j = 0; j < BCB; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += THREADS) {
    // the chunk's boxes on this level whose window meets the tile, in order
    const int kt = k0 + tid;
    bool hit = false;
    if (kt < K) {
      const int lk = level ? min(max(level[kt], 0), MAX_LEVELS - 1) : 0;
      if (lk == l) {
        int ylo, yhi, xlo, xhi;
        box_window(boxes, kt, scale, H, W, oh, ow, s, &ylo, &yhi, &xlo, &xhi);
        hit = yhi >= r0 && ylo < r0 + TR && xhi >= w0 && xlo < w0 + TW;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    __syncthreads();              // the previous chunk's list is used
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int base = 0, total = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      base += w < warp ? s_warp[w] : 0;
      total += s_warp[w];
    }
    if (hit) s_list[base + __popc(ballot & ((1u << lane) - 1u))] = kt;
    __syncthreads();

    for (int q = 0; q < total; ++q) {
      const int k = s_list[q];
      const float bx1 = boxes[4 * k + 0] * scale, by1 = boxes[4 * k + 1] * scale;
      const float bw = fmaxf(boxes[4 * k + 2] * scale - bx1, 1e-3f);
      const float bh = fmaxf(boxes[4 * k + 3] * scale - by1, 1e-3f);
      int i0, i1;
      float d;
      __syncthreads();            // the previous box's shared values are used
      const float* gk = g + ((size_t)k * C + c0) * ohw;
      for (int e = tid; e < BCB * ohw; e += THREADS) s_g[e] = e < nc * ohw ? gk[e] : 0.f;
      for (int e = tid; e < ow * TW; e += THREADS) {
        const int x = e / TW, col = w0 + e % TW;
        float a = 0.f;
        for (int i = 0; i < s; ++i) {
          sample_pos(bx1, bw, x, i, ow, s, W, &i0, &i1, &d);
          if (i0 == col) a += 1.f - d;
          if (i1 == col) a += d;
        }
        s_ax[e] = a * inv_s;
      }
      for (int e = tid; e < oh * TR; e += THREADS) {
        const int y = e / TR, row = r0 + e % TR;
        float a = 0.f;
        for (int i = 0; i < s; ++i) {
          sample_pos(by1, bh, y, i, oh, s, H, &i0, &i1, &d);
          if (i0 == row) a += 1.f - d;
          if (i1 == row) a += d;
        }
        s_ay[e] = a * inv_s;
      }
      if (tid < oh) {             // cell tid's rows: its first sample's tap to its last's
        int a0, b1;
        sample_pos(by1, bh, tid, 0, oh, s, H, &a0, &i1, &d);
        sample_pos(by1, bh, tid, s - 1, oh, s, H, &i0, &b1, &d);
        s_yt[tid] = b1 >= r0 && a0 < r0 + TR;
      } else if (tid >= 32 && tid < 32 + ow) {
        int a0, b1;
        sample_pos(bx1, bw, tid - 32, 0, ow, s, W, &a0, &i1, &d);
        sample_pos(bx1, bw, tid - 32, s - 1, ow, s, W, &i0, &b1, &d);
        s_xt[tid - 32] = b1 >= w0 && a0 < w0 + TW;
      }
      __syncthreads();
      // the cells whose taps reach the tile: every other cell's weights on
      // the tile are 0 (the cells are contiguous, the taps monotone)
      int ya = oh, yb = -1, xa = ow, xb = -1;
      for (int y = 0; y < oh; ++y)
        if (s_yt[y]) { ya = min(ya, y); yb = y; }
      for (int x = 0; x < ow; ++x)
        if (s_xt[x]) { xa = min(xa, x); xb = x; }
      const int ny = yb - ya + 1;

      // along x: v[c][y][w] = sum_x Ax[x][w] * g[c][y][x]
      for (int e = tid; e < BCB * ny * TW; e += THREADS) {
        const int c = e / (ny * TW), y = ya + (e / TW) % ny, w = e % TW;
        const float* grow = s_g + (c * oh + y) * ow;
        float v = 0.f;
        for (int x = xa; x <= xb; ++x) v = fmaf(s_ax[x * TW + w], grow[x], v);
        s_v[(c * oh + y) * TW + w] = v;
      }
      __syncthreads();

      // along y, into this thread's accumulators
      for (int y = ya; y <= yb; ++y) {
        const float a = s_ay[y * TR + rl];
#pragma unroll
        for (int j = 0; j < BCB; ++j) acc[j] = fmaf(a, s_v[(j * oh + y) * TW + wl], acc[j]);
      }
    }
  }

  const int r = r0 + rl, w = w0 + wl;
  if (r < H && w < W) {
    float* o = lv.grads[l] + ((size_t)c0 * H + r) * W + w;
#pragma unroll
    for (int j = 0; j < BCB; ++j)
      if (j < nc) o[(size_t)j * H * W] = acc[j];
  }
}

}  // namespace

// The four level gradients (C, H_l, W_l) of the multi-level form, for the
// upstream gradient g (K, C, oh, ow) and the boxes' levels (K,) int32 (the
// forward's); every element of every grad_l is written.  K = 0 launches
// nothing (the wrapper fills zeros).  Returns cudaGetLastError().
extern "C" int dmm_roi_align_backward(float* g0, float* g1, float* g2, float* g3, int H0,
                                      int H1, int H2, int H3, int W0, int W1, int W2, int W3,
                                      float sc0, float sc1, float sc2, float sc3,
                                      const float* boxes, const int* level, const float* g,
                                      int K, int C, int oh, int ow, int s, void* stream) {
  if (K < 0 || C < 1 || oh < 1 || ow < 1 || s < 1 || s > 4 || oh > MAX_OUT || ow > MAX_OUT)
    return static_cast<int>(cudaErrorInvalidValue);
  if (K == 0) return static_cast<int>(cudaSuccess);
  GradLevels lv;
  float* gs[MAX_LEVELS] = {g0, g1, g2, g3};
  const int Hs[MAX_LEVELS] = {H0, H1, H2, H3}, Ws[MAX_LEVELS] = {W0, W1, W2, W3};
  const float scs[MAX_LEVELS] = {sc0, sc1, sc2, sc3};
  lv.first_tile[0] = 0;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    if (Hs[l] < 1 || Ws[l] < 1 || gs[l] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    lv.grads[l] = gs[l];
    lv.H[l] = Hs[l];
    lv.W[l] = Ws[l];
    lv.scale[l] = scs[l];
    lv.tiles_w[l] = (Ws[l] + TW - 1) / TW;
    lv.first_tile[l + 1] = lv.first_tile[l] + (Hs[l] + TR - 1) / TR * lv.tiles_w[l];
  }
  const int cblocks = (C + BCB - 1) / BCB;
  if (cblocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  roi_align_backward_kernel<<<dim3(lv.first_tile[MAX_LEVELS], cblocks), THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(lv, boxes, level, g, K, C,
                                                                    oh, ow, s);
  return static_cast<int>(cudaGetLastError());
}
