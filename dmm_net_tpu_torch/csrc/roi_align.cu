// Multi-level ROI-Align, aligned semantics (kernel B4).
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
