// ROI-Align on one pyramid level, aligned semantics (kernel B4).
//
// Replaces the TPU kernel `roi_align_pallas` / `_roi_align_kernel`
// (dmm_net_tpu/kernels/roi_align.py), which builds per-box interpolation
// matrices A_y (oh, H), A_x (ow, W) and computes A_y @ feat @ A_x^T on the
// matrix unit.  Here the same function is a direct sum:
//
//   out[k, c, y, x] = 1/(s*s) * sum_{sy, sx} bilinear(feat[c], py(y, sy), px(x, sx))
//   py = clamp(y1 + (y*s + sy + 0.5) / (oh*s) * max(y2 - y1, 1e-3) - 0.5, 0, H-1)
//
// with the box already multiplied by spatial_scale, the floor taken after
// the clamp, and the second tap at min(p0 + 1, dim - 1), so a clamped edge
// puts full weight on the edge pixel (ops/roi_pool._interp_matrix).
//
// Layout: feats (C, H, W) float32, boxes (K, 4) float32 (x1, y1, x2, y2),
// out (K, C, oh, ow) float32.  One thread per output element, x fastest, so
// the writes are coalesced; each thread reads s*s*4 taps from global memory
// (through L1/L2: the taps of neighbouring threads overlap).
//
// What bounds it on an H100: bytes.  At the detector's p2 level with K=128
// and a 14x14 output it must read 7.34 MB of features and write 25.69 MB,
// ~10 us at 3.35 TB/s, against ~0.2 GFLOP of f32 work.  This first version
// recomputes the box geometry in every thread and leans on the caches for
// the feature reuse; a shared-memory tile per (box, channel block) is the
// next step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

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

__global__ void roi_align_kernel(const float* __restrict__ feats,   // (C, H, W)
                                 const float* __restrict__ boxes,   // (K, 4)
                                 float* __restrict__ out,           // (K, C, oh, ow)
                                 int K, int C, int H, int W, int oh, int ow, int s,
                                 float scale) {
  const int64_t total = (int64_t)K * C * oh * ow;
  const float inv = 1.f / (float)(s * s);
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int x = (int)(e % ow);
    int64_t r = e / ow;
    const int y = (int)(r % oh);
    r /= oh;
    const int c = (int)(r % C);
    const int k = (int)(r / C);
    const float bx1 = boxes[4 * k + 0] * scale, by1 = boxes[4 * k + 1] * scale;
    const float bx2 = boxes[4 * k + 2] * scale, by2 = boxes[4 * k + 3] * scale;
    const float bw = fmaxf(bx2 - bx1, 1e-3f), bh = fmaxf(by2 - by1, 1e-3f);
    const float* f = feats + (size_t)c * H * W;
    float acc = 0.f;
    for (int sy = 0; sy < s; ++sy) {
      int y0, y1;
      float dy;
      sample_pos(by1, bh, y, sy, oh, s, H, &y0, &y1, &dy);
      const float* r0 = f + (size_t)y0 * W;
      const float* r1 = f + (size_t)y1 * W;
      for (int sx = 0; sx < s; ++sx) {
        int x0, x1;
        float dx;
        sample_pos(bx1, bw, x, sx, ow, s, W, &x0, &x1, &dx);
        const float top = (1.f - dx) * r0[x0] + dx * r0[x1];
        const float bot = (1.f - dx) * r1[x0] + dx * r1[x1];
        acc += (1.f - dy) * top + dy * bot;
      }
    }
    out[e] = acc * inv;
  }
}

}  // namespace

extern "C" int dmm_roi_align(const float* feats, const float* boxes, float* out, int K,
                             int C, int H, int W, int oh, int ow, int s, float scale,
                             void* stream) {
  if (K < 0 || C < 1 || H < 1 || W < 1 || oh < 1 || ow < 1 || s < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (K == 0) return static_cast<int>(cudaSuccess);
  const int64_t total = (int64_t)K * C * oh * ow;
  const int64_t blocks = (total + THREADS - 1) / THREADS;
  const int grid = (int)(blocks < (1 << 30) ? blocks : (1 << 30));
  roi_align_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      feats, boxes, out, K, C, H, W, oh, ow, s, scale);
  return static_cast<int>(cudaGetLastError());
}
