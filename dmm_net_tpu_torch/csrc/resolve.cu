// Fused bilinear upsample + overlap argmax: mask-grid logits -> uint8 labels.
//
// Replaces the TPU kernel `fused_resolve_upsample` / `_resolve_kernel`
// (dmm_net_tpu/kernels/resolve.py).  The TPU kernel runs the upsample as two
// bf16 matmuls against interpolation matrices; here each output pixel is one
// thread that reads its taps directly.  Bilinear upsampling has at most two
// nonzero weights per output row and column, and the wrapper passes them
// (taken from the bf16-rounded interpolation matrices, so clamped edge taps
// merge exactly as in the matrix).  With bf16 operands every product is exact
// in f32, so the per-pixel sums round exactly as the matmuls do:
//
//   u_y   = bf16(lg[m, y, x0] * cw0 + lg[m, y, x1] * cw1)   for y in {y0, y1}
//   U     = u_y0 * rw0 + u_y1 * rw1                          (f32)
//   label = argmax over valid m (strict >, lower index wins ties) + 1
//           where the best U > logit(bg_threshold), else 0
//
// The (B, M, H, W) upsampled tensor never exists.  Logits may arrive as f32
// (rounded to bf16 here, which saves the caller a cast pass) or bf16.
//
// What bounds it on an H100: bytes.  At p3 (B=16, M=16, 64x112 -> 256x448)
// it must read the logits once (7.3 MB as f32) and write 1.8 MB of labels:
// ~2.7 us at 3.35 TB/s.  Neighbouring threads share taps, so the repeated
// logit reads are served from L1/L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_bf16_f32(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load_bf16(const float* p) { return to_bf16_f32(*p); }
__device__ __forceinline__ float load_bf16(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T>
__global__ void resolve_kernel(const T* __restrict__ logits,        // (B, M, h, w)
                               const uint8_t* __restrict__ valid,   // (B, M)
                               const int* __restrict__ ridx,        // (H, 2)
                               const float* __restrict__ rw,        // (H, 2)
                               const int* __restrict__ cidx,        // (W, 2)
                               const float* __restrict__ cw,        // (W, 2)
                               uint8_t* __restrict__ out,           // (B, H, W)
                               int B, int M, int h, int w, int H, int W, float bg_logit) {
  const long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)B * H * W;
  if (pix >= total) return;
  const int X = (int)(pix % W);
  const int Y = (int)((pix / W) % H);
  const int b = (int)(pix / ((long long)H * W));

  const int y0 = ridx[2 * Y], y1 = ridx[2 * Y + 1];
  const float rw0 = rw[2 * Y], rw1 = rw[2 * Y + 1];
  const int x0 = cidx[2 * X], x1 = cidx[2 * X + 1];
  const float cw0 = cw[2 * X], cw1 = cw[2 * X + 1];

  float best = -INFINITY;
  int idx = 0;
  for (int m = 0; m < M; ++m) {
    if (!valid[(size_t)b * M + m]) continue;
    const T* lg = logits + ((size_t)b * M + m) * h * w;
    const float u0 = to_bf16_f32(load_bf16(lg + (size_t)y0 * w + x0) * cw0 +
                                 load_bf16(lg + (size_t)y0 * w + x1) * cw1);
    const float u1 = to_bf16_f32(load_bf16(lg + (size_t)y1 * w + x0) * cw0 +
                                 load_bf16(lg + (size_t)y1 * w + x1) * cw1);
    const float U = u0 * rw0 + u1 * rw1;
    if (U > best) {
      best = U;
      idx = m;
    }
  }
  out[pix] = best > bg_logit ? (uint8_t)(idx + 1) : (uint8_t)0;
}

template <typename T>
int launch(const T* logits, const uint8_t* valid, const int* ridx, const float* rw,
           const int* cidx, const float* cw, uint8_t* out, int B, int M, int h, int w,
           int H, int W, float bg_logit, void* stream) {
  const long long total = (long long)B * H * W;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (total <= 0 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  resolve_kernel<T><<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      logits, valid, ridx, rw, cidx, cw, out, B, M, h, w, H, W, bg_logit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dmm_resolve_upsample_f32(const float* logits, const uint8_t* valid,
                                        const int* ridx, const float* rw, const int* cidx,
                                        const float* cw, uint8_t* out, int B, int M, int h,
                                        int w, int H, int W, float bg_logit, void* stream) {
  return launch(logits, valid, ridx, rw, cidx, cw, out, B, M, h, w, H, W, bg_logit, stream);
}

extern "C" int dmm_resolve_upsample_bf16(const void* logits, const uint8_t* valid,
                                         const int* ridx, const float* rw, const int* cidx,
                                         const float* cw, uint8_t* out, int B, int M, int h,
                                         int w, int H, int W, float bg_logit, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(logits), valid, ridx, rw, cidx, cw, out, B,
                M, h, w, H, W, bg_logit, stream);
}
