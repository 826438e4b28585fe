// Fused bilinear upsample + overlap argmax: mask-grid logits -> uint8 labels
// (kernel B2).
//
// Replaces the TPU kernel `fused_resolve_upsample` / `_resolve_kernel`
// (dmm_net_tpu/kernels/resolve.py), which runs the upsample as one bf16
// column-pass matmul over all objects and then, per object, a row-pass
// matmul with the running max and argmax kept in VMEM.  The interpolation
// matrices have at most two nonzeros per column, and those two are
// neighbours, so here the same two passes read their taps directly (the
// wrapper takes them from the bf16-rounded matrices, so clamped edge taps
// merge exactly as there):
//
//   u[m, y, X] = bf16(lg[m, y, cx(X)] * cw0(X) + lg[m, y, cx(X) + 1] * cw1(X))
//   U[m, Y, X] = u[m, ry0(Y), X] * rw0(Y) + u[m, ry1(Y), X] * rw1(Y)   (f32)
//   label      = argmax over valid m (strict >, lower index wins ties) + 1
//                where the best U > logit(bg_threshold), else 0
//
// with the logits rounded to bf16 first (f32 logits are rounded here, which
// saves the caller a cast pass).  The (B, M, H, W) upsampled tensor never
// exists.
//
// Bit-exact.  Every product is of two bf16 values (8-bit significands), so it
// is exact in f32, and every sum has at most two nonzero terms, so each pass
// rounds once, whether the compiler fuses to FMA or not, and whatever order a
// matmul takes the zero terms in.  The kernel, the plain version
// (`resolve_upsample_plain`) and the dense-matmul form give the same labels.
//
// Design: one block per (batch element b, band of TY = 32 output rows, tile of
// TX = 32 output columns), 128 threads; p3 B=4 (256x448) gives 448 blocks.
// The wrapper cuts the windows: the input rows a band's row taps reach and
// the input columns a tile's column taps reach (10 x 10 at a 4x upsample),
// each band's and tile's first one, and the largest of each, which size
// shared memory.  Index math is 32-bit from blockIdx.
//   1. Warp 0 compacts b's valid slots, in index order, and where each window
//      row of each starts in the logits.  Invalid objects are neither loaded
//      nor computed.
//   2. Per chunk of up to CH = 16 valid objects: the windows are staged into
//      shared memory, every copy in flight at once (cp.async for f32 logits).
//   3. The column pass, once per (object, window row, output column), into
//      shared memory as f32 holding the bf16 value; a thread's neighbouring
//      columns share their loads where their taps agree.
//   4. The row pass: each thread owns 4 consecutive output columns of 2
//      output rows, reads two float4 of column-pass values per object (one
//      pair for both rows when their taps agree, as at every 4x upsample),
//      and keeps the running max and argmax in registers.  Its 4 labels per
//      row go out as one 32-bit store where W % 4 == 0, else byte by byte.
//
// What bounds it on an NVIDIA H100 80GB HBM3 (700 W power limit): not bytes.
// At p3 B=16 (16 objects, 64x112 -> 256x448, f32 logits, 190 of 256 slots
// valid) the bound is 0.0022 ms (the valid slots' 5.45 MB of logits read,
// 1.84 MB of labels written, at 3.35 TB/s); the kernel takes 0.0195 ms, 9.0x
// that.  Copies of this file with one phase cut out (PERF.md) put the row
// pass and argmax (~6 instructions per pixel and valid object) at about
// 0.0066 ms, the logit loads at about 0.0034 ms, and the per-block work
// around them (valid slots, taps, staging, column pass, three barriers,
// stores) with the launch at 0.0094 ms, 0.0020 ms of that the launch and
// scheduling of 1792 blocks.  At the main path's B=4 (47 of 64 slots valid),
// 0.0075 ms against a bound of 0.00054 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;                 // output columns per block (one tile)
constexpr int TY = 32;                 // output rows per block (one band)
constexpr int CPT = 4;                 // output columns per thread
constexpr int RPT = 2;                 // output rows per thread
constexpr int GX = TX / CPT;           // threads across a row
constexpr int THREADS = GX * (TY / RPT);
constexpr int TROWS = THREADS / GX;    // thread rows
constexpr int CH = 16;                 // valid objects per chunk
constexpr int MIN_BLOCKS = 6;          // resident blocks per SM the registers must allow
constexpr int MAX_M = 255;             // labels are uint8
constexpr long long MAX_DYN_SMEM = 232448 - 2048;   // the block's 227 KB, less the static part

static_assert(RPT == 2, "the row pass below is written for two rows per thread");

// dynamic shared memory for windows of nwr input rows by nwc input columns
// and M slots: a chunk's column pass, its staged windows, and where each
// window row of every valid object starts in the logits
long long smem_bytes(int nwr, int nwc, int M) {
  return (long long)CH * nwr * (TX + nwc) * 4 + (long long)M * nwr * 4;
}

// stage one logit into shared memory as f32: asynchronously for f32 logits,
// through a register for bf16 ones
__device__ __forceinline__ void stage(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src) {
  *dst = __bfloat162float(__ldg(src));
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Row pass over a chunk's nch valid objects (list), in index order: each of
// this thread's RPT x CPT pixels keeps its running max and argmax.  SAME: both
// rows read the same two window rows, so they share the loads.
template <bool SAME>
__device__ __forceinline__ void row_pass(const float4* const (&p)[RPT][2], const float (&rw0)[RPT],
                                         const float (&rw1)[RPT], const int* list, int nch,
                                         int stride, float (&best)[RPT][CPT],
                                         int (&idx)[RPT][CPT]) {
  for (int j = 0; j < nch; ++j) {
    const int m = list[j];
    const int off = j * stride;
    float4 a[RPT], e[RPT];
    a[0] = p[0][0][off];
    e[0] = p[0][1][off];
    a[1] = SAME ? a[0] : p[1][0][off];
    e[1] = SAME ? e[0] : p[1][1][off];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float U = comp(a[r], c) * rw0[r] + comp(e[r], c) * rw1[r];
        if (U > best[r][c]) {
          best[r][c] = U;
          idx[r][c] = m;
        }
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
resolve_band_kernel(const T* __restrict__ logits,        // (B, M, h, w)
                    const uint8_t* __restrict__ valid,   // (B, M)
                    const int* __restrict__ band_lo,     // (ceil(H / TY),) first window row
                    const int* __restrict__ tile_lo,     // (ceil(W / TX),) first window column
                    const int* __restrict__ ridx,        // (H, 2)
                    const float* __restrict__ rw,        // (H, 2)
                    const int* __restrict__ cx,          // (W,) first of two neighbouring taps
                    const float* __restrict__ cw,        // (W, 2)
                    uint8_t* __restrict__ out,           // (B, H, W)
                    int M, int h, int w, int H, int W, int nwr, int nwc, float bg_logit) {
  extern __shared__ float4 s_u[];                              // [CH * nwr][GX]: column pass
  float* s_in = reinterpret_cast<float*>(s_u + CH * nwr * GX);  // [CH * nwr][nwc]: windows
  int* s_row = reinterpret_cast<int*>(s_in + CH * nwr * nwc);  // [M * nwr]: row offsets
  __shared__ int s_list[MAX_M + 1];
  __shared__ int s_nv;

  const int tid = threadIdx.x;
  const int gx = tid % GX, ty = tid / GX;
  const int b = blockIdx.z;
  const int Y0 = blockIdx.y * TY + ty * RPT;
  const int X0 = blockIdx.x * TX + gx * CPT;
  const int lo = band_lo[blockIdx.y];
  const int clo = tile_lo[blockIdx.x];

  // 1. warp 0: b's valid slots in index order, then where each window row
  //    q = j * nwr + r of each starts in b's logits
  if (tid < 32) {
    int n = 0;
    for (int m0 = 0; m0 < M; m0 += 32) {
      const int m = m0 + tid;
      const bool v = m < M && valid[(size_t)b * M + m] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, v);
      if (v) s_list[n + __popc(bal & ((1u << tid) - 1u))] = m;
      n += __popc(bal);
    }
    __syncwarp();
    for (int q = tid; q < n * nwr; q += 32) {
      const int j = q / nwr;
      s_row[q] = (s_list[j] * h + lo + q - j * nwr) * w + clo;
    }
    if (tid == 0) s_nv = n;
  }

  // taps of this thread's columns (two neighbours each) and rows, relative to
  // the block's window; columns and rows past the edge take the last one's
  // taps and store nothing
  int cx0[CPT];
  float cw0[CPT], cw1[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int X = min(X0 + c, W - 1);
    cx0[c] = cx[X] - clo;
    cw0[c] = cw[2 * X];
    cw1[c] = cw[2 * X + 1];
  }
  // columns 0 and 1, and 2 and 3, read the same two logits, as at every 4x
  // upsample
  const bool paired = cx0[1] == cx0[0] && cx0[3] == cx0[2];
  const float4* p_u[RPT][2];
  float rw0[RPT], rw1[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int Y = min(Y0 + r, H - 1);
    p_u[r][0] = s_u + (ridx[2 * Y] - lo) * GX + gx;
    p_u[r][1] = s_u + (ridx[2 * Y + 1] - lo) * GX + gx;
    rw0[r] = rw[2 * Y];
    rw1[r] = rw[2 * Y + 1];
  }
  // both rows read the same two window rows, as at every 4x upsample
  const bool same = p_u[1][0] == p_u[0][0] && p_u[1][1] == p_u[0][1];

  float best[RPT][CPT];
  int idx[RPT][CPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      best[r][c] = -INFINITY;
      idx[r][c] = 0;
    }

  __syncthreads();
  const int nv = s_nv;
  const T* lg_b = logits + (size_t)b * M * h * w;

  for (int c0 = 0; c0 < nv; c0 += CH) {
    const int nch = min(CH, nv - c0);
    const int nq = nch * nwr;          // window rows of the chunk
    const int* rows = s_row + c0 * nwr;

    // 2. stage the chunk's windows: every copy in flight at once
    for (int q = ty; q < nq; q += TROWS) {
      const T* src = lg_b + rows[q];
      float* dst = s_in + q * nwc;
      for (int c = gx; c < nwc; c += GX) stage(dst + c, src + c);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    // 3. column pass, window row q, this thread's 4 columns: the logits
    //    rounded to bf16, the sum rounded to bf16
    for (int q = ty; q < nq; q += TROWS) {
      const float* row = s_in + q * nwc;
      float u[CPT];
      if (paired) {
#pragma unroll
        for (int c = 0; c < CPT; c += 2) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(row[cx0[c]], row[cx0[c] + 1]);
          u[c] = __low2float(v) * cw0[c] + __high2float(v) * cw1[c];
          u[c + 1] = __low2float(v) * cw0[c + 1] + __high2float(v) * cw1[c + 1];
        }
      } else {
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(row[cx0[c]], row[cx0[c] + 1]);
          u[c] = __low2float(v) * cw0[c] + __high2float(v) * cw1[c];
        }
      }
      const __nv_bfloat162 u01 = __floats2bfloat162_rn(u[0], u[1]);
      const __nv_bfloat162 u23 = __floats2bfloat162_rn(u[2], u[3]);
      s_u[q * GX + gx] =
          make_float4(__low2float(u01), __high2float(u01), __low2float(u23), __high2float(u23));
    }
    __syncthreads();

    // 4. row pass and running max / argmax, objects in index order
    if (same)
      row_pass<true>(p_u, rw0, rw1, s_list + c0, nch, nwr * GX, best, idx);
    else
      row_pass<false>(p_u, rw0, rw1, s_list + c0, nch, nwr * GX, best, idx);
    __syncthreads();                   // shared memory is free for the next chunk
  }

  // labels: one 32-bit store per row where W % 4 == 0, else byte by byte
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int Y = Y0 + r;
    if (Y >= H || X0 >= W) continue;
    uint8_t lab[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      lab[c] = best[r][c] > bg_logit ? (uint8_t)(idx[r][c] + 1) : (uint8_t)0;
    uint8_t* o = out + ((size_t)b * H + Y) * W + X0;
    if ((W & 3) == 0) {
      *reinterpret_cast<uint32_t*>(o) = (uint32_t)lab[0] | ((uint32_t)lab[1] << 8) |
                                        ((uint32_t)lab[2] << 16) | ((uint32_t)lab[3] << 24);
    } else {
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        if (X0 + c < W) o[c] = lab[c];
    }
  }
}

template <typename T>
int launch(const T* logits, const uint8_t* valid, const int* band_lo, const int* tile_lo,
           const int* ridx, const float* rw, const int* cx, const float* cw, uint8_t* out, int B,
           int M, int h, int w, int H, int W, int nwr, int nwc, float bg_logit, void* stream) {
  const long long smem = smem_bytes(nwr, nwc, M);
  if (B < 1 || B > 65535 || M < 1 || M > MAX_M || h < 1 || w < 2 || H < 1 || W < 1 ||
      nwr < 1 || nwc < 2 || (H + TY - 1) / TY > 65535 ||
      (long long)M * h * w > 0x7fffffffLL || smem > MAX_DYN_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem + 2048 > 48 * 1024) {       // past the default 48 KB with the static part
    const cudaError_t err = cudaFuncSetAttribute(
        resolve_band_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  resolve_band_kernel<T><<<grid, THREADS, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      logits, valid, band_lo, tile_lo, ridx, rw, cx, cw, out, M, h, w, H, W, nwr, nwc,
      bg_logit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory the kernel needs for windows of nwr input rows by nwc
// input columns and M slots, or -1 where that is more than a block has.
extern "C" long long dmm_resolve_smem_bytes(int nwr, int nwc, int M) {
  const long long smem = smem_bytes(nwr, nwc, M);
  return smem <= MAX_DYN_SMEM ? smem : -1;
}

// Output rows and output columns per block: the wrapper cuts its windows to
// these bands and tiles.
extern "C" int dmm_resolve_band_rows() { return TY; }
extern "C" int dmm_resolve_tile_cols() { return TX; }

// band_lo, tile_lo: each band's first window row and each tile's first window
// column; nwr, nwc: rows and columns of the largest window; cx: each output
// column's first input column, read with its right neighbour (w >= 2).
// Returns cudaGetLastError().
extern "C" int dmm_resolve_upsample_f32(const float* logits, const uint8_t* valid,
                                        const int* band_lo, const int* tile_lo, const int* ridx,
                                        const float* rw, const int* cx, const float* cw,
                                        uint8_t* out, int B, int M, int h, int w, int H, int W,
                                        int nwr, int nwc, float bg_logit, void* stream) {
  return launch(logits, valid, band_lo, tile_lo, ridx, rw, cx, cw, out, B, M, h, w, H, W, nwr,
                nwc, bg_logit, stream);
}

extern "C" int dmm_resolve_upsample_bf16(const void* logits, const uint8_t* valid,
                                         const int* band_lo, const int* tile_lo, const int* ridx,
                                         const float* rw, const int* cx, const float* cw,
                                         uint8_t* out, int B, int M, int h, int w, int H, int W,
                                         int nwr, int nwc, float bg_logit, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(logits), valid, band_lo, tile_lo, ridx, rw,
                cx, cw, out, B, M, h, w, H, W, nwr, nwc, bg_logit, stream);
}
