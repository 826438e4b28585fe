// Host RLE mask codec of the PyTorch port, the counterpart of cocoapi's
// maskApi.c: encode, decode and IoU of run lengths. A copy of the JAX
// package's codec with the same C interface. Bound by
// dmm_net_tpu_torch/ops/rle.py, whose numpy code is the plain version and
// the oracle. Column-major (Fortran) pixel order; runs alternate, the
// zero-run first, as COCO's.
//
// Built at first use by dmm_net_tpu_torch/kernels/_build.py (g++).

#include <cstdint>
#include <cstddef>
#include <algorithm>

extern "C" {

// Encode h*w column-major binary pixels into run lengths.
// Returns the number of runs written, or -1 if out_cap is too small.
int rle_encode(const uint8_t* pixels, int h, int w, uint32_t* out, int out_cap) {
    const long n = static_cast<long>(h) * w;
    int m = 0;
    uint8_t cur = 0;            // runs start with the zero-run
    uint32_t len = 0;
    for (long i = 0; i < n; ++i) {
        const uint8_t v = pixels[i] ? 1 : 0;
        if (v != cur) {
            if (m >= out_cap) return -1;
            out[m++] = len;
            len = 0;
            cur = v;
        }
        ++len;
    }
    if (m >= out_cap) return -1;
    out[m++] = len;
    return m;
}

// Decode run lengths into out (column-major). Returns pixels written.
int rle_decode(const uint32_t* counts, int m, uint8_t* out, int out_cap) {
    long p = 0;
    uint8_t v = 0;
    for (int i = 0; i < m; ++i) {
        const long end = std::min<long>(p + counts[i], out_cap);
        for (; p < end; ++p) out[p] = v;
        v = 1 - v;
    }
    return static_cast<int>(p);
}

// IoU of two RLE masks by run intersection — no decode, O(ma + mb).
double rle_iou(const uint32_t* a, int ma, const uint32_t* b, int mb) {
    // absolute run boundaries; value of run i is (i % 2 == 1)
    long area_a = 0, area_b = 0;
    for (int i = 1; i < ma; i += 2) area_a += a[i];
    for (int i = 1; i < mb; i += 2) area_b += b[i];
    if (area_a + area_b == 0) return 0.0;

    long inter = 0;
    long ca = ma > 0 ? static_cast<long>(a[0]) : 0;  // end of current a-run
    long cb = mb > 0 ? static_cast<long>(b[0]) : 0;
    int ia = 0, ib = 0;
    long pos = 0;
    while (ia < ma && ib < mb) {
        const long nxt = std::min(ca, cb);
        if ((ia & 1) && (ib & 1)) inter += nxt - pos;
        pos = nxt;
        if (ca <= nxt && ia < ma) { ++ia; if (ia < ma) ca += a[ia]; }
        if (cb <= nxt && ib < mb) { ++ib; if (ib < mb) cb += b[ib]; }
    }
    const double uni = static_cast<double>(area_a + area_b - inter);
    return uni > 0 ? static_cast<double>(inter) / uni : 0.0;
}

}  // extern "C"
