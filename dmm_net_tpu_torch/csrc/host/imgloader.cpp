// Host image loader of the PyTorch port: libjpeg/libpng decode plus an
// antialiased resize in a C++ thread pool, called through ctypes (which
// releases the GIL for the call), so the readers' decode runs beside the
// staging threads of data/pipeline.py instead of under the GIL.
// A copy of the JAX package's loader with the same C interface, so both
// packages decode a tree to the same bytes.
//
// Formats: JPEG (libjpeg) and PNG (libpng). Frames come out RGB8 resized
// with a separable antialiased triangle (bilinear) filter -- half-pixel
// sample centers, edge clamp, per-output weight normalization: the
// convention of PIL BILINEAR, within +-1/255 of it (exact equality across
// libraries is not defined because each rounds differently).
// Annotations (palette PNGs) come out as raw palette INDEX maps resized
// with half-pixel nearest -- label values are never interpolated.
//
// Bound by dmm_net_tpu_torch/data/native_loader.py, whose PIL path is the
// fallback and the oracle. Built at first use by
// dmm_net_tpu_torch/kernels/_build.py (g++, links -ljpeg -lpng -lpthread).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <csetjmp>

namespace {

// ---------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------

struct Image {
    int h = 0, w = 0, c = 0;      // c: 3 = RGB frame, 1 = palette indexes
    std::vector<uint8_t> px;      // (h, w, c) row-major
};

struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
    longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jump, 1);
}

bool decode_jpeg(FILE* f, Image& im) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    im.h = static_cast<int>(cinfo.output_height);
    im.w = static_cast<int>(cinfo.output_width);
    im.c = 3;
    im.px.resize(static_cast<size_t>(im.h) * im.w * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = im.px.data() +
            static_cast<size_t>(cinfo.output_scanline) * im.w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return true;
}

// want_palette: return raw palette indexes (annotations). Otherwise RGB.
bool decode_png(FILE* f, Image& im, bool want_palette) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING,
                                             nullptr, nullptr, nullptr);
    if (!png) return false;
    png_infop info = png_create_info_struct(png);
    if (!info) {
        png_destroy_read_struct(&png, nullptr, nullptr);
        return false;
    }
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        return false;
    }
    png_init_io(png, f);
    png_read_info(png, info);
    const int ctype = png_get_color_type(png, info);
    const int depth = png_get_bit_depth(png, info);

    if (want_palette) {
        if (ctype != PNG_COLOR_TYPE_PALETTE) {
            // grayscale annotation files also occur (label = gray value)
            if (ctype != PNG_COLOR_TYPE_GRAY) {
                png_destroy_read_struct(&png, &info, nullptr);
                return false;
            }
        }
        if (depth < 8) png_set_packing(png);   // 1/2/4-bit -> 1 byte/px
        if (depth == 16) png_set_strip_16(png);
        im.c = 1;
    } else {
        if (ctype == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
        if (ctype == PNG_COLOR_TYPE_GRAY && depth < 8)
            png_set_expand_gray_1_2_4_to_8(png);
        if (png_get_valid(png, info, PNG_INFO_tRNS))
            png_set_tRNS_to_alpha(png);
        if (depth == 16) png_set_strip_16(png);
        if (ctype == PNG_COLOR_TYPE_GRAY ||
            ctype == PNG_COLOR_TYPE_GRAY_ALPHA)
            png_set_gray_to_rgb(png);
        png_set_strip_alpha(png);
        im.c = 3;
    }
    png_read_update_info(png, info);
    im.h = static_cast<int>(png_get_image_height(png, info));
    im.w = static_cast<int>(png_get_image_width(png, info));
    im.px.resize(static_cast<size_t>(im.h) * im.w * im.c);
    std::vector<png_bytep> rows(im.h);
    for (int y = 0; y < im.h; ++y)
        rows[y] = im.px.data() + static_cast<size_t>(y) * im.w * im.c;
    png_read_image(png, rows.data());
    png_read_end(png, nullptr);
    png_destroy_read_struct(&png, &info, nullptr);
    return true;
}

bool decode_file(const char* path, Image& im, bool want_palette) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    uint8_t magic[2] = {0, 0};
    if (std::fread(magic, 1, 2, f) != 2) {
        std::fclose(f);
        return false;
    }
    std::rewind(f);
    bool ok = false;
    if (magic[0] == 0xFF && magic[1] == 0xD8) {          // JPEG
        ok = !want_palette && decode_jpeg(f, im);
    } else if (magic[0] == 0x89 && magic[1] == 'P') {    // PNG
        ok = decode_png(f, im, want_palette);
    }
    std::fclose(f);
    return ok;
}

// ---------------------------------------------------------------------
// resize
// ---------------------------------------------------------------------

// Precomputed sample window for one output coordinate.
struct Taps {
    int lo = 0, n = 0;            // input window [lo, lo+n)
    int woff = 0;                 // offset into the weight pool
};

// Antialiased triangle weights, half-pixel centers, edge clamp via
// window clipping + renormalization (PIL/jax downscale convention;
// degenerates to plain 2-tap bilinear for upscales).
void build_taps(int n_in, int n_out, std::vector<Taps>& taps,
                std::vector<float>& weights) {
    const double scale = static_cast<double>(n_in) / n_out;
    const double support = std::max(1.0, scale);
    taps.resize(n_out);
    weights.clear();
    for (int o = 0; o < n_out; ++o) {
        const double center = (o + 0.5) * scale - 0.5;
        int lo = static_cast<int>(std::ceil(center - support));
        int hi = static_cast<int>(std::floor(center + support));
        lo = std::max(lo, 0);
        hi = std::min(hi, n_in - 1);
        taps[o].lo = lo;
        taps[o].n = hi - lo + 1;
        taps[o].woff = static_cast<int>(weights.size());
        double sum = 0.0;
        for (int i = lo; i <= hi; ++i) {
            const double t = std::abs((i - center) / support);
            const double wgt = t < 1.0 ? 1.0 - t : 0.0;
            weights.push_back(static_cast<float>(wgt));
            sum += wgt;
        }
        if (sum > 0.0)
            for (int k = 0; k < taps[o].n; ++k)
                weights[taps[o].woff + k] /= static_cast<float>(sum);
    }
}

inline uint8_t to_u8(float v) {
    const int r = static_cast<int>(v + 0.5f);
    return static_cast<uint8_t>(std::min(std::max(r, 0), 255));
}

// (ih, iw, c) uint8 -> (oh, ow, c) uint8, separable, float accumulate.
void resize_bilinear(const uint8_t* in, int ih, int iw, int c,
                     uint8_t* out, int oh, int ow) {
    if (ih == oh && iw == ow) {
        std::memcpy(out, in, static_cast<size_t>(ih) * iw * c);
        return;
    }
    std::vector<Taps> tx, ty;
    std::vector<float> wx, wy;
    build_taps(iw, ow, tx, wx);
    build_taps(ih, oh, ty, wy);
    // horizontal pass: (ih, iw, c) -> (ih, ow, c) float
    std::vector<float> tmp(static_cast<size_t>(ih) * ow * c);
    for (int y = 0; y < ih; ++y) {
        const uint8_t* row = in + static_cast<size_t>(y) * iw * c;
        float* trow = tmp.data() + static_cast<size_t>(y) * ow * c;
        for (int o = 0; o < ow; ++o) {
            const Taps& t = tx[o];
            for (int ch = 0; ch < c; ++ch) {
                float acc = 0.f;
                for (int k = 0; k < t.n; ++k)
                    acc += wx[t.woff + k] * row[(t.lo + k) * c + ch];
                trow[o * c + ch] = acc;
            }
        }
    }
    // vertical pass: (ih, ow, c) -> (oh, ow, c) uint8
    for (int o = 0; o < oh; ++o) {
        const Taps& t = ty[o];
        uint8_t* orow = out + static_cast<size_t>(o) * ow * c;
        for (int x = 0; x < ow * c; ++x) {
            float acc = 0.f;
            for (int k = 0; k < t.n; ++k)
                acc += wy[t.woff + k] *
                       tmp[static_cast<size_t>(t.lo + k) * ow * c + x];
            orow[x] = to_u8(acc);
        }
    }
}

// half-pixel nearest (labels must never be interpolated)
void resize_nearest(const uint8_t* in, int ih, int iw,
                    uint8_t* out, int oh, int ow) {
    if (ih == oh && iw == ow) {
        std::memcpy(out, in, static_cast<size_t>(ih) * iw);
        return;
    }
    const double sy = static_cast<double>(ih) / oh;
    const double sx = static_cast<double>(iw) / ow;
    std::vector<int> xs(ow);
    for (int x = 0; x < ow; ++x)
        xs[x] = std::min(static_cast<int>((x + 0.5) * sx), iw - 1);
    for (int y = 0; y < oh; ++y) {
        const int yy = std::min(static_cast<int>((y + 0.5) * sy), ih - 1);
        const uint8_t* row = in + static_cast<size_t>(yy) * iw;
        uint8_t* orow = out + static_cast<size_t>(y) * ow;
        for (int x = 0; x < ow; ++x) orow[x] = row[xs[x]];
    }
}

// one item: decode + resize into the caller's slot
int load_one(const char* path, int oh, int ow, uint8_t* out,
             bool palette) {
    Image im;
    if (!decode_file(path, im, palette)) return -1;
    if (palette)
        resize_nearest(im.px.data(), im.h, im.w, out, oh, ow);
    else
        resize_bilinear(im.px.data(), im.h, im.w, 3, out, oh, ow);
    return 0;
}

int run_batch(const char** paths, int n, int oh, int ow, uint8_t* out,
              int nthreads, bool palette) {
    const size_t stride = static_cast<size_t>(oh) * ow * (palette ? 1 : 3);
    std::atomic<int> next(0), failures(0);
    auto worker = [&]() {
        for (;;) {
            const int i = next.fetch_add(1);
            if (i >= n) return;
            if (load_one(paths[i], oh, ow, out + stride * i, palette) != 0)
                failures.fetch_add(1);
        }
    };
    nthreads = std::max(1, std::min(nthreads, n));
    std::vector<std::thread> pool;
    pool.reserve(nthreads - 1);
    for (int t = 1; t < nthreads; ++t) pool.emplace_back(worker);
    worker();
    for (auto& th : pool) th.join();
    return failures.load();
}

// Header-only probes: dimensions come from the JPEG SOF / PNG IHDR
// headers, no pixel decode (the native-resolution loaders call probe to
// size their buffer and then decode ONCE; a decoding probe would double
// host decode cost on the eval path this loader exists to speed up).
bool probe_jpeg(FILE* f, int* h, int* w, int* c) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    *h = static_cast<int>(cinfo.image_height);
    *w = static_cast<int>(cinfo.image_width);
    *c = 3;
    jpeg_destroy_decompress(&cinfo);
    return true;
}

bool probe_png(FILE* f, int* h, int* w, int* c) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING,
                                             nullptr, nullptr, nullptr);
    if (!png) return false;
    png_infop info = png_create_info_struct(png);
    if (!info) {
        png_destroy_read_struct(&png, nullptr, nullptr);
        return false;
    }
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        return false;
    }
    png_init_io(png, f);
    png_read_info(png, info);
    *h = static_cast<int>(png_get_image_height(png, info));
    *w = static_cast<int>(png_get_image_width(png, info));
    const int ctype = png_get_color_type(png, info);
    // palette/gray = 1 (index/label maps) — same convention as the PIL
    // fallback in native_loader.probe (mode "P"/"L" -> 1)
    *c = (ctype == PNG_COLOR_TYPE_PALETTE ||
          ctype == PNG_COLOR_TYPE_GRAY) ? 1 : 3;
    png_destroy_read_struct(&png, &info, nullptr);
    return true;
}

}  // namespace

extern "C" {

// Header-only size probe. Returns 0 and fills h/w/c on success.
int imgl_probe(const char* path, int* h, int* w, int* c) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    uint8_t magic[2] = {0, 0};
    if (std::fread(magic, 1, 2, f) != 2) {
        std::fclose(f);
        return -1;
    }
    std::rewind(f);
    bool ok = false;
    if (magic[0] == 0xFF && magic[1] == 0xD8) {
        ok = probe_jpeg(f, h, w, c);
    } else if (magic[0] == 0x89 && magic[1] == 'P') {
        ok = probe_png(f, h, w, c);
    }
    std::fclose(f);
    return ok ? 0 : -1;
}

// Decode one RGB frame at NATIVE size into out (cap bytes). Returns
// bytes written or -1 (decode failure) / -2 (cap too small).
int imgl_decode_rgb(const char* path, uint8_t* out, long cap,
                    int* h, int* w) {
    Image im;
    if (!decode_file(path, im, false)) return -1;
    const long need = static_cast<long>(im.h) * im.w * 3;
    if (need > cap) return -2;
    std::memcpy(out, im.px.data(), need);
    *h = im.h;
    *w = im.w;
    return static_cast<int>(std::min<long>(need, 0x7FFFFFFF));
}

// Decode one palette/gray annotation at NATIVE size (index map).
int imgl_decode_palette(const char* path, uint8_t* out, long cap,
                        int* h, int* w) {
    Image im;
    if (!decode_file(path, im, true)) return -1;
    const long need = static_cast<long>(im.h) * im.w;
    if (need > cap) return -2;
    std::memcpy(out, im.px.data(), need);
    *h = im.h;
    *w = im.w;
    return static_cast<int>(std::min<long>(need, 0x7FFFFFFF));
}

// Batch decode+resize, threaded. out is (n, oh, ow, 3) uint8 row-major.
// Returns the number of failed items (0 = all good).
int imgl_load_rgb_batch(const char** paths, int n, int oh, int ow,
                        uint8_t* out, int nthreads) {
    return run_batch(paths, n, oh, ow, out, nthreads, false);
}

// Batch palette decode + NEAREST resize. out is (n, oh, ow) uint8.
int imgl_load_palette_batch(const char** paths, int n, int oh, int ow,
                            uint8_t* out, int nthreads) {
    return run_batch(paths, n, oh, ow, out, nthreads, true);
}

}  // extern "C"
