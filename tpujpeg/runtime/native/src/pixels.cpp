// Native host pixel stage: dequant + inverse zigzag + integer IDCT +
// chroma upsampling (box / libjpeg-fancy) + exact color conversion.
//
// Together with entropy.cpp this makes the host path a COMPLETE CPU
// decoder — the host-side analog of the reference's cpp-decoder
// (cpp-decoder/src/{idct,color}.cpp), kept bit-identical to the NumPy
// oracle (tpujpeg/oracle/decoder.py:211-369, itself the reference's
// bit-exactness contract).  The prior host full-decode ran the XLA
// pixel program on CPU and lost to PIL on the same cores; this stage is
// plain C++ parallelized with OpenMP over
// MCUs / plane rows.
//
// Exactness notes:
//  - IDCT runs the oracle's int64 intermediate math (>>8 row pass,
//    >>14 column pass, clip [-256, 255]) so corrupt-stream garbage
//    matches the oracle bit for bit, not just conformant streams.
//  - Color reproduces the mixed-precision float semantics exactly:
//    double products, one float32 rounding per channel, +128.0f in
//    float32, truncating int cast, clamp (oracle ycbcr_to_rgb_exact).
//  - Fancy upsampling is the shared ops/upsample.py definition: h2v1 /
//    h1v2 single rounded pass, h2v2 unrounded 3:1 column sums then one
//    rounded horizontal pass (biases 8/7, >>4); factors > 2 box.
//
// Exported (C ABI, ctypes):
//   tpj_pixels32 / tpj_pixels16 - full pixel stage from int32/int16
//                                 zigzag coefficients

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include "omp_compat.h"

namespace {

constexpr int kZ2N[64] = {
    0, 1, 5, 6, 14, 15, 27, 28, 2, 4, 7, 13, 16, 26, 29, 42,
    3, 8, 12, 17, 25, 30, 41, 43, 9, 11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

// 2048*sqrt(2)*cos(k*pi/16) fixed-point constants (constants.py:65-70,
// reference cpp-decoder/src/idct.cpp).
constexpr int64_t C1 = 2841, C2 = 2676, C3 = 2408, C5 = 1609, C6 = 1108,
                  C7 = 565;

inline int16_t clip_pix(int64_t v) {
  return static_cast<int16_t>(v < -256 ? -256 : (v > 255 ? 255 : v));
}

// 8-lane int64 vectors (GCC vector extensions; one AVX-512 zmm on this
// class of host, legalized to narrower registers elsewhere).  int64
// intermediates are part of the exactness contract — corrupt-stream
// coefficient garbage overflows any int32 formulation (see the
// extreme-coefficient tests) — and AVX-512DQ makes 8-wide int64
// multiplies native, so the vector form loses nothing to a narrower one.
typedef int64_t v8i __attribute__((vector_size(64)));
typedef int16_t v8s __attribute__((vector_size(16)));

static inline v8i v8i_load(const int64_t* p) {
  v8i v;
  std::memcpy(&v, p, sizeof(v));
  return v;
}

// In-register 8x8 int64 transpose: 3 stages x 8 generic shuffles.
static inline void transpose8(v8i r[8]) {
  v8i u0 = __builtin_shufflevector(r[0], r[1], 0, 8, 2, 10, 4, 12, 6, 14);
  v8i u1 = __builtin_shufflevector(r[0], r[1], 1, 9, 3, 11, 5, 13, 7, 15);
  v8i u2 = __builtin_shufflevector(r[2], r[3], 0, 8, 2, 10, 4, 12, 6, 14);
  v8i u3 = __builtin_shufflevector(r[2], r[3], 1, 9, 3, 11, 5, 13, 7, 15);
  v8i u4 = __builtin_shufflevector(r[4], r[5], 0, 8, 2, 10, 4, 12, 6, 14);
  v8i u5 = __builtin_shufflevector(r[4], r[5], 1, 9, 3, 11, 5, 13, 7, 15);
  v8i u6 = __builtin_shufflevector(r[6], r[7], 0, 8, 2, 10, 4, 12, 6, 14);
  v8i u7 = __builtin_shufflevector(r[6], r[7], 1, 9, 3, 11, 5, 13, 7, 15);
  v8i v0 = __builtin_shufflevector(u0, u2, 0, 1, 8, 9, 4, 5, 12, 13);
  v8i v2 = __builtin_shufflevector(u0, u2, 2, 3, 10, 11, 6, 7, 14, 15);
  v8i v1 = __builtin_shufflevector(u1, u3, 0, 1, 8, 9, 4, 5, 12, 13);
  v8i v3 = __builtin_shufflevector(u1, u3, 2, 3, 10, 11, 6, 7, 14, 15);
  v8i v4 = __builtin_shufflevector(u4, u6, 0, 1, 8, 9, 4, 5, 12, 13);
  v8i v6 = __builtin_shufflevector(u4, u6, 2, 3, 10, 11, 6, 7, 14, 15);
  v8i v5 = __builtin_shufflevector(u5, u7, 0, 1, 8, 9, 4, 5, 12, 13);
  v8i v7 = __builtin_shufflevector(u5, u7, 2, 3, 10, 11, 6, 7, 14, 15);
  r[0] = __builtin_shufflevector(v0, v4, 0, 1, 2, 3, 8, 9, 10, 11);
  r[4] = __builtin_shufflevector(v0, v4, 4, 5, 6, 7, 12, 13, 14, 15);
  r[1] = __builtin_shufflevector(v1, v5, 0, 1, 2, 3, 8, 9, 10, 11);
  r[5] = __builtin_shufflevector(v1, v5, 4, 5, 6, 7, 12, 13, 14, 15);
  r[2] = __builtin_shufflevector(v2, v6, 0, 1, 2, 3, 8, 9, 10, 11);
  r[6] = __builtin_shufflevector(v2, v6, 4, 5, 6, 7, 12, 13, 14, 15);
  r[3] = __builtin_shufflevector(v3, v7, 0, 1, 2, 3, 8, 9, 10, 11);
  r[7] = __builtin_shufflevector(v3, v7, 4, 5, 6, 7, 12, 13, 14, 15);
}

// One 8x8 block: dequant (zigzag domain) + inverse zigzag + two-pass
// integer IDCT, both passes 8 lanes wide.  `zz` is the block's 64 zigzag
// coefficients, `q` the component's zigzag quant table; writes centered
// pixels [-256, 255] into `out` with row stride `stride`.
//
// The row pass vectorizes ACROSS ROWS (each variable holds one natural
// column over all 8 rows — the dequant loop writes the natural block
// TRANSPOSED so those vectors load contiguously for free), producing
// the columns of the intermediate; one in-register transpose then hands
// the column pass its row vectors, which vectorize ACROSS COLUMNS and
// store straight to the output rows.  Arithmetic is the scalar
// schedule's, verbatim — bit-identical to the oracle by construction.
template <typename T>
void idct_block(const T* zz, const int32_t* q, int16_t* out, int64_t stride) {
  alignas(64) int64_t natt[64];  // natt[c*8 + r] = dequant natural [r][c]
  for (int p = 0; p < 64; ++p) {
    const int z = kZ2N[p];
    // inverse of natural[p] = deq[Z2N[p]] (oracle dequantize)
    natt[(p & 7) * 8 + (p >> 3)] = static_cast<int64_t>(zz[z]) * q[z];
  }
  // Row pass: butterfly inputs are columns 0,4,6,2,1,7,5,3 of each row.
  v8i x0 = (v8i_load(natt + 0 * 8) << 11) + 128,
      x1 = v8i_load(natt + 4 * 8) << 11, x2 = v8i_load(natt + 6 * 8),
      x3 = v8i_load(natt + 2 * 8), x4 = v8i_load(natt + 1 * 8),
      x5 = v8i_load(natt + 7 * 8), x6 = v8i_load(natt + 5 * 8),
      x7 = v8i_load(natt + 3 * 8), x8;
  x8 = C7 * (x4 + x5);
  x4 = x8 + (C1 - C7) * x4;
  x5 = x8 - (C1 + C7) * x5;
  x8 = C3 * (x6 + x7);
  x6 = x8 - (C3 - C5) * x6;
  x7 = x8 - (C3 + C5) * x7;
  x8 = x0 + x1;
  x0 = x0 - x1;
  x1 = C6 * (x3 + x2);
  x2 = x1 - (C2 + C6) * x2;
  x3 = x1 + (C2 - C6) * x3;
  x1 = x4 + x6;
  x4 = x4 - x6;
  x6 = x5 + x7;
  x5 = x5 - x7;
  x7 = x8 + x3;
  x8 = x8 - x3;
  x3 = x0 + x2;
  x0 = x0 - x2;
  x2 = (181 * (x4 + x5) + 128) >> 8;
  x4 = (181 * (x4 - x5) + 128) >> 8;
  v8i t[8];  // t[j][r] = intermediate [r][j] (columns); transposed to rows
  t[0] = (x7 + x1) >> 8;
  t[1] = (x3 + x2) >> 8;
  t[2] = (x0 + x4) >> 8;
  t[3] = (x8 + x6) >> 8;
  t[4] = (x8 - x6) >> 8;
  t[5] = (x0 - x4) >> 8;
  t[6] = (x3 - x2) >> 8;
  t[7] = (x7 - x1) >> 8;
  transpose8(t);
  // Column pass: same permutation over rows, >>14 with clip.
  x0 = (t[0] << 8) + 8192;
  x1 = t[4] << 8;
  x2 = t[6];
  x3 = t[2];
  x4 = t[1];
  x5 = t[7];
  x6 = t[5];
  x7 = t[3];
  x8 = C7 * (x4 + x5) + 4;
  x4 = (x8 + (C1 - C7) * x4) >> 3;
  x5 = (x8 - (C1 + C7) * x5) >> 3;
  x8 = C3 * (x6 + x7) + 4;
  x6 = (x8 - (C3 - C5) * x6) >> 3;
  x7 = (x8 - (C3 + C5) * x7) >> 3;
  x8 = x0 + x1;
  x0 = x0 - x1;
  x1 = C6 * (x3 + x2) + 4;
  x2 = (x1 - (C2 + C6) * x2) >> 3;
  x3 = (x1 + (C2 - C6) * x3) >> 3;
  x1 = x4 + x6;
  x4 = x4 - x6;
  x6 = x5 + x7;
  x5 = x5 - x7;
  x7 = x8 + x3;
  x8 = x8 - x3;
  x3 = x0 + x2;
  x0 = x0 - x2;
  x2 = (181 * (x4 + x5) + 128) >> 8;
  x4 = (181 * (x4 - x5) + 128) >> 8;
  const v8i rows[8] = {(x7 + x1) >> 14, (x3 + x2) >> 14, (x0 + x4) >> 14,
                       (x8 + x6) >> 14, (x8 - x6) >> 14, (x0 - x4) >> 14,
                       (x3 - x2) >> 14, (x7 - x1) >> 14};
  const v8i lo = {-256, -256, -256, -256, -256, -256, -256, -256};
  const v8i hi = {255, 255, 255, 255, 255, 255, 255, 255};
  for (int k = 0; k < 8; ++k) {
    v8i v = rows[k];
    v = v < lo ? lo : v;
    v = v > hi ? hi : v;
    const v8s s = __builtin_convertvector(v, v8s);
    std::memcpy(out + k * stride, &s, sizeof(s));
  }
}

inline int clamp255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

// Build ONE upsampled row (output row r, width sw*fh) from a native
// plane [sh, sw] — the upsample stage fused into the color loop's row
// walk, so no full-resolution chroma plane is ever materialized (at
// 2000^2 4:2:0 that is ~16 MB of write+read traffic per image gone, and
// rows above the true image height are never computed at all).  Runs
// inside the color stage's parallel region: no omp here.
//
// Formulas are ops/upsample.py verbatim: box replication for any
// factors, libjpeg fancy (triangle) h2v2 / h2v1 / h1v2 on CLAMPED
// samples with edge replication at the padded plane edge.  The h2v2
// column sums are recomputed for each of the two output rows that share
// them — cheaper than materializing the plane they'd be cached in.
void upsample_row(const int16_t* plane, int64_t sh, int64_t sw, int fh,
                  int fv, bool fancy, int64_t r, int16_t* d) {
  if (!fancy) {
    const int16_t* s = plane + (r / fv) * sw;
    for (int64_t c = 0; c < sw; ++c) {
      for (int f = 0; f < fh; ++f) d[c * fh + f] = s[c];
    }
    return;
  }
  if (fh == 2 && fv == 2) {
    const int64_t rr = r >> 1;
    const int16_t* s = plane + rr * sw;
    const int16_t* n = (r & 1) ? plane + (rr + 1 < sh ? rr + 1 : sh - 1) * sw
                               : plane + (rr ? rr - 1 : 0) * sw;
    // unrounded 12-bit column sums, one rounded horizontal pass
    for (int64_t c = 0; c < sw; ++c) {
      const int cs = 3 * (clamp255(s[c] + 128)) + clamp255(n[c] + 128);
      const int csl = 3 * (clamp255(s[c ? c - 1 : 0] + 128)) +
                      clamp255(n[c ? c - 1 : 0] + 128);
      const int64_t cr = c + 1 < sw ? c + 1 : sw - 1;
      const int csr = 3 * (clamp255(s[cr] + 128)) + clamp255(n[cr] + 128);
      d[2 * c] = static_cast<int16_t>(((3 * cs + csl + 8) >> 4) - 128);
      d[2 * c + 1] = static_cast<int16_t>(((3 * cs + csr + 7) >> 4) - 128);
    }
    return;
  }
  if (fh == 2 && fv == 1) {
    const int16_t* s = plane + r * sw;
    for (int64_t c = 0; c < sw; ++c) {
      const int mid = clamp255(s[c] + 128);
      const int left = clamp255(s[c ? c - 1 : 0] + 128);
      const int right = clamp255(s[c + 1 < sw ? c + 1 : sw - 1] + 128);
      d[2 * c] = static_cast<int16_t>(((3 * mid + left + 1) >> 2) - 128);
      d[2 * c + 1] = static_cast<int16_t>(((3 * mid + right + 2) >> 2) - 128);
    }
    return;
  }
  // fh == 1 && fv == 2 (h1v2): the transposed single rounded pass
  const int64_t rr = r >> 1;
  const int16_t* s = plane + rr * sw;
  const int16_t* n = (r & 1) ? plane + (rr + 1 < sh ? rr + 1 : sh - 1) * sw
                             : plane + (rr ? rr - 1 : 0) * sw;
  const int bias = (r & 1) ? 2 : 1;
  for (int64_t c = 0; c < sw; ++c) {
    d[c] = static_cast<int16_t>(
        ((3 * clamp255(s[c] + 128) + clamp255(n[c] + 128) + bias) >> 2) -
        128);
  }
}

// Per-thread growable scratch arena.  The full-resolution planes at
// 2000^2 are ~24 MB; a fresh malloc/free per call hands them back to
// the OS (glibc mmap threshold) and every decode repays the soft
// page-fault cost of first-touching them.  BatchDecoder calls the pixel
// stage from a persistent worker pool, so thread-local reuse makes the
// buffers warm after the first image of each size class.
struct Arena {
  void* p = nullptr;
  size_t cap = 0;
  ~Arena() { free(p); }
  void* get(size_t n) {
    if (n > cap) {
      free(p);
      p = malloc(n);
      cap = p ? n : 0;
    }
    return p;
  }
};
thread_local Arena g_pixels_arena;

template <typename T>
int32_t pixels_impl(const T* coeffs, const int32_t* quant,
                    const int32_t* comp_h, const int32_t* comp_v,
                    const int32_t* comp_q, int64_t n_comp, int64_t mcus_x,
                    int64_t mcus_y, int64_t width, int64_t height,
                    int32_t fancy, int32_t n_threads, uint8_t* out) {
  if (n_comp != 1 && n_comp != 3) return -10;
  int max_h = 1, max_v = 1;
  int64_t bpm = 0;
  for (int64_t ci = 0; ci < n_comp; ++ci) {
    if (comp_h[ci] < 1 || comp_h[ci] > 4 || comp_v[ci] < 1 || comp_v[ci] > 4)
      return -10;
    if (comp_h[ci] > max_h) max_h = comp_h[ci];
    if (comp_v[ci] > max_v) max_v = comp_v[ci];
    bpm += comp_h[ci] * comp_v[ci];
  }
  const int64_t W8 = mcus_x * max_h * 8, H8 = mcus_y * max_v * 8;
  if (width < 1 || height < 1 || width > W8 || height > H8) return -10;

  // NATIVE-resolution centered planes per component (int16: IDCT output
  // is [-256, 255]) plus the color stage's per-thread row buffers
  // (upsampled chroma rows + planar RGB rows), carved from one
  // thread-local arena.  Full-resolution chroma planes are never
  // materialized: upsample_row builds each row on the fly inside the
  // color walk.
  // n_threads > 0 caps the OpenMP teams: batch drivers decode many
  // images concurrently on a thread pool, where image-level parallelism
  // beats oversubscribed intra-image teams (runtime/batch.py passes 1).
  const int nt = n_threads > 0 ? int(n_threads) : omp_get_max_threads();
  int64_t plane_off[4] = {0, 0, 0, 0};
  int n_sub = 0;  // subsampled components needing a row buffer
  for (int64_t ci = 0; ci < n_comp; ++ci) {
    const int64_t sh = mcus_y * comp_v[ci] * 8, sw = mcus_x * comp_h[ci] * 8;
    plane_off[ci + 1] = plane_off[ci] + sh * sw;
    if (sh != H8 || sw != W8) ++n_sub;
  }
  const size_t planes_bytes = sizeof(int16_t) * plane_off[n_comp];
  // chroma rows + r/g/b byte rows + the color stage's pass buffers
  // (3 double widen rows + 2 float rows): splitting the exact color
  // math into per-array passes is what lets gcc vectorize it — the
  // one-loop form was REJECTED by the vectorizer ("unsupported
  // data-type double"), leaving a scalar vdivsd per pixel that
  // dominated the whole native decode (r4 profile: pixels 184 ms vs
  // entropy 98 ms per 32x640^2).
  const size_t threadrow_bytes =
      sizeof(int16_t) * n_sub * W8 + 3 * W8 +
      sizeof(double) * 3 * W8 + sizeof(float) * 2 * W8;
  char* arena = static_cast<char*>(
      g_pixels_arena.get(planes_bytes + threadrow_bytes * nt));
  if (!arena) return -11;
  int16_t* plane_of[3] = {nullptr, nullptr, nullptr};
  for (int64_t ci = 0; ci < n_comp; ++ci)
    plane_of[ci] = reinterpret_cast<int16_t*>(arena) + plane_off[ci];
  char* threadrows = arena + planes_bytes;

  int64_t base = 0;
  for (int64_t ci = 0; ci < n_comp; ++ci) {
    const int h = comp_h[ci], v = comp_v[ci];
    const int64_t sw = mcus_x * h * 8;
    int16_t* plane = plane_of[ci];
    const int32_t* q = quant + comp_q[ci] * 64;
#pragma omp parallel for collapse(2) schedule(static) num_threads(nt)
    for (int64_t my = 0; my < mcus_y; ++my) {
      for (int64_t mx = 0; mx < mcus_x; ++mx) {
        const int64_t mcu = my * mcus_x + mx;
        for (int bv = 0; bv < v; ++bv) {
          for (int bh = 0; bh < h; ++bh) {
            const int64_t blk = mcu * bpm + base + bv * h + bh;
            int16_t* dst =
                plane + (my * v + bv) * 8 * sw + (mx * h + bh) * 8;
            idct_block(coeffs + blk * 64, q, dst, sw);
          }
        }
      }
    }
    base += h * v;
  }

  // Exact mixed-precision color conversion (oracle ycbcr_to_rgb_exact):
  // double products, ONE float32 rounding per channel, +128.0f, trunc.
  // Split into a branch-free planar row kernel gcc vectorizes (AVX-512:
  // 8-wide double math; the /0.587 stays a true division — a reciprocal
  // multiply rounds differently and breaks the bit-exactness contract)
  // and a cheap byte-interleave pass: the stride-3 RGB store inside the
  // math loop defeated auto-vectorization entirely (scalar vdivsd), and
  // this stage — not the IDCT — dominated the pixel-stage profile.
  const double kRed = 2.0 - 2.0 * 0.299;   // 1.402
  const double kBlue = 2.0 - 2.0 * 0.114;  // 1.772
#pragma omp parallel num_threads(nt)
  {
    char* mine = threadrows + threadrow_bytes * omp_get_thread_num();
    int16_t* subrow[3] = {nullptr, nullptr, nullptr};
    int nsub = 0;
    bool fancy_of[3] = {false, false, false};
    int fh_of[3] = {1, 1, 1}, fv_of[3] = {1, 1, 1};
    int64_t sh_of[3] = {0, 0, 0}, sw_of[3] = {0, 0, 0};
    for (int64_t ci = 0; ci < n_comp; ++ci) {
      sh_of[ci] = mcus_y * comp_v[ci] * 8;
      sw_of[ci] = mcus_x * comp_h[ci] * 8;
      fh_of[ci] = max_h / comp_h[ci];
      fv_of[ci] = max_v / comp_v[ci];
      fancy_of[ci] = fancy && fh_of[ci] <= 2 && fv_of[ci] <= 2;
      if (sh_of[ci] != H8 || sw_of[ci] != W8)
        subrow[ci] = reinterpret_cast<int16_t*>(mine) + W8 * nsub++;
    }
    uint8_t* r8 = reinterpret_cast<uint8_t*>(
        mine + sizeof(int16_t) * n_sub * W8);
    uint8_t* g8 = r8 + W8;
    uint8_t* b8 = r8 + 2 * W8;
    double* yd = reinterpret_cast<double*>(b8 + W8);
    double* cbd = yd + W8;
    double* crd = cbd + W8;
    float* rf = reinterpret_cast<float*>(crd + W8);
    float* bf = rf + W8;
#pragma omp for schedule(static)
    for (int64_t r = 0; r < height; ++r) {
      const int16_t* crow[3] = {nullptr, nullptr, nullptr};
      for (int64_t ci = 0; ci < n_comp; ++ci) {
        if (subrow[ci]) {
          upsample_row(plane_of[ci], sh_of[ci], sw_of[ci], fh_of[ci],
                       fv_of[ci], fancy_of[ci], r, subrow[ci]);
          crow[ci] = subrow[ci];
        } else {
          crow[ci] = plane_of[ci] + r * W8;
        }
      }
      const int16_t* yrow = crow[0];
      if (n_comp == 3) {
        const int16_t* cbrow = crow[1];
        const int16_t* crrow = crow[2];
        // pass-wise form of the EXACT mixed-precision math (identical
        // operations and rounding order, just on arrays so every pass
        // vectorizes — incl. the 8-wide vdivpd for /0.587)
        for (int64_t c = 0; c < width; ++c) {
          yd[c] = static_cast<double>(yrow[c]);
          cbd[c] = static_cast<double>(cbrow[c]);
          crd[c] = static_cast<double>(crrow[c]);
        }
        for (int64_t c = 0; c < width; ++c) {
          rf[c] = static_cast<float>(kRed * crd[c] + yd[c]);
          bf[c] = static_cast<float>(kBlue * cbd[c] + yd[c]);
        }
        for (int64_t c = 0; c < width; ++c) {
          const float g32 = static_cast<float>(
              (yd[c] - 0.114 * static_cast<double>(bf[c]) -
               0.299 * static_cast<double>(rf[c])) /
              0.587);
          g8[c] =
              static_cast<uint8_t>(clamp255(static_cast<int>(g32 + 128.0f)));
        }
        for (int64_t c = 0; c < width; ++c) {
          r8[c] =
              static_cast<uint8_t>(clamp255(static_cast<int>(rf[c] + 128.0f)));
          b8[c] =
              static_cast<uint8_t>(clamp255(static_cast<int>(bf[c] + 128.0f)));
        }
      } else {
        // grayscale: same formula with cb = cr = 0 (identical rounding)
        for (int64_t c = 0; c < width; ++c) {
          const double yd = yrow[c];
          const float r32 = static_cast<float>(yd);
          const float g32 = static_cast<float>(
              (yd - 0.114 * static_cast<double>(r32) -
               0.299 * static_cast<double>(r32)) /
              0.587);
          r8[c] =
              static_cast<uint8_t>(clamp255(static_cast<int>(r32 + 128.0f)));
          g8[c] =
              static_cast<uint8_t>(clamp255(static_cast<int>(g32 + 128.0f)));
        }
      }
      uint8_t* o = out + r * width * 3;
      if (n_comp == 3) {
        for (int64_t c = 0; c < width; ++c) {
          o[c * 3 + 0] = r8[c];
          o[c * 3 + 1] = g8[c];
          o[c * 3 + 2] = b8[c];
        }
      } else {
        for (int64_t c = 0; c < width; ++c) {
          o[c * 3 + 0] = r8[c];
          o[c * 3 + 1] = g8[c];
          o[c * 3 + 2] = r8[c];
        }
      }
    }
  }

  return 0;
}

}  // namespace

extern "C" {

int32_t tpj_pixels32(const int32_t* coeffs, const int32_t* quant,
                     const int32_t* comp_h, const int32_t* comp_v,
                     const int32_t* comp_q, int64_t n_comp, int64_t mcus_x,
                     int64_t mcus_y, int64_t width, int64_t height,
                     int32_t fancy, int32_t n_threads, uint8_t* out) {
  return pixels_impl(coeffs, quant, comp_h, comp_v, comp_q, n_comp, mcus_x,
                     mcus_y, width, height, fancy, n_threads, out);
}

int32_t tpj_pixels16(const int16_t* coeffs, const int32_t* quant,
                     const int32_t* comp_h, const int32_t* comp_v,
                     const int32_t* comp_q, int64_t n_comp, int64_t mcus_x,
                     int64_t mcus_y, int64_t width, int64_t height,
                     int32_t fancy, int32_t n_threads, uint8_t* out) {
  return pixels_impl(coeffs, quant, comp_h, comp_v, comp_q, n_comp, mcus_x,
                     mcus_y, width, height, fancy, n_threads, out);
}

}  // extern "C"
