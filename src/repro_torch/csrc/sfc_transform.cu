// B1: SFC input transform + per-frequency int8 quantization, and
// B5: the same transform without quantization (the fp path).
//
// B1 replaces src/repro/kernels/sfc_transform.py::_transform_quant_kernel
// (wrappers sfc_transform_quantize and sfc_transform_quantize_pt); B5
// replaces ::_transform_kernel (wrapper sfc_transform).
//
// Computes, for every tile n = (b, th, tw) of the padded NHWC input and
// every channel c, TX = B^T X B (L x L -> t x t), and writes it as f32
// tx[n, u, v, c] (B5; the fp path's batched product reads it by strides)
// or as int8 xq = clip(rint(TX[u, v] / s[u, v]), -qmax, qmax) (B1), in the
// tile layout xq[n, u, v, c] (the JAX kernel's contract) or in the
// (P, T, C) layout xq[u t + v, n, c] that the staged GEMM (B2) and the
// depthwise product (B6) read, so nothing is copied between B1 and them.
//
// What bounds it on the H100: bytes.  It reads each input element once
// from HBM and writes t^2/M^2 bytes (B1) or 4 t^2/M^2 bytes (B5) per input
// element; the additions are a few per byte, below the card's ratio of f32
// operations to memory rate.  At the small layers (a few thousand
// (tile, channel) pairs) what bounds it is latency: one chain of loads,
// FMAs and divisions per row.
//
// Design (B7's transform, csrc/sfc_fused_dw.cu, without the product and
// the inverse).  The geometry comes from the wrapper
// (kernels/sfc_transform.py, TransformGeometry), which picks it per layer;
// this file only checks it.  A block owns a run of `tiles` tiles along one
// tile row and cb channels:
//   0. one thread has TMA copy the run's input region, L rows x (M tiles +
//      R - 1) pixels x cb channels, into shared memory, zero-filled where
//      it reaches outside the image (the SAME/VALID padding) and past C
//      (sfc::region_tma_start, shared with B7; plain loads where the shape
//      rules TMA out: C or cb no multiple of 4, as at VGG-16's first
//      layer, C = 3);
//   1. `splits` threads per (tile, channel) each transform the tile's rows
//      u = g, g + splits, ... from shared memory and store them.
// Threads are channel-fastest, so a warp reads consecutive words of shared
// memory and stores consecutive channels of one (tile, position).  For
// sfc6_6, sfc6_7 and sfc4_4 (B^T checked against sfc::FixedBt) the kernels
// are compiled for the algorithm and for 32 or 16 channels a block:
//   * a row's loops unroll (sfc::transform_row<T, L, FixedBt>), so its
//     sums interleave; B^T, passed by value, gives constant operands;
//   * row u's pass over the input rows is compiled for u's own
//     coefficients, so it loads and adds only the input rows whose
//     coefficient is nonzero (half of them for sfc6_6);
//   * the channel block fixes the loads' offsets, so they take immediate
//     offsets from one address a region row, and a thread holds far fewer
//     registers than with offsets at run time;
//   * B1 quantizes by the scales' reciprocals, scales and reciprocals
//     passed by value, with two correction steps
//     (sfc::quantize_by_reciprocal: the IEEE division's int8, bit for
//     bit, without its branch a value); the launcher takes it where every
//     scale lies in [2^-60, 2^60], the run-time kernel otherwise.
// Other algorithms, a B^T other than FixedBt's or a scale outside
// [2^-60, 2^60] take the run-time kernel ((t, L) at run time,
// sfc::transform_row and quantize, the IEEE division); a channel block
// other than 32 or 16 takes cb at run time.  Tiles past the row's last and
// channels past C are masked.  B4 and B7 call the same device
// functions (and the same row and column order), so B5's output is exactly
// the value B1, B4 and B7 quantize, and B1's int8 values are B4's and
// B7's.
#include "sfc_common.cuh"
#include "sfc_tma.cuh"

namespace {

constexpr int kMaxThreads = 512;
// dynamic shared memory a block may have: the H100's 232448 bytes less
// this kernel's static part (an mbarrier), rounded up to 2 KB
// (TRANSFORM_STATIC_SMEM_BYTES in kernels/sfc_transform.py)
constexpr int kMaxSmem = 232448 - 2048;

enum Layout { kTiles = 0, kPTC = 1 };

struct Args {
  CUtensorMap tmap_x;   // x (C, W, H, B) f32, box (cb, region_w, L, 1)
  // B^T by value: constant operands where the index is compile-time
  float bt[sfc::kMaxT * sfc::kMaxL];
  // B1's scales and their reciprocals by value (the compile-time kernels)
  float sc[sfc::kMaxT * sfc::kMaxT];
  float rc[sfc::kMaxT * sfc::kMaxT];
  const float* x;
  const float* s_g;     // (t, t) activation scales (B1; run-time kernel)
  void* out;
  int H, W, C, M, L, t, lo_h, lo_w, nH, nW;
  int tiles, cb, splits, runs;  // runs: tile runs per tile row
  int n_tiles;                  // B nH nW
  int tma;
  float qmax;
};

// Dynamic shared memory: region f32 [L][region_w][cb], on 128 bytes.
// kT, kL: the algorithm's t and L at compile time (0: at run time); kCb:
// the channels of a block at compile time (0: at run time), so a thread's
// loads from a region row take immediate offsets; kQuantize: B1 (int8),
// else B5 (f32); kLayout: the output's layout.
template <int kT, int kL, int kCb, bool kQuantize, int kLayout>
__global__ void __launch_bounds__(kMaxThreads) transform_kernel(
    const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;

  const int t = kT ? kT : a.t, L = kL ? kL : a.L, M = a.M;
  const int cb = kCb ? kCb : a.cb, tiles = a.tiles, G = a.splits;
  const float* __restrict__ s = a.s_g;   // activation scales, via L1
  const int region_w = M * (tiles - 1) + L;
  const int row = blockIdx.x / a.runs;           // over (image, tile row)
  const int tw0 = (blockIdx.x % a.runs) * tiles;
  const int b = row / a.nH, th = row % a.nH;
  const int c0 = blockIdx.y * cb;
  const int h_in = th * M - a.lo_h, w_in = tw0 * M - a.lo_w;

  float* region = reinterpret_cast<float*>(
      smem_raw + ((128 - (sfc::smem_u32(smem_raw) & 127)) & 127));
  if (a.tma) {
    if (threadIdx.x == 0)
      sfc::region_tma_start(region, &a.tmap_x, &bar,
                            (unsigned)(4 * L * region_w * cb), b, h_in, w_in,
                            c0);
  } else {
    sfc::region_load(region, a.x, a.H, a.W, a.C, b, h_in, w_in, c0, L,
                     region_w, cb);
  }
  __syncthreads();                 // the mbarrier is initialised
  if (a.tma) sfc::mbar_wait(&bar, 0);

  // thread (g, tile col, channel cc), channels fastest
  const int per_g = tiles * cb;
  const int g = threadIdx.x / per_g, col = (threadIdx.x % per_g) / cb,
            cc = threadIdx.x % cb;
  const int tw = tw0 + col, ch = c0 + cc;
  if (g >= G || tw >= a.nW || ch >= a.C) return;

  const float* xt = region + col * M * cb + cc;
  const int row_stride = region_w * cb;
  auto x_at = [&](int i, int j) -> float {
    return xt[i * row_stride + j * cb];
  };
  const long long n = (long long)row * a.nW + tw;   // the tile
  // value (u, v) of the tile goes to out[base + u * ustride + v * vstride]
  const long long C = a.C, P = (long long)t * t;
  const long long base = kLayout == kPTC ? n * C + ch : n * P * C + ch;
  const long long vstride = kLayout == kPTC ? a.n_tiles * C : C;
  const long long ustride = t * vstride;
  for (int u = g; u < t; u += G) {
    const long long o = base + u * ustride;
    if constexpr (kQuantize) {
      int8_t* oq = static_cast<int8_t*>(a.out) + o;
      auto store = [&](int v, int8_t q) { oq[v * vstride] = q; };
      if constexpr (kT > 0)
        sfc::transform_quantize_row_by_reciprocal<kT, kL,
                                                  sfc::FixedBt<kT, kL>>(
            x_at, a.bt, a.sc, a.rc, a.qmax, u, store);
      else
        sfc::transform_quantize_row(x_at, a.bt, s, t, L, a.qmax, u, store);
    } else {
      float* of = static_cast<float*>(a.out) + o;
      auto store = [&](int v, float tx) { of[v * vstride] = tx; };
      if constexpr (kT > 0)
        sfc::transform_row<kT, kL, sfc::FixedBt<kT, kL>>(x_at, a.bt, u,
                                                          store);
      else
        sfc::transform_row(x_at, a.bt, t, L, u, store);
    }
  }
}

template <int kT, int kL, int kCb, bool kQuantize, int kLayout>
cudaError_t launch(const Args& a, dim3 grid, int threads, int smem,
                   cudaStream_t stream) {
  auto kernel = transform_kernel<kT, kL, kCb, kQuantize, kLayout>;
  // once per instantiation and device: all the dynamic shared memory a
  // block may have
  static std::atomic<bool> ready[sfc::kMaxDevices];
  const cudaError_t set = sfc::once_per_device(ready, [kernel] {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  });
  if (set != cudaSuccess) return set;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// (t, L) at compile time for sfc6_6, sfc6_7 and sfc4_4, with the channel
// blocks the wrapper takes (TRANSFORM_CHANNEL_BLOCKS: 32, 16)
template <int kT, int kL, bool kQuantize, int kLayout>
cudaError_t launch_cb(const Args& a, dim3 grid, int threads, int smem,
                      cudaStream_t s) {
  if (a.cb == 32)
    return launch<kT, kL, 32, kQuantize, kLayout>(a, grid, threads, smem, s);
  if (a.cb == 16)
    return launch<kT, kL, 16, kQuantize, kLayout>(a, grid, threads, smem, s);
  return launch<kT, kL, 0, kQuantize, kLayout>(a, grid, threads, smem, s);
}

// the compile-time kernel of (t, L) = (kT, kL) where B^T is that
// algorithm's (and, quantizing, every scale fits the reciprocal
// quantizer), the run-time one otherwise
template <int kT, int kL>
bool fixed(const Args& a, bool fits) {
  return a.t == kT && a.L == kL && fits &&
         sfc::fixed_bt_matches<sfc::FixedBt<kT, kL>, kT, kL>(a.bt);
}

template <bool kQuantize, int kLayout>
cudaError_t launch_algo(const Args& a, bool fits, dim3 grid, int threads,
                        int smem, cudaStream_t s) {
  if (fixed<10, 8>(a, fits))   // sfc6_6
    return launch_cb<10, 8, kQuantize, kLayout>(a, grid, threads, smem, s);
  if (fixed<12, 9>(a, fits))   // sfc6_7
    return launch_cb<12, 9, kQuantize, kLayout>(a, grid, threads, smem, s);
  if (fixed<7, 6>(a, fits))    // sfc4_4
    return launch_cb<7, 6, kQuantize, kLayout>(a, grid, threads, smem, s);
  return launch<0, 0, 0, kQuantize, kLayout>(a, grid, threads, smem, s);
}

// The geometry (tiles, cb, splits, threads, smem, grid) is the wrapper's
// TransformGeometry; this checks it and launches.  bt: host memory, t x L;
// scale: the card's (t, t) scales and scale_h the same in host memory
// (B1).
int launch_checked(const void* x, const float* bt, const void* scale,
                   const float* scale_h, void* out, int B, int H, int W,
                   int C, int M, int L,
                   int t, int lo_h, int lo_w, int nH, int nW, int tiles,
                   int cb, int splits, int threads, int smem, int grid_x,
                   int grid_y, float qmax, bool quantize, int layout,
                   void* stream) {
  if ((long long)B * nH * nW == 0 || C == 0) return 0;
  const long long region_w = (long long)M * (tiles - 1) + L;
  const long long runs = tiles > 0 ? (nW + tiles - 1) / tiles : 0;
  const int per_block = splits * tiles * cb;
  const bool ok =
      tiles >= 1 && cb >= 1 && splits >= 1 && splits <= t &&
      t <= sfc::kMaxT && L <= sfc::kMaxL && M >= 1 && M <= L &&
      threads == (per_block + 31) / 32 * 32 && threads <= kMaxThreads &&
      smem == 128 + sfc::align128(4 * L * region_w * cb) &&
      smem <= kMaxSmem && region_w <= 256 &&
      (long long)grid_x == (long long)B * nH * runs &&
      grid_y == (C + cb - 1) / cb && grid_y <= 65535;
  if (!ok) return (int)cudaErrorInvalidValue;
  Args a;
  for (int i = 0; i < t * L; ++i) a.bt[i] = bt[i];
  bool fits = true;   // every scale, for the reciprocal quantizer
  if (quantize)
    for (int i = 0; i < t * t; ++i) {
      a.sc[i] = scale_h[i];
      a.rc[i] = 1.f / scale_h[i];   // IEEE division: correctly rounded
      fits = fits && sfc::reciprocal_quantizer_fits(scale_h[i]);
    }
  a.x = (const float*)x;
  a.s_g = (const float*)scale;
  a.out = out;
  a.H = H; a.W = W; a.C = C; a.M = M; a.L = L; a.t = t;
  a.lo_h = lo_h; a.lo_w = lo_w; a.nH = nH; a.nW = nW;
  a.tiles = tiles; a.cb = cb; a.splits = splits; a.runs = (int)runs;
  a.n_tiles = B * nH * nW;
  a.qmax = qmax;
  // the copy, by the shape alone: TMA where the input allows its box,
  // plain loads otherwise; a map that cannot be encoded refuses the launch
  a.tma = sfc::region_tma_ok(x, C, cb, (int)region_w);
  if (a.tma) {
    const cudaError_t e =
        sfc::region_map(&a.tmap_x, x, B, H, W, C, cb, (int)region_w, L);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y, 1);
  cudaStream_t s = (cudaStream_t)stream;
  if (!quantize)
    return (int)launch_algo<false, kTiles>(a, true, grid, threads, smem, s);
  return (int)(layout == kPTC ? launch_algo<true, kPTC>(a, fits, grid,
                                                        threads, smem, s)
                              : launch_algo<true, kTiles>(a, fits, grid,
                                                          threads, smem, s));
}

}  // namespace

// B1: int8 (T, t, t, C) when pt == 0, (t^2, T, C) when pt == 1.
extern "C" int sfc_transform_quantize_launch(
    const void* x, const float* bt, const void* scale, const float* scale_h,
    void* out, int B, int H, int W, int C, int M, int L, int t, int lo_h,
    int lo_w, int nH, int nW, int tiles, int cb, int splits, int threads,
    int smem, int grid_x, int grid_y, float qmax, int pt, void* stream) {
  return launch_checked(x, bt, scale, scale_h, out, B, H, W, C, M, L, t,
                        lo_h, lo_w, nH, nW, tiles, cb, splits, threads, smem,
                        grid_x, grid_y, qmax, true, pt ? kPTC : kTiles,
                        stream);
}

// B5: f32 (T, t, t, C).
extern "C" int sfc_transform_launch(const void* x, const float* bt, void* out,
                                    int B, int H, int W, int C, int M, int L,
                                    int t, int lo_h, int lo_w, int nH, int nW,
                                    int tiles, int cb, int splits,
                                    int threads, int smem, int grid_x,
                                    int grid_y, void* stream) {
  return launch_checked(x, bt, nullptr, nullptr, out, B, H, W, C, M, L, t,
                        lo_h, lo_w, nH, nW, tiles, cb, splits, threads, smem,
                        grid_x, grid_y, 0.f, false, kTiles, stream);
}

extern "C" const char* sfc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
