// B3: SFC inverse transform A^T Y A.
//
// Replaces src/repro/kernels/sfc_inverse.py::_inverse_kernel (wrappers
// sfc_inverse and sfc_inverse_nhwc).
//
// Computes, for every tile n and output channel o, the (M, M) spatial
// block A^T Y[n, :, :, o] A from the (t, t) dequantized transform-domain
// values.  A^T carries the correction-term columns, so the circular ->
// linear conversion of paper §4.2 happens in the same contraction.
//
// What bounds it on the H100: bytes.  It reads t^2 floats and writes M^2
// floats per (tile, channel), with about M t (t + M) FMAs between them,
// which is below the card's ratio of compute to memory rate.
//
// Design.  Y is read where it lies: a tile stride and a position stride
// say where value (n, u, v, o) is, so the kernel reads the (P, T, O)
// output of the GEMM (B2), of the depthwise product (B6) and of the fp
// path's torch.bmm in place, as well as the (T, t, t, O) tile layout.  It
// writes either the (T, M, M, O) tile layout or the cropped NHWC output
// through the tile grid, so no copy runs before or after it.  A thread
// owns one (tile, channel) and a group of output rows; it reads each of
// the t^2 values once and keeps Z = A^T Y for its rows in registers
// (sfc::inverse_tile, with t and M fixed at compile time for sfc6_6,
// sfc6_7 and sfc4_4).  Each tile's M rows are split over kSplits = 2
// threads (ceil(M / 2) rows each; the second reads Y again, from L1/L2),
// against one or three at VGG-16's and MobileNetV2's depthwise layer
// shapes on an H100 (tools/variants.py b3-splits; PERF.md).  Channels
// are fastest, so a warp reads and writes 128
// consecutive bytes.  Other algorithms take (t, M) at run time
// (sfc::inverse_row, rows s, s + 2, ...).  inverse_tile gives
// inverse_row's bits, which B4 calls, so the fused and staged datapaths
// stay bit-identical.
#include "sfc_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSplits = 2;   // threads per (tile, channel)

struct Args {
  const float* y;
  const float* at;
  float* out;
  long long tile_stride;      // floats between tiles
  int pos_stride;             // floats between positions
  int O, t, M, splits;         // splits: min(kSplits, M)
  int n_tiles;
  int nH, nW, out_h, out_w;   // the tile grid of the NHWC output
};

// kT, kM: t and M at compile time (0: at run time, a thread's rows
// `splits` apart); kNhwc: the cropped NHWC output through the tile grid,
// else the tile layout.  At most 168 registers a thread (Z takes
// kT ceil(kM / 2) <= 48 of them), so three blocks share an SM and one
// block's loads overlap another's arithmetic.
template <int kT, int kM, bool kNhwc>
__global__ void __launch_bounds__(kThreads, 3) inverse_kernel(
    const __grid_constant__ Args a) {
  __shared__ float at[sfc::kMaxM * sfc::kMaxT];
  const int t = kT ? kT : a.t, M = kM ? kM : a.M;
  for (int i = threadIdx.x; i < M * t; i += kThreads) at[i] = a.at[i];
  __syncthreads();

  // (tile, row group, channel), channels fastest; the wrapper keeps the
  // count below 2^31
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  const int O = a.O, S = a.splits;
  if (idx >= a.n_tiles * S * O) return;
  const int o = idx % O;
  const int s = (idx / O) % S;
  const int n = idx / (O * S);
  const float* y = a.y + n * a.tile_stride + o;
  const int ps = a.pos_stride;
  auto load = [&](int u, int v) -> float {
    return __ldg(y + (u * t + v) * ps);
  };
  // output (m, q) of tile n: NHWC less the crop, or the tile layout
  float* out;
  int h_left = M, w_left = M;   // rows and columns inside the output
  if constexpr (kNhwc) {
    const int tw = n % a.nW, th = (n / a.nW) % a.nH, b = n / (a.nW * a.nH);
    h_left = a.out_h - th * M;
    w_left = a.out_w - tw * M;
    out = a.out + (((long long)b * a.out_h + th * M) * a.out_w + tw * M) *
                      O + o;
  } else {
    out = a.out + (long long)n * M * M * O + o;
  }
  const int row_stride = kNhwc ? a.out_w * O : M * O;
  auto store = [&](int m, int q, float val) {
    if (m < h_left && q < w_left) out[m * row_stride + q * O] = val;
  };
  if constexpr (kT > 0) {
    constexpr int kRM = (kM + kSplits - 1) / kSplits;
    sfc::inverse_tile<kT, kM, kRM>(load, at, s * kRM, store);
  } else {
    for (int m = s; m < M; m += S)
      sfc::inverse_row(load, at, t, M, m,
                       [&](int q, float val) { store(m, q, val); });
  }
}

template <int kT, int kM>
cudaError_t launch(const Args& a, bool nhwc, cudaStream_t stream) {
  const long long total = (long long)a.n_tiles * a.splits * a.O;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  if (nhwc)
    inverse_kernel<kT, kM, true><<<blocks, kThreads, 0, stream>>>(a);
  else
    inverse_kernel<kT, kM, false><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// y: (n_tiles, t, t, O) with tile_stride t^2 O and pos_stride O, or
// (t^2, n_tiles, O) with tile_stride O and pos_stride n_tiles O.
// out: (n_tiles, M, M, O) if nhwc == 0, else (B, out_h, out_w, O) with
// n_tiles = B nH nW.
extern "C" int sfc_inverse_launch(const void* y, const void* at, void* out,
                                  int n_tiles, int O, int t, int M,
                                  long long tile_stride, long long pos_stride,
                                  int nhwc, int nH, int nW, int out_h,
                                  int out_w, void* stream) {
  if (n_tiles == 0 || O == 0) return 0;
  const int splits = M < kSplits ? M : kSplits;
  // offsets within a tile and within an output image fit 32 bits
  const long long out_row = nhwc ? (long long)out_w * O : (long long)M * O;
  if (t > sfc::kMaxT || M > sfc::kMaxM || M < 1 ||
      (long long)n_tiles * splits * O >= (1LL << 31) - kThreads ||
      (long long)t * t * pos_stride >= (1LL << 31) ||
      out_row * M >= (1LL << 31) || (nhwc && (long long)nH * nW == 0))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.y = (const float*)y;
  a.at = (const float*)at;
  a.out = (float*)out;
  a.tile_stride = tile_stride;
  a.pos_stride = (int)pos_stride;
  a.O = O; a.t = t; a.M = M; a.splits = splits; a.n_tiles = n_tiles;
  a.nH = nH; a.nW = nW; a.out_h = out_h; a.out_w = out_w;
  cudaStream_t s = (cudaStream_t)stream;
  if (t == 10 && M == 6) return (int)launch<10, 6>(a, nhwc, s);
  if (t == 12 && M == 7) return (int)launch<12, 7>(a, nhwc, s);
  if (t == 7 && M == 4) return (int)launch<7, 4>(a, nhwc, s);
  return (int)launch<0, 0>(a, nhwc, s);
}
