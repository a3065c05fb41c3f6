// B7: the whole int8 depthwise SFC convolution in one launch.
//
// Replaces src/repro/kernels/sfc_fused.py::_fused_dw_kernel (via
// _fused_depthwise, i.e. sfc_fused_conv2d(depthwise=True)).
//
// Computes y[c] = A^T [ dequant( xq[c] * wq[c] ) ] A per output tile and
// channel, where xq = clip(rint(B^T X B / s)) is the int8 transform of the
// input tile and wq the (P, C) int8 transformed weights: the
// transform-domain tensor never goes to HBM.
//
// What bounds it on the H100: bytes.  It must read the f32 input and write
// the f32 output once (the weights are P x C, small); per (tile, channel)
// it does the transform's and the inverse's few hundred additions, below
// the card's ratio of f32 operations to memory rate.
//
// Design.  Depthwise has no channel contraction, so every channel block is
// used exactly once: there is no C_in loop, no accumulator and no cluster
// (the dense kernel, sfc_fused.cu, needs all three).  A block owns kCols
// tiles (numbered over image, tile row, tile column, so a group may span
// rows and images) and cb channels, and runs two phases:
//   1. the threads transform and quantize (tile, transform row u, channel)
//      items straight from the unpadded NHWC input into xq[p][tile][c] in
//      shared memory (sfc::transform_quantize_row, the staged B1's
//      arithmetic);
//   2. the threads take (tile, output row m, channel) items and invert the
//      dequantized products (sfc::dequant of the int32 xq * wq, the staged
//      B6's arithmetic, inside sfc::inverse_row, B3's arithmetic), writing
//      NHWC output.
// So the fused and the staged depthwise datapaths are bit-identical on the
// card.  Channels are fastest in both phases: a warp reads and writes
// consecutive channels of one pixel.  A block of 512 threads takes 4
// tiles, so at cb = 16 each thread runs one or two rows per phase: every
// row is a chain of dependent loads, FMAs and divisions, and blocks of
// 256 threads over 8 tiles, whose threads ran up to 5 rows one after
// another, took 1.9x as long on an H100 (PERF.md).  The block's (P, cb)
// weights and weight scales sit in shared memory beside xq:
// P cb (kCols + 5) bytes, 14 KB for sfc6_6 at cb = 16.  Tiles past the
// last one and channels past C are masked: they are neither computed nor
// stored, so C need not be a multiple of cb.
#include "sfc_common.cuh"

namespace {

constexpr int kCols = 4;        // tiles per block
constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads) fused_dw_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ wq,
    const float* __restrict__ s_g, const float* __restrict__ sw_g,
    const float* __restrict__ bt_g, const float* __restrict__ at_g,
    float* __restrict__ out, int H, int W, int C, int M, int L, int t,
    int lo_h, int lo_w, int nH, int nW, long long n_tiles, int out_h,
    int out_w, int cb, float qmax) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float bt[sfc::kMaxT * sfc::kMaxL];
  __shared__ float at[sfc::kMaxM * sfc::kMaxT];
  __shared__ float s[sfc::kMaxT * sfc::kMaxT];

  const int P = t * t;
  float* sw = reinterpret_cast<float*>(smem);                 // [P][cb]
  int8_t* xq = reinterpret_cast<int8_t*>(sw + P * cb);        // [P][kCols][cb]
  int8_t* w = xq + P * kCols * cb;                            // [P][cb]

  const int tid = threadIdx.x;
  const long long tile0 = (long long)blockIdx.x * kCols;
  const int c0 = blockIdx.y * cb;
  for (int i = tid; i < t * L; i += kThreads) bt[i] = bt_g[i];
  for (int i = tid; i < M * t; i += kThreads) at[i] = at_g[i];
  for (int i = tid; i < P; i += kThreads) s[i] = s_g[i];
  for (int i = tid; i < P * cb; i += kThreads) {
    const int p = i / cb, ch = c0 + i % cb;
    const bool in = ch < C;
    w[i] = in ? wq[(long long)p * C + ch] : (int8_t)0;
    sw[i] = in ? sw_g[(long long)p * C + ch] : 0.f;
  }
  __syncthreads();

  // 1. transform + quantize the block's tiles and channels
  for (int item = tid; item < kCols * t * cb; item += kThreads) {
    const int cc = item % cb, u = (item / cb) % t, col = item / (cb * t);
    const long long n = tile0 + col;
    const int ch = c0 + cc;
    if (n >= n_tiles || ch >= C) continue;
    const int tw = (int)(n % nW);
    const int th = (int)((n / nW) % nH);
    const long long b = n / ((long long)nW * nH);
    const float* xb = x + b * H * W * C + ch;
    const int h0 = th * M - lo_h, w0 = tw * M - lo_w;
    auto load = [&](int i, int j) -> float {
      const int hh = h0 + i, ww = w0 + j;
      return (hh >= 0 && hh < H && ww >= 0 && ww < W)
                 ? __ldg(xb + ((long long)hh * W + ww) * C)
                 : 0.f;
    };
    int8_t* dst = xq + (u * t * kCols + col) * cb + cc;
    sfc::transform_quantize_row(load, bt, s, t, L, qmax, u,
                                [&](int v, int8_t q) { dst[v * kCols * cb] = q; });
  }
  __syncthreads();

  // 2. elementwise int32 product, dequant and inverse, written as NHWC
  for (int item = tid; item < kCols * M * cb; item += kThreads) {
    const int cc = item % cb, m = (item / cb) % M, col = item / (cb * M);
    const long long n = tile0 + col;
    const int ch = c0 + cc;
    if (n >= n_tiles || ch >= C) continue;
    const int tw = (int)(n % nW);
    const int th = (int)((n / nW) % nH);
    const long long b = n / ((long long)nW * nH);
    auto load = [&](int u, int v) -> float {
      const int p = u * t + v;
      const int prod = (int)xq[(p * kCols + col) * cb + cc] * (int)w[p * cb + cc];
      return sfc::dequant(prod, s[p], sw[p * cb + cc]);
    };
    const int hh = th * M + m;
    float* ob = out + ((b * out_h + hh) * out_w + (long long)tw * M) * C + ch;
    auto store = [&](int q, float val) {
      if (hh < out_h && tw * M + q < out_w) ob[(long long)q * C] = val;
    };
    sfc::inverse_row(load, at, t, M, m, store);
  }
}

}  // namespace

extern "C" int sfc_fused_conv2d_depthwise_launch(
    const void* x, const void* wq, const void* act_scale, const void* w_scale,
    const void* bt, const void* at, void* out, int B, int H, int W, int C,
    int M, int L, int t, int lo_h, int lo_w, int nH, int nW, int out_h,
    int out_w, int cb, float qmax, void* stream) {
  const long long n_tiles = (long long)B * nH * nW;
  if (n_tiles == 0 || C == 0) return 0;
  // sw (4 B) + xq (kCols B) + w (1 B) per position and channel; the
  // wrapper's smem_bytes_depthwise is the same formula
  const int smem = t * t * cb * (kCols + 5);
  cudaError_t err = cudaFuncSetAttribute(
      fused_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n_tiles + kCols - 1) / kCols),
                  (unsigned)((C + cb - 1) / cb));
  fused_dw_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const int8_t*)wq, (const float*)act_scale,
      (const float*)w_scale, (const float*)bt, (const float*)at, (float*)out,
      H, W, C, M, L, t, lo_h, lo_w, nH, nW, n_tiles, out_h, out_w, cb, qmax);
  return (int)cudaGetLastError();
}
