// B1: SFC input transform + per-frequency int8 quantization, and
// B5: the same transform without quantization (the fp path).
//
// B1 replaces src/repro/kernels/sfc_transform.py::_transform_quant_kernel
// (wrapper sfc_transform_quantize); B5 replaces ::_transform_kernel
// (wrapper sfc_transform).
//
// Computes, for every tile n = (b, th, tw) of the padded NHWC input and
// every channel c, TX = B^T X B (L x L -> t x t), and writes it as f32
// tx[n, u, v, c] (B5) or as int8
// xq[n, u, v, c] = clip(rint(TX[u, v] / s[u, v]), -qmax, qmax) (B1).
//
// What bounds it on the H100: bytes.  It reads each input element once
// from HBM (plus the L^2/M^2 overlap of neighbouring tiles, served by L1/L2)
// and writes t^2/M^2 bytes (B1) or 4 t^2/M^2 bytes (B5) per input element;
// the additions are a few per byte, far below the card's compute rate.
//
// Design: one thread per (tile, channel, transform row u), channels
// fastest, so a warp reads 32 consecutive floats of one pixel and writes
// 32 consecutive values of one frequency, and t times as many threads as
// (tile, channel) pairs hide the latency of each thread's short chain of
// loads and sums.  The tiles are read straight from the unpadded input
// with the SAME/VALID padding masked in the loader: the JAX package's
// ops.extract_tiles materialises 1.78x the input for sfc6_6 first, this
// kernel does not.  The arithmetic is sfc::transform_row (B5) and
// sfc::transform_quantize_row (B1), which quantizes the values of
// transform_row; the fused kernels call the same functions, so B5's
// output is exactly the value that B1, B4 and B7 quantize.
#include "sfc_common.cuh"

namespace {

template <bool kQuantize>
__global__ void __launch_bounds__(128) transform_kernel(
    const float* __restrict__ x, const float* __restrict__ bt_g,
    const float* __restrict__ s_g, void* __restrict__ out, int H, int W,
    int C, int M, int L, int t, int lo_h, int lo_w, int nH, int nW,
    long long total, float qmax) {
  __shared__ float bt[sfc::kMaxT * sfc::kMaxL];
  __shared__ float s[sfc::kMaxT * sfc::kMaxT];
  for (int i = threadIdx.x; i < t * L; i += blockDim.x) bt[i] = bt_g[i];
  if (kQuantize)
    for (int i = threadIdx.x; i < t * t; i += blockDim.x) s[i] = s_g[i];
  __syncthreads();

  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  const int u = (int)((idx / C) % t);
  const long long n = idx / ((long long)C * t);
  const int tw = (int)(n % nW);
  const int th = (int)((n / nW) % nH);
  const long long b = n / ((long long)nW * nH);
  const float* xb = x + b * H * W * C + c;
  const int h0 = th * M - lo_h, w0 = tw * M - lo_w;
  auto load = [&](int i, int j) -> float {
    const int hh = h0 + i, ww = w0 + j;
    return (hh >= 0 && hh < H && ww >= 0 && ww < W)
               ? __ldg(xb + ((long long)hh * W + ww) * C)
               : 0.f;
  };
  const long long o = (n * t + u) * t * C + c;
  if constexpr (kQuantize) {
    int8_t* oq = static_cast<int8_t*>(out) + o;
    sfc::transform_quantize_row(load, bt, s, t, L, qmax, u,
                                [&](int v, int8_t q) { oq[(long long)v * C] = q; });
  } else {
    float* of = static_cast<float*>(out) + o;
    sfc::transform_row(load, bt, t, L, u,
                       [&](int v, float tx) { of[(long long)v * C] = tx; });
  }
}

template <bool kQuantize>
int launch(const void* x, const void* bt, const void* scale, void* out,
           int B, int H, int W, int C, int M, int L, int t, int lo_h,
           int lo_w, int nH, int nW, float qmax, void* stream) {
  const long long total = (long long)B * nH * nW * t * C;
  if (total == 0) return 0;
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  transform_kernel<kQuantize><<<(unsigned)blocks, threads, 0,
                                (cudaStream_t)stream>>>(
      (const float*)x, (const float*)bt, (const float*)scale, out, H, W, C,
      M, L, t, lo_h, lo_w, nH, nW, total, qmax);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sfc_transform_quantize_launch(
    const void* x, const void* bt, const void* scale, void* out, int B, int H,
    int W, int C, int M, int L, int t, int lo_h, int lo_w, int nH, int nW,
    float qmax, void* stream) {
  return launch<true>(x, bt, scale, out, B, H, W, C, M, L, t, lo_h, lo_w, nH,
                      nW, qmax, stream);
}

extern "C" int sfc_transform_launch(const void* x, const void* bt, void* out,
                                    int B, int H, int W, int C, int M, int L,
                                    int t, int lo_h, int lo_w, int nH, int nW,
                                    void* stream) {
  return launch<false>(x, bt, nullptr, out, B, H, W, C, M, L, t, lo_h, lo_w,
                       nH, nW, 0.f, stream);
}

extern "C" const char* sfc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
