// B1: SFC input transform + per-frequency int8 quantization.
//
// Replaces src/repro/kernels/sfc_transform.py::_transform_quant_kernel
// (wrapper sfc_transform_quantize).
//
// Computes, for every tile n = (b, th, tw) of the padded NHWC input and
// every channel c, TX = B^T X B (L x L -> t x t) and
// xq[n, u, v, c] = clip(rint(TX[u, v] / s[u, v]), -qmax, qmax) as int8.
//
// What bounds it on the H100: bytes.  It reads each input element once
// from HBM (plus the L^2/M^2 overlap of neighbouring tiles, served by L1/L2)
// and writes t^2/M^2 int8 bytes per input element; the additions are a few
// per byte, far below the card's compute rate.
//
// Design: one thread per (tile, channel, transform row u), channels
// fastest, so a warp reads 32 consecutive floats of one pixel and writes
// 32 consecutive bytes of one frequency, and t times as many threads as
// (tile, channel) pairs hide the latency of each thread's short chain of
// loads, sums and divisions.  The tiles are read straight from the
// unpadded input with the SAME/VALID padding masked in the loader: the JAX
// package's ops.extract_tiles materialises 1.78x the input for sfc6_6
// first, this kernel does not.  The arithmetic is
// sfc::transform_quantize_row, which the fused kernel (sfc_fused.cu) calls
// too, so both land on one grid.
#include "sfc_common.cuh"

namespace {

__global__ void __launch_bounds__(128) transform_quant_kernel(
    const float* __restrict__ x, const float* __restrict__ bt_g,
    const float* __restrict__ s_g, int8_t* __restrict__ out, int H, int W,
    int C, int M, int L, int t, int lo_h, int lo_w, int nH, int nW,
    long long total, float qmax) {
  __shared__ float bt[sfc::kMaxT * sfc::kMaxL];
  __shared__ float s[sfc::kMaxT * sfc::kMaxT];
  for (int i = threadIdx.x; i < t * L; i += blockDim.x) bt[i] = bt_g[i];
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
  int8_t* o = out + (n * t + u) * t * C + c;
  auto store = [&](int v, int8_t q) { o[(long long)v * C] = q; };
  sfc::transform_quantize_row(load, bt, s, t, L, qmax, u, store);
}

}  // namespace

extern "C" int sfc_transform_quantize_launch(
    const void* x, const void* bt, const void* scale, void* out, int B, int H,
    int W, int C, int M, int L, int t, int lo_h, int lo_w, int nH, int nW,
    float qmax, void* stream) {
  const long long total = (long long)B * nH * nW * t * C;
  if (total == 0) return 0;
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  transform_quant_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const float*)x, (const float*)bt, (const float*)scale, (int8_t*)out, H,
      W, C, M, L, t, lo_h, lo_w, nH, nW, total, qmax);
  return (int)cudaGetLastError();
}

extern "C" const char* sfc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
