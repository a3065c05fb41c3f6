// B6: the depthwise transform-domain stage: elementwise int8 products with
// the dequant.
//
// Replaces src/repro/kernels/sfc_tdmm.py::_tdmm_dw_kernel (wrapper
// tdmm_int8_depthwise).
//
// Computes, for each transform-domain position p, tile t and channel c,
//   Y[p, t, c] = float(int(X[p, t, c]) * int(W[p, c])) * (sx[p] * sw[p, c])
// with X (P, T, C) int8 and W (P, C) int8: an exact int32 product, then
// sfc::dequant, the function the fused depthwise kernel (sfc_fused_dw.cu)
// calls on the same product, so the staged and the fused depthwise
// datapaths land on one fp32 grid.
//
// What bounds it on the H100: bytes.  There is no contraction: each output
// costs one int8 read and one f32 write (the weights and scales are P x C,
// small), and two multiplications.
//
// Design.  The geometry comes from the wrapper (kernels/sfc_tdmm.py,
// DwProductGeometry, picked per layer); this file only checks it.  A
// thread owns 16 channels of one position p, as four 4-channel chunks,
// and a run of tiles: it keeps their 16 weights and scales in registers
// across the run, and per tile makes four 4-byte loads of X and four
// 16-byte stores of Y.  A block is groups x lanes threads: a span of 16
// `groups` channels (threadIdx.x; chunk q of thread x holds channels
// 4 x + 4 groups q ..) times `lanes` tiles (threadIdx.y), each lane taking
// tiles lane, lane + lanes, ... of the block's run, so each load and
// store of a warp is contiguous.  (16 consecutive channels a thread, one
// 16-byte load and four 16-byte stores 64 bytes apart across a warp, was
// slower than the parent's thread per element at every depthwise layer,
// PERF.md.)  Grid: (runs of tiles, channel spans, P).  Where C is no
// multiple of 4 or a pointer is misaligned, the same threads take their
// channels one at a time, masked past C.  Indices are 32-bit (the
// launcher checks P T C < 2^31), with no division.
#include <climits>

#include "sfc_common.cuh"

namespace {

constexpr int kMaxThreads = 512;  // DW_MAX_THREADS in kernels/sfc_tdmm.py

__global__ void __launch_bounds__(kMaxThreads) tdmm_dw_kernel(
    const int8_t* __restrict__ X, const int8_t* __restrict__ W,
    const float* __restrict__ sx, const float* __restrict__ sw,
    float* __restrict__ Y, int T, int C, int run, bool vec) {
  // channels c[q] .. c[q] + 3 for q = 0 .. 3: four 4-channel chunks, 4 G
  // channels apart, so a warp's threads take neighbouring chunks
  const int G = blockDim.x;
  const int cq0 = 16 * G * blockIdx.y + 4 * threadIdx.x;
  if (cq0 >= C) return;
  const int p = blockIdx.z;
  const int t0 = blockIdx.x * blockDim.y * run + threadIdx.y;
  const int t1 = min(T, t0 + run * (int)blockDim.y);
  const float sxp = __ldg(sx + p);
  int w[16];
  float s[16];
  if (vec) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = cq0 + 4 * G * q;
      char4 wv = make_char4(0, 0, 0, 0);
      float4 sv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < C) {
        wv = __ldg(reinterpret_cast<const char4*>(W + p * C + c));
        sv = __ldg(reinterpret_cast<const float4*>(sw + p * C + c));
      }
      w[4 * q] = wv.x, w[4 * q + 1] = wv.y, w[4 * q + 2] = wv.z,
      w[4 * q + 3] = wv.w;
      s[4 * q] = sv.x, s[4 * q + 1] = sv.y, s[4 * q + 2] = sv.z,
      s[4 * q + 3] = sv.w;
    }
    for (int t = t0; t < t1; t += blockDim.y) {
      const int e = (p * T + t) * C;
      char4 xv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = cq0 + 4 * G * q;
        if (c < C) xv[q] = __ldg(reinterpret_cast<const char4*>(X + e + c));
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = cq0 + 4 * G * q;
        if (c < C)
          *reinterpret_cast<float4*>(Y + e + c) = make_float4(
              sfc::dequant(xv[q].x * w[4 * q], sxp, s[4 * q]),
              sfc::dequant(xv[q].y * w[4 * q + 1], sxp, s[4 * q + 1]),
              sfc::dequant(xv[q].z * w[4 * q + 2], sxp, s[4 * q + 2]),
              sfc::dequant(xv[q].w * w[4 * q + 3], sxp, s[4 * q + 3]));
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = cq0 + 4 * G * (i >> 2) + (i & 3);
      w[i] = c < C ? (int)__ldg(W + p * C + c) : 0;
      s[i] = c < C ? __ldg(sw + p * C + c) : 0.f;
    }
    for (int t = t0; t < t1; t += blockDim.y) {
      const int e = (p * T + t) * C;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = cq0 + 4 * G * (i >> 2) + (i & 3);
        if (c < C) Y[e + c] = sfc::dequant((int)X[e + c] * w[i], sxp, s[i]);
      }
    }
  }
}

}  // namespace

// The geometry (groups, lanes, run) is DwProductGeometry's.
extern "C" int tdmm_int8_depthwise_launch(const void* X, const void* W,
                                          const void* sx, const void* sw,
                                          void* Y, int P, int T, int C,
                                          int groups, int lanes, int run,
                                          void* stream) {
  if ((long long)P * T * C == 0) return 0;
  const long long span = (long long)lanes * run;
  if ((long long)P * T * C > INT_MAX || P > 65535 || groups < 1 ||
      lanes < 1 || run < 1 || groups * lanes > kMaxThreads ||
      (T + span - 1) / span > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const bool vec = C % 4 == 0 && (uintptr_t)X % 4 == 0 &&
                   (uintptr_t)W % 4 == 0 && (uintptr_t)sw % 16 == 0 &&
                   (uintptr_t)Y % 16 == 0;
  const int spans = (C + 16 * groups - 1) / (16 * groups);
  if (spans > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((T + span - 1) / span), (unsigned)spans,
                  (unsigned)P);
  tdmm_dw_kernel<<<grid, dim3(groups, lanes), 0, (cudaStream_t)stream>>>(
      (const int8_t*)X, (const int8_t*)W, (const float*)sx, (const float*)sw,
      (float*)Y, T, C, run, vec);
  return (int)cudaGetLastError();
}
