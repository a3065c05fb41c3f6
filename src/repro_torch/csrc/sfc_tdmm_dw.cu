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
// small and cached), and two multiplications.
//
// Design: a thread per element; consecutive threads take consecutive
// channels, so the loads and stores of a warp are contiguous.  The grid's
// y index is the position p, so a thread finds its channel with one 32-bit
// remainder (a 64-bit division costs tens of instructions on the card).
#include <climits>

#include "sfc_common.cuh"

namespace {

__global__ void __launch_bounds__(256) tdmm_dw_kernel(
    const int8_t* __restrict__ X, const int8_t* __restrict__ W,
    const float* __restrict__ sx, const float* __restrict__ sw,
    float* __restrict__ Y, int TC, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;   // in (T, C)
  if (i >= TC) return;
  const int p = blockIdx.y;
  const long long e = (long long)p * TC + i;
  const int wi = p * C + i % C;
  Y[e] = sfc::dequant((int)X[e] * (int)__ldg(W + wi), __ldg(sx + p),
                      __ldg(sw + wi));
}

}  // namespace

extern "C" int tdmm_int8_depthwise_launch(const void* X, const void* W,
                                          const void* sx, const void* sw,
                                          void* Y, int P, int T, int C,
                                          void* stream) {
  const long long TC = (long long)T * C;
  if (P == 0 || TC == 0) return 0;
  if (TC > INT_MAX || P > 65535) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const dim3 grid((unsigned)((TC + threads - 1) / threads), (unsigned)P);
  tdmm_dw_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)X, (const int8_t*)W, (const float*)sx, (const float*)sw,
      (float*)Y, (int)TC, C);
  return (int)cudaGetLastError();
}
