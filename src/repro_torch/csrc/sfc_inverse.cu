// B3: SFC inverse transform A^T Y A.
//
// Replaces src/repro/kernels/sfc_inverse.py::_inverse_kernel (wrapper
// sfc_inverse).
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
// Design: one thread per (tile, output channel, output row m), channels
// fastest, so each warp reads and writes 128 consecutive bytes and M times
// as many threads as (tile, channel) pairs hide each thread's latency.
// A^T sits in shared memory.  The arithmetic is sfc::inverse_row, which
// the fused kernel calls too.
#include "sfc_common.cuh"

namespace {

__global__ void __launch_bounds__(128) inverse_kernel(
    const float* __restrict__ ty, const float* __restrict__ at_g,
    float* __restrict__ out, int O, int t, int M, long long total) {
  __shared__ float at[sfc::kMaxM * sfc::kMaxT];
  for (int i = threadIdx.x; i < M * t; i += blockDim.x) at[i] = at_g[i];
  __syncthreads();

  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int o = (int)(idx % O);
  const int m = (int)((idx / O) % M);
  const long long n = idx / ((long long)O * M);
  const float* y = ty + n * t * t * O + o;
  float* z = out + (n * M + m) * M * O + o;
  auto load = [&](int u, int v) -> float {
    return __ldg(y + (long long)(u * t + v) * O);
  };
  auto store = [&](int q, float val) { z[(long long)q * O] = val; };
  sfc::inverse_row(load, at, t, M, m, store);
}

}  // namespace

extern "C" int sfc_inverse_launch(const void* ty, const void* at, void* out,
                                  long long nT, int O, int t, int M,
                                  void* stream) {
  const long long total = nT * M * O;
  if (total == 0) return 0;
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  inverse_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)ty, (const float*)at, (float*)out, O, t, M, total);
  return (int)cudaGetLastError();
}
