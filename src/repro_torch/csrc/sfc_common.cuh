// Device functions shared by the staged kernels (sfc_transform.cu,
// sfc_inverse.cu, sfc_tdmm.cu, sfc_tdmm_dw.cu) and the fused kernels
// (sfc_fused.cu, sfc_fused_dw.cu).  Their copies by TMA share
// sfc_tma.cuh.
//
// The staged and the fused datapath must land on one integer grid and one
// fp32 epilogue, so the forward transform, the quantizer, the dequant and
// the inverse each exist exactly once, here.  The JAX package shares
// _quantize_strip_group / _dequant_inverse_strip_group between its Pallas
// kernels for the same reason (src/repro/kernels/sfc_fused.py).
//
// Arithmetic contract (held against the plain PyTorch versions):
//   * forward  TX = B^T X B, rows first, each sum in ascending index order;
//     B^T has entries in {-1, 0, 1} for the SFC algorithms, so on inputs
//     that are multiples of a power of two the sums are exact in any order;
//   * quantize clip(rint(tx / s), -qmax, qmax): IEEE division (__fdiv_rn,
//     never a reciprocal) and round-half-to-even (rintf), as jnp.round and
//     torch.round do.  Build without --use_fast_math;
//   * dequant  float(acc) * (sx[p] * sw[p, n]), the JAX package's order,
//     for the dense GEMM's int32 sums and the depthwise int32 products;
//   * inverse  Z = A^T Y (over rows), then Z A (over columns).
#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace sfc {

// A kernel's attributes (cudaFuncSetAttribute) belong to the current
// device's context: `set` runs once per device, recorded in the call
// site's `done`, and again after a failure.
constexpr int kMaxDevices = 64;

template <class Set>
inline cudaError_t once_per_device(std::atomic<bool> (&done)[kMaxDevices],
                                   Set set) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  e = set();
  if (e == cudaSuccess && known)
    done[dev].store(true, std::memory_order_release);
  return e;
}

// Largest tile sizes the kernels take (L = M + R - 1 input rows, t
// transform-domain positions per dim).  The registered algorithms reach
// L = 9, t = 12; the wrappers reject anything larger.
constexpr int kMaxL = 12;
constexpr int kMaxT = 12;
constexpr int kMaxM = 12;

// Row u of one tile's forward transform B^T X B: the t float values
// tx[u, 0..t), rows first, each sum in ascending index order.  The fp
// transform (B5) stores them as they are; transform_quantize_row (B1, B4,
// B7) quantizes them, so B5's output is exactly the value B1 quantizes.
// The rows of a tile are independent, so the kernels give each
// (tile, channel, u) its own thread.
//   load(i, j)  -> float, the tile's input at row i, column j (zero
//                  outside the image: the caller masks the padding);
//   bt          -> t x L row-major (shared or global memory);
//   emit(v, tx) <- the transform-domain value at position (u, v).
template <class Load, class Emit>
__device__ __forceinline__ void transform_row(Load load, const float* bt,
                                              int t, int L, int u,
                                              Emit emit) {
  // r[j] = sum_i bt[u, i] * x[i, j]
  float r[kMaxL];
#pragma unroll
  for (int j = 0; j < kMaxL; ++j) r[j] = 0.f;
  for (int i = 0; i < L; ++i) {
    const float b = bt[u * L + i];
    if (b == 0.f) continue;
#pragma unroll
    for (int j = 0; j < kMaxL; ++j)
      if (j < L) r[j] = fmaf(b, load(i, j), r[j]);
  }
  for (int v = 0; v < t; ++v) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxL; ++j)
      if (j < L) acc = fmaf(bt[v * L + j], r[j], acc);
    emit(v, acc);
  }
}

// The per-frequency quantizer: clip(rint(tx / s), -qmax, qmax) as int8.
__device__ __forceinline__ int8_t quantize(float tx, float s, float qmax) {
  const float q = rintf(__fdiv_rn(tx, s));
  return static_cast<int8_t>(fminf(fmaxf(q, -qmax), qmax));
}

// Row u of one tile's forward transform + per-frequency quantization:
// the t int8 values xq[u, 0..t).
//   scale       -> t x t per-frequency activation scales;
//   store(v, q) <- the int8 value at transform-domain position (u, v).
template <class Load, class Store>
__device__ __forceinline__ void transform_quantize_row(
    Load load, const float* bt, const float* scale, int t, int L,
    float qmax, int u, Store store) {
  transform_row(load, bt, t, L, u, [&](int v, float tx) {
    store(v, quantize(tx, scale[u * t + v], qmax));
  });
}

// transform_quantize_row with t = T and L fixed at compile time and its
// loops unrolled, so the t sums and divisions of the row interleave; a
// zero coefficient of B^T discards its FMAs (a select, not a branch, so
// nothing orders the loads).  Output for output it gives the bits of the
// run-time form: the same FMAs in the same order, the same zero
// coefficients skipped in the row pass and none in the column pass, the
// same quantizer.  B7 (sfc_fused_dw.cu) calls it; B1, B4 and B5 call
// transform_row.
template <int T, int L, class Load, class Store>
__device__ __forceinline__ void transform_quantize_row(
    Load load, const float* bt, const float* scale, float qmax, int u,
    Store store) {
  // r[j] = sum_i bt[u, i] * x[i, j]
  float r[L];
#pragma unroll
  for (int j = 0; j < L; ++j) r[j] = 0.f;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const float b = bt[u * L + i];
    const bool nz = b != 0.f;
#pragma unroll
    for (int j = 0; j < L; ++j) r[j] = nz ? fmaf(b, load(i, j), r[j]) : r[j];
  }
#pragma unroll
  for (int v = 0; v < T; ++v) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < L; ++j) acc = fmaf(bt[v * L + j], r[j], acc);
    store(v, quantize(acc, scale[u * T + v], qmax));
  }
}

// The dequantized transform-domain value of one int32 accumulator.
__device__ __forceinline__ float dequant(int acc, float sx, float sw) {
  return __fmul_rn(static_cast<float>(acc), __fmul_rn(sx, sw));
}

// Row m of one tile's inverse transform A^T Y A: the M spatial outputs
// of tile row m.  Rows are independent; each (tile, channel, m) gets its
// own thread.
//   load(u, v)     -> float, the dequantized value at position (u, v);
//   at             -> M x t row-major;
//   store(q, val)  <- the spatial output at row m, column q of the tile.
template <class Load, class Store>
__device__ __forceinline__ void inverse_row(Load load, const float* at,
                                            int t, int M, int m,
                                            Store store) {
  // z[v] = sum_u at[m, u] * y[u, v]
  float z[kMaxT];
#pragma unroll
  for (int v = 0; v < kMaxT; ++v) z[v] = 0.f;
  for (int u = 0; u < t; ++u) {
    const float a = at[m * t + u];
    if (a == 0.f) continue;
#pragma unroll
    for (int v = 0; v < kMaxT; ++v)
      if (v < t) z[v] = fmaf(a, load(u, v), z[v]);
  }
  for (int q = 0; q < M; ++q) {
    float o = 0.f;
#pragma unroll
    for (int v = 0; v < kMaxT; ++v)
      if (v < t) o = fmaf(at[q * t + v], z[v], o);
    store(q, o);
  }
}

// Output rows m0 .. m0 + RM - 1 (those below M) of one tile's inverse
// transform A^T Y A, with T, M and RM fixed at compile time: each value
// y(u, v) is loaded once, Z = A^T Y is kept in registers for the RM rows,
// and each output is formed by Z A; a zero coefficient of A^T discards
// its FMAs by a select.  Output for output it gives the bits of
// inverse_row: the same FMAs in the same order, the same zero
// coefficients of A^T skipped in Z and none in Z A.  B3 (sfc_inverse.cu)
// and B7 (sfc_fused_dw.cu) call it; B4 calls inverse_row.
//   load(u, v)       -> float, the value at position (u, v);
//   at               -> M x T row-major;
//   store(m, q, val) <- the spatial output at row m, column q of the tile.
template <int T, int M, int RM, class Load, class Store>
__device__ __forceinline__ void inverse_tile(Load load, const float* at,
                                             int m0, Store store) {
  // z[i][v] = sum_u at[m0 + i, u] * y[u, v]
  float z[RM][T];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int v = 0; v < T; ++v) z[i][v] = 0.f;
#pragma unroll
  for (int u = 0; u < T; ++u) {
    float y[T];
#pragma unroll
    for (int v = 0; v < T; ++v) y[v] = load(u, v);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float a = m0 + i < M ? at[(m0 + i) * T + u] : 0.f;
      const bool nz = a != 0.f;
#pragma unroll
      for (int v = 0; v < T; ++v)
        z[i][v] = nz ? fmaf(a, y[v], z[i][v]) : z[i][v];
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    if (m0 + i >= M) break;
#pragma unroll
    for (int q = 0; q < M; ++q) {
      float o = 0.f;
#pragma unroll
      for (int v = 0; v < T; ++v) o = fmaf(at[q * T + v], z[i][v], o);
      store(m0 + i, q, o);
    }
  }
}

// One int8 tensor-core product D = A(16x32) * B(32x8) + C, s8 x s8 -> s32.
// Fragments follow the PTX ISA layout of mma.m16n8k32 (.row.col):
//   a[0] = A[g][4c..4c+3]     a[1] = A[g+8][4c..]
//   a[2] = A[g][16+4c..]      a[3] = A[g+8][16+4c..]
//   b[0] = B[4c..4c+3][g]     b[1] = B[16+4c..][g]
//   c[0..1] = C[g][2c..2c+1]  c[2..3] = C[g+8][2c..2c+1]
// with g = lane / 4 and c = lane % 4; the lowest byte holds the lowest k.
__device__ __forceinline__ void mma_s8_16832(int c[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace sfc
