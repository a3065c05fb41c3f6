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
#include <type_traits>
#include <utility>

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
// The rows of a tile are independent: the kernels share them out over a
// few threads per (tile, channel).  (The compile-time form below gives the
// same bits.)
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

// B^T at compile time for the algorithms whose (t, L) the kernels fix:
// sfc6_6, sfc6_7 and sfc4_4, entries -1, 0, 1 (tests/test_torch_kernels.py
// holds these tables to the registry's B^T).  A launcher takes them only
// where fixed_bt_matches says the B^T it was given is this one.
template <int T, int L> struct FixedBt;

template <> struct FixedBt<10, 8> {   // sfc6_6
  __host__ __device__ static constexpr int at(int u, int i) {
    constexpr signed char v[10 * 8] = {
         0,  1,  1,  1,  1,  1,  1,  0,
         0,  1,  0, -1, -1,  0,  1,  0,
         0,  0,  1,  1,  0, -1, -1,  0,
         0,  1,  1,  0, -1, -1,  0,  0,
         0,  1, -1,  0,  1, -1,  0,  0,
         0,  0,  1, -1,  0,  1, -1,  0,
         0,  1,  0, -1,  1,  0, -1,  0,
         0,  1, -1,  1, -1,  1, -1,  0,
         1,  0,  0,  0,  0,  0, -1,  0,
         0, -1,  0,  0,  0,  0,  0,  1,
    };
    return v[u * 8 + i];
  }
};

template <> struct FixedBt<12, 9> {   // sfc6_7
  __host__ __device__ static constexpr int at(int u, int i) {
    constexpr signed char v[12 * 9] = {
         0,  1,  1,  1,  1,  1,  1,  0,  0,
         0,  1,  0, -1, -1,  0,  1,  0,  0,
         0,  0,  1,  1,  0, -1, -1,  0,  0,
         0,  1,  1,  0, -1, -1,  0,  0,  0,
         0,  1, -1,  0,  1, -1,  0,  0,  0,
         0,  0,  1, -1,  0,  1, -1,  0,  0,
         0,  1,  0, -1,  1,  0, -1,  0,  0,
         0,  1, -1,  1, -1,  1, -1,  0,  0,
         1,  0,  0,  0,  0,  0, -1,  0,  0,
         0, -1,  0,  0,  0,  0,  0,  1,  0,
         0, -1,  0,  0,  0,  0,  0,  1,  0,
         0,  0, -1,  0,  0,  0,  0,  0,  1,
    };
    return v[u * 9 + i];
  }
};

template <> struct FixedBt<7, 6> {   // sfc4_4
  __host__ __device__ static constexpr int at(int u, int i) {
    constexpr signed char v[7 * 6] = {
         0,  1,  1,  1,  1,  0,
         0,  1,  0, -1,  0,  0,
         0,  0,  1,  0, -1,  0,
         0,  1,  1, -1, -1,  0,
         0,  1, -1,  1, -1,  0,
         1,  0,  0,  0, -1,  0,
         0, -1,  0,  0,  0,  1,
    };
    return v[u * 6 + i];
  }
};

template <class Bt, int T, int L>
inline bool fixed_bt_matches(const float* bt) {
  for (int u = 0; u < T; ++u)
    for (int i = 0; i < L; ++i)
      if (bt[u * L + i] != static_cast<float>(Bt::at(u, i))) return false;
  return true;
}

namespace detail {

// r[j] = fma(bt[U, I], x[I, j], r[j]) where that compile-time coefficient
// is nonzero; nothing where it is zero
template <class Bt, int U, int I, int L, class Load>
__device__ __forceinline__ void fixed_row_term(Load& load, float (&r)[L]) {
  constexpr int b = Bt::at(U, I);
  if constexpr (b != 0) {
#pragma unroll
    for (int j = 0; j < L; ++j)
      r[j] = fmaf(static_cast<float>(b), load(I, j), r[j]);
  }
}

template <class Bt, int U, int L, class Load, int... I>
__device__ __forceinline__ void fixed_row(Load& load, float (&r)[L],
                                          std::integer_sequence<int, I...>) {
  (fixed_row_term<Bt, U, I, L>(load, r), ...);
}

// the row pass of row u, u sent to its compile-time code
template <class Bt, int T, int L, int U = 0, class Load>
__device__ __forceinline__ void fixed_row_at(int u, Load& load,
                                             float (&r)[L]) {
  if constexpr (U < T) {
    if (u == U)
      fixed_row<Bt, U, L>(load, r, std::make_integer_sequence<int, L>());
    else
      fixed_row_at<Bt, T, L, U + 1>(u, load, r);
  }
}

}  // namespace detail

// transform_row with t = T and L fixed at compile time and its loops
// unrolled, so the t sums of the row (and, quantizing, its t divisions)
// interleave.  Output for output it gives the bits of the run-time form:
// the same FMAs in the same order, the same zero coefficients skipped in
// the row pass and none in the column pass.  With B^T passed by value (a
// kernel parameter), the coefficients of the column pass are constant
// operands.  In the row pass, a zero coefficient of B^T discards its FMAs
// by a select (nothing orders the loads); with Fixed = FixedBt<T, L>, B^T
// as it is for sfc6_6, sfc6_7 or sfc4_4, row u's pass is compiled for its
// own coefficients (u sent to it by a branch), so it loads, and adds, only
// the input rows whose coefficient is nonzero.
template <int T, int L, class Fixed = void, class Load, class Emit>
__device__ __forceinline__ void transform_row(Load load, const float* bt,
                                              int u, Emit emit) {
  // r[j] = sum_i bt[u, i] * x[i, j]
  float r[L];
#pragma unroll
  for (int j = 0; j < L; ++j) r[j] = 0.f;
  if constexpr (std::is_void_v<Fixed>) {
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const float b = bt[u * L + i];
      const bool nz = b != 0.f;
#pragma unroll
      for (int j = 0; j < L; ++j)
        r[j] = nz ? fmaf(b, load(i, j), r[j]) : r[j];
    }
  } else {
    detail::fixed_row_at<Fixed, T, L>(u, load, r);
  }
#pragma unroll
  for (int v = 0; v < T; ++v) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < L; ++j) acc = fmaf(bt[v * L + j], r[j], acc);
    emit(v, acc);
  }
}

// transform_quantize_row with t = T and L fixed at compile time: the
// compile-time transform_row, quantized by the same quantizer, so it gives
// the run-time form's bits.  B1 (sfc_transform.cu, with Fixed) and B7
// (sfc_fused_dw.cu) call it for sfc6_6, sfc6_7 and sfc4_4; B4 calls the
// run-time form.
template <int T, int L, class Fixed = void, class Load, class Store>
__device__ __forceinline__ void transform_quantize_row(
    Load load, const float* bt, const float* scale, float qmax, int u,
    Store store) {
  transform_row<T, L, Fixed>(load, bt, u, [&](int v, float tx) {
    store(v, quantize(tx, scale[u * T + v], qmax));
  });
}

// quantize() without its division, for a scale s with |s| in [2^-60, 2^60]
// (reciprocal_quantizer_fits) and y = 1 / s correctly rounded: the same
// int8, bit for bit.  q0 = tx y is within 1.5 ulp of tx / s; one step
// q1 = q0 + (tx - s q0) y (the remainder exact, by an FMA) makes it within
// an ulp, and a second step from q1 rounds to the IEEE quotient
// (Markstein's theorem: y within half an ulp of 1 / s, q1 within an ulp,
// the remainder exact).  Nothing overflows where |q0| < 2^64; elsewhere (an
// infinite tx, a huge quotient) q0 itself has the quotient's sign and
// clips to the same +-qmax, and a NaN stays NaN.  Where a remainder
// underflows, |tx / s| < 2^-40 and both round to 0.  Five FP operations
// and no branch, where the IEEE division is a branch region of its own.
__device__ __forceinline__ int8_t quantize_by_reciprocal(float tx, float s,
                                                         float y,
                                                         float qmax) {
  const float q0 = __fmul_rn(tx, y);
  const float q1 = __fmaf_rn(__fmaf_rn(-s, q0, tx), y, q0);
  const float q2 = __fmaf_rn(__fmaf_rn(-s, q1, tx), y, q1);
  const float q = fabsf(q0) < 0x1p64f ? q2 : q0;
  return static_cast<int8_t>(fminf(fmaxf(rintf(q), -qmax), qmax));
}

inline bool reciprocal_quantizer_fits(float s) {
  const float a = s < 0.f ? -s : s;
  return a >= 0x1p-60f && a <= 0x1p60f;
}

// transform_quantize_row<T, L, Fixed> by quantize_by_reciprocal: the same
// bits.  scale, rscale -> t x t scales and their reciprocals.  B1
// (sfc_transform.cu) calls it, with scales and reciprocals by value.
template <int T, int L, class Fixed = void, class Load, class Store>
__device__ __forceinline__ void transform_quantize_row_by_reciprocal(
    Load load, const float* bt, const float* scale, const float* rscale,
    float qmax, int u, Store store) {
  transform_row<T, L, Fixed>(load, bt, u, [&](int v, float tx) {
    store(v, quantize_by_reciprocal(tx, scale[u * T + v], rscale[u * T + v],
                                    qmax));
  });
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

// Copies into shared memory by cp.async: 16 bytes, zero-filled past
// src_bytes (0: nothing is read), in copy groups that a thread commits and
// waits for.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until every copy group of this thread has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The slot in a 32-deep k row that holds k when a B fragment is formed by
// ldsm_x4_trans from rows k = lane (lane 8m + j gives row 8m + j) and
// __byte_perm (B4): lane c4 gets k = 2 c4, 2 c4 + 1, 2 c4 + 8, 2 c4 + 9
// and the same + 16, so the A fragments hold k in that order too.  slot_k
// is its inverse.
__host__ __device__ constexpr int k_slot(int k) {
  return (k & ~15) | ((k >> 1) & 3) << 2 | ((k >> 3) & 1) << 1 | (k & 1);
}

__host__ __device__ constexpr int slot_k(int s) {
  return (s & ~15) | ((s >> 2) & 3) << 1 | ((s >> 1) & 1) << 3 | (s & 1);
}

// four 8 x 8 matrices of 16-bit elements, transposed: lanes 8m .. 8m + 7
// give the rows of matrix m, and lane (g, c4) gets its column g, rows
// 2 c4 and 2 c4 + 1, in r[m]
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((unsigned)__cvta_generic_to_shared(p)));
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
