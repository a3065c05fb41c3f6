// B2: transform-domain int8 matmul with fused dequant.
//
// Replaces src/repro/kernels/sfc_tdmm.py::_tdmm_kernel and
// ::_tdmm_kblock_kernel (wrapper tdmm_int8).  The two Pallas kernels are
// one kernel here: the K reduction is one loop inside the block, with the
// int32 accumulator in registers across all of K.  The TPU splits K into
// blocks to fit VMEM; nothing here needs that, so there is no k_block.
//
// Computes, for each of the P = t^2 transform-domain positions p,
//   Y[p] = float(X[p] @ W[p]) * (sx[p] * sw[p, :])
// with X (P, T, K) int8, W (P, K, N) int8, accumulation in int32.
//
// What bounds it on the H100: at the VGG-16 shapes (K, N = 64..512) the
// arithmetic intensity is 2 K N / (K + 4 N) ops per byte of X and Y, well
// below the ~590 int8 ops per byte where the tensor cores become the limit,
// so bytes bind: the f32 output dominates the traffic.
//
// Design: grid (N / 64, T / 64, P); 4 warps per block, each owning a
// 32 x 32 output tile as 2 x 4 mma.m16n8k32 s8 fragments.  Each 32-deep K
// step stages a 64 x 32 tile of X and a transposed 32 x 64 tile of W in
// shared memory (rows padded to 48 bytes, so the fragment loads hit 32
// distinct banks).  Loads are 16-byte vectors when K and N allow it, bytes
// with masks otherwise (C_in = 3 on VGG-16's first layer).  The dequant
// runs in the epilogue.  wgmma and TMA are for a later, faster version.
#include "sfc_common.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32, kPad = 48;

template <bool kVecA, bool kVecB>
__global__ void __launch_bounds__(128) tdmm_kernel(
    const int8_t* __restrict__ X, const int8_t* __restrict__ W,
    const float* __restrict__ sx, const float* __restrict__ sw,
    float* __restrict__ Y, int T, int K, int N) {
  __shared__ __align__(16) int8_t As[kBM][kPad];
  __shared__ __align__(16) int8_t Bs[kBN][kPad];

  const int p = blockIdx.z;
  const int t0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int8_t* Xp = X + (long long)p * T * K;
  const int8_t* Wp = W + (long long)p * K * N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    {  // X tile: 64 rows x 32 k, 16 bytes per thread
      const int r = tid >> 1, cc = (tid & 1) * 16;
      const int tr = t0 + r, k = k0 + cc;
      if (kVecA) {
        int4 v = make_int4(0, 0, 0, 0);
        if (tr < T && k < K)
          v = *reinterpret_cast<const int4*>(Xp + (long long)tr * K + k);
        *reinterpret_cast<int4*>(&As[r][cc]) = v;
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          As[r][cc + j] = (tr < T && k + j < K)
                              ? Xp[(long long)tr * K + k + j]
                              : (int8_t)0;
      }
    }
    {  // W tile: 32 k x 64 n, stored transposed as Bs[n][k]
      const int kr = tid >> 2, cc = (tid & 3) * 16;
      const int k = k0 + kr, n = n0 + cc;
      if (kVecB) {
        int4 v = make_int4(0, 0, 0, 0);
        if (k < K && n < N)
          v = *reinterpret_cast<const int4*>(Wp + (long long)k * N + n);
        const int8_t* vb = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int j = 0; j < 16; ++j) Bs[cc + j][kr] = vb[j];
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          Bs[cc + j][kr] = (k < K && n + j < N)
                               ? Wp[(long long)k * N + n + j]
                               : (int8_t)0;
      }
    }
    __syncthreads();
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = wm + mt * 16 + g;
      a[mt][0] = *reinterpret_cast<const uint32_t*>(&As[r][c4 * 4]);
      a[mt][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][c4 * 4]);
      a[mt][2] = *reinterpret_cast<const uint32_t*>(&As[r][16 + c4 * 4]);
      a[mt][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][16 + c4 * 4]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int cn = wn + nt * 8 + g;
      b[nt][0] = *reinterpret_cast<const uint32_t*>(&Bs[cn][c4 * 4]);
      b[nt][1] = *reinterpret_cast<const uint32_t*>(&Bs[cn][16 + c4 * 4]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) sfc::mma_s8_16832(acc[mt][nt], a[mt], b[nt]);
    __syncthreads();
  }

  const float sxp = sx[p];
  const float* swp = sw + (long long)p * N;
  float* Yp = Y + (long long)p * T * N;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = t0 + wm + mt * 16 + g + (r >= 2 ? 8 : 0);
        const int col = n0 + wn + nt * 8 + c4 * 2 + (r & 1);
        if (row < T && col < N)
          Yp[(long long)row * N + col] = sfc::dequant(acc[mt][nt][r], sxp, swp[col]);
      }
}

template <bool kVecA, bool kVecB>
void launch(dim3 grid, cudaStream_t stream, const void* X, const void* W,
            const void* sx, const void* sw, void* Y, int T, int K, int N) {
  tdmm_kernel<kVecA, kVecB><<<grid, 128, 0, stream>>>(
      (const int8_t*)X, (const int8_t*)W, (const float*)sx, (const float*)sw,
      (float*)Y, T, K, N);
}

}  // namespace

extern "C" int tdmm_int8_launch(const void* X, const void* W, const void* sx,
                                const void* sw, void* Y, int P, int T, int K,
                                int N, void* stream) {
  if ((long long)P * T * N == 0) return 0;
  const dim3 grid((N + kBN - 1) / kBN, (T + kBM - 1) / kBM, P);
  const bool vec_a = (K % 16 == 0);
  const bool vec_b = (N % 16 == 0);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec_a && vec_b) launch<true, true>(grid, s, X, W, sx, sw, Y, T, K, N);
  else if (vec_a) launch<true, false>(grid, s, X, W, sx, sw, Y, T, K, N);
  else if (vec_b) launch<false, true>(grid, s, X, W, sx, sw, Y, T, K, N);
  else launch<false, false>(grid, s, X, W, sx, sw, Y, T, K, N);
  return (int)cudaGetLastError();
}
