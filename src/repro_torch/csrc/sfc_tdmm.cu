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
// with X (P, T, K) int8, W (P, K, N) int8, accumulation in int32, and the
// dequant of sfc_common.cuh (B4's epilogue: the two are bit-identical).
//
// What bounds it on the H100: bytes.  At VGG-16's shapes the int8
// operations take a twentieth of the time the bytes do (PERF.md): at many
// tiles (T = 1444 at 224x224) the f32 output Y dominates, at few (T = 9 or
// 25 at 14x14 and 28x28) the int8 weights W, t^2 C_in C_out bytes that
// every block streams once.  So the kernel keeps enough loads in flight and
// wastes no bytes.
//
// Design.  The geometry comes from the wrapper (kernels/sfc_tdmm.py,
// TdmmGeometry, picked per layer); this file only checks it.  A block owns
// BN columns of Y[p] (64 or 128) and `tiles` consecutive row tiles of BM
// rows (16, 32, 64 or 128, so a layer of 9 or 25 tiles does not pay for
// 64), and walks each tile's K in BK-deep steps (32 or 64): one sequence
// of (row tile, K step) items through a ring of `stages` slots in shared
// memory, filled by 16-byte cp.async copies issued stages - 1 items ahead,
// so the loads of item i + stages - 1 overlap the products of item i, and
// the next row tile's loads a finished tile's stores.
// Each warp owns a (BM / warps_m) x (BN / warps_n) part of the tile as
// int32 mma.m16n8k32 fragments.  The rows of both tiles are stored as
// they arrive (X k-contiguous, W n-contiguous), their 16-byte chunks
// swizzled as TMA's 32-, 64- and 128-byte swizzles place them (swz), so
// no fragment load conflicts on a bank.  The B fragments come from
// ldmatrix.trans of 32 k rows x 16 columns and two byte permutes (even
// and odd columns, as B4 forms them); the lanes address the k rows in an
// order (ldsm_row) that gives each lane's B fragment four consecutive k,
// rotated by two for lanes c4 = 2, 3, so the A fragments are single
// 32-bit loads of X's rows with the same rotation.  The epilogue
// dequantizes in registers: a lane holds four consecutive output columns
// of a row (even and odd n-tiles interleaved), written as one 16-byte
// store.  Where K or N is no multiple of 16 (VGG-16's first layer has K =
// 3), that operand is loaded byte by byte with masks into the same layout
// (and Y stored by floats), the loads issued with the copies into
// registers and placed in shared memory after the item before has been
// multiplied and stored: a compile-time variant of the same kernel, at
// BK = 32 and BN = 64.
#include <atomic>

#include "sfc_common.cuh"

namespace {

constexpr int kMaxStages = 6;   // TDMM_MAX_STAGES in kernels/sfc_tdmm.py
constexpr int kRegisters = 128; // a thread's budget: TDMM_REGISTERS

// The block's warps (warps_m x warps_n) and what each owns: kMT m-tiles of
// 16 rows and kNC chunks of 16 columns (an even and an odd n-tile each).
template <int BM, int BN>
struct Warps {
  static constexpr int kM = BM == 16 ? 1 : BM == 128 ? 4 : 2;
  static constexpr int kN = BM == 16 ? 4 : 2;
  static constexpr int kThreads = 32 * kM * kN;
  static constexpr int kMT = BM / kM / 16;
  static constexpr int kNC = BN / kN / 16;
};

// The 16-byte chunk where chunk c of row r of a tile with NC chunks a row
// (NC = 2, 4, 8) is stored: TMA's 32-, 64- and 128-byte swizzle.  Eight
// rows whose r % 8 differ then read 16 bytes each from distinct banks.
template <int NC>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int shift = NC == 8 ? 0 : NC == 4 ? 1 : 2;
  return c ^ ((r >> shift) & (NC - 1));
}

// The k row (of 32) that lane L addresses in ldsm_x4_trans: matrix m = L / 8
// takes, for lanes c4 = j / 2 of its rows j, the k pairs 4 c4 + i (m even)
// and 4 c4 + 2 + i (m odd), swapped for c4 >= 2, plus 16 for m >= 2.  Then
// lane (g, c4)'s B fragment holds k = 4 c4 .. 4 c4 + 3 (and + 16), rotated
// by two for c4 >= 2, and each matrix's eight rows differ mod 8.
__device__ __forceinline__ int ldsm_row(int lane) {
  const int m = lane >> 3, j = lane & 7, c = j >> 1;
  return 16 * (m >> 1) + 4 * c + 2 * ((m & 1) ^ (c >> 1)) + (j & 1);
}

__device__ __forceinline__ void wait_ring(int stages) {
  switch (stages) {  // stages - 2 copy groups may stay in flight
    case 2: sfc::cp_async_wait<0>(); break;
    case 3: sfc::cp_async_wait<1>(); break;
    case 4: sfc::cp_async_wait<2>(); break;
    case 5: sfc::cp_async_wait<3>(); break;
    default: sfc::cp_async_wait<4>(); break;
  }
}

// kVecA: X by 16-byte cp.async (K % 16 == 0), else by bytes; kVecB: W by
// 16-byte cp.async and Y by 16-byte stores (N % 16 == 0), else by bytes
// and floats.
template <int BM, int BN, int BK, bool kVecA, bool kVecB>
__global__ void __launch_bounds__(Warps<BM, BN>::kThreads,
                                  65536 / kRegisters /
                                      Warps<BM, BN>::kThreads)
    tdmm_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ W,
                const float* __restrict__ sx, const float* __restrict__ sw,
                float* __restrict__ Y, int T, int K, int N, int stages,
                int tiles) {
  using Wp = Warps<BM, BN>;
  constexpr int kThreads = Wp::kThreads, kMT = Wp::kMT, kNC = Wp::kNC;
  constexpr int NCA = BK / 16, NCB = BN / 16;  // 16-byte chunks a row
  constexpr int kA = BM * BK, kB = BK * BN;    // bytes of a slot
  extern __shared__ __align__(128) int8_t smem[];

  const int n0 = blockIdx.x * BN, p = blockIdx.z;
  const int8_t* Xp = X + (long long)p * T * K;
  const int8_t* Wq = W + (long long)p * K * N;
  const int ksteps = (K + BK - 1) / BK;
  // the block's row tiles: `tiles` consecutive ones (fewer at the end),
  // walked as one sequence of (row tile, K step) items
  const int mt0 = blockIdx.y * tiles;
  const int items = min(tiles, (T + BM - 1) / BM - mt0) * ksteps;
  const int S = stages;
  int8_t* As = smem;                                 // [ring][BM][BK]
  int8_t* Bs = smem + min(S, tiles * ksteps) * kA;   // [ring][BK][BN]
  const int tid = threadIdx.x;

  // Item it's X rows m0 .. m0 + BM and W rows k0 .. k0 + BK, zero past T,
  // K and N: `copy` issues the 16-byte copies into `slot`; an operand by
  // bytes is `fetch`ed into registers (ra, rb: four neighbouring bytes of
  // a row a word) when the copies are issued and `place`d into the slot
  // after the item before has been multiplied and stored, so its loads'
  // latency overlaps that work.
  constexpr int NA = kVecA ? 1 : BM * BK / 4 / kThreads;  // words a thread
  constexpr int NB = kVecB ? 1 : BK * BN / 4 / kThreads;
  static_assert(kVecA || NA * 4 * kThreads == BM * BK, "X words");
  static_assert(kVecB || NB * 4 * kThreads == BK * BN, "W words");
  uint32_t ra[NA], rb[NB];
  auto origin = [&](int it, int& m0, int& k0) {
    const int j = it / ksteps;
    m0 = (mt0 + j) * BM;
    k0 = (it - j * ksteps) * BK;
  };
  auto copy = [&](int slot, int it) {
    int m0, k0;
    origin(it, m0, k0);
    if constexpr (kVecA) {
      int8_t* as = As + slot * kA;
#pragma unroll
      for (int i = tid; i < BM * NCA; i += kThreads) {
        const int r = i / NCA, c = i % NCA, t = m0 + r, k = k0 + 16 * c;
        const bool ok = t < T && k < K;
        sfc::cp_async16(as + r * BK + 16 * swz<NCA>(r, c),
                        ok ? Xp + (long long)t * K + k : Xp, ok ? 16 : 0);
      }
    }
    if constexpr (kVecB) {
      int8_t* bs = Bs + slot * kB;
#pragma unroll
      for (int i = tid; i < BK * NCB; i += kThreads) {
        const int r = i / NCB, c = i % NCB, k = k0 + r, n = n0 + 16 * c;
        const bool ok = k < K && n < N;
        sfc::cp_async16(bs + r * BN + 16 * swz<NCB>(r, c),
                        ok ? Wq + (long long)k * N + n : Wq, ok ? 16 : 0);
      }
    }
  };
  // byte `b` of a row of `len` bytes, 0 past it
  auto byte = [](const int8_t* row, int b, int len) -> uint32_t {
    return b < len ? (uint32_t)(uint8_t)row[b] : 0u;
  };
  auto fetch = [&](int it) {
    int m0, k0;
    origin(it, m0, k0);
    if constexpr (!kVecA) {
#pragma unroll
      for (int j = 0; j < NA; ++j) {   // word w: row w / (BK / 4)
        const int w = tid + j * kThreads, r = w / (BK / 4);
        const int k = k0 + 4 * (w % (BK / 4)), t = m0 + r;
        const int8_t* row = Xp + (long long)t * K + k;
        const int len = t < T ? K - k : 0;
        ra[j] = byte(row, 0, len) | byte(row, 1, len) << 8 |
                byte(row, 2, len) << 16 | byte(row, 3, len) << 24;
      }
    }
    if constexpr (!kVecB) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int w = tid + j * kThreads, r = w / (BN / 4);
        const int n = n0 + 4 * (w % (BN / 4)), k = k0 + r;
        const int8_t* row = Wq + (long long)k * N + n;
        const int len = k < K ? N - n : 0;
        rb[j] = byte(row, 0, len) | byte(row, 1, len) << 8 |
                byte(row, 2, len) << 16 | byte(row, 3, len) << 24;
      }
    }
  };
  auto place = [&](int slot) {
    if constexpr (!kVecA) {
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        const int w = tid + j * kThreads, r = w / (BK / 4);
        const int kk = 4 * (w % (BK / 4));
        *reinterpret_cast<uint32_t*>(As + slot * kA + r * BK +
                                     16 * swz<NCA>(r, kk >> 4) + (kk & 15)) =
            ra[j];
      }
    }
    if constexpr (!kVecB) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int w = tid + j * kThreads, r = w / (BN / 4);
        const int nn = 4 * (w % (BN / 4));
        *reinterpret_cast<uint32_t*>(Bs + slot * kB + r * BN +
                                     16 * swz<NCB>(r, nn >> 4) + (nn & 15)) =
            rb[j];
      }
    }
  };
  constexpr bool kBytes = !kVecA || !kVecB;

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, c4 = lane & 3;
  const int row0 = (warp / Wp::kN) * (BM / Wp::kM);  // the warp's rows
  const int chunk0 = (warp % Wp::kN) * kNC;          // and column chunks
  const int lrow = ldsm_row(lane);
  // A's bytes in the slot order of the B fragments: rotated for c4 >= 2
  const unsigned arot = c4 >= 2 ? 0x1032u : 0x3210u;

  int acc[kMT][kNC][2][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int q = 0; q < kNC; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][q][h][r] = 0;

  // lane (g, c4) holds columns 4 c4 .. 4 c4 + 3 of each chunk, rows g and
  // g + 8 of each m-tile: (even, odd, even, odd) n-tile values
  const float sxp = __ldg(sx + p);
  const float* swp = sw + (long long)p * N;
  float* Yp = Y + (long long)p * T * N;
  auto epilogue = [&](int m0) {
#pragma unroll
    for (int q = 0; q < kNC; ++q) {
      const int n = n0 + 16 * (chunk0 + q) + 4 * c4;
      float s4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s4[j] = n + j < N ? __ldg(swp + n + j) : 0.f;
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = m0 + row0 + 16 * i + g + 8 * h;
          if (t >= T) continue;
          const int* e = acc[i][q][0];
          const int* o = acc[i][q][1];
          const float v[4] = {sfc::dequant(e[2 * h], sxp, s4[0]),
                              sfc::dequant(o[2 * h], sxp, s4[1]),
                              sfc::dequant(e[2 * h + 1], sxp, s4[2]),
                              sfc::dequant(o[2 * h + 1], sxp, s4[3])};
          float* dst = Yp + (long long)t * N + n;
          if constexpr (kVecB) {
            if (n < N)
              *reinterpret_cast<float4*>(dst) =
                  make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (n + j < N) dst[j] = v[j];
          }
        }
    }
  };

  for (int s = 0; s < S - 1; ++s) {
    if (s < items) {
      copy(s, s);
      fetch(s);
      place(s);
    }
    sfc::cp_async_commit();
  }
  int ks = 0, mt = mt0;   // item it's K step and row tile
  for (int it = 0; it < items; ++it) {
    // item it has landed, and every warp is done with item it - 1, whose
    // slot item it + S - 1 refills (the next row tile's loads overlap this
    // one's products and stores)
    wait_ring(S);
    __syncthreads();
    const bool next = it + S - 1 < items;
    if (next) {
      copy((it + S - 1) % S, it + S - 1);
      fetch(it + S - 1);
    }
    sfc::cp_async_commit();
    const int8_t* as = As + (it % S) * kA;
    const int8_t* bs = Bs + (it % S) * kB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      const int ca = kk / 16;
      uint32_t af[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int r = row0 + 16 * i + g;
        auto word = [&](int rr, int c) {
          return __byte_perm(*reinterpret_cast<const uint32_t*>(
                                 as + rr * BK + 16 * swz<NCA>(rr, c) + 4 * c4),
                             0u, arot);
        };
        af[i][0] = word(r, ca);
        af[i][1] = word(r + 8, ca);
        af[i][2] = word(r, ca + 1);
        af[i][3] = word(r + 8, ca + 1);
      }
      const int kr = kk + lrow;
#pragma unroll
      for (int q = 0; q < kNC; ++q) {
        // 32 k rows of 16 columns: r4[m] holds columns 2g, 2g + 1 of two k
        uint32_t r4[4];
        sfc::ldsm_x4_trans(r4, bs + kr * BN + 16 * swz<NCB>(kr, chunk0 + q));
        const uint32_t be[2] = {__byte_perm(r4[0], r4[1], 0x6420),
                                __byte_perm(r4[2], r4[3], 0x6420)};
        const uint32_t bo[2] = {__byte_perm(r4[0], r4[1], 0x7531),
                                __byte_perm(r4[2], r4[3], 0x7531)};
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          sfc::mma_s8_16832(acc[i][q][0], af[i], be);
          sfc::mma_s8_16832(acc[i][q][1], af[i], bo);
        }
      }
    }
    if (++ks == ksteps) {   // the row tile's sums are complete
      epilogue(mt * BM);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int q = 0; q < kNC; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][q][h][r] = 0;
      ks = 0;
      ++mt;
    }
    if (kBytes && next) place((it + S - 1) % S);
  }
}

struct Launch {
  const void *X, *W, *sx, *sw;
  void* Y;
  int P, T, K, N, stages, tiles, smem;
  cudaStream_t stream;
};

template <int BM, int BN, int BK, bool kVecA, bool kVecB>
cudaError_t run(const Launch& l) {
  using Wp = Warps<BM, BN>;
  const int ring = l.tiles * ((l.K + BK - 1) / BK);
  if (l.smem != (l.stages < ring ? l.stages : ring) * (BM * BK + BK * BN))
    return cudaErrorInvalidValue;
  auto kernel = tdmm_kernel<BM, BN, BK, kVecA, kVecB>;
  static std::atomic<bool> done[sfc::kMaxDevices];
  cudaError_t e = sfc::once_per_device(done, [&] {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kMaxStages * (BM * BK + BK * BN));
  });
  if (e != cudaSuccess) return e;
  const int row_tiles = (l.T + BM - 1) / BM;
  const dim3 grid((l.N + BN - 1) / BN,
                  (row_tiles + l.tiles - 1) / l.tiles, l.P);
  kernel<<<grid, Wp::kThreads, l.smem, l.stream>>>(
      (const int8_t*)l.X, (const int8_t*)l.W, (const float*)l.sx,
      (const float*)l.sw, (float*)l.Y, l.T, l.K, l.N, l.stages, l.tiles);
  return cudaGetLastError();
}

}  // namespace

// The geometry (bm, bn, bk, stages, tiles, smem) is TdmmGeometry's; a
// kernel is compiled for each TDMM_CASE below
// (tests/test_torch_tdmm_geometry.py holds the list to
// kernels/sfc_tdmm.py's TDMM_KERNELS).
extern "C" int tdmm_int8_launch(const void* X, const void* W, const void* sx,
                                const void* sw, void* Y, int P, int T, int K,
                                int N, int bm, int bn, int bk, int stages,
                                int tiles, int smem, void* stream) {
  if ((long long)P * T * N == 0) return 0;
  if (stages < 2 || stages > kMaxStages || P > 65535 || bm < 16 ||
      tiles < 1 || tiles > (T + bm - 1) / bm || (T + bm - 1) / bm > 65535 ||
      (uintptr_t)X % 16 || (uintptr_t)W % 16 || (uintptr_t)Y % 16)
    return (int)cudaErrorInvalidValue;
  const Launch l{X, W, sx, sw, Y, P, T, K, N, stages, tiles, smem,
                 (cudaStream_t)stream};
  const bool va = K % 16 == 0, vb = N % 16 == 0;
#define TDMM_CASE(BM, BN, BK, VA, VB)                                   \
  if (bm == BM && bn == BN && bk == BK && va == VA && vb == VB)         \
    return (int)run<BM, BN, BK, VA, VB>(l);
  TDMM_CASE(16, 64, 32, true, true)
  TDMM_CASE(16, 64, 64, true, true)
  TDMM_CASE(16, 128, 32, true, true)
  TDMM_CASE(16, 128, 64, true, true)
  TDMM_CASE(32, 64, 32, true, true)
  TDMM_CASE(32, 64, 64, true, true)
  TDMM_CASE(32, 128, 32, true, true)
  TDMM_CASE(32, 128, 64, true, true)
  TDMM_CASE(64, 64, 32, true, true)
  TDMM_CASE(64, 64, 64, true, true)
  TDMM_CASE(64, 128, 32, true, true)
  TDMM_CASE(64, 128, 64, true, true)
  TDMM_CASE(128, 64, 32, true, true)
  TDMM_CASE(128, 64, 64, true, true)
  TDMM_CASE(128, 128, 32, true, true)
  TDMM_CASE(128, 128, 64, true, true)
  TDMM_CASE(16, 64, 32, false, true)
  TDMM_CASE(32, 64, 32, false, true)
  TDMM_CASE(64, 64, 32, false, true)
  TDMM_CASE(128, 64, 32, false, true)
  TDMM_CASE(16, 64, 32, true, false)
  TDMM_CASE(32, 64, 32, true, false)
  TDMM_CASE(64, 64, 32, true, false)
  TDMM_CASE(128, 64, 32, true, false)
  TDMM_CASE(16, 64, 32, false, false)
  TDMM_CASE(32, 64, 32, false, false)
  TDMM_CASE(64, 64, 32, false, false)
  TDMM_CASE(128, 64, 32, false, false)
#undef TDMM_CASE
  return (int)cudaErrorInvalidValue;
}
