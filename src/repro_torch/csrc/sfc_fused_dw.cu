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
// it does the transform's and the inverse's few thousand f32 operations,
// below the card's ratio of f32 operations to memory rate.  At MobileNet's
// small layers what bounds it is latency: a few hundred to a few thousand
// (tile, channel) pairs, each a chain of loads, FMAs and divisions.
//
// Design.  Depthwise has no channel contraction, so every channel block is
// used exactly once: there is no C_in loop, no accumulator and no cluster
// (the dense kernel, sfc_fused.cu, needs all three).  The geometry comes
// from the wrapper (kernels/sfc_fused.py, DepthwiseGeometry), which picks
// it per layer; this file only checks it.  A block owns a run of `tiles`
// tiles along one tile row and cb channels:
//   0. one thread has TMA copy the run's input region, (L) x (M tiles +
//      R - 1) pixels x cb channels, into shared memory, zero-filled where
//      it reaches outside the image (the SAME/VALID padding) and past C
//      (sfc::region_tma_start, which B1 and B5 share), and the (P, cb)
//      int8 weights and f32 weight scales beside it, all completing on
//      one mbarrier (plain loads where the shape rules TMA out: C or cb
//      no multiple of 16);
//   1. `splits` threads per (tile, channel) transform and quantize the
//      tile's rows u = g, g + splits, ... from shared memory
//      (sfc::transform_quantize_row, the staged B1's arithmetic), multiply
//      each int8 value by its weight and dequantize it (sfc::dequant, the
//      staged B6's arithmetic) into y in shared memory;
//   2. the same threads each take ceil(M / min(splits, M)) output rows and
//      invert y (sfc::inverse_tile, which gives B3's bits), writing NHWC
//      output.
// So the fused and the staged depthwise datapaths are bit-identical on the
// card.  Channels are fastest: a warp reads shared memory and writes
// device memory for consecutive channels of one pixel.  (t, L, M) and the
// rows a thread inverts are compile-time for sfc6_6, sfc6_7 and sfc4_4
// (the compile-time form of sfc::transform_quantize_row): a row's loops
// unroll, so its sums and divisions interleave, the inverse's rows stay in
// registers, and B^T and A^T, passed by value, are constant operands
// where the index is compile-time.  (Unrolling the rows of a thread too,
// each thread's row set at compile time, made the code 300 KB and B7
// slower: PERF.md.)  Other algorithms take (t, L, M) at run time.  Tiles
// past the row's last and channels past C are masked: neither computed
// nor stored.
#include "sfc_common.cuh"
#include "sfc_tma.cuh"

namespace {

// up to 168 registers a thread: the rows of Z the inverse keeps (84 floats
// for sfc6_7 at one split) fit without spilling
constexpr int kMaxThreads = 384;
// dynamic shared memory a block may have: the H100's 232448 bytes less
// this kernel's static part (an mbarrier), rounded up to 2 KB
// (DW_STATIC_SMEM_BYTES in kernels/sfc_fused.py)
constexpr int kMaxSmem = 232448 - 2048;
constexpr int kMaxSplits = 10;   // threads per (tile, channel)

struct Args {
  CUtensorMap tmap_x;   // x (C, W, H, B) f32, box (cb, region_w, L, 1)
  CUtensorMap tmap_w;   // wq (C, P) int8, box (cb, P)
  CUtensorMap tmap_sw;  // w_scale (C, P) f32, box (cb, P)
  // B^T and A^T by value: constant operands where the index is
  // compile-time
  float bt[sfc::kMaxT * sfc::kMaxL];
  float at[sfc::kMaxM * sfc::kMaxT];
  const float* x;
  const int8_t* wq;
  const float* s_g;
  const float* sw_g;
  float* out;
  int H, W, C, M, L, t, lo_h, lo_w, nH, nW, out_h, out_w;
  int tiles, cb, splits, runs;  // runs: tile runs per tile row
  int tma;
  float qmax;
};

// Dynamic shared memory of one block (the same layout as
// DepthwiseGeometry; each region starts on 128 bytes):
//   region f32  [L][region_w][cb]   the run's input pixels
//   sw     f32  [P][cb]             weight scales of its channels
//   w      int8 [P][cb]             its weights
//   y      f32  [P][tiles][cb]      the dequantized products
// kT, kL, kM: the algorithm's t, L, M at compile time (0: at run time);
// kRM: the output rows of each thread, ceil(M / min(splits, M)).
template <int kT, int kL, int kM, int kRM>
__global__ void __launch_bounds__(kMaxThreads) fused_dw_kernel(
    const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;

  const int t = kT ? kT : a.t, L = kL ? kL : a.L, M = kM ? kM : a.M;
  const int P = t * t, cb = a.cb, tiles = a.tiles, G = a.splits;
  const float* __restrict__ s = a.s_g;   // activation scales, via L1
  const int region_w = M * (tiles - 1) + L;
  const int row = blockIdx.x / a.runs;           // over (image, tile row)
  const int tw0 = (blockIdx.x % a.runs) * tiles;
  const int b = row / a.nH, th = row % a.nH;
  const int c0 = blockIdx.y * cb;
  const int h_in = th * M - a.lo_h, w_in = tw0 * M - a.lo_w;

  unsigned char* smem =
      smem_raw + ((128 - (sfc::smem_u32(smem_raw) & 127)) & 127);
  const int region_bytes = 4 * L * region_w * cb;
  float* region = reinterpret_cast<float*>(smem);
  float* sw = reinterpret_cast<float*>(smem + sfc::align128(region_bytes));
  int8_t* w = reinterpret_cast<int8_t*>(sw) + sfc::align128(4 * P * cb);
  float* y = reinterpret_cast<float*>(w + sfc::align128(P * cb));

  const int tid = threadIdx.x, nthreads = blockDim.x;
  if (a.tma) {
    if (tid == 0) {
      sfc::region_tma_start(region, &a.tmap_x, &bar,
                            (unsigned)(region_bytes + 5 * P * cb), b, h_in,
                            w_in, c0);
      sfc::tma_load_2d(sw, &a.tmap_sw, &bar, c0, 0);
      sfc::tma_load_2d(w, &a.tmap_w, &bar, c0, 0);
    }
  } else {
    sfc::region_load(region, a.x, a.H, a.W, a.C, b, h_in, w_in, c0, L,
                     region_w, cb);
    for (int i = tid; i < P * cb; i += nthreads) {
      const int p = i / cb, ch = c0 + i % cb;
      const bool in = ch < a.C;
      w[i] = in ? a.wq[(long long)p * a.C + ch] : (int8_t)0;
      sw[i] = in ? a.sw_g[(long long)p * a.C + ch] : 0.f;
    }
  }
  __syncthreads();                 // the mbarrier is initialised
  if (a.tma) sfc::mbar_wait(&bar, 0);

  // thread (g, tile col, channel cc), channels fastest
  const int per_g = tiles * cb;
  const int g = tid / per_g, col = (tid % per_g) / cb, cc = tid % cb;
  const int tw = tw0 + col, ch = c0 + cc;
  const bool mine = g < G && tw < a.nW && ch < a.C;

  // 1. transform + quantize rows u = g, g + G, ... of the tile, multiply
  // by the weights and dequantize into y
  const float* xt = region + col * M * cb + cc;
  auto x_at = [&](int i, int j) -> float {
    return xt[(i * region_w + j) * cb];
  };
  float* yt = y + col * cb + cc;
  auto product = [&](int u, int v, int8_t q) {
    const int p = u * t + v;
    yt[p * per_g] = sfc::dequant((int)q * (int)w[p * cb + cc],
                                 __ldg(s + p), sw[p * cb + cc]);
  };
  if (mine) {
    for (int u = g; u < t; u += G) {
      auto emit = [&](int v, int8_t q) { product(u, v, q); };
      if constexpr (kT > 0)
        sfc::transform_quantize_row<kT, kL>(x_at, a.bt, s, a.qmax, u, emit);
      else
        sfc::transform_quantize_row(x_at, a.bt, s, t, L, a.qmax, u, emit);
    }
  }
  __syncthreads();

  // 2. the inverse of rows g RM .. (g + 1) RM - 1, written as NHWC
  if (!mine) return;
  auto load = [&](int u, int v) -> float { return yt[(u * t + v) * per_g]; };
  const int h0 = th * M, w0 = tw * M, out_h = a.out_h, out_w = a.out_w;
  float* ob = a.out + (((long long)b * out_h + h0) * out_w + w0) * a.C + ch;
  auto store = [&](int m, int q, float val) {
    if (h0 + m < out_h && w0 + q < out_w)
      ob[((long long)m * out_w + q) * a.C] = val;
  };
  if constexpr (kT > 0) {
    if (g * kRM < kM)
      sfc::inverse_tile<kT, kM, kRM>(load, a.at, g * kRM, store);
  } else {
    for (int m = g; m < M; m += G)
      sfc::inverse_row(load, a.at, t, M, m,
                       [&](int q, float val) { store(m, q, val); });
  }
}

template <int kT, int kL, int kM, int kRM>
cudaError_t launch(const Args& a, dim3 grid, int threads, int smem,
                   cudaStream_t stream) {
  auto kernel = fused_dw_kernel<kT, kL, kM, kRM>;
  // once per instantiation and device: all the dynamic shared memory a
  // block may have
  static std::atomic<bool> ready[sfc::kMaxDevices];
  const cudaError_t set = sfc::once_per_device(ready, [kernel] {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  });
  if (set != cudaSuccess) return set;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// (t, L, M) at compile time for sfc6_6, sfc6_7 and sfc4_4, with the rows
// per thread of the splits the wrapper takes (DW_SPLITS: 1, 2, 3, 5, 10)
template <int kT, int kL, int kM>
cudaError_t launch_splits(const Args& a, dim3 grid, int threads, int smem,
                          cudaStream_t s) {
  const int g = a.splits < kM ? a.splits : kM;
  const int rm = (kM + g - 1) / g;
  if (rm == kM) return launch<kT, kL, kM, kM>(a, grid, threads, smem, s);
  if (rm == (kM + 1) / 2)
    return launch<kT, kL, kM, (kM + 1) / 2>(a, grid, threads, smem, s);
  if (rm == (kM + 2) / 3)
    return launch<kT, kL, kM, (kM + 2) / 3>(a, grid, threads, smem, s);
  if (rm == 2) return launch<kT, kL, kM, 2>(a, grid, threads, smem, s);
  if (rm == 1) return launch<kT, kL, kM, 1>(a, grid, threads, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// The geometry (tiles, cb, splits, threads, smem, grid) is the wrapper's
// DepthwiseGeometry; this checks it and launches.
extern "C" int sfc_fused_conv2d_depthwise_launch(
    const void* x, const void* wq, const void* act_scale, const void* w_scale,
    const float* bt, const float* at, void* out, int B, int H, int W, int C,
    int M, int L, int t, int lo_h, int lo_w, int nH, int nW, int out_h,
    int out_w, int tiles, int cb, int splits, int threads, int smem,
    int grid_x, int grid_y, float qmax, void* stream) {
  if ((long long)B * nH * nW == 0 || C == 0) return 0;
  Args a;
  a.x = (const float*)x;
  a.wq = (const int8_t*)wq;
  a.s_g = (const float*)act_scale;
  a.sw_g = (const float*)w_scale;
  for (int i = 0; i < t * L && i < sfc::kMaxT * sfc::kMaxL; ++i)
    a.bt[i] = bt[i];
  for (int i = 0; i < M * t && i < sfc::kMaxM * sfc::kMaxT; ++i)
    a.at[i] = at[i];
  a.out = (float*)out;
  a.H = H; a.W = W; a.C = C; a.M = M; a.L = L; a.t = t;
  a.lo_h = lo_h; a.lo_w = lo_w; a.nH = nH; a.nW = nW;
  a.out_h = out_h; a.out_w = out_w;
  a.tiles = tiles; a.cb = cb; a.splits = splits;
  a.runs = tiles > 0 ? (nW + tiles - 1) / tiles : 0;
  a.qmax = qmax;
  // the checks: the same geometry as DepthwiseGeometry, or refuse the
  // launch
  const long long P = (long long)t * t;
  const long long region_w = (long long)M * (tiles - 1) + L;
  const long long need = 128 + sfc::align128(4 * L * region_w * cb) +
                         sfc::align128(4 * P * cb) + sfc::align128(P * cb) +
                         sfc::align128(4 * P * tiles * cb);
  const int per_block = splits * tiles * cb;
  const bool ok =
      tiles >= 1 && cb >= 1 && splits >= 1 && splits <= kMaxSplits &&
      threads == (per_block + 31) / 32 * 32 && threads <= kMaxThreads &&
      smem == need && smem <= kMaxSmem &&
      (long long)grid_x == (long long)B * nH * a.runs &&
      grid_y == (C + cb - 1) / cb && t <= sfc::kMaxT && L <= sfc::kMaxL &&
      M <= sfc::kMaxM && region_w <= 256;
  if (!ok) return (int)cudaErrorInvalidValue;
  // the copies, by the shape alone: TMA where the tensors allow its boxes
  // (rows of a box a multiple of 16 bytes, bases on 16), plain loads
  // otherwise (1.3-1.8x slower at MobileNetV2's layers on an H100:
  // tools/variants.py b7-loaders); a map that cannot be encoded refuses
  // the launch
  a.tma = C % 16 == 0 && cb % 16 == 0 && cb <= 256 &&
          (uintptr_t)x % 16 == 0 && (uintptr_t)wq % 16 == 0 &&
          (uintptr_t)w_scale % 16 == 0;
  if (a.tma) {
    // wq and w_scale (P, C) as (C, P), boxes (cb, P)
    const cuuint64_t pdims[2] = {(cuuint64_t)C, (cuuint64_t)P};
    const cuuint64_t wstride[1] = {(cuuint64_t)C};
    const cuuint64_t sstride[1] = {4ull * C};
    const cuuint32_t pbox[2] = {(cuuint32_t)cb, (cuuint32_t)P};
    cudaError_t e = sfc::region_map(&a.tmap_x, x, B, H, W, C, cb,
                                    (int)region_w, L);
    if (e == cudaSuccess)
      e = sfc::encode(&a.tmap_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wq, pdims,
                      wstride, pbox);
    if (e == cudaSuccess)
      e = sfc::encode(&a.tmap_sw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, w_scale,
                      pdims, sstride, pbox);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y, 1);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (t == 10 && L == 8 && M == 6)
    err = launch_splits<10, 8, 6>(a, grid, threads, smem, s);   // sfc6_6
  else if (t == 12 && L == 9 && M == 7)
    err = launch_splits<12, 9, 7>(a, grid, threads, smem, s);   // sfc6_7
  else if (t == 7 && L == 6 && M == 4)
    err = launch_splits<7, 6, 4>(a, grid, threads, smem, s);    // sfc4_4
  else
    err = launch<0, 0, 0, 0>(a, grid, threads, smem, s);
  return (int)err;
}
