// B4: the whole int8 SFC convolution in one launch.
//
// Replaces src/repro/kernels/sfc_fused.py::_fused_kernel (wrapper
// sfc_fused_conv2d, depthwise=False).
//
// Computes y = A^T [ dequant( sum_c xq[c] * wq[c] ) ] A per output tile,
// where xq = clip(rint(B^T X B / s)) is the int8 transform of the input
// tile: the transform-domain tensor never goes to HBM.
//
// What bounds it on the H100: bytes at the VGG-16 shapes.  The kernel must
// read the f32 input and the int8 weights and write the f32 output; its
// int8 products (2 P T C_in C_out) stay below the tensor cores' share of
// that time except on the widest layers.  This simple version reads the
// weights with byte loads and runs its phases one after the other, so it
// is far from either bound; see PERF.md.
//
// Design.  The Pallas kernel leans on the TPU running its grid in order:
// it zeroes an accumulator at k == 0, fills a strip cache at j == 0 and
// chains DMA slots over the sequential step index.  CUDA blocks run in no
// order and share no scratch, so here each block owns one group of 16
// tiles (one mma M tile; tiles are numbered over (image, tile row, tile
// column), so a group may span rows and images) and one block of cb output
// channels, and loops over the C_in blocks itself:
//   1. for each kb-wide C_in block, the threads transform and quantize
//      (tile, channel, transform row) items straight from the unpadded
//      NHWC input into xq[p][tile][k] in shared memory
//      (sfc::transform_quantize_row, the staged B1's arithmetic);
//   2. each warp takes positions p = warp, warp + 32, ... and adds
//      xq[p] (16 x kb) @ wq[p] (kb x cb) into the int32 accumulator
//      acc[p][tile][n] in shared memory with mma.m16n8k32;
// The C_out blocks of one tile group need the same xq, which the TPU
// kernel computes once and caches across its in-order C_out steps.  Here
// up to 8 of them form a thread block cluster: in step 1 each block
// transforms only the tiles col = rank (mod cluster size), and in step 2
// it reads the other tiles' rows from its neighbours' shared memory
// (distributed shared memory), with a cluster barrier on either side.
//   3. after the last C_in block the threads dequantize and invert
//      (tile, channel, output row) items (sfc::dequant, sfc::inverse_row,
//      the staged B2 epilogue and B3's arithmetic) and write NHWC output.
// The shared memory allows one block per SM, so the block has 1024
// threads: every phase is a chain of dependent loads and FMAs per thread,
// and 32 warps per SM are what hides their latency.
// Dynamic shared memory holds acc (4 P 16 cb bytes) and xq (P 16 kb bytes):
// 150 KB for sfc6_6 at kb = 32, cb = 16, and 216 KB for sfc6_7 (P = 144).
// Padded tiles, channels >= C_in and outputs >= C_out are masked: their
// xq and weights load as zero and contribute nothing.
#include <cooperative_groups.h>

#include "sfc_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCols = 16;      // tiles per block: the mma M dimension
constexpr int kThreads = 1024;  // 32 warps: the SM's one block

__global__ void __launch_bounds__(kThreads, 1) fused_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ wq,
    const float* __restrict__ s_g, const float* __restrict__ sw,
    const float* __restrict__ bt_g, const float* __restrict__ at_g,
    float* __restrict__ out, int H, int W, int Cin, int Cout, int M, int L,
    int t, int lo_h, int lo_w, int nH, int nW, long long n_tiles, int out_h,
    int out_w, int kb, int cb, float qmax) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float bt[sfc::kMaxT * sfc::kMaxL];
  __shared__ float at[sfc::kMaxM * sfc::kMaxT];
  __shared__ float s[sfc::kMaxT * sfc::kMaxT];

  const int P = t * t;
  int* acc = reinterpret_cast<int*>(smem);          // [P][kCols][cb]
  int8_t* xq = reinterpret_cast<int8_t*>(acc + P * kCols * cb);  // [P][kCols][kb]

  const int tid = threadIdx.x;
  for (int i = tid; i < t * L; i += kThreads) bt[i] = bt_g[i];
  for (int i = tid; i < M * t; i += kThreads) at[i] = at_g[i];
  for (int i = tid; i < P; i += kThreads) s[i] = s_g[i];
  for (int i = tid; i < P * kCols * cb; i += kThreads) acc[i] = 0;
  __syncthreads();

  const long long tile0 = (long long)blockIdx.x * kCols;
  const int n0 = blockIdx.y * cb;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, c4 = lane & 3;
  // the blocks of a cluster share the tile group (same blockIdx.x)
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();

  for (int k0 = 0; k0 < Cin; k0 += kb) {
    // 1. transform + quantize this block's tiles of the C_in block
    for (int item = tid; item < kCols / n_ranks * t * kb; item += kThreads) {
      const int kk = item % kb, u = (item / kb) % t;
      const int col = rank + n_ranks * (item / (kb * t));
      const long long n = tile0 + col;
      const int c = k0 + kk;
      int8_t* dst = xq + (u * t * kCols + col) * kb + kk;
      auto store = [&](int v, int8_t q) { dst[v * kCols * kb] = q; };
      if (n < n_tiles && c < Cin) {
        const int tw = (int)(n % nW);
        const int th = (int)((n / nW) % nH);
        const long long b = n / ((long long)nW * nH);
        const float* xb = x + b * H * W * Cin + c;
        const int h0 = th * M - lo_h, w0 = tw * M - lo_w;
        auto load = [&](int i, int j) -> float {
          const int hh = h0 + i, ww = w0 + j;
          return (hh >= 0 && hh < H && ww >= 0 && ww < W)
                     ? __ldg(xb + ((long long)hh * W + ww) * Cin)
                     : 0.f;
        };
        sfc::transform_quantize_row(load, bt, s, t, L, qmax, u, store);
      } else {
        for (int v = 0; v < t; ++v) store(v, 0);
      }
    }
    cluster.sync();

    // 2. acc[p] += xq[p] @ wq[p, k0:k0+kb, n0:n0+cb] on the tensor cores
    for (int p = warp; p < P; p += kThreads / 32) {
      // rows g and g + 8 of xq[p] live in the block of rank g mod n_ranks
      const int8_t* xp = cluster.map_shared_rank(xq + p * kCols * kb,
                                                 (unsigned)(g % n_ranks));
      const int8_t* wp = wq + (long long)p * Cin * Cout;
      int* ap = acc + p * kCols * cb;
      for (int nt = 0; nt < cb / 8; ++nt) {
        int d[4];
        d[0] = ap[g * cb + nt * 8 + c4 * 2];
        d[1] = ap[g * cb + nt * 8 + c4 * 2 + 1];
        d[2] = ap[(g + 8) * cb + nt * 8 + c4 * 2];
        d[3] = ap[(g + 8) * cb + nt * 8 + c4 * 2 + 1];
        const int n = n0 + nt * 8 + g;
        for (int ks = 0; ks < kb; ks += 32) {
          uint32_t a[4], b[2];
          a[0] = *reinterpret_cast<const uint32_t*>(xp + g * kb + ks + c4 * 4);
          a[1] = *reinterpret_cast<const uint32_t*>(xp + (g + 8) * kb + ks + c4 * 4);
          a[2] = *reinterpret_cast<const uint32_t*>(xp + g * kb + ks + 16 + c4 * 4);
          a[3] = *reinterpret_cast<const uint32_t*>(xp + (g + 8) * kb + ks + 16 + c4 * 4);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            uint32_t packed = 0;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int k = k0 + ks + half * 16 + c4 * 4 + i;
              const int8_t v = (k < Cin && n < Cout)
                                   ? wp[(long long)k * Cout + n]
                                   : (int8_t)0;
              packed |= (uint32_t)(uint8_t)v << (8 * i);
            }
            b[half] = packed;
          }
          sfc::mma_s8_16832(d, a, b);
        }
        ap[g * cb + nt * 8 + c4 * 2] = d[0];
        ap[g * cb + nt * 8 + c4 * 2 + 1] = d[1];
        ap[(g + 8) * cb + nt * 8 + c4 * 2] = d[2];
        ap[(g + 8) * cb + nt * 8 + c4 * 2 + 1] = d[3];
      }
    }
    cluster.sync();  // every block's reads of xq are done
  }

  // 3. dequant + inverse, written as NHWC output
  for (int item = tid; item < kCols * M * cb; item += kThreads) {
    const int nn = item % cb, m = (item / cb) % M, col = item / (cb * M);
    const long long n = tile0 + col;
    const int o = n0 + nn;
    if (n >= n_tiles || o >= Cout) continue;
    const int tw = (int)(n % nW);
    const int th = (int)((n / nW) % nH);
    const long long b = n / ((long long)nW * nH);
    const int* ap = acc + col * cb + nn;
    auto load = [&](int u, int v) -> float {
      const int p = u * t + v;
      return sfc::dequant(ap[p * kCols * cb], s[p], sw[(long long)p * Cout + o]);
    };
    const int hh = th * M + m;
    float* ob = out + ((b * out_h + hh) * out_w + (long long)tw * M) * Cout + o;
    auto store = [&](int q, float val) {
      if (hh < out_h && tw * M + q < out_w) ob[(long long)q * Cout] = val;
    };
    sfc::inverse_row(load, at, t, M, m, store);
  }
}

}  // namespace

extern "C" int sfc_fused_conv2d_launch(
    const void* x, const void* wq, const void* act_scale, const void* w_scale,
    const void* bt, const void* at, void* out, int B, int H, int W, int Cin,
    int Cout, int M, int L, int t, int lo_h, int lo_w, int nH, int nW,
    int out_h, int out_w, int kb, int cb, float qmax, void* stream) {
  const long long n_tiles = (long long)B * nH * nW;
  if (n_tiles == 0 || Cout == 0) return 0;
  const int smem = t * t * kCols * (4 * cb + kb);  // acc + xq
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n_tiles + kCols - 1) / kCols),
                  (unsigned)((Cout + cb - 1) / cb));
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  config.attrs = attr;
  config.numAttrs = 1;
  // the largest cluster (8, 4, 2 or 1 C_out blocks) that divides the grid
  // and that the card can place
  int size = 8;
  for (; size > 1; size /= 2) {
    if (grid.y % size) continue;
    attr[0].val.clusterDim.y = size;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, fused_kernel, &config) ==
            cudaSuccess &&
        clusters > 0)
      break;
    cudaGetLastError();  // a refused size is not an error of the launch
  }
  attr[0].val.clusterDim.y = size;
  err = cudaLaunchKernelEx(
      &config, fused_kernel, (const float*)x, (const int8_t*)wq,
      (const float*)act_scale, (const float*)w_scale, (const float*)bt,
      (const float*)at, (float*)out, H, W, Cin, Cout, M, L, t, lo_h, lo_w, nH,
      nW, n_tiles, out_h, out_w, kb, cb, qmax);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
