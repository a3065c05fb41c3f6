// B4: the whole int8 SFC convolution in one launch.
//
// Replaces src/repro/kernels/sfc_fused.py::_fused_kernel (wrapper
// sfc_fused_conv2d, depthwise=False).
//
// Computes y = A^T [ dequant( sum_c xq[c] * wq[c] ) ] A per output tile,
// where xq = clip(rint(B^T X B / s)) is the int8 transform of the input
// tile: the transform-domain tensor never goes to device memory.
//
// What bounds it on the H100: bytes.  It must read the f32 input and the
// int8 weights (t^2 C_in C_out bytes, 26 MB at VGG-16's 512-channel
// layers) and write the f32 output; its int8 products need a third of
// that time.  What bounds this version is latency: a block holds an SM
// (the int32 fragments of all t^2 positions fill half of the 128
// registers a thread may have, the weight ring, xq and input strip most
// of its shared memory), and each C_in stage is a chain of phases
// (transform, exchange with the cluster, products, cluster barrier) whose
// latencies nothing else on the SM hides (PERF.md).  Nothing may spill:
// the fragments and the addresses the products need fit in registers.
//
// Design.  The geometry comes from the wrapper (kernels/sfc_fused.py,
// FusedGeometry), which picks it per layer; this file only checks it.  A
// block owns one group of 16 tiles (one mma M tile; tiles are numbered
// over (image, tile row, tile column), so a group may span rows and
// images), cb = 8 or 16 output channels, all t^2 positions and a
// k_slice-wide slice of C_in.  A thread block cluster joins n_share C_out
// blocks of one tile group, which share its transform, times k_split C_in
// slices.  Per kb-wide C_in stage each block
//   1. has its tiles' L x L input patches (tiles col = rank mod n_share)
//      and the stage's weights wq[:, k0:k0+kb, n0:n0+cb] brought into
//      shared memory, a ring of two weight stages, issued a stage ahead:
//      by TMA (cp.async.bulk.tensor: one box per patch, one for the
//      weights, zero-filled outside the image and past C_in and C_out,
//      completing on mbarriers) where the shape allows it (C_in a
//      multiple of 4 for the input; C_out a multiple of 16 and cb = 16 for
//      the weights), by cp.async copies otherwise (measured slower on
//      every VGG-16 layer, PERF.md);
//   2. transforms and quantizes its tiles' (tile, channel, u) rows into
//      its region of xq (sfc::transform_quantize_row, the staged B1's
//      arithmetic), then copies that region with one bulk copy per peer
//      (cp.async.bulk shared::cta -> shared::cluster) into the xq of the
//      other C_out blocks of its cluster, completing on their mbarriers;
//   3. adds each warp's (position, 8-channel) pairs with mma.m16n8k32 into
//      int32 fragments held in registers, reading xq (blocked by C_out
//      rank, padded and half-swapped per xq_pad / xq_swap: conflict-free A
//      fragments) and the weights from its own shared memory.  At cb = 16
//      one ldmatrix.trans of a position's 32 x 16 weight bytes gives, after
//      two byte permutes, the B fragments of both n-tiles: the even
//      channels and the odd ones, with the mma's k in the order k_slot
//      gives (xq is stored in that order, so the int32 sums are the same);
//      at cb = 8 each B fragment is gathered by byte loads.
// The next stage's weights are issued as soon as the products that read
// their ring slot are done (the stage's first barrier), so they land
// while it transforms.  A split cluster barrier (arrive after the
// products, wait after the next stage's transform, before its rows go to
// the peers) keeps every peer's xq from being overwritten while it is
// read, and lets the transform overlap the slowest peer's products.
// After the last stage a block with the whole of C_in dequantizes its fragments (sfc::dequant, B2's
// epilogue) into f32 Y in shared memory; with several C_in slices the
// blocks exchange int32 partial sums over distributed shared memory and
// each finishes cb / k_split channels.  Then (tile, channel, output row)
// items run the inverse (sfc::inverse_row, B3's arithmetic) and write NHWC
// output.  The int32 sums are exact and the f32 epilogue is B2's and B3's,
// value for value and in their order, so the output is bit-identical to
// the staged datapath at every geometry (chip_smoke.py asserts it).
// The kernel is compiled for each count of pairs with (t, L, M) at run
// time, and with the (t, L, M) of sfc6_6, sfc6_7 and sfc4_4 at compile time
// for the counts of pairs FusedGeometry gives them, which unrolls the
// transform and inverse loops (1.4x faster over VGG-16, PERF.md).
#include <cooperative_groups.h>
#include <cuda.h>

#include "sfc_common.cuh"
#include "sfc_tma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTiles = 16;      // tiles per block: the mma M dimension
constexpr int kThreads = 512;   // 16 warps, up to 128 registers each
constexpr int kWarps = kThreads / 32;
// dynamic shared memory a block may have: the H100's 232448 bytes less
// this kernel's static arrays (FusedGeometry's B4_STATIC_SMEM_BYTES)
constexpr int kMaxSmem = 232448 - 4096;

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

struct Args {
  CUtensorMap tmap_x;  // x (C_in, W, H, B) f32, box (kb, L, L, 1)
  CUtensorMap tmap_w;  // wq (C_out, C_in, t^2) int8, box (cb, kb, t^2)
  const float* x;
  const int8_t* wq;
  const float* s_g;
  const float* sw_g;
  const float* bt_g;
  const float* at_g;
  float* out;
  int H, W, Cin, Cout, M, L, t, lo_h, lo_w, nH, nW, out_h, out_w;
  long long n_tiles;
  int cb, kb, strip_bufs, n_share, k_split, k_slice;
  int vec_w;  // weights by TMA (kTma), by 8-byte cp.async (8), or bytes
  int vec_x;  // input by TMA (kTma) or by 4-byte cp.async (0)
  float qmax;
};

constexpr int kTma = 17;
constexpr int kStages = 2;  // the weight ring

using sfc::align128;
using sfc::cp_async16;
using sfc::cp_async_commit;
using sfc::cp_async_wait_all;
using sfc::encode;
using sfc::k_slot;
using sfc::ldsm_x4_trans;
using sfc::mbar_expect;
using sfc::mbar_init;
using sfc::mbar_wait;
using sfc::slot_k;
using sfc::smem_u32;
using sfc::tma_load_3d;
using sfc::tma_load_4d;

// xq is blocked by the C_out rank that quantized the rows: rank o's tiles
// col = o + n_share c at xq + o * xq_region, row (position p, tile c) at
// (p * tiles / n_share + c) * kb.  The region is padded (xq_pad) and, for
// n_share 1 and 4, the two 16-byte halves of some rows swapped, so the 8
// rows of an A fragment load hit 32 distinct banks (at kb = 32).
__host__ __device__ constexpr int xq_pad(int n_share) {
  return n_share == 1 ? 0 : n_share == 4 ? 32 : 16;
}

__device__ __forceinline__ int xq_swap(int n_share, int c) {
  return n_share == 1 ? (c & 4) << 2 : n_share == 4 ? (c & 1) << 4 : 0;
}

// the shared::cluster address of `addr` (shared::cta) in block `rank`
__device__ __forceinline__ unsigned mapa(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// `bytes` of this block's shared memory into a cluster peer's, completing
// on the peer's mbarrier
__device__ __forceinline__ void dsmem_copy(unsigned dst_cluster,
                                           const void* src, unsigned bytes,
                                           unsigned bar_cluster) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
      "bytes [%0], [%1], %2, [%3];\n" ::"r"(dst_cluster),
      "r"(smem_u32(src)), "r"(bytes), "r"(bar_cluster)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Dynamic shared memory of one block (the same layout as FusedGeometry;
// each region starts on 128 bytes):
//   sw    f32  [P][cb]                  weight scales of its channels
//   ring  int8 [2][P][kb][cb]           weight stages
//   xq    int8 [n_share][P][16 / n_share][kb] + pads: the stage's
//                                       quantized tiles, all 16 (each C_out
//                                       rank copies its own into every
//                                       rank's xq)
//   strip f32  [tiles / n_share][L][L][kb]      its tiles' input patches
// After the C_in loop the f32 Y [P][16][cb / k_split] (k_split == 1) or
// the int32 partial sums [P][16][cb] followed by Y take the place of the
// ring and what follows.
// kT, kL, kM: the algorithm's t, L, M at compile time (0: at run time).
template <int kPairs, int kT, int kL, int kM>
__global__ void __launch_bounds__(kThreads, 1)
    fused_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float bt[sfc::kMaxT * sfc::kMaxL];
  __shared__ float at[sfc::kMaxM * sfc::kMaxT];
  __shared__ float sx[sfc::kMaxT * sfc::kMaxT];
  __shared__ long long tile_img[kTiles];   // image of each tile
  __shared__ int tile_h[kTiles], tile_w[kTiles];  // tile row, column
  // completions: TMA strips and weights, the peers' xq rows
  __shared__ __align__(8) uint64_t bar_x[2], bar_w[kStages], bar_q;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = kT ? kT : a.t, L = kL ? kL : a.L, M = kM ? kM : a.M;
  const int Cin = a.Cin, Cout = a.Cout;
  const int P = t * t;
  const int cb = a.cb, kb = a.kb, S_n = a.n_share, S_k = a.k_split;
  const int nr = rank % S_n, kr = rank / S_n;  // C_out and C_in rank
  const int TL = kTiles / S_n;               // tiles this block transforms
  const int n0 = ((blockIdx.x / (S_n * S_k)) * S_n + nr) * cb;
  const long long tile0 = (long long)blockIdx.y * kTiles;
  const int real_tiles = (int)min((long long)kTiles, a.n_tiles - tile0);
  const int own_tiles = max(0, (real_tiles - nr + S_n - 1) / S_n);
  const int NT = cb / 8;                     // mma n-tiles per block
  // kb, cb and n_share are powers of two (the wrapper checks): shifts
  const int kb_shift = __ffs(kb) - 1, nt_shift = __ffs(NT) - 1;
  const int kbase = kr * a.k_slice;          // this block's C_in slice
  const int n_stages = a.k_slice / kb;

  unsigned char* smem =
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  float* swl = reinterpret_cast<float*>(smem);
  int8_t* ws = reinterpret_cast<int8_t*>(smem + align128(4LL * P * cb));
  const int w_stage = (int)align128((long long)P * kb * cb);
  int8_t* xq = ws + kStages * w_stage;
  const int xq_own = P * TL * kb;            // one rank's rows
  const int xq_region = xq_own + xq_pad(S_n);
  float* strip0 = reinterpret_cast<float*>(
      xq + align128((long long)S_n * xq_region));
  const int strip_floats = TL * L * L * kb;  // one buffer of the strip
  const int bufs = a.strip_bufs;
  const int cbk = cb / S_k;                  // channels this block finishes
  int* partial = reinterpret_cast<int*>(ws);                  // [P][16][cb]
  float* Y = S_k == 1 ? reinterpret_cast<float*>(ws)
                      : reinterpret_cast<float*>(partial + P * kTiles * cb);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, c4 = lane & 3;
  if (tid == 0) {  // the TMA descriptors, fetched while the prologue runs
    if (a.vec_x == kTma)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&a.tmap_x) : "memory");
    if (a.vec_w == kTma)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&a.tmap_w) : "memory");
  }
  for (int i = tid; i < t * L; i += kThreads) bt[i] = a.bt_g[i];
  for (int i = tid; i < M * t; i += kThreads) at[i] = a.at_g[i];
  for (int i = tid; i < P; i += kThreads) sx[i] = a.s_g[i];
  if (Cout % 4 == 0 && (uintptr_t)a.sw_g % 16 == 0) {
    // 4 scales a copy, in the first copy group (waited before the epilogue)
    for (int i = tid; i < P * cb / 4; i += kThreads) {
      const int p = (4 * i) >> nt_shift >> 3, nn = (4 * i) & (cb - 1);
      const bool ok = n0 + nn < Cout;
      cp_async16(swl + 4 * i,
                 ok ? a.sw_g + (long long)p * Cout + n0 + nn : a.sw_g,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < P * cb; i += kThreads) {
      const int p = i >> nt_shift >> 3, nn = i & (cb - 1);
      swl[i] = n0 + nn < Cout ? a.sw_g[(long long)p * Cout + n0 + nn] : 0.f;
    }
  }
  if (tid < real_tiles) {
    const long long n = tile0 + tid;
    tile_w[tid] = (int)(n % a.nW);
    tile_h[tid] = (int)((n / a.nW) % a.nH);
    tile_img[tid] = n / ((long long)a.nW * a.nH);
  }
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) mbar_init(&bar_x[i], 1);
    for (int i = 0; i < kStages; ++i) mbar_init(&bar_w[i], 1);
    mbar_init(&bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every peer's bar_q is ready for this block's copies

  // the L x L input patches of this block's tiles (col = nr + n_share c)
  // for stage s's channels into strip buffer s % strip_bufs, zero outside
  // the image and past C_in: one TMA box per tile, or cp.async copies
  // (`per` threads share a pixel)
  auto stage_strip = [&](int s) {
    const int k0 = kbase + s * kb, kreal = min(kb, Cin - k0);
    if (kreal <= 0) return;
    float* strip = strip0 + (s % bufs) * strip_floats;
    if (a.vec_x == kTma) {
      if (tid == 0) {
        uint64_t* bar = &bar_x[s % bufs];
        mbar_expect(bar, (unsigned)(own_tiles * L * L * kb * 4));
        for (int c = 0; c < own_tiles; ++c) {
          const int col = nr + S_n * c;
          tma_load_4d(strip + c * L * L * kb, &a.tmap_x, bar, k0,
                      tile_w[col] * M - a.lo_w, tile_h[col] * M - a.lo_h,
                      (int)tile_img[col]);
        }
      }
      return;
    }
    int per = 1;                               // a power of two >= kreal
    while (per < kreal) per <<= 1;
    const int ch = tid & (per - 1);
    if (ch >= kreal) return;
    for (int q = tid / per; q < own_tiles * L * L; q += kThreads / per) {
      const int c = q / (L * L), ij = q - c * L * L;
      const int i = ij / L, j = ij - i * L, col = nr + S_n * c;
      const int hh = tile_h[col] * M - a.lo_h + i;
      const int ww = tile_w[col] * M - a.lo_w + j;
      const bool in = hh >= 0 && hh < a.H && ww >= 0 && ww < a.W;
      const float* src =
          in ? a.x + ((tile_img[col] * a.H + hh) * a.W + ww) * Cin + k0 + ch
             : a.x;
      cp_async4(strip + q * kb + ch, src, in ? 4 : 0);
    }
  };
  // weights of stage s into ring slot s % kStages, zero past C_in and
  // C_out: one TMA box, or cp.async copies
  auto stage_weights = [&](int s) {
    const int k0 = kbase + s * kb;
    if (k0 >= Cin) return;   // the ring slot is not read (no channels)
    int8_t* dst0 = ws + (s % kStages) * w_stage;
    if (a.vec_w == kTma) {
      if (tid == 0) {
        uint64_t* bar = &bar_w[s % kStages];
        mbar_expect(bar, (unsigned)(P * kb * cb));
        tma_load_3d(dst0, &a.tmap_w, bar, n0, k0, 0);
      }
    } else if (a.vec_w == 8) {  // NT threads per weight row, 8 bytes each
      const int j8 = tid & (NT - 1), n = n0 + j8 * 8;
      for (int r = tid >> nt_shift; r < P * kb; r += kThreads >> nt_shift) {
        const int p = r >> kb_shift, k = k0 + (r & (kb - 1));
        const bool ok = k < Cin && n < Cout;
        const int8_t* src =
            ok ? a.wq + ((long long)p * Cin + k) * Cout + n : a.wq;
        cp_async8(dst0 + r * cb + j8 * 8, src, ok ? 8 : 0);
      }
    } else {
      for (int e = tid; e < P * kb * cb; e += kThreads) {
        const int nn = e & (cb - 1), r = e >> nt_shift >> 3;
        const int p = r >> kb_shift, k = k0 + (r & (kb - 1)), n = n0 + nn;
        dst0[r * cb + nn] =
            (k < Cin && n < Cout)
                ? a.wq[((long long)p * Cin + k) * Cout + n]
                : (int8_t)0;
      }
    }
  };

  int acc[kPairs][4];
#pragma unroll
  for (int q = 0; q < kPairs; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[q][r] = 0;

  // the cp.async copies (the scales, the weights of stage 0 and the strips
  // of stages 0 .. strip_bufs-1, then per stage s the strip of
  // s + strip_bufs and the weights of s + 1) are waited for all at once;
  // the TMA copies complete on bar_x[buffer] and bar_w[slot]
  if (n_stages > 0) stage_weights(0);
  for (int s = 0; s < bufs && s < n_stages; ++s) stage_strip(s);
  cp_async_commit();
  const bool pair_ldsm = NT == 2;  // B fragments of two n-tiles a load

  // the A rows of lane group g: tiles g and g + 8 of the group
  const int8_t* xq_g =
      xq + (g & (S_n - 1)) * xq_region + (g / S_n) * kb;
  const int8_t* xq_g8 =
      xq + ((g + 8) & (S_n - 1)) * xq_region + ((g + 8) / S_n) * kb;
  const int swap_g = xq_swap(S_n, g / S_n);
  for (int s = 0; s < n_stages; ++s) {
    const int k0 = kbase + s * kb, kreal = min(kb, Cin - k0);
    // the strip of s and the weights of s have landed, and every warp of
    // the block is done with the products of s - 1
    cp_async_wait_all();
    if (kreal > 0) {
      if (a.vec_x == kTma) mbar_wait(&bar_x[s % bufs], (s / bufs) & 1);
      if (a.vec_w == kTma)
        mbar_wait(&bar_w[s % kStages], (s / kStages) & 1);
    }
    __syncthreads();
    // ring slot (s + 1) % 2 is free: its products (stage s - 1) are done
    if (s + 1 < n_stages) stage_weights(s + 1);
    cp_async_commit();
    // 1. transform + quantize this stage's channels of the block's tiles
    //    into its xq, channels fastest: a warp reads 32 neighbouring
    //    floats of a pixel and writes 32 neighbouring bytes
    const int items = kreal > 0 ? own_tiles * t * kreal : 0;
    for (int item = tid; item < items; item += kThreads) {
      int kk, rest;
      if (kreal == kb) { kk = item & (kb - 1); rest = item >> kb_shift; }
      else { kk = item % kreal; rest = item / kreal; }
      const int u = rest / own_tiles, c = rest - u * own_tiles;
      const float* xs = strip0 + (s % bufs) * strip_floats + c * L * L * kb + kk;
      auto load = [&](int i, int j) -> float { return xs[(i * L + j) * kb]; };
      int8_t* dst = xq + nr * xq_region + (u * t * TL + c) * kb +
                    (k_slot(kk) ^ xq_swap(S_n, c));
      sfc::transform_quantize_row(
          load, bt, sx, t, L, a.qmax, u,
          [&](int v, int8_t q) { dst[v * TL * kb] = q; });
    }
    // its xq rows are complete (and visible to the copy engine); the
    // strip buffer of s is free
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (s + bufs < n_stages) stage_strip(s + bufs);
    cp_async_commit();
    if (s > 0) cluster_wait();  // every peer is done reading xq of s - 1
    // its rows into the other C_out ranks' xq, one bulk copy each, and
    // theirs into its own
    if (S_n > 1 && kreal > 0) {
      if (tid < S_n - 1) {
        const unsigned peer = (unsigned)(kr * S_n + (tid < nr ? tid : tid + 1));
        const unsigned own = smem_u32(xq + nr * xq_region);
        dsmem_copy(mapa(own, peer), xq + nr * xq_region, (unsigned)xq_own,
                   mapa(smem_u32(&bar_q), peer));
      }
      if (tid == 0) mbar_expect(&bar_q, (unsigned)((S_n - 1) * xq_own));
      mbar_wait(&bar_q, s & 1);  // every C_out rank's tiles are in xq
    }

    // 2. acc[pair] += xq[p] @ wq[p, k0:k0+kb, n-tile] on the tensor cores;
    //    straight-line code over the warp's pairs, two at a time (a pair
    //    past the last position loads position P - 1 and skips its
    //    product), so the loads of all pairs can be in flight together.
    //    At cb = 16 the pairs 2i, 2i + 1 are one position's even and odd
    //    channels, and one ldmatrix gives both their B fragments.
    if (kreal > 0) {
      const int8_t* wst = ws + (s % kStages) * w_stage;
      // a position's rows in xq, opaque to the compiler, so it computes
      // the A addresses here and does not keep them across the C_in loop
      // (kept, they spill: 4 local loads per mma)
      int xq_row = TL * kb;
      asm volatile("" : "+r"(xq_row));
      // the A fragment of position p, k slots ks .. ks + 31; rows g and
      // g + 8 share their swap (xq_swap)
      auto a_frag = [&](int p, int ks, uint32_t af[4]) {
        const int8_t* xg = xq_g + p * xq_row;    // tile g's row
        const int8_t* xg8 = xq_g8 + p * xq_row;  // tile g + 8's row
        const int lo = (ks + c4 * 4) ^ swap_g, hi = (ks + 16 + c4 * 4) ^ swap_g;
        af[0] = *reinterpret_cast<const uint32_t*>(xg + lo);
        af[1] = *reinterpret_cast<const uint32_t*>(xg8 + lo);
        af[2] = *reinterpret_cast<const uint32_t*>(xg + hi);
        af[3] = *reinterpret_cast<const uint32_t*>(xg8 + hi);
      };
#pragma unroll
      for (int q = 0; q < kPairs; q += 2) {
        if (pair_ldsm) {
          const int pos = (warp * kPairs + q) >> 1;
          const int p = min(pos, P - 1);
#pragma unroll
          for (int ks = 0; ks < 64; ks += 32) {
            if (ks >= kreal) break;
            uint32_t af[4], r[4];
            a_frag(p, ks, af);
            // rows ks .. ks + 31 of position p's 16 channels: r[m] holds
            // channels 2g, 2g + 1 of rows ks + 8m + 2c4 and + 1
            ldsm_x4_trans(r, wst + (p * kb + ks + lane) * 16);
            const uint32_t be[2] = {__byte_perm(r[0], r[1], 0x6420),
                                    __byte_perm(r[2], r[3], 0x6420)};
            const uint32_t bo[2] = {__byte_perm(r[0], r[1], 0x7531),
                                    __byte_perm(r[2], r[3], 0x7531)};
            if (pos < P && n0 < Cout) sfc::mma_s8_16832(acc[q], af, be);
            if (pos < P && n0 + 1 < Cout)
              sfc::mma_s8_16832(acc[q + 1], af, bo);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int pos = warp * kPairs + q + j;   // one n-tile
            const int p = min(pos, P - 1);
            const int8_t* wp = wst + p * kb * 8 + g;
#pragma unroll
            for (int ks = 0; ks < 64; ks += 32) {
              if (ks >= kreal) break;
              uint32_t af[4], bf[2];
              a_frag(p, ks, af);
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                uint32_t packed = 0;
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  packed |= (uint32_t)(uint8_t)
                                wp[slot_k(ks + half * 16 + c4 * 4 + i) * 8]
                            << (8 * i);
                bf[half] = packed;
              }
              if (pos < P && n0 < Cout) sfc::mma_s8_16832(acc[q + j], af, bf);
            }
          }
        }
      }
    }
    cluster_arrive();  // done reading xq of stage s
  }
  cp_async_wait_all();
  cluster_wait();  // every block of the cluster is done with its C_in loop

  // 3. the epilogue.  One C_in slice: dequantize the fragments (B2's
  //    epilogue) into Y.  Several: int32 partial sums into shared memory,
  //    and each C_in rank sums cb / k_split of the channels over the ranks
  //    (exact in any order) and dequantizes them.  Then the inverse (B3's
  //    arithmetic) of the block's channels.
  const int nbase = kr * cbk;                // first channel it finishes
  if (S_k == 1) {
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const int pair = warp * kPairs + q;
      const int p = pair >> nt_shift, nt = pair & (NT - 1);
      if (p >= P) continue;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = g + (r >= 2 ? 8 : 0);
        const int nn = (c4 * 2 + (r & 1)) * NT + nt;  // see the products
        Y[(p * kTiles + col) * cb + nn] =
            sfc::dequant(acc[q][r], sx[p], swl[p * cb + nn]);
      }
    }
    __syncthreads();
  } else {
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const int pair = warp * kPairs + q;
      const int p = pair >> nt_shift, nt = pair & (NT - 1);
      if (p >= P) continue;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = g + (r >= 2 ? 8 : 0);
        const int nn = (c4 * 2 + (r & 1)) * NT + nt;
        partial[(p * kTiles + col) * cb + nn] = acc[q][r];
      }
    }
    cluster.sync();  // every C_in rank's partial sums are in place
    // every rank's loads are issued before the first is added: their
    // latencies overlap
    if (cbk % 2 || S_k > 8) {
      for (int e = tid; e < P * kTiles * cbk; e += kThreads) {
        const int j = e % cbk, pc = e / cbk, p = pc / kTiles;
        int v[16];
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (k < S_k)
            v[k] = cluster.map_shared_rank(partial, (unsigned)(k * S_n + nr))
                       [pc * cb + nbase + j];
        int sum = 0;
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (k < S_k) sum += v[k];
        Y[e] = sfc::dequant(sum, sx[p], swl[p * cb + nbase + j]);
      }
    } else if (cbk % 4) {  // 2 channels per step, one 8-byte load a rank
      const int duos = cbk / 2;
      for (int e = tid; e < P * kTiles * duos; e += kThreads) {
        const int j2 = e % duos, pc = e / duos, p = pc / kTiles;
        int2 v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (k < S_k)
            v[k] = *reinterpret_cast<const int2*>(
                cluster.map_shared_rank(partial, (unsigned)(k * S_n + nr)) +
                pc * cb + nbase + 2 * j2);
        int2 sum = make_int2(0, 0);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (k < S_k) { sum.x += v[k].x; sum.y += v[k].y; }
        const float* swp = swl + p * cb + nbase + 2 * j2;
        Y[pc * cbk + 2 * j2] = sfc::dequant(sum.x, sx[p], swp[0]);
        Y[pc * cbk + 2 * j2 + 1] = sfc::dequant(sum.y, sx[p], swp[1]);
      }
    } else {  // 4 channels per step as one 16-byte load from each rank
      const int quads = cbk / 4;
      for (int e = tid; e < P * kTiles * quads; e += kThreads) {
        const int j4 = e % quads, pc = e / quads, p = pc / kTiles;
        int4 v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (k < S_k)
            v[k] = *reinterpret_cast<const int4*>(
                cluster.map_shared_rank(partial, (unsigned)(k * S_n + nr)) +
                pc * cb + nbase + 4 * j4);
        int4 sum = make_int4(0, 0, 0, 0);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (k < S_k) {
            sum.x += v[k].x; sum.y += v[k].y; sum.z += v[k].z; sum.w += v[k].w;
          }
        const float* swp = swl + p * cb + nbase + 4 * j4;
        float* y = Y + pc * cbk + 4 * j4;
        y[0] = sfc::dequant(sum.x, sx[p], swp[0]);
        y[1] = sfc::dequant(sum.y, sx[p], swp[1]);
        y[2] = sfc::dequant(sum.z, sx[p], swp[2]);
        y[3] = sfc::dequant(sum.w, sx[p], swp[3]);
      }
    }
    cluster_arrive();  // done reading the other ranks' partial sums
    __syncthreads();
  }

  const int cbv = max(0, min(cbk, Cout - n0 - nbase));
  for (int it = tid; it < real_tiles * cbv * M; it += kThreads) {
    const int j = it % cbv, rest = it / cbv;
    const int m = rest % M, col = rest / M;
    const float* yc = Y + col * cbk + j;
    auto load = [&](int u, int v) -> float {
      return yc[(u * t + v) * kTiles * cbk];
    };
    const int tw = tile_w[col], hh = tile_h[col] * M + m;
    float* ob = a.out +
                ((tile_img[col] * a.out_h + hh) * a.out_w + (long long)tw * M) *
                    Cout +
                n0 + nbase + j;
    const int out_h = a.out_h, out_w = a.out_w;
    auto store = [&](int q, float val) {
      if (hh < out_h && tw * M + q < out_w) ob[(long long)q * Cout] = val;
    };
    sfc::inverse_row(load, at, t, M, m, store);
  }
  if (S_k > 1) cluster_wait();  // the other ranks are done with ours
}

template <int kPairs, int kT, int kL, int kM>
cudaError_t launch(const Args& a, dim3 grid, int smem, cudaStream_t stream) {
  auto kernel = fused_kernel<kPairs, kT, kL, kM>;
  // once per instantiation and device: all the dynamic shared memory a
  // block may have, and clusters of up to 16 blocks
  static std::atomic<bool> ready[sfc::kMaxDevices];
  const cudaError_t set = sfc::once_per_device(ready, [kernel] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  });
  if (set != cudaSuccess) return set;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int cluster = a.n_share * a.k_split;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = (size_t)smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, a);
}

// (t, L, M) at compile time for sfc6_6, sfc6_7 and sfc4_4 at the counts of
// pairs FusedGeometry gives them (cb = 16 and 8; sfc6_7 fits only cb = 8)
template <int kPairs>
cudaError_t launch_tile(const Args& a, dim3 grid, int smem,
                        cudaStream_t s) {
  if constexpr (kPairs == 16 || kPairs == 8)
    if (a.t == 10 && a.L == 8 && a.M == 6)
      return launch<kPairs, 10, 8, 6>(a, grid, smem, s);   // sfc6_6
  if constexpr (kPairs == 12)
    if (a.t == 12 && a.L == 9 && a.M == 7)
      return launch<kPairs, 12, 9, 7>(a, grid, smem, s);   // sfc6_7
  if constexpr (kPairs == 8 || kPairs == 4)
    if (a.t == 7 && a.L == 6 && a.M == 4)
      return launch<kPairs, 7, 6, 4>(a, grid, smem, s);    // sfc4_4
  return launch<kPairs, 0, 0, 0>(a, grid, smem, s);
}

}  // namespace

// The geometry (tiles, cb, kb, stages, strip_bufs, n_share, k_split,
// k_slice, pairs, threads, smem, grid) is the wrapper's FusedGeometry;
// this checks it and launches.
extern "C" int sfc_fused_conv2d_launch(
    const void* x, const void* wq, const void* act_scale, const void* w_scale,
    const void* bt, const void* at, void* out, int B, int H, int W, int Cin,
    int Cout, int M, int L, int t, int lo_h, int lo_w, int nH, int nW,
    int out_h, int out_w, int tiles, int cb, int kb, int stages,
    int strip_bufs, int n_share, int k_split, int k_slice, int pairs,
    int threads, int smem, int grid_x, int grid_y, float qmax,
    void* stream) {
  const long long n_tiles = (long long)B * nH * nW;
  if (n_tiles == 0 || Cout == 0) return 0;
  Args a;
  a.x = (const float*)x;
  a.wq = (const int8_t*)wq;
  a.s_g = (const float*)act_scale;
  a.sw_g = (const float*)w_scale;
  a.bt_g = (const float*)bt;
  a.at_g = (const float*)at;
  a.out = (float*)out;
  a.H = H; a.W = W; a.Cin = Cin; a.Cout = Cout; a.M = M; a.L = L; a.t = t;
  a.lo_h = lo_h; a.lo_w = lo_w; a.nH = nH; a.nW = nW;
  a.out_h = out_h; a.out_w = out_w; a.n_tiles = n_tiles;
  a.cb = cb; a.kb = kb; a.strip_bufs = strip_bufs;
  a.n_share = n_share;
  a.k_split = k_split; a.k_slice = k_slice;
  a.qmax = qmax;
  // the checks: the same geometry as FusedGeometry, or refuse the launch
  const long long P = (long long)t * t;
  const int TL = kTiles / (n_share > 0 ? n_share : 1);
  const long long reused = kStages * align128(P * kb * cb) +
                           align128((long long)n_share *
                                    (P * kTiles / n_share * kb +
                                     xq_pad(n_share))) +
                           strip_bufs * align128(4LL * TL * L * L * kb);
  const long long ep = k_split > 1
                           ? 4 * P * kTiles * cb + 4 * P * kTiles * cb / k_split
                           : 4 * P * kTiles * cb;
  const long long need = 128 + align128(4 * P * cb) + reused;
  const int n_blocks = (Cout + cb - 1) / cb;
  const bool pow2 =
      (n_share & (n_share - 1)) == 0 && (k_split & (k_split - 1)) == 0;
  const bool ok =
      tiles == kTiles && threads == kThreads && pow2 &&
      (cb == 8 || cb == 16) && (kb == 32 || kb == 64) && stages == kStages &&
      (strip_bufs == 1 || strip_bufs == 2) &&
      n_share >= 1 && n_share <= 16 && k_split >= 1 &&
      n_share * k_split <= 16 && cb / k_split >= 1 &&
      k_slice % kb == 0 && (long long)k_slice * k_split >= Cin &&
      ep <= reused && smem == need && pairs % 2 == 0 &&
      pairs * kWarps >= P * (cb / 8) &&
      grid_x == (n_blocks + n_share - 1) / n_share * n_share * k_split &&
      (long long)grid_y * kTiles >= n_tiles &&
      (long long)(grid_y - 1) * kTiles < n_tiles && t <= sfc::kMaxT &&
      L <= sfc::kMaxL && M <= sfc::kMaxM;
  if (!ok) return (int)cudaErrorInvalidValue;
  // the copies, by the shape alone: TMA where the tensor allows its boxes
  // (a row of a box a multiple of 16 bytes, the base on 16), cp.async
  // copies otherwise; a map that cannot be encoded refuses the launch
  a.vec_x = 0;
  if (Cin % 4 == 0 && (uintptr_t)x % 16 == 0) {
    // x (B, H, W, C_in) as (C_in, W, H, B), boxes (kb, L, L, 1)
    const cuuint64_t dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W,
                                (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {4ull * Cin, 4ull * Cin * W,
                                   4ull * Cin * W * H};
    const cuuint32_t box[4] = {(cuuint32_t)kb, (cuuint32_t)L, (cuuint32_t)L,
                               1};
    const cudaError_t e = encode(&a.tmap_x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                 4, x, dims, strides, box);
    if (e != cudaSuccess) return (int)e;
    a.vec_x = kTma;
  }
  a.vec_w = (Cout % 8 == 0 && (uintptr_t)wq % 8 == 0) ? 8 : 0;
  if (Cout % 16 == 0 && (uintptr_t)wq % 16 == 0 && cb == 16) {
    // wq (t^2, C_in, C_out) as (C_out, C_in, t^2), boxes (cb, kb, t^2)
    const cuuint64_t dims[3] = {(cuuint64_t)Cout, (cuuint64_t)Cin,
                                (cuuint64_t)P};
    const cuuint64_t strides[2] = {(cuuint64_t)Cout,
                                   (cuuint64_t)Cout * Cin};
    const cuuint32_t box[3] = {(cuuint32_t)cb, (cuuint32_t)kb,
                               (cuuint32_t)P};
    const cudaError_t e = encode(&a.tmap_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                                 wq, dims, strides, box);
    if (e != cudaSuccess) return (int)e;
    a.vec_w = kTma;
  }
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y, 1);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (pairs) {
    case 4: err = launch_tile<4>(a, grid, smem, s); break;
    case 8: err = launch_tile<8>(a, grid, smem, s); break;
    case 12: err = launch_tile<12>(a, grid, smem, s); break;
    case 16: err = launch_tile<16>(a, grid, smem, s); break;
    case 20: err = launch_tile<20>(a, grid, smem, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
