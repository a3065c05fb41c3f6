// Copies by the Tensor Memory Accelerator, shared by the kernels that
// stage their input in shared memory (sfc_fused.cu, sfc_fused_dw.cu,
// sfc_transform.cu): mbarriers in shared memory, tiled tensor-map loads
// that complete on them, the host-side encoder of a tensor map (libcuda's
// cuTensorMapEncodeTiled, fetched through the runtime's entry-point query
// so the library needs no link to libcuda), and the copy of a run of
// tiles' input region that B1, B5 and B7 share.
//
// A box is zero-filled where it reaches outside the tensor (negative
// coordinates included), which is the SAME/VALID padding of an input patch
// and the tail past the last channel.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace sfc {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

// one thread: expect `bytes` more from the copies completing on `bar`
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(phase)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// bytes rounded up to the 128-byte alignment TMA destinations need
__host__ __device__ constexpr long long align128(long long n) {
  return (n + 127) / 128 * 128;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, or null where the CUDA installation lacks it
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      return (EncodeTiled) nullptr;
    }
    return (EncodeTiled)p;
  }();
  return fn;
}

// a tiled tensor map of `rank` dims (innermost first), zero out of bounds
inline cudaError_t encode(CUtensorMap* map, CUtensorMapDataType type,
                          int rank, const void* base, const cuuint64_t* dims,
                          const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled fn = encoder();
  if (!fn) return cudaErrorNotSupported;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), dims,
            strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// The input region of a run of tiles along one tile row, as B1, B5 and B7
// stage it: `rows` input rows x `width` pixels x cb channels of the NHWC
// f32 input x (B, H, W, C), from row h0, column w0 of image b and channel
// c0 on, into region[rows][width][cb] in shared memory, zero where it
// reaches outside the image (the SAME/VALID padding) and past C.
//
// By TMA: one thread calls region_tma_start, which initialises `bar` for
// one arrival expecting `bytes` (the region's, plus any copies the caller
// issues on `bar` after it) and issues the region's box; the block then
// waits on `bar` after a __syncthreads().  The map is region_map's.
__device__ __forceinline__ void region_tma_start(float* region,
                                                 const CUtensorMap* map,
                                                 uint64_t* bar,
                                                 unsigned bytes, int b,
                                                 int h0, int w0, int c0) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(map) : "memory");
  mbar_init(bar, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect(bar, bytes);
  tma_load_4d(region, map, bar, c0, w0, h0, b);
}

// The same region by plain loads, every thread of the block taking a share
// (where the shape rules TMA out); the caller synchronises after it.
__device__ __forceinline__ void region_load(float* region, const float* x,
                                            int H, int W, int C, int b,
                                            int h0, int w0, int c0, int rows,
                                            int width, int cb) {
  for (int i = threadIdx.x; i < rows * width * cb; i += blockDim.x) {
    const int cc = i % cb, px = i / cb;
    const int hh = h0 + px / width, ww = w0 + px % width;
    const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W && c0 + cc < C;
    region[i] = in ? __ldg(x + (((long long)b * H + hh) * W + ww) * C + c0 +
                           cc)
                   : 0.f;
  }
}

// Whether TMA can copy the region: rows of the box a multiple of 16 bytes
// (cb and C multiples of 4 floats), a box of at most 256 a dimension, the
// base on 16 bytes.
inline bool region_tma_ok(const void* x, int C, int cb, int width) {
  return C % 4 == 0 && cb % 4 == 0 && cb <= 256 && width <= 256 &&
         (uintptr_t)x % 16 == 0;
}

// The tensor map of the region's box: x (B, H, W, C) as (C, W, H, B), box
// (cb, width, rows, 1).
inline cudaError_t region_map(CUtensorMap* map, const void* x, int B, int H,
                              int W, int C, int cb, int width, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {4ull * C, 4ull * C * W, 4ull * C * W * H};
  const cuuint32_t box[4] = {(cuuint32_t)cb, (cuuint32_t)width,
                             (cuuint32_t)rows, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, dims, strides,
                box);
}

}  // namespace sfc
