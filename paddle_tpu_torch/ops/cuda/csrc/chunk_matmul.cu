// One ring chunk's matrix product for Hopper (sm_90a): K6.
//
// Replaces the TPU kernel of paddle_tpu/ops/pallas/collective_matmul.py:
//   chunk_matmul (body _mm_kernel)   -> chunk_mm_f32_kernel (float32)
//                                       chunk_mm_bf16_kernel (bfloat16)
//
//   out[M, N] = x[M, K] . w[K, N], summed in f32 and stored in the
//   operands' dtype.  x, w and out are row-major with leading dimensions
//   ldx, ldw and ldo (in elements): the column-parallel ring form writes
//   each chunk straight into its column block of the [M, N_total] output
//   (ldo = N_total), and the row-parallel form reads its slice of the
//   activations in place (ldx = the full width).
//
// Requirements (checked by the wrapper, ops/cuda/chunk_matmul.py): K a
// multiple of 32 and N of 128 (the gate asks K and N % 128), 16-byte
// aligned rows; any M >= 1 (rows past M are masked).
//
// The summation order of every output element is fixed and does not
// depend on N or on the column block the element lies in: at f32 one
// thread sums k = 0, 1, ..., K-1 by FMA into one register; at bf16 one
// wgmma accumulator takes the K steps of 16 in ascending order, on one
// instruction shape (m64n128k16).  No split-K.  So a chunk computed alone
// equals, bit for bit, the same columns of the product with the whole
// weight: the ring form of the column-parallel matmul is bitwise equal to
// gathering w first.
//
// f32 stays exact f32 on the CUDA cores (paddle_tpu asks the TPU for
// Precision.HIGHEST, so no TF32); bf16 runs on the tensor cores (wgmma,
// f32 accumulation).
//
// Bound on this card: operations.  The GPT 1b step's chunks (M 8192;
// K, N from 1792 and 7168) are 53-210 GFLOP each against 65-172 MB of
// operands and result at bf16, so at 989 TFLOP/s the products take
// 53-213 us and the bytes (3.35 TB/s) 19-51 us; at f32 (67 TFLOP/s) the
// products dominate by far more.
// What the design does about it:
//   * f32 (not on the main path): f32_tile.cuh's mainloop, one block of
//     256 threads a 128 x 128 tile, 8 x 8 outputs a thread;
//   * bf16: wgmma, the only way to the tensor cores' full rate on this
//     card, fed by TMA.  A persistent grid (one block an SM) walks the
//     128 x 128 output tiles; in each block one producer thread issues
//     the TMA loads of 64-deep x and w tiles (128-byte swizzle) into a
//     ring of 6 stages of shared memory (32 KB each), each guarded by a
//     full and an empty mbarrier, and two consumer warpgroups each own
//     64 rows of the tile (wgmma.mma_async m64n128k16, x K-major, w
//     MN-major through the transpose flag, f32 accumulators in
//     registers, one wgmma group kept in flight).  setmaxnreg moves
//     registers from the producer's warpgroup to the consumers.  The
//     producer runs ahead into the next tile while the consumers store
//     the last one: rounded to bf16 into a swizzled tile of shared
//     memory, then out by TMA stores that run on while the next tile is
//     multiplied.  TMA's out-of-bounds zero fill covers the rows past M
//     and a K that is not a multiple of 64 (each zero adds +0 to the
//     sum); its stores skip the rows past M.  The tensor maps are built
//     on the host for each launch from the pointers and ldx / ldw / ldo;
//     cuTensorMapEncodeTiled is looked up in libcuda at run time through
//     cudaGetDriverEntryPoint, so nothing links against libcuda.  The
//     mbarrier, TMA, wgmma and setmaxnreg plumbing lives in hopper.cuh,
//     shared with the flash attention kernels.

#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "f32_tile.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

// ------------------------------------------------------------------ f32
__global__ void __launch_bounds__(f32_tile::kThreads)
chunk_mm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, int M, int K, long long ldx,
                    long long ldw, long long ldo) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * f32_tile::kBM, n0 = blockIdx.x * f32_tile::kBN;
  float acc[8][8];
  f32_tile::mainloop(x, w, M, K, ldx, ldw, m0, n0, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + f32_tile::row_of(ty, i);
    if (row >= M) continue;
    float* o = out + (long long)row * ldo + n0;
    *reinterpret_cast<float4*>(o + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(o + 64 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// ----------------------------------------------------------------- bf16
constexpr int kTile = 128;                      // rows and columns of a tile
constexpr int kDepth = 64;                      // k of a stage (128 bytes)
constexpr int kStages = 6;
constexpr int kBytesA = kTile * kDepth * 2;     // x tile: 128 rows of 128 B
constexpr int kBytesB = kDepth * kTile * 2;     // w tile: two 64 x 64 boxes
constexpr int kStageBytes = kBytesA + kBytesB;
constexpr int kConsumers = 2;                   // warpgroups of wgmma
constexpr int kThreadsBf16 = 128 * (kConsumers + 1);
constexpr int kBytesC = 64 * kTile * 2;         // a warpgroup's out rows
// the stages and each consumer's out tile (1024-byte aligned for the
// 128-byte swizzle), then the barriers, plus the slack to align the base
constexpr size_t kSmemBf16 = (size_t)kStages * kStageBytes +
                             (size_t)kConsumers * kBytesC +
                             2 * kStages * sizeof(uint64_t) + 1024;

__global__ void __launch_bounds__(kThreadsBf16, 1)
chunk_mm_bf16_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ CUtensorMap map_o, int M, int K,
                     int N) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // stage s at base + s * 32 KB
  const uint32_t tile_c = base + kStages * kStageBytes;  // out tiles
  const uint32_t full = tile_c + kConsumers * kBytesC;   // mbarriers
  const uint32_t empty = full + kStages * sizeof(uint64_t);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);             // the producer's expect_tx
      mbar_init(empty + 8 * s, kConsumers);   // one arrive per warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int tiles_n = N / kTile;
  const int tiles = (M + kTile - 1) / kTile * tiles_n;
  const int nk = (K + kDepth - 1) / kDepth;
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---------------------------------------------------- the producer
    reg_dealloc<40>();
    if (threadIdx.x % 128 != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / tiles_n * kTile, n0 = t % tiles_n * kTile;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t bar = full + 8 * stage;
        const uint32_t dst = base + stage * kStageBytes;
        mbar_expect_tx(bar, kStageBytes);
        tma_load(dst, &map_x, kt * kDepth, m0, bar);
        tma_load(dst + kBytesA, &map_w, n0, kt * kDepth, bar);
        tma_load(dst + kBytesA + kBytesB / 2, &map_w, n0 + 64, kt * kDepth,
                 bar);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    // stay until the consumers have released every stage
    for (int s = 0; s < kStages; ++s) {
      mbar_wait(empty + 8 * stage, phase ^ 1);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    // ------------------------------------------- the consumers: 64 rows
    reg_alloc<232>();
    const bool lead = threadIdx.x % 128 == 0;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / tiles_n * kTile, n0 = t % tiles_n * kTile;
      float d[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = 0.f;
      int prev = 0;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t a = base + stage * kStageBytes + wg * (kBytesA / 2);
        const uint32_t b = base + stage * kStageBytes + kBytesA;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDepth / 16; ++kk) {
          // x: +32 bytes a k step inside the 128-byte rows; SBO: 8 rows
          // (1024 B).  w: +16 rows (2048 B) a k step; LBO: the second
          // 64-column box (8192 B), SBO: 8 rows of k (1024 B)
          wgmma_m64n128k16<1>(d, wgmma_desc(a + kk * 32, 1, 64),
                              wgmma_desc(b + kk * 2048, 512, 64), 1);
        }
        wgmma_commit();
        // the group of step kt - 1 is done: release its stage
        wgmma_wait<1>();
        if (kt > 0 && lead) mbar_arrive(empty + 8 * prev);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (lead) mbar_arrive(empty + 8 * prev);
      // the accumulator, rounded to bf16, into this warpgroup's out tile
      // (two 64 x 64 boxes in the 128-byte swizzle, so the 4-byte stores
      // of a warp hit 32 distinct banks), then out by TMA.  Fragment:
      // warp w holds rows 16 w .. 16 w + 15; per 8 columns j, d[4j],
      // d[4j+1] at row lane / 4, columns 2 (lane % 4) and + 1; d[4j+2],
      // d[4j+3] eight rows below.  The stores of the last tile must have
      // read the tile before it is written again.
      const uint32_t c = tile_c + wg * kBytesC;
      if (lead) tma_store_wait_read();
      warpgroup_sync(wg);
      const int r = warp * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint32_t at = c + (j / 8) * (kBytesC / 2) + r * 128 +
                            (((j % 8) ^ (r % 8)) * 16) + (lane % 4) * 4;
        __nv_bfloat162 lo = __floats2bfloat162_rn(d[4 * j], d[4 * j + 1]);
        __nv_bfloat162 hi =
            __floats2bfloat162_rn(d[4 * j + 2], d[4 * j + 3]);
        asm volatile("st.shared.b32 [%0], %1;\n"
                     :: "r"(at), "r"(*reinterpret_cast<uint32_t*>(&lo)));
        asm volatile("st.shared.b32 [%0], %1;\n"
                     :: "r"(at + 8 * 128),
                        "r"(*reinterpret_cast<uint32_t*>(&hi)));
      }
      // the generic proxy's writes, visible to TMA's
      fence_proxy_async();
      warpgroup_sync(wg);
      if (lead) {
        tma_store(&map_o, c, n0, m0 + wg * 64);
        tma_store(&map_o, c + kBytesC / 2, n0 + 64, m0 + wg * 64);
        tma_store_commit();
      }
    }
    if (lead) tma_store_wait();
  }
}

// ---------------------------------------------------------- tensor maps
// a row-major bf16 [rows, cols] matrix with leading dimension ld, moved
// in boxes of box_rows x box_cols (box_cols * 2 = 128 bytes, swizzled);
// out-of-bounds elements read as 0 and are not written
bool bf16_map(CUtensorMap* map, const void* base, long long rows,
              long long cols, long long ld, int box_rows, int box_cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, box, steps,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_bf16(const void* x, const void* w, void* out, int M, int K, int N,
                long long ldx, long long ldw, long long ldo,
                cudaStream_t st) {
  CUtensorMap map_x, map_w, map_o;
  if (!bf16_map(&map_x, x, M, K, ldx, kTile, kDepth) ||
      !bf16_map(&map_w, w, K, N, ldw, kDepth, 64) ||
      !bf16_map(&map_o, out, M, N, ldo, 64, 64))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(chunk_mm_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBf16);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (M + kTile - 1) / kTile * (N / kTile);
  chunk_mm_bf16_kernel<<<tiles < sms ? tiles : sms, kThreadsBf16, kSmemBf16,
                         st>>>(map_x, map_w, map_o, M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound from Python with ctypes
// (paddle_tpu_torch/ops/cuda/chunk_matmul.py).  dtype: 0 = float32,
// 1 = bfloat16.  Leading dimensions in elements.  Returns 0, -1 for a
// dtype or shape this file does not take, or the cudaError_t of the
// launch (cudaErrorInvalidValue when no tensor map could be built).
extern "C" int ptt_chunk_matmul(const void* x, const void* w, void* out,
                                int M, int K, int N, long long ldx,
                                long long ldw, long long ldo, int dtype,
                                void* stream) {
  if (M < 1 || K < 32 || K % 32 || N < kTile || N % kTile) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid(N / f32_tile::kBN, (M + f32_tile::kBM - 1) / f32_tile::kBM);
    chunk_mm_f32_kernel<<<grid, f32_tile::kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), M, K, ldx, ldw, ldo);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) return launch_bf16(x, w, out, M, K, N, ldx, ldw, ldo, st);
  return -1;
}
