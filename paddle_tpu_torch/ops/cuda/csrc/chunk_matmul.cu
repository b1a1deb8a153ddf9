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
// mma.sync accumulator takes the K steps of 16 in ascending order.  No
// split-K.  So a chunk computed alone equals, bit for bit, the same
// columns of the product with the whole weight: the ring form of the
// column-parallel matmul is bitwise equal to gathering w first.
//
// f32 stays exact f32 on the CUDA cores (paddle_tpu asks the TPU for
// Precision.HIGHEST, so no TF32); bf16 runs on the tensor cores
// (mma.sync m16n8k16, f32 accumulation).
//
// Bound on this card: operations.  The GPT 1b step's chunks (M 8192;
// K, N from 1792 and 7168) are 53-210 GFLOP each against 65-172 MB of
// operands and result at bf16, so at 989 TFLOP/s the products take
// 53-213 us and the bytes (3.35 TB/s) 19-51 us; at f32 (67 TFLOP/s) the
// products dominate by far more.
// What the design does about it:
//   * one block of 256 threads owns a 128 x 128 output tile and walks K;
//   * f32: the x tile (transposed) and the w tile, 8 deep, go through
//     shared memory, the next ones loaded into registers while the
//     current ones are multiplied; each thread owns 8 x 8 outputs (rows
//     and columns split in two halves of 4, so the float4 reads from
//     shared memory are free of bank conflicts): 64 FMA per 16 values
//     read;
//   * bf16: 32-deep tiles of x and w stream through shared memory by
//     cp.async, four tiles in flight (74 KB; rows padded by 16 bytes so
//     ldmatrix is free of bank conflicts), one barrier a tile; 8 warps
//     each own 64 x 32 outputs as 4 x 4 mma.sync tiles, with x
//     fragments from ldmatrix and w fragments from ldmatrix.trans.
// Not done yet (later work): wgmma, TMA, a persistent schedule.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;             // rows of a block tile
constexpr int kBN = 128;             // columns of a block tile
constexpr int kBK32 = 8;             // depth of an f32 step
constexpr int kBK16 = 32;            // depth of a bf16 step
constexpr int kSA = kBK16 + 8;       // bf16 x tile row stride (elements)
constexpr int kSB = kBN + 8;         // bf16 w tile row stride (elements)

// ------------------------------------------------------------------ f32
__global__ void __launch_bounds__(kThreads)
chunk_mm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, int M, int K, long long ldx,
                    long long ldw, long long ldo) {
  __shared__ __align__(16) float As[2][kBK32][kBM];   // x tile, [k][m]
  __shared__ __align__(16) float Bs[2][kBK32][kBN];   // w tile, [k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  // loads: x row tid / 2, depth (tid % 2) * 4; w depth tid / 32,
  // columns (tid % 32) * 4: one float4 each per step
  const int ar = tid >> 1, ak = (tid & 1) * 4;
  const int bk = tid >> 5, bn = (tid & 31) * 4;
  const bool arow = m0 + ar < M;
  const float* xp = x + (long long)(arow ? m0 + ar : 0) * ldx + ak;
  const float* wp = w + (long long)bk * ldw + n0 + bn;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 ra = arow ? *reinterpret_cast<const float4*>(xp) : zero4;
  float4 rb = *reinterpret_cast<const float4*>(wp);
  auto put = [&](int buf) {
    As[buf][ak + 0][ar] = ra.x;
    As[buf][ak + 1][ar] = ra.y;
    As[buf][ak + 2][ar] = ra.z;
    As[buf][ak + 3][ar] = ra.w;
    *reinterpret_cast<float4*>(&Bs[buf][bk][bn]) = rb;
  };
  put(0);
  __syncthreads();
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int nk = K / kBK32;
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      const int k0 = (kt + 1) * kBK32;
      ra = arow ? *reinterpret_cast<const float4*>(xp + k0) : zero4;
      rb = *reinterpret_cast<const float4*>(wp + (long long)k0 * ldw);
    }
#pragma unroll
    for (int k = 0; k < kBK32; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[cur][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[cur][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read in step kt - 1, which ended with a
    // barrier
    if (more) put(cur ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
    float* o = out + (long long)row * ldo + n0;
    *reinterpret_cast<float4*>(o + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(o + 64 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// ----------------------------------------------------------------- bf16
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// C fragment: lane (g = lane / 4, t = lane % 4) holds c[0..1] at row g,
// cols 2t, 2t + 1 and c[2..3] at row g + 8
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int kStages = 4;           // bf16 tiles in flight
constexpr int kStageA = kBM * kSA;   // elements of one stage's x tile
constexpr int kStageB = kBK16 * kSB; // elements of one stage's w tile
constexpr size_t kSmemBf16 =
    (size_t)kStages * (kStageA + kStageB) * sizeof(__nv_bfloat16);

__global__ void __launch_bounds__(kThreads)
chunk_mm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     __nv_bfloat16* __restrict__ out, int M, int K,
                     long long ldx, long long ldw, long long ldo) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [m][k]
  __nv_bfloat16* Bs = As + kStages * kStageA;                   // [k][n]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;   // warp tile: 64 rows, 32 cols
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = K / kBK16;
  // k tile kt -> stage kt % kStages, by cp.async; rows past M are zero
  auto load = [&](int kt) {
    if (kt >= nk) return;
    const int k0 = kt * kBK16, st = kt % kStages;
    __nv_bfloat16* a = As + st * kStageA;
    __nv_bfloat16* b = Bs + st * kStageB;
    // x: 128 rows of 32 values = 4 vectors of 8 a row
    for (int i = tid; i < kBM * 4; i += kThreads) {
      const int r = i >> 2, c = (i & 3) * 8;
      const bool ok = m0 + r < M;
      cp_async16(a + r * kSA + c,
                 ok ? x + (long long)(m0 + r) * ldx + k0 + c : x, ok);
    }
    // w: 32 rows of 128 values = 16 vectors a row
    for (int i = tid; i < kBK16 * 16; i += kThreads) {
      const int r = i >> 4, c = (i & 15) * 8;
      cp_async16(b + r * kSB + c, w + (long long)(k0 + r) * ldw + n0 + c,
                 true);
    }
  };
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  // one commit group per k tile (empty past the end), so that "all but
  // the newest kStages - 2 groups done" means tile kt has landed
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    // tile kt is visible to every thread, and every thread is done with
    // tile kt - 1, whose stage the next load refills
    __syncthreads();
    load(kt + kStages - 1);
    cp_async_commit();
    const int st = kt % kStages;
    const __nv_bfloat16* A = As + st * kStageA +
                             (wm * 64 + (lane & 15)) * kSA + (lane >> 4) * 8;
    const __nv_bfloat16* B = Bs + st * kStageB + (lane & 15) * kSB +
                             wn * 32 + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kBK16; kk += 16) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) ldsm_x4(af[mt], A + mt * 16 * kSA + kk);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4_t(bf[np], B + kk * kSB + np * 16);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], af[mt], bf[nt >> 1][(nt & 1) * 2],
                   bf[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int row = m0 + wm * 64 + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn * 32 + nt * 8 + 2 * t;
      if (row < M)
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * ldo + col) =
            __floats2bfloat162_rn(acc[mt][nt][0], acc[mt][nt][1]);
      if (row + 8 < M)
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)(row + 8) * ldo +
                                           col) =
            __floats2bfloat162_rn(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

}  // namespace

// Plain C entry point, bound from Python with ctypes
// (paddle_tpu_torch/ops/cuda/chunk_matmul.py).  dtype: 0 = float32,
// 1 = bfloat16.  Leading dimensions in elements.  Returns 0, -1 for a
// dtype or shape this file does not take, or the cudaError_t of the
// launch.
extern "C" int ptt_chunk_matmul(const void* x, const void* w, void* out,
                                int M, int K, int N, long long ldx,
                                long long ldw, long long ldo, int dtype,
                                void* stream) {
  if (M < 1 || K < kBK16 || K % kBK16 || N < kBN || N % kBN) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  if (dtype == 0) {
    chunk_mm_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), M, K, ldx, ldw, ldo);
  } else if (dtype == 1) {
    const cudaError_t e = cudaFuncSetAttribute(
        chunk_mm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBf16);
    if (e != cudaSuccess) return (int)e;
    chunk_mm_bf16_kernel<<<grid, kThreads, kSmemBf16, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), M, K, ldx, ldw, ldo);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
