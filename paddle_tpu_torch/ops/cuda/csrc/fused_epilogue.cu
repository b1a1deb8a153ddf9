// Fused matmul epilogue for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/fused_epilogue.py:
//   _fwd (body from _make_fwd_kernel)       -> epilogue_fwd_f32_kernel
//                                              (f32), epilogue_fwd_kernel
//                                              (bf16)
//   _bwd_call (body from _make_bwd_kernel)  -> epilogue_bwd_kernel and
//                                              epilogue_grads_kernel
//
//   x [M, K], w [K, N] (one dtype, f32 or bf16), out [M, N] in x's dtype
//   out = epilogue(x @ w) on the f32 accumulator, the stages in order:
//     bias (+ [N] operand), relu, gelu (erf or tanh), add (+ [M, N]
//     residual), layer_norm (row statistics over N, eps, optional [N]
//     weight and bias); operands are f32 or bf16, read as f32.
//   The backward replays the forward from (x, w, operands) and walks the
//   stages back from dy to g, the gradient at the accumulator, then
//   dx = g . w^T, dw = x^T . g (f32), d-bias and d-affine (f32 sums over
//   rows) and d-residual (the operand's dtype).
//
// f32 products stay exact f32 (FMA on the CUDA cores; paddle_tpu asks for
// Precision.HIGHEST, so no TF32); bf16 products run on the tensor cores
// (mma.sync m16n8k16) with f32 accumulation.
//
// Bound on this card, at BERT-base (M 8192; K, N = 768, 768 | 768, 3072
// | 3072, 768): every chain is a matrix product of 2.MKN operations on
// an M.N epilogue; at f32 the products bound it (fc1: 38.65 GFLOP,
// 0.58 ms at 67 TFLOP/s, against 47 MB moved, 0.014 ms).
// What the design does about it:
//   * the f32 forward (the main path's dtype) runs f32_tile.cuh's
//     mainloop: one block of 256 threads a 128 x 128 tile, 8 x 8 outputs
//     a thread, float4 loads, one barrier an 8-deep step; every element
//     is one FMA chain over k = 0..K-1, bit for bit K6's f32 product.
//     The stages run on the accumulators in registers and the results
//     are stored from there.  A layer_norm needs whole rows: the blocks
//     of one 128-row band then form one thread-block cluster along N
//     (N / 128 blocks, up to 12 at N = 1536), and the row statistics
//     take two rounds over distributed shared memory (the per-block row
//     sums give the mean, then the sums of squared deviations give
//     rstd; each block sums the cluster's partials in rank order, so
//     every block gets the same statistics).  The [M, N] pre-norm
//     values never reach device memory;
//   * the bf16 forward (not on the main path) and the backward keep the
//     TileGemm tiles below: one block of 256 threads owns 64 rows (32
//     with a layer_norm); it computes the f32 accumulator one rows x 128
//     tile at a time (k steps of 32, 16 for 32 rows, through shared
//     memory, the next step's tiles loaded into registers while the
//     current one is multiplied) into a shared-memory staging area;
//     chains without layer_norm give each block one 128-column tile (a
//     2-D grid); with a layer_norm the block walks all N columns and
//     keeps the 32 x N pre-normalisation rows in shared memory (N <=
//     1536: 197 KB; two blocks an SM at N = 768);
//   * the backward is deterministic (no atomics: two runs agree bit for
//     bit).  epilogue_bwd_kernel recomputes the accumulator for its rows,
//     replays the stages, walks them back and writes g (rounded to w's
//     dtype, as the TPU kernel rounds it before its products), the
//     d-residual, and per-block partial sums of d-bias and d-affine;
//     epilogue_grads_kernel then computes 64 x 128 dx and dw tiles (each
//     output element summed by one block in a fixed order) and sums the
//     partials in row-block order.  Unlike the TPU kernel it writes g to
//     device memory once and reads it back for the two products.  Its
//     f32 tile sums each element in the same order as the forward's, so
//     it replays the same accumulator.
// Not done yet (later work): wgmma/TMA for bf16 and the backward, a
// persistent schedule.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "f32_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 32;              // rows of a layer_norm block tile
constexpr int kGM = 64;              // rows of the other block tiles
constexpr int kBN = 128;             // columns of a block tile
constexpr int kRowGroups = 2;        // row groups of the column pass
constexpr int kMaxStages = 8;
constexpr int kMaxOps = 8;

// depth of one k step of a BM-row tile: 16 for the layer_norm tile, so
// that two blocks holding 32 whole rows of N = 768 fit on one SM
template <int BM>
__host__ __device__ constexpr int depth() {
  return BM == kBM ? 16 : 32;
}

// shared bytes of the k-step tiles of a BM-row tile (the f32 layout is
// the larger)
template <int BM>
__host__ __device__ constexpr int tile_bytes() {
  return (depth<BM>() * (BM + 4) + depth<BM>() * (kBN + 4)) * 4;
}

enum { kBias = 0, kRelu = 1, kGelu = 2, kAdd = 3, kLayerNorm = 4 };

struct Recipe {
  int n;                   // stages
  int ln;                  // index of the layer_norm stage, or -1
  int kind[kMaxStages];
  int approx[kMaxStages];  // gelu: tanh form
  int op0[kMaxStages];     // operand slot: bias/add operand, LN weight
  int op1[kMaxStages];     // LN bias slot
  float eps[kMaxStages];
  int n_ops;
  const void* ops[kMaxOps];
  void* grad[kMaxOps];     // d-residual outputs (add operands)
  int full[kMaxOps];       // 1: [M, N] residual, 0: [N] vector
  int bf16[kMaxOps];       // operand dtype
};

constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

__device__ __forceinline__ float ld(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
template <typename T>
__device__ __forceinline__ T cvt(float v);
template <>
__device__ __forceinline__ float cvt<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float op_at(const Recipe& r, int slot,
                                       long long row, int col, int N) {
  const long long i = r.full[slot] ? row * N + col : col;
  return r.bf16[slot]
             ? __bfloat162float(
                   static_cast<const __nv_bfloat16*>(r.ops[slot])[i])
             : static_cast<const float*>(r.ops[slot])[i];
}

__device__ __forceinline__ float gelu_f(float z, int approx) {
  if (approx) {
    const float u = kSqrt2OverPi * (z + 0.044715f * z * z * z);
    return 0.5f * z * (1.f + tanhf(u));
  }
  return 0.5f * z * (1.f + erff(z * kInvSqrt2));
}

__device__ __forceinline__ float dgelu_f(float z, int approx) {
  if (approx) {
    const float u = kSqrt2OverPi * (z + 0.044715f * z * z * z);
    const float t = tanhf(u);
    const float du = kSqrt2OverPi * (1.f + 3.f * 0.044715f * z * z);
    return 0.5f * (1.f + t) + 0.5f * z * (1.f - t * t) * du;
  }
  const float cdf = 0.5f * (1.f + erff(z * kInvSqrt2));
  const float pdf = kInvSqrt2Pi * expf(-0.5f * z * z);
  return cdf + z * pdf;
}

__device__ __forceinline__ float stage(float z, const Recipe& r, int s,
                                       long long row, int col, int N) {
  switch (r.kind[s]) {
    case kBias:
    case kAdd:
      return z + op_at(r, r.op0[s], row, col, N);
    case kRelu:
      return fmaxf(z, 0.f);
    case kGelu:
      return gelu_f(z, r.approx[s]);
  }
  return z;
}

// stages [from, to) forward (none of them a layer_norm)
__device__ float fwd_stages(float z, const Recipe& r, int from, int to,
                            long long row, int col, int N) {
  for (int s = from; s < to; ++s) z = stage(z, r, s, row, col, N);
  return z;
}

// stages [from, to) backward: z is the input of stage ``from``, g the
// gradient at the output of stage ``to - 1``; returns the gradient at
// z.  With ``acc`` the operand gradients are emitted: d-bias into the
// column sums ``acc``, d-residual into the operand's grad output.
__device__ float bwd_stages(float z, float g, const Recipe& r, int from,
                            int to, long long row, int col, int N,
                            float* acc) {
  float hs[kMaxStages];
  for (int s = from; s < to; ++s) {
    hs[s] = z;
    z = stage(z, r, s, row, col, N);
  }
  for (int s = to - 1; s >= from; --s) {
    switch (r.kind[s]) {
      case kBias:
        if (acc) acc[r.op0[s]] += g;
        break;
      case kAdd:
        if (acc) {
          const int k = r.op0[s];
          const long long i = row * N + col;
          if (r.bf16[k])
            static_cast<__nv_bfloat16*>(r.grad[k])[i] = __float2bfloat16(g);
          else
            static_cast<float*>(r.grad[k])[i] = g;
        }
        break;
      case kRelu:
        g = hs[s] > 0.f ? g : 0.f;
        break;
      case kGelu:
        g *= dgelu_f(hs[s], r.approx[s]);
        break;
    }
  }
  return g;
}

// ------------------------------------------------------ the tile product
// C[BM][ldc] = A[rows][K] . B[K][kBN] in f32, with A(i, k) = A[i * sai +
// k * sak] and B(k, j) = B[k * sbk + j * sbj]; rows past ``rows``,
// columns past ``cols`` and depth past K read as 0.  Every load is
// coalesced along whichever of the two strides is 1.  Ends with the
// tile in C; the caller synchronises before reading it.
template <typename T, int BM>
struct TileGemm;

// f32: thread (ty, tx) of the 8 x 32 grid owns rows ty * BM/8 .. and
// columns 4 tx ..; per k it reads BM/8 + 4 values from shared memory as
// float4 for 4 BM/8 FMAs (the 64-row tile halves the reads per FMA).
template <int BM>
struct TileGemm<float, BM> {
  static constexpr int kBK = depth<BM>();
  static constexpr int kLa = BM + 4;    // As[k][m]
  static constexpr int kLb = kBN + 4;   // Bs[k][n]
  static constexpr int kRM = BM / 8;    // rows a thread owns
  static constexpr int kNa = BM * kBK / kThreads;
  static constexpr int kNb = kBK * kBN / kThreads;

  __device__ static void run(const float* __restrict__ A, long long sai,
                             long long sak, int rows,
                             const float* __restrict__ B, long long sbk,
                             long long sbj, int cols, int K, float* C,
                             int ldc, char* smem) {
    float* As = reinterpret_cast<float*>(smem);
    float* Bs = As + kBK * kLa;
    const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
    float acc[kRM][4];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float ra[kNa], rb[kNb];
    auto load = [&](int k0) {
#pragma unroll
      for (int t = 0; t < kNa; ++t) {
        const int e = tid + t * kThreads;
        const int i = sak == 1 ? e / kBK : e % BM;
        const int k = sak == 1 ? e % kBK : e / BM;
        ra[t] = (i < rows && k0 + k < K)
                    ? A[i * sai + (long long)(k0 + k) * sak] : 0.f;
      }
#pragma unroll
      for (int t = 0; t < kNb; ++t) {
        const int e = tid + t * kThreads;
        const int k = sbj == 1 ? e / kBN : e % kBK;
        const int j = sbj == 1 ? e % kBN : e / kBK;
        rb[t] = (j < cols && k0 + k < K)
                    ? B[(long long)(k0 + k) * sbk + j * sbj] : 0.f;
      }
    };
    auto store = [&]() {
#pragma unroll
      for (int t = 0; t < kNa; ++t) {
        const int e = tid + t * kThreads;
        const int i = sak == 1 ? e / kBK : e % BM;
        const int k = sak == 1 ? e % kBK : e / BM;
        As[k * kLa + i] = ra[t];
      }
#pragma unroll
      for (int t = 0; t < kNb; ++t) {
        const int e = tid + t * kThreads;
        const int k = sbj == 1 ? e / kBN : e % kBK;
        const int j = sbj == 1 ? e % kBN : e / kBK;
        Bs[k * kLb + j] = rb[t];
      }
    };
    load(0);
    store();
    __syncthreads();
    for (int k0 = 0; k0 < K; k0 += kBK) {
      const bool more = k0 + kBK < K;
      if (more) load(k0 + kBK);
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float av[kRM];
#pragma unroll
        for (int r = 0; r < kRM; r += 4) {
          const float4 a = *reinterpret_cast<const float4*>(
              &As[k * kLa + ty * kRM + r]);
          av[r] = a.x;
          av[r + 1] = a.y;
          av[r + 2] = a.z;
          av[r + 3] = a.w;
        }
        const float4 b = *reinterpret_cast<const float4*>(&Bs[k * kLb +
                                                              tx * 4]);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < kRM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j],
                                                       acc[i][j]);
      }
      __syncthreads();
      if (more) {
        store();
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) C[(ty * kRM + i) * ldc + tx * 4 + j] =
                                      acc[i][j];
  }
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bf16: both tiles stored k-contiguous (As[m][k], Bs[n][k], rows padded
// by 16 bytes), so every A and B fragment register is one 32-bit load;
// warp w owns columns 16w..16w+15 of the tile and all BM rows: BM/16 x 2
// m16n8 accumulators.
template <int BM>
struct TileGemm<__nv_bfloat16, BM> {
  static constexpr int kBK = depth<BM>();
  static constexpr int kLd = kBK + 8;
  static constexpr int kMT = BM / 16;
  static constexpr int kNa = BM * kBK / kThreads;
  static constexpr int kNb = kBK * kBN / kThreads;

  __device__ static void run(const __nv_bfloat16* __restrict__ A,
                             long long sai, long long sak, int rows,
                             const __nv_bfloat16* __restrict__ B,
                             long long sbk, long long sbj, int cols, int K,
                             float* C, int ldc, char* smem) {
    __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* Bs = As + BM * kLd;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tig = lane & 3;
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    float acc[kMT][2][4];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;
    __nv_bfloat16 ra[kNa], rb[kNb];
    auto load = [&](int k0) {
#pragma unroll
      for (int t = 0; t < kNa; ++t) {
        const int e = tid + t * kThreads;
        const int i = sak == 1 ? e / kBK : e % BM;
        const int k = sak == 1 ? e % kBK : e / BM;
        ra[t] = (i < rows && k0 + k < K)
                    ? A[i * sai + (long long)(k0 + k) * sak] : zero;
      }
#pragma unroll
      for (int t = 0; t < kNb; ++t) {
        const int e = tid + t * kThreads;
        const int k = sbj == 1 ? e / kBN : e % kBK;
        const int j = sbj == 1 ? e % kBN : e / kBK;
        rb[t] = (j < cols && k0 + k < K)
                    ? B[(long long)(k0 + k) * sbk + j * sbj] : zero;
      }
    };
    auto store = [&]() {
#pragma unroll
      for (int t = 0; t < kNa; ++t) {
        const int e = tid + t * kThreads;
        const int i = sak == 1 ? e / kBK : e % BM;
        const int k = sak == 1 ? e % kBK : e / BM;
        As[i * kLd + k] = ra[t];
      }
#pragma unroll
      for (int t = 0; t < kNb; ++t) {
        const int e = tid + t * kThreads;
        const int k = sbj == 1 ? e / kBN : e % kBK;
        const int j = sbj == 1 ? e % kBN : e / kBK;
        Bs[j * kLd + k] = rb[t];
      }
    };
    load(0);
    store();
    __syncthreads();
    for (int k0 = 0; k0 < K; k0 += kBK) {
      const bool more = k0 + kBK < K;
      if (more) load(k0 + kBK);
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t a[kMT][4], b[2][2];
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
          const __nv_bfloat16* p = As + (m * 16 + g) * kLd + kk + 2 * tig;
          a[m][0] = *reinterpret_cast<const uint32_t*>(p);
          a[m][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd);
          a[m][2] = *reinterpret_cast<const uint32_t*>(p + 8);
          a[m][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd + 8);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const __nv_bfloat16* p = Bs + (warp * 16 + n * 8 + g) * kLd + kk +
                                   2 * tig;
          b[n][0] = *reinterpret_cast<const uint32_t*>(p);
          b[n][1] = *reinterpret_cast<const uint32_t*>(p + 8);
        }
#pragma unroll
        for (int m = 0; m < kMT; ++m)
#pragma unroll
          for (int n = 0; n < 2; ++n) mma_bf16(acc[m][n], a[m], b[n]);
      }
      __syncthreads();
      if (more) {
        store();
        __syncthreads();
      }
    }
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int row = m * 16 + g, col = warp * 16 + n * 8 + 2 * tig;
        C[row * ldc + col] = acc[m][n][0];
        C[row * ldc + col + 1] = acc[m][n][1];
        C[(row + 8) * ldc + col] = acc[m][n][2];
        C[(row + 8) * ldc + col + 1] = acc[m][n][3];
      }
  }
};

// The block's column span: all N when the recipe has a layer_norm (it
// needs whole rows), else one 128-column tile.
struct Span {
  int begin, width, ld;
  __device__ Span(const Recipe& r, int N) {
    begin = r.ln >= 0 ? 0 : blockIdx.y * kBN;
    width = r.ln >= 0 ? N : kBN;
    ld = width + 4;
  }
};

// z = x . w for the block's rows over its span, into H[BM][sp.ld]
template <typename T, int BM>
__device__ void accumulate_rows(const T* x, const T* w, long long row0,
                                int rows, int K, int N, const Span& sp,
                                float* H, char* smem) {
  for (int c0 = 0; c0 < sp.width; c0 += kBN) {
    TileGemm<T, BM>::run(x + row0 * K, K, 1, rows, w + sp.begin + c0, N, 1,
                         kBN, K, H + c0, sp.ld, smem);
  }
  __syncthreads();
}

// -------------------------------------------------------- forward, bf16
// BM rows a block: 32 with a layer_norm (whole rows in shared memory),
// 64 without
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
    epilogue_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        T* __restrict__ out, int M, int K, int N,
                        Recipe r) {
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * BM;
  const int rows = (int)min((long long)BM, (long long)M - row0);
  const Span sp(r, N);
  float* H = reinterpret_cast<float*>(smem + tile_bytes<BM>());
  accumulate_rows<T, BM>(x, w, row0, rows, K, N, sp, H, smem);
  const bool ln = r.ln >= 0;
  const int pre = ln ? r.ln : r.n;
  for (int e = tid; e < BM * sp.width; e += kThreads) {
    const int i = e / sp.width, j = e % sp.width;
    if (i >= rows) continue;
    float* h = &H[i * sp.ld + j];
    const float z = fwd_stages(*h, r, 0, pre, row0 + i, sp.begin + j, N);
    if (ln)
      *h = z;
    else
      out[(row0 + i) * N + sp.begin + j] = cvt<T>(z);
  }
  if (!ln) return;
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31, s = r.ln;
  for (int i = warp; i < rows; i += kWarps) {
    const float* h = &H[i * sp.ld];
    const long long row = row0 + i;
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) sum += h[j];
    const float mu = warp_sum(sum) / N;
    float sq = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float d = h[j] - mu;
      sq += d * d;
    }
    const float rstd = rsqrtf(warp_sum(sq) / N + r.eps[s]);
    for (int j = lane; j < N; j += 32) {
      float z = (h[j] - mu) * rstd;
      if (r.op0[s] >= 0) z *= op_at(r, r.op0[s], row, j, N);
      if (r.op1[s] >= 0) z += op_at(r, r.op1[s], row, j, N);
      z = fwd_stages(z, r, s + 1, r.n, row, j, N);
      out[row * N + j] = cvt<T>(z);
    }
  }
}

// --------------------------------------------------------- forward, f32
// Four consecutive values of operand ``slot`` at (row, col), as f32
// (col a multiple of 4; the [N] vectors ignore the row).
__device__ __forceinline__ float4 op4(const Recipe& r, int slot,
                                      long long row, int col, int N) {
  const long long i = r.full[slot] ? row * N + col : col;
  if (r.bf16[slot]) {
    const uint2 u = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(r.ops[slot]) + i);
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  return *reinterpret_cast<const float4*>(
      static_cast<const float*>(r.ops[slot]) + i);
}

__device__ __forceinline__ void add4(float* v, float4 o) {
  v[0] += o.x;
  v[1] += o.y;
  v[2] += o.z;
  v[3] += o.w;
}

__device__ __forceinline__ void put4(float* v, float4 o) {
  v[0] = o.x;
  v[1] = o.y;
  v[2] = o.z;
  v[3] = o.w;
}

// stages [from, to) (none of them a layer_norm) on a thread's 8 x 8
// values: rows m0 + row_of(ty, i), columns c[0] + 0..3 and c[1] + 0..3.
// The same arithmetic as fwd_stages, element by element.
__device__ void tile_stages(float (&v)[8][8], const Recipe& r, int from,
                            int to, int m0, int ty, const int (&c)[2], int M,
                            int N) {
  for (int s = from; s < to; ++s) {
    const int kind = r.kind[s];
    if (kind == kRelu) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) v[i][j] = fmaxf(v[i][j], 0.f);
    } else if (kind == kGelu) {
      const int approx = r.approx[s];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) v[i][j] = gelu_f(v[i][j], approx);
    } else if (kind == kBias || kind == kAdd) {
      const int k = r.op0[s];
      if (!r.full[k]) {
        const float4 a = op4(r, k, 0, c[0], N), b = op4(r, k, 0, c[1], N);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          add4(v[i], a);
          add4(v[i] + 4, b);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = m0 + f32_tile::row_of(ty, i);
          if (row >= M) continue;
          add4(v[i], op4(r, k, row, c[0], N));
          add4(v[i] + 4, op4(r, k, row, c[1], N));
        }
      }
    }
  }
}

// a thread's 8 row values summed over the 16 threads of its row group
// (one half-warp), into part[row]
__device__ __forceinline__ void row_partials(float (&p)[8], int tx, int ty,
                                             float* part) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float s = p[i];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (tx == 0) part[f32_tile::row_of(ty, i)] = s;
  }
}

// The cluster's sum of part[row] over its blocks, in rank order.
__device__ __forceinline__ float cluster_sum(
    cooperative_groups::cluster_group& cluster, float* part, int row) {
  float t = 0.f;
  const int n = (int)cluster.num_blocks();
  for (int q = 0; q < n; ++q) t += cluster.map_shared_rank(part, q)[row];
  return t;
}

// Block (bx, by) computes out's 128 x 128 tile at rows 128 by, columns
// 128 bx; two blocks an SM (at most 128 registers a thread).  With LN
// the launch makes the N / 128 blocks of a row band one cluster, which
// joins the layer_norm rows.
template <bool LN>
__global__ void __launch_bounds__(f32_tile::kThreads, 2)
    epilogue_fwd_f32_kernel(const float* __restrict__ x,
                            const float* __restrict__ w,
                            float* __restrict__ out, int M, int K, int N,
                            Recipe r) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * f32_tile::kBM, n0 = blockIdx.x * f32_tile::kBN;
  const int c[2] = {n0 + tx * 4, n0 + 64 + tx * 4};
  float v[8][8];
  f32_tile::mainloop(x, w, M, K, K, N, m0, n0, v);
  tile_stages(v, r, 0, LN ? r.ln : r.n, m0, ty, c, M, N);
  if constexpr (LN) {
    __shared__ float sums[f32_tile::kBM], squares[f32_tile::kBM];
    __shared__ float mean_s[f32_tile::kBM], rstd_s[f32_tile::kBM];
    cooperative_groups::cluster_group cluster =
        cooperative_groups::this_cluster();
    const int s = r.ln;
    // round 1: the row sums give the mean
    float p[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      p[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) p[i] += v[i][j];
    }
    row_partials(p, tx, ty, sums);
    cluster.sync();
    if (tid < f32_tile::kBM)
      mean_s[tid] = cluster_sum(cluster, sums, tid) / N;
    __syncthreads();
    float mu[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) mu[i] = mean_s[f32_tile::row_of(ty, i)];
    // round 2: the sums of squared deviations give rstd
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      p[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[i][j] - mu[i];
        p[i] += d * d;
      }
    }
    row_partials(p, tx, ty, squares);
    cluster.sync();
    if (tid < f32_tile::kBM)
      rstd_s[tid] =
          rsqrtf(cluster_sum(cluster, squares, tid) / N + r.eps[s]);
    // no block leaves (or reuses its partials) while another reads them
    cluster.sync();
    // the affine: weight and bias at the thread's 8 columns
    const bool has_g = r.op0[s] >= 0, has_b = r.op1[s] >= 0;
    float gv[8], bv[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 g = has_g ? op4(r, r.op0[s], 0, c[h], N)
                             : make_float4(1.f, 1.f, 1.f, 1.f);
      const float4 b = has_b ? op4(r, r.op1[s], 0, c[h], N)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      put4(gv + 4 * h, g);
      put4(bv + 4 * h, b);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float rstd = rstd_s[f32_tile::row_of(ty, i)];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float z = (v[i][j] - mu[i]) * rstd;
        if (has_g) z *= gv[j];
        if (has_b) z += bv[j];
        v[i][j] = z;
      }
    }
    tile_stages(v, r, s + 1, r.n, m0, ty, c, M, N);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + f32_tile::row_of(ty, i);
    if (row >= M) continue;
    float* o = out + (long long)row * N;
    *reinterpret_cast<float4*>(o + c[0]) =
        make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
    *reinterpret_cast<float4*>(o + c[1]) =
        make_float4(v[i][4], v[i][5], v[i][6], v[i][7]);
  }
}

// ------------------------------------------------------------ backward
// g (w's dtype) [M, N], the d-residuals, and partial [gridDim.x *
// kRowGroups][n_ops][N] column sums of the vector operands' gradients.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    epilogue_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const T* __restrict__ dy, T* __restrict__ gout,
                        float* __restrict__ partial, int M, int K, int N,
                        Recipe r) {
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kBM;
  const int rows = (int)min((long long)kBM, (long long)M - row0);
  const Span sp(r, N);
  float* H = reinterpret_cast<float*>(smem + tile_bytes<kBM>());
  float* mu_s = H + kBM * sp.ld;
  float* rstd_s = mu_s + kBM;
  float* s1_s = rstd_s + kBM;   // mean over the row of g at xhat
  float* s2_s = s1_s + kBM;     // mean over the row of g at xhat * xhat
  accumulate_rows<T, kBM>(x, w, row0, rows, K, N, sp, H, smem);
  const int s = r.ln;
  if (s >= 0) {
    const int warp = tid >> 5, lane = tid & 31;
    for (int i = warp; i < rows; i += kWarps) {
      const float* h = &H[i * sp.ld];
      const long long row = row0 + i;
      float sum = 0.f;
      for (int j = lane; j < N; j += 32)
        sum += fwd_stages(h[j], r, 0, s, row, j, N);
      const float mu = warp_sum(sum) / N;
      float sq = 0.f;
      for (int j = lane; j < N; j += 32) {
        const float d = fwd_stages(h[j], r, 0, s, row, j, N) - mu;
        sq += d * d;
      }
      const float rstd = rsqrtf(warp_sum(sq) / N + r.eps[s]);
      float a = 0.f, b = 0.f;
      for (int j = lane; j < N; j += 32) {
        const float xhat = (fwd_stages(h[j], r, 0, s, row, j, N) - mu) *
                           rstd;
        float y = xhat;
        if (r.op0[s] >= 0) y *= op_at(r, r.op0[s], row, j, N);
        if (r.op1[s] >= 0) y += op_at(r, r.op1[s], row, j, N);
        float g = bwd_stages(y, ld(dy, row * N + j), r, s + 1, r.n, row,
                                j, N, nullptr);
        if (r.op0[s] >= 0) g *= op_at(r, r.op0[s], row, j, N);
        a += g;
        b += g * xhat;
      }
      a = warp_sum(a);
      b = warp_sum(b);
      if (lane == 0) {
        mu_s[i] = mu;
        rstd_s[i] = rstd;
        s1_s[i] = a / N;
        s2_s[i] = b / N;
      }
    }
    __syncthreads();
  }
  // column pass: a thread owns one column of one row group, so the
  // operand sums over rows stay in its registers
  constexpr int kGroupRows = kBM / kRowGroups;
  for (int e = tid; e < sp.width * kRowGroups; e += kThreads) {
    const int j = e % sp.width, grp = e / sp.width;
    const int col = sp.begin + j;
    float acc[kMaxOps];
#pragma unroll
    for (int k = 0; k < kMaxOps; ++k) acc[k] = 0.f;
    const int i_end = min(rows, (grp + 1) * kGroupRows);
    for (int i = grp * kGroupRows; i < i_end; ++i) {
      const long long row = row0 + i;
      const float z = H[i * sp.ld + j];
      float g = ld(dy, row * N + col);
      if (s >= 0) {
        const float xhat = (fwd_stages(z, r, 0, s, row, col, N) - mu_s[i]) *
                           rstd_s[i];
        float y = xhat;
        if (r.op0[s] >= 0) y *= op_at(r, r.op0[s], row, col, N);
        if (r.op1[s] >= 0) y += op_at(r, r.op1[s], row, col, N);
        g = bwd_stages(y, g, r, s + 1, r.n, row, col, N, acc);
        if (r.op1[s] >= 0) acc[r.op1[s]] += g;
        if (r.op0[s] >= 0) {
          acc[r.op0[s]] += g * xhat;
          g *= op_at(r, r.op0[s], row, col, N);
        }
        g = rstd_s[i] * (g - s1_s[i] - xhat * s2_s[i]);
        g = bwd_stages(z, g, r, 0, s, row, col, N, acc);
      } else {
        g = bwd_stages(z, g, r, 0, r.n, row, col, N, acc);
      }
      gout[row * N + col] = cvt<T>(g);
    }
    const long long pb = (long long)blockIdx.x * kRowGroups + grp;
    for (int k = 0; k < r.n_ops; ++k)
      if (!r.full[k]) partial[(pb * r.n_ops + k) * N + col] = acc[k];
  }
}

// dx = g . w^T and dw = x^T . g tiles, then the operand sums: one launch,
// three kinds of block (dw tiles first: each runs over all M rows).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    epilogue_grads_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const T* __restrict__ g, T* __restrict__ dx,
                          float* __restrict__ dw,
                          const float* __restrict__ partial,
                          float* __restrict__ dvec, int M, int K, int N,
                          int n_partials, int dw_blocks, int dx_blocks,
                          Recipe r) {
  extern __shared__ __align__(16) char smem[];
  constexpr int kLc = kBN + 4;
  float* Cs = reinterpret_cast<float*>(smem + tile_bytes<kGM>());
  const int tid = threadIdx.x;
  int b = blockIdx.x;
  if (b < dw_blocks) {              // dw[K, N] rows r0.., cols c0..
    const int tn = N / kBN;
    const long long r0 = (long long)(b / tn) * kGM;
    const int c0 = (b % tn) * kBN;
    const int rows = (int)min((long long)kGM, (long long)K - r0);
    TileGemm<T, kGM>::run(x + r0, 1, K, rows, g + c0, N, 1, kBN, M, Cs,
                          kLc, smem);
    __syncthreads();
    for (int e = tid; e < kGM * kBN; e += kThreads) {
      const int i = e / kBN, j = e % kBN;
      if (i < rows) dw[(r0 + i) * N + c0 + j] = Cs[i * kLc + j];
    }
    return;
  }
  b -= dw_blocks;
  if (b < dx_blocks) {              // dx[M, K] rows r0.., cols c0..
    const int tk = (K + kBN - 1) / kBN;
    const long long r0 = (long long)(b / tk) * kGM;
    const int c0 = (b % tk) * kBN;
    const int rows = (int)min((long long)kGM, (long long)M - r0);
    const int cols = min(kBN, K - c0);
    TileGemm<T, kGM>::run(g + r0 * N, N, 1, rows, w + (long long)c0 * N, 1,
                          N, cols, N, Cs, kLc, smem);
    __syncthreads();
    for (int e = tid; e < kGM * kBN; e += kThreads) {
      const int i = e / kBN, j = e % kBN;
      if (i < rows && j < cols)
        dx[(r0 + i) * K + c0 + j] = cvt<T>(Cs[i * kLc + j]);
    }
    return;
  }
  b -= dx_blocks;                   // operand sums, in row-block order
  const long long e = (long long)b * kThreads + tid;
  if (e >= (long long)r.n_ops * N) return;
  const int k = (int)(e / N), col = (int)(e % N);
  if (r.full[k]) return;
  float sum = 0.f;
  for (int p = 0; p < n_partials; ++p)
    sum += partial[((long long)p * r.n_ops + k) * N + col];
  dvec[(long long)k * N + col] = sum;
}

// ------------------------------------------------------------ launches
int make_recipe(Recipe* r, const int* codes, const float* eps,
                int n_stages, const void* const* ops, void* const* grads,
                const int* op_info, int n_ops) {
  if (n_stages < 0 || n_stages > kMaxStages || n_ops < 0 ||
      n_ops > kMaxOps)
    return (int)cudaErrorInvalidValue;
  r->n = n_stages;
  r->ln = -1;
  for (int s = 0; s < n_stages; ++s) {
    r->kind[s] = codes[4 * s];
    r->approx[s] = codes[4 * s + 1];
    r->op0[s] = codes[4 * s + 2];
    r->op1[s] = codes[4 * s + 3];
    r->eps[s] = eps[s];
    if (r->kind[s] == kLayerNorm) {
      if (r->ln >= 0) return (int)cudaErrorInvalidValue;
      r->ln = s;
    }
  }
  r->n_ops = n_ops;
  for (int k = 0; k < n_ops; ++k) {
    r->ops[k] = ops ? ops[k] : nullptr;
    r->grad[k] = grads ? grads[k] : nullptr;
    r->full[k] = op_info[2 * k];
    r->bf16[k] = op_info[2 * k + 1];
  }
  return 0;
}

size_t span_bytes(const Recipe& r, int N, int rows) {
  const int width = r.ln >= 0 ? N : kBN;
  return (size_t)rows * (width + 4) * sizeof(float);
}

template <typename Kern, typename... Args>
int launch(Kern kern, dim3 grid, size_t smem, cudaStream_t st,
           Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kThreads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// The f32 forward: one block a 128 x 128 tile, a 2-D grid (columns,
// rows); with a layer_norm the N / 128 blocks of a row band form one
// cluster (more than 8 only as a non-portable size, up to 12 at
// MAX_LN_N = 1536).
int launch_fwd_f32(const float* x, const float* w, float* out, int M, int K,
                   int N, const Recipe& r, cudaStream_t st) {
  if (K % f32_tile::kBK) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / f32_tile::kBN, (M + f32_tile::kBM - 1) / f32_tile::kBM);
  if (r.ln < 0) {
    epilogue_fwd_f32_kernel<false><<<grid, f32_tile::kThreads, 0, st>>>(
        x, w, out, M, K, N, r);
    return (int)cudaGetLastError();
  }
  const unsigned cluster = grid.x;
  if (cluster > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        epilogue_fwd_f32_kernel<true>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(f32_tile::kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, epilogue_fwd_f32_kernel<true>, x, w, out, M, K, N, r);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 f32, 1 bf16 (x, w, dy, out, g, dx)
extern "C" int ptt_epilogue_fwd(const void* x, const void* w, void* out,
                                int M, int K, int N, const int* codes,
                                const float* eps, int n_stages,
                                const void* const* ops, const int* op_info,
                                int n_ops, int dtype, void* stream) {
  Recipe r;
  int rc = make_recipe(&r, codes, eps, n_stages, ops, nullptr, op_info,
                       n_ops);
  if (rc) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd_f32(static_cast<const float*>(x),
                          static_cast<const float*>(w),
                          static_cast<float*>(out), M, K, N, r, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  if (r.ln >= 0)
    return launch(epilogue_fwd_kernel<__nv_bfloat16, kBM>,
                  dim3((M + kBM - 1) / kBM, 1),
                  tile_bytes<kBM>() + span_bytes(r, N, kBM), st, xb, wb, ob,
                  M, K, N, r);
  return launch(epilogue_fwd_kernel<__nv_bfloat16, kGM>,
                dim3((M + kGM - 1) / kGM, N / kBN),
                tile_bytes<kGM>() + span_bytes(r, N, kGM), st, xb, wb, ob, M,
                K, N, r);
}

// partial: [ceil(M / 32) * 2][n_ops][N] f32 (see ptt_epilogue_partials)
extern "C" int ptt_epilogue_bwd(const void* x, const void* w, const void* dy,
                                void* g, float* partial, int M, int K, int N,
                                const int* codes, const float* eps,
                                int n_stages, const void* const* ops,
                                void* const* grads, const int* op_info,
                                int n_ops, int dtype, void* stream) {
  Recipe r;
  int rc = make_recipe(&r, codes, eps, n_stages, ops, grads, op_info,
                       n_ops);
  if (rc) return rc;
  const dim3 grid((M + kBM - 1) / kBM, r.ln >= 0 ? 1 : N / kBN);
  const size_t smem = tile_bytes<kBM>() + span_bytes(r, N, kBM) +
                      4 * kBM * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(epilogue_bwd_kernel<float>, grid, smem, st,
                  static_cast<const float*>(x), static_cast<const float*>(w),
                  static_cast<const float*>(dy), static_cast<float*>(g),
                  partial, M, K, N, r);
  if (dtype == 1)
    return launch(epilogue_bwd_kernel<__nv_bfloat16>, grid, smem, st,
                  static_cast<const __nv_bfloat16*>(x),
                  static_cast<const __nv_bfloat16*>(w),
                  static_cast<const __nv_bfloat16*>(dy),
                  static_cast<__nv_bfloat16*>(g), partial, M, K, N, r);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ptt_epilogue_grads(const void* x, const void* w,
                                  const void* g, void* dx, float* dw,
                                  const float* partial, float* dvec, int M,
                                  int K, int N, const int* op_info, int n_ops,
                                  int dtype, void* stream) {
  Recipe r;
  int rc = make_recipe(&r, nullptr, nullptr, 0, nullptr, nullptr, op_info,
                       n_ops);
  if (rc) return rc;
  const int n_partials = (M + kBM - 1) / kBM * kRowGroups;
  const int dw_blocks = (K + kGM - 1) / kGM * (N / kBN);
  const int dx_blocks = (M + kGM - 1) / kGM * ((K + kBN - 1) / kBN);
  const int sum_blocks = (int)(((long long)n_ops * N + kThreads - 1) /
                               kThreads);
  const size_t smem = tile_bytes<kGM>() + (size_t)kGM * (kBN + 4) *
                      sizeof(float);
  const dim3 grid(dw_blocks + dx_blocks + sum_blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(epilogue_grads_kernel<float>, grid, smem, st,
                  static_cast<const float*>(x), static_cast<const float*>(w),
                  static_cast<const float*>(g), static_cast<float*>(dx), dw,
                  partial, dvec, M, K, N, n_partials, dw_blocks, dx_blocks,
                  r);
  if (dtype == 1)
    return launch(epilogue_grads_kernel<__nv_bfloat16>, grid, smem, st,
                  static_cast<const __nv_bfloat16*>(x),
                  static_cast<const __nv_bfloat16*>(w),
                  static_cast<const __nv_bfloat16*>(g),
                  static_cast<__nv_bfloat16*>(dx), dw, partial, dvec, M, K,
                  N, n_partials, dw_blocks, dx_blocks, r);
  return (int)cudaErrorInvalidValue;
}
