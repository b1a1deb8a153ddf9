// The f32 mainloop of a 128 x 128 output tile on the CUDA cores, shared
// by K6's f32 kernel (chunk_matmul.cu) and K2f's f32 forward
// (fused_epilogue.cu), so the two sum every output element in the same
// order, bit for bit.
//
//   acc = x[m0 : m0 + 128, :] . w[:, n0 : n0 + 128], in exact f32 (no
//   TF32): each element is one FMA chain over k = 0, 1, ..., K-1 into
//   one register, starting from 0.
//
// One block of 256 threads.  Each step takes 8 values of depth: the x
// tile (transposed, [k][m]) and the w tile ([k][n]) go through shared
// memory, double-buffered, the next step's float4s loaded into registers
// while the current step is multiplied, one barrier a step.  Thread
// (ty, tx) = (tid / 16, tid % 16) owns 8 x 8 outputs, rows row_of(ty, i)
// and columns 4 tx + 0..3 and 64 + 4 tx + 0..3: two halves of 4 each
// way, so the float4 reads from shared memory are free of bank
// conflicts; 64 FMAs per 16 values read.
//
// Requirements (the callers' wrappers check them): K a multiple of 8 (no
// tail: every step is whole), rows of x and w 16-byte aligned (ldx, ldw
// multiples of 4), n0 + 128 <= the columns of w.  Rows past M read as 0.
#pragma once

#include <cuda_runtime.h>

namespace {
namespace f32_tile {

constexpr int kThreads = 256;
constexpr int kBM = 128;   // rows of the tile
constexpr int kBN = 128;   // columns of the tile
constexpr int kBK = 8;     // depth of a step

__device__ __forceinline__ int row_of(int ty, int i) {
  return i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4;
}

// The tiles are the calling kernel's own static shared memory (16 KB),
// declared here so that every access is a plain shared-memory access.
__device__ __forceinline__ void mainloop(const float* __restrict__ x,
                                         const float* __restrict__ w, int M,
                                         int K, long long ldx, long long ldw,
                                         int m0, int n0,
                                         float (&acc)[8][8]) {
  __shared__ __align__(16) float As[2][kBK][kBM];   // x tile, [k][m]
  __shared__ __align__(16) float Bs[2][kBK][kBN];   // w tile, [k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
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
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int nk = K / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      const int k0 = (kt + 1) * kBK;
      ra = arow ? *reinterpret_cast<const float4*>(xp + k0) : zero4;
      rb = *reinterpret_cast<const float4*>(wp + (long long)k0 * ldw);
    }
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
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
}

}  // namespace f32_tile
}  // namespace
