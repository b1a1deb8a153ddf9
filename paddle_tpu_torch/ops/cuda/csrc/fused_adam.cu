// Fused Adam for Hopper (sm_90a): one multi-tensor launch a step.
//
// Replaces the TPU kernel of paddle_tpu/ops/pallas/fused_adam.py:
//   fused_adam_update (body _adam_kernel)  -> adam_kernel
//
//   for every (p, g, m, v) of the table, elementwise in f32, in place:
//     m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g
//     p = p - lr (m / bc1) / (sqrt(v / bc2) + eps)
//   with bc = 1 - exp(step * log b): the TPU kernel's form, so the
//   trajectory follows paddle_tpu's; lr and step are read from device
//   memory (no per-step upload).
//
// The anomaly sentry's skip flag: an optional device int.  When it is
// not 0, every block returns before it writes anything, so a flagged
// step leaves p, m and v bitwise as they were (the TPU step selects
// the old arrays after the update; an in-place update cannot, and a
// copy of the whole state first would move the state twice over).  The
// flag is read on the device, so the host never waits for it.
//
// Bound on this card: bytes.  Each element reads p, g, m, v and writes
// p, m, v: 28 bytes and ~15 operations, so the whole BERT-base update
// (131,966,778 parameters) is 3.70 GB, 1.10 ms at 3.35 TB/s.
// What the design does about it:
//   * one launch for all tensors: a device table of (p, g, m, v, n)
//     rows, built once per compiled step, and a per-block map to
//     (tensor, first element) in 32768-element chunks;
//   * 16-byte vector loads and stores where all four pointers are
//     16-byte aligned and the chunk is whole, scalar elsewhere;
//   * every element read once and written once, nothing else moved.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 32768;

struct Entry {           // one row of the table: six 64-bit fields
  float* p;
  const float* g;
  float* m;
  float* v;
  long long n;
  long long vec;         // 1: all four pointers 16-byte aligned
};

struct Consts {
  float b1, b2, one_m_b1, one_m_b2, log_b1, log_b2, eps;
};

__device__ __forceinline__ void adam1(float& p, float g, float& m, float& v,
                                      float lr, float bc1, float bc2,
                                      const Consts& c) {
  m = c.b1 * m + c.one_m_b1 * g;
  v = c.b2 * v + c.one_m_b2 * g * g;
  const float mhat = m / bc1;
  const float vhat = v / bc2;
  p = p - lr * mhat / (sqrtf(vhat) + c.eps);
}

__global__ void __launch_bounds__(kThreads)
    adam_kernel(const Entry* __restrict__ table,
                const int* __restrict__ blk_entry,
                const long long* __restrict__ blk_start,
                const float* __restrict__ lr_p,
                const float* __restrict__ step_p,
                const int* __restrict__ skip_p, Consts c) {
  if (skip_p != nullptr && *skip_p != 0) return;
  const Entry e = table[blk_entry[blockIdx.x]];
  const long long start = blk_start[blockIdx.x];
  const long long end = min(start + kChunk, e.n);
  const float lr = *lr_p, step = *step_p;
  const float bc1 = 1.f - expf(step * c.log_b1);
  const float bc2 = 1.f - expf(step * c.log_b2);
  if (e.vec && ((end - start) & 3) == 0) {
    for (long long i = start + 4 * threadIdx.x; i < end;
         i += 4 * kThreads) {
      float4 p = *reinterpret_cast<const float4*>(e.p + i);
      const float4 g = *reinterpret_cast<const float4*>(e.g + i);
      float4 m = *reinterpret_cast<const float4*>(e.m + i);
      float4 v = *reinterpret_cast<const float4*>(e.v + i);
      adam1(p.x, g.x, m.x, v.x, lr, bc1, bc2, c);
      adam1(p.y, g.y, m.y, v.y, lr, bc1, bc2, c);
      adam1(p.z, g.z, m.z, v.z, lr, bc1, bc2, c);
      adam1(p.w, g.w, m.w, v.w, lr, bc1, bc2, c);
      *reinterpret_cast<float4*>(e.p + i) = p;
      *reinterpret_cast<float4*>(e.m + i) = m;
      *reinterpret_cast<float4*>(e.v + i) = v;
    }
    return;
  }
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    float p = e.p[i], m = e.m[i], v = e.v[i];
    adam1(p, e.g[i], m, v, lr, bc1, bc2, c);
    e.p[i] = p;
    e.m[i] = m;
    e.v[i] = v;
  }
}

}  // namespace

extern "C" long long ptt_adam_chunk() { return kChunk; }

// table: [n_entries] Entry rows; blk_entry / blk_start: [n_blocks];
// skip: the sentry's device flag, or null
extern "C" int ptt_fused_adam(const void* table, const int* blk_entry,
                              const long long* blk_start, int n_blocks,
                              const float* lr, const float* step,
                              const int* skip, float b1,
                              float b2, float one_m_b1, float one_m_b2,
                              float log_b1, float log_b2, float eps,
                              void* stream) {
  if (n_blocks <= 0) return 0;
  const Consts c{b1, b2, one_m_b1, one_m_b2, log_b1, log_b2, eps};
  adam_kernel<<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Entry*>(table), blk_entry, blk_start, lr, step,
      skip, c);
  return (int)cudaGetLastError();
}
