// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py:
// _decode_kernel (entry paged_attention_decode).  One query token per
// sequence slot attends over that slot's KV cache, which lives in
// fixed-size pages of a shared pool and is reached through the slot's
// page table:
//
//   q        [S, H, D]               (T = float or bf16)
//   k/v pool [N, page, Hkv, D]        (one layer; the wrapper offsets
//                                      the pointer into a stacked
//                                      [L, N, page, Hkv, D] pool)
//   table    [S, P] int32, lengths [S] int32
//   out      [S, H, D] = softmax(q.K^T * scale over t < len) . V
//
// Bound: HBM bytes.  Each slot reads len x Hkv x D x 2 x sizeof(T) of
// K/V per layer and does 4 flops per K/V element it reads, far below
// the card's ~20 flops/byte ridge for f32 CUDA-core math.  What keeps a
// kernel from that bound is latency: too few bytes in flight, and the
// longest slot walked by one block.  What the design does about it:
//   * a slot may be split over C <= 8 blocks (the wrapper picks C once
//     per engine shape (S, H, Hkv, D, dtype) and card: the most that
//     keep the whole grid resident, never from the table width).  Each
//     block reads lengths[s] and table[s, p] itself and takes a
//     contiguous share of the slot's live pages, ceil(ceil(len / page) /
//     C) of them and at least kMinTokens' worth, so the longest slot is
//     walked by up to C blocks and no block touches a page past the live
//     length.  A slot's result depends on its own length, the page and
//     C only: never on the other slots or on the table width;
//   * the grid is (R, Hkv, S), and the R blocks of one (KV head, slot)
//     form a thread-block cluster: R = min(C, ceil(P / pages of
//     kMinTokens)), as many as a slot of the table's P pages can have
//     shares, so a narrow table launches no idle blocks (R = 1, no
//     cluster, at P <= 2 pages of 16).  Ranks past a slot's shares stay
//     idle;
//   * each warp owns U consecutive tokens a step and keeps the next
//     step's K and V rows in flight (a two-deep ring of registers) while
//     it runs the online softmax on this step's: 16-byte vector loads,
//     a row per warp, neighbouring lanes on neighbouring addresses;
//   * the G = H / Hkv query rows of the group, the running max and sum
//     and the f32 accumulator acc[G][D] stay in registers, so a K/V
//     row is read from HBM once and serves all G query heads (GQA);
//   * the warps of a block combine their partial (m, l, acc) through
//     shared memory; with C > 1 each block leaves its combined partial
//     in its shared memory, and after a cluster barrier rank 0 reads the
//     C partials over distributed shared memory in rank order, merges
//     them and writes the output.  No scratch tensor, no second launch,
//     no atomics: every output is summed in a fixed order, so two runs
//     agree bit for bit.  The result is acc / max(l, 1e-30), so a slot
//     with length 0 writes zeros, as the TPU kernel does.
// Accumulation is always f32, for f32 and bf16 pools.  A page id
// outside [0, N) makes the slot's output NaN instead of reading out of
// bounds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxCluster = 8;             // the portable cluster size
constexpr int kMinTokens = 32;             // a share holds at least these

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, float (&dst)[N]) {
  const Pack<T, N> pk = *reinterpret_cast<const Pack<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = to_f32(pk.v[i]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// U tokens' K and V rows of one warp as loaded (converted to f32 only
// where they are used, so the loads stay in flight), and which are live
template <typename T, int U, int V>
struct Rows {
  Pack<T, V> k[U], v[U];
  bool live[U];
};

// start the loads of tokens [t0, t0 + U) below t_end (t0 < t_end); a
// page id outside [0, num_pages) sets `bad` and leaves its token dead.
// One division a step: the tokens walk the page from t0's offset.
template <typename T, int U, int V>
__device__ __forceinline__ void fetch(Rows<T, U, V>& r, const T* k_pool,
                                      const T* v_pool, const int* trow,
                                      int t0, int t_end, int page,
                                      int num_pages, size_t page_stride,
                                      size_t tok_stride, size_t col,
                                      int& bad) {
  int pi = t0 / page, o = t0 - pi * page;
  int pid = trow[pi];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    r.live[u] = false;
    if (t0 + u < t_end) {
      if (o == page) {                 // the next page
        o = 0;
        pid = trow[++pi];
      }
      if (pid < 0 || pid >= num_pages) {
        bad = 1;
      } else {
        const size_t off = (size_t)pid * page_stride +
                           (size_t)o * tok_stride + col;
        r.k[u] = *reinterpret_cast<const Pack<T, V>*>(k_pool + off);
        r.v[u] = *reinterpret_cast<const Pack<T, V>*>(v_pool + off);
        r.live[u] = true;
      }
      ++o;
    }
  }
}

// the online softmax over one step's live tokens, in token order
template <int G, typename T, int U, int V>
__device__ __forceinline__ void consume(const Rows<T, U, V>& r,
                                        const float (&qr)[G][V],
                                        float (&m)[G], float (&l)[G],
                                        float (&acc)[G][V]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (!r.live[u]) continue;          // uniform across the warp
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sc = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) sc += qr[g][i] * to_f32(r.k[u].v[i]);
      sc = warp_sum(sc);
      const float mn = fmaxf(m[g], sc);
      const float alpha = expf(m[g] - mn);
      const float p = expf(sc - mn);
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int i = 0; i < V; ++i)
        acc[g][i] = acc[g][i] * alpha + p * to_f32(r.v[u].v[i]);
      m[g] = mn;
    }
  }
}

// tokens a warp loads a step, by the floats a lane holds for one row
// across the group (G * D / 32): fewer where q and acc take more
// registers
template <int GV>
constexpr int kTokens = GV > 16 ? 1 : 2;

// blocks an SM the registers must leave room for: at GV <= 4 (one query
// row a KV head at D <= 128) four, so a grid four times the SMs' count
// runs in one wave
template <int GV>
constexpr int kMinBlocks = GV <= 4 ? 4 : 1;

template <typename T, int D, int G, int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32, kMinBlocks<G * D / 32>)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int P, int page, int hkv, int num_pages, float scale,
                    int C) {
  constexpr int V = D / 32;                  // row elements per lane
  constexpr int U = kTokens<G * V>;          // tokens per warp per step
  const int rank = blockIdx.x;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int H = hkv * G;
  const int len = max(0, min(lengths[s], P * page));
  // this block's share of the live pages, in tokens, and how many ranks
  // have one (rank 0 always: it writes the output); at most R, as the
  // launch makes sure.  One block a slot (R = 1) takes the whole slot,
  // as the one share of a split would.
  int shares = 1, share = len;
  if (gridDim.x > 1) {
    const int pg = max(page, 1);        // (an empty pool: len is 0)
    const int live_pages = (len + pg - 1) / pg;
    const int share_pages = max((live_pages + C - 1) / C,
                                (kMinTokens + pg - 1) / pg);
    shares = max(1, (live_pages + share_pages - 1) / share_pages);
    if (rank >= shares) {              // idle: only keep the barriers
      if (shares > 1) {
        cooperative_groups::this_cluster().sync();
        cooperative_groups::this_cluster().sync();
      }
      return;
    }
    share = share_pages * page;
  }
  const int t_begin = rank * share;
  const int t_end = min(len, t_begin + share);
  const int* trow = table + (size_t)s * P;
  const size_t tok_stride = (size_t)hkv * D;
  const size_t page_stride = (size_t)page * tok_stride;
  const size_t col = (size_t)h * D + (size_t)lane * V;

  float qr[G][V];
  float m[G], l[G], acc[G][V];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_row<T, V>(q + ((size_t)s * H + (size_t)h * G + g) * D +
                       (size_t)lane * V, qr[g]);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      qr[g][i] *= scale;
      acc[g][i] = 0.f;
    }
    m[g] = kNeg;
    l[g] = 0.f;
  }

  // steps t0, t0 + stride, ... alternate between two sets of registers:
  // the next step's loads are in flight while this step is consumed
  int bad = 0;
  const int stride = NWARPS * U;
  int t0 = t_begin + warp * U;
  if (t0 < t_end) {
    Rows<T, U, V> a, b;
    fetch<T>(a, k_pool, v_pool, trow, t0, t_end, page, num_pages,
             page_stride, tok_stride, col, bad);
    for (;;) {
      const int t1 = t0 + stride;
      if (t1 < t_end)
        fetch<T>(b, k_pool, v_pool, trow, t1, t_end, page, num_pages,
                 page_stride, tok_stride, col, bad);
      consume<G>(a, qr, m, l, acc);
      if (t1 >= t_end) break;
      const int t2 = t1 + stride;
      if (t2 < t_end)
        fetch<T>(a, k_pool, v_pool, trow, t2, t_end, page, num_pages,
                 page_stride, tok_stride, col, bad);
      consume<G>(b, qr, m, l, acc);
      if (t2 >= t_end) break;
      t0 = t2;
    }
  }

  // the warps' partials, combined per query row; with one share a slot
  // the result goes out, else into this block's partial for rank 0
  bad = __syncthreads_or(bad);
  __shared__ float sm_m[NWARPS];
  __shared__ float sm_l[NWARPS];
  __shared__ float sm_acc[NWARPS][D];
  __shared__ float part_m[G], part_l[G];
  __shared__ __align__(16) float part_acc[G][D];
  __shared__ int part_bad;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp] = m[g];
      sm_l[warp] = l[g];
    }
#pragma unroll
    for (int i = 0; i < V; ++i) sm_acc[warp][lane * V + i] = acc[g][i];
    __syncthreads();
    for (int d = threadIdx.x; d < D; d += NWARPS * 32) {
      float mx = kNeg;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, sm_m[w]);
      float lsum = 0.f, o = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) {
        const float e = expf(sm_m[w] - mx);
        lsum += sm_l[w] * e;
        o += sm_acc[w][d] * e;
      }
      if (shares == 1) {
        const float r = bad ? __int_as_float(0x7fc00000)
                            : o / fmaxf(lsum, 1e-30f);
        store(out + ((size_t)s * H + (size_t)h * G + g) * D + d, r);
      } else {
        part_acc[g][d] = o;
        if (d == 0) {
          part_m[g] = mx;
          part_l[g] = lsum;
        }
      }
    }
    __syncthreads();
  }
  if (shares == 1) return;

  // rank 0 merges the partials of the ranks with a share, in rank order
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  if (threadIdx.x == 0) part_bad = bad;
  cluster.sync();
  if (rank == 0) {
    int any_bad = 0;
    for (int r = 0; r < shares; ++r)
      any_bad |= *cluster.map_shared_rank(&part_bad, r);
    for (int idx = threadIdx.x; idx < G * D; idx += NWARPS * 32) {
      const int g = idx / D, d = idx % D;
      float mr[kMaxCluster], mx = kNeg;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r >= shares) break;
        mr[r] = *cluster.map_shared_rank(&part_m[g], r);
        mx = fmaxf(mx, mr[r]);
      }
      float lsum = 0.f, o = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r >= shares) break;
        const float e = expf(mr[r] - mx);
        lsum += *cluster.map_shared_rank(&part_l[g], r) * e;
        o += *cluster.map_shared_rank(&part_acc[g][d], r) * e;
      }
      const float res = any_bad ? __int_as_float(0x7fc00000)
                                : o / fmaxf(lsum, 1e-30f);
      store(out + ((size_t)s * H + (size_t)h * G + g) * D + d, res);
    }
  }
  // no block leaves while rank 0 reads its shared memory
  cluster.sync();
}

constexpr int kWarps = 8;

// the blocks launched for a slot split over C: no more than a slot of
// the table's P pages can have shares
inline int cluster_blocks(int C, int P, int page) {
  const int min_pages = (kMinTokens + max(page, 1) - 1) / max(page, 1);
  return max(1, min(C, (P + min_pages - 1) / min_pages));
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const int* table,
           const int* lengths, void* out, int S, int hkv, int P, int page,
           int num_pages, float scale, int C, cudaStream_t stream) {
  const int R = cluster_blocks(C, P, page);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R, hkv, S);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = R > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, paged_decode_kernel<T, D, G, kWarps>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), table, lengths,
      static_cast<T*>(out), P, page, hkv, num_pages, scale, C);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// one (T, D, G) instance, for the dispatch below
template <typename T_, int D_, int G_>
struct Inst {
  using T = T_;
  static constexpr int D = D_, G = G_;
};

// fn(Inst<T, D, G>{}) for the instance (dtype, D, G), or -1 where this
// file has none
template <typename T, int D, typename Fn>
int by_group(int G, Fn&& fn) {
  switch (G) {
    case 1: return fn(Inst<T, D, 1>{});
    case 2: return fn(Inst<T, D, 2>{});
    case 4: return fn(Inst<T, D, 4>{});
    case 8: return fn(Inst<T, D, 8>{});
    default: return -1;
  }
}

template <typename Fn>
int by_instance(int dtype, int D, int G, Fn&& fn) {
  if (dtype != 0 && dtype != 1) return -1;
  const bool f32 = dtype == 0;
  switch (D) {
    case 64: return f32 ? by_group<float, 64>(G, fn)
                        : by_group<__nv_bfloat16, 64>(G, fn);
    case 128: return f32 ? by_group<float, 128>(G, fn)
                         : by_group<__nv_bfloat16, 128>(G, fn);
    case 256: return f32 ? by_group<float, 256>(G, fn)
                         : by_group<__nv_bfloat16, 256>(G, fn);
    default: return -1;
  }
}

}  // namespace

// Plain C entry points, bound from Python with ctypes
// (paddle_tpu_torch/ops/cuda/paged_attention.py).  dtype: 0 = float32,
// 1 = bfloat16; clusters: the blocks C a slot may be split over, 1 to 8
// (the cluster launched is cluster_blocks(C, P, page) of them).
// ptt_paged_decode returns 0, -1 for a (D, G, dtype, C) this file has no
// instance for, or the cudaError_t of the launch.
extern "C" int ptt_paged_decode(const void* q, const void* k_pool,
                                const void* v_pool, const int* table,
                                const int* lengths, void* out, int S, int H,
                                int hkv, int D, int P, int page,
                                int num_pages, float scale, int clusters,
                                int dtype, void* stream) {
  if (hkv < 1 || H % hkv || clusters < 1 || clusters > kMaxCluster)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_instance(dtype, D, H / hkv, [&](auto inst) {
    using I = decltype(inst);
    return launch<typename I::T, I::D, I::G>(
        q, k_pool, v_pool, table, lengths, out, S, hkv, P, page, num_pages,
        scale, clusters, st);
  });
}

// How many clusters of C blocks of the (D, G, dtype) instance the
// current card holds at once (the occupancy calculator: registers,
// shared memory, threads, and where a cluster can be placed), or -1
// where there is no instance, or minus the cudaError_t.  The wrapper
// sizes the clusters from it.
extern "C" int ptt_paged_decode_max_clusters(int D, int G, int dtype,
                                             int C) {
  if (C < 1 || C > kMaxCluster) return -1;
  return by_instance(dtype, D, G, [&](auto inst) {
    using I = decltype(inst);
    const auto kernel = paged_decode_kernel<typename I::T, I::D, I::G,
                                            kWarps>;
    int n = 0;
    cudaError_t e;
    if (C == 1) {                      // no cluster: blocks a card
      int dev = 0, sms = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                        kWarps * 32, 0);
      if (e == cudaSuccess) e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
      n *= sms;
    } else {
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = C;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(C, 1, 1);
      cfg.blockDim = dim3(kWarps * 32);
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      e = cudaOccupancyMaxActiveClusters(
          &n, reinterpret_cast<const void*>(kernel), &cfg);
    }
    return e == cudaSuccess ? n : -(int)e;
  });
}
