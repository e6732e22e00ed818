// moe_dispatch: the MoE channel's dispatch. Each top-k assignment's slot in
// its expert's capacity buffer (the count of earlier assignments to the same
// expert in its batch row, token-major then k), and each kept token row
// copied into its slot of the (B, E, C, d) buffers.
//
// Replaces: no TPU kernel. The JAX package (src/repro/models/moe.py:moe_ffn)
// leaves the one-hot count and the scatter to XLA. The port's plain version
// (kernels/moe_dispatch/ref.py) is PyTorch's int64 one-hot cumsum, an outer-
// dimension scan over S*K rows of E columns, and an accumulating index_put_
// of a materialised (B, S, K, d) tensor into zeros; on the H100 the two took
// about 7.5 ms a layer at OLMoE's 3,328-token prefill.
//
// Bound on the H100: bytes. The token rows are read once (a token's K reads
// are one warp's, from registers) and every byte of the buffers is written
// once: at that prefill 13.6 MB in and 136 MB out, ~45 us at 3.35 TB/s.
//
// Design: two launches on the caller's stream, with int32 scratch the
// wrapper allocates and no atomics to device memory. A tile is tile_tokens
// consecutive tokens of a row with all K assignments of each.
//  1. moe_dispatch_count_kernel, grid (tiles, B): counts its tile's
//     assignments per expert in shared memory and writes the counts to the
//     scratch (B, tiles, E).
//  2. moe_dispatch_scatter_kernel, grid (tiles, B):
//     a. sums the counts of the earlier tiles (its slots' base per expert)
//        and of all tiles (each expert's total) from the scratch;
//     b. ranks its assignments in order, one a thread and 256 a pass:
//        __match_any_sync on the expert gives a warp's lanes with the same
//        expert, a lane's rank among them is the popcount of the lower ones,
//        and per-warp counts in shared memory are added in warp order; it
//        writes pos_c (clamped to C-1) and keep;
//     c. copies each token row once into registers and stores it into the
//        slot of each of its kept assignments, a warp a token, in the widest
//        vectors (16, 8, 4 or 2 bytes) the row's bytes and pointers allow;
//     d. zeroes its share of the slots no assignment reached ([total, C) of
//        each expert, split evenly over the row's tiles).
//  So every byte of the buffers is written exactly once and the wrapper
//  allocates them with torch.empty. A dropped assignment writes nothing
//  where the plain version adds x*0 at slot C-1: the buffers are equal
//  wherever x is finite. It works on bytes, so one kernel serves bf16, fp16
//  and fp32; top_i is read as the int64 top-k returns, in its own strides.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxExperts = 512;
constexpr int kUnroll = 8;  // vectors a lane holds of a row: 4 KB a warp at 16 bytes

// The expert of row b's assignment a (token a / K, choice a % K). top_i's
// entries must lie in [0, E): top-k's indices do, and the kernel does not
// check them.
__device__ __forceinline__ int expert_of(const long long* __restrict__ top_i, long long b,
                                         long long a, int K, long long sb, long long ss,
                                         long long sk) {
  const long long s = a / K;
  return (int)top_i[b * sb + s * ss + (a - s * K) * sk];
}

__global__ void __launch_bounds__(kThreads)
moe_dispatch_count_kernel(const long long* __restrict__ top_i, int* __restrict__ counts,
                          int S, int K, int E, int tile_tokens, long long sb, long long ss,
                          long long sk) {
  __shared__ int cnt[kMaxExperts];
  const int t = blockIdx.x, b = blockIdx.y, lane = threadIdx.x & 31;
  for (int e = threadIdx.x; e < E; e += kThreads) cnt[e] = 0;
  __syncthreads();
  const long long a0 = (long long)t * tile_tokens * K;
  const long long a1 = min((long long)(t + 1) * tile_tokens, (long long)S) * K;
  for (long long p = a0; p < a1; p += kThreads) {  // the same trip count in every lane
    const long long a = p + threadIdx.x;
    const int e = a < a1 ? expert_of(top_i, b, a, K, sb, ss, sk) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    if (e >= 0 && __ffs(peers) - 1 == lane) atomicAdd(&cnt[e], __popc(peers));
  }
  __syncthreads();
  int* out = counts + ((long long)b * gridDim.x + t) * E;
  for (int e = threadIdx.x; e < E; e += kThreads) out[e] = cnt[e];
}

__device__ __forceinline__ bool kept(const unsigned char* keep, long long i, int elem_bytes) {
  return elem_bytes == 2 ? reinterpret_cast<const unsigned short*>(keep)[i] != 0
                         : reinterpret_cast<const unsigned*>(keep)[i] != 0u;
}

template <typename Vec>
__global__ void __launch_bounds__(kThreads)
moe_dispatch_scatter_kernel(const unsigned char* __restrict__ x,
                            const long long* __restrict__ top_i,
                            const int* __restrict__ counts, unsigned char* __restrict__ buffers,
                            long long* __restrict__ pos_c, unsigned char* __restrict__ keep,
                            int S, int K, int E, int C, int tile_tokens, int elem_bytes,
                            unsigned keep_one, long long row_bytes, long long sb, long long ss,
                            long long sk) {
  __shared__ int base[kMaxExperts];             // slots taken before the current pass
  __shared__ int total[kMaxExperts];            // the row's assignments to each expert
  __shared__ int warp_cnt[kWarps][kMaxExperts]; // this pass's, by warp; zero between passes
  __shared__ long long empty_at[kMaxExperts + 1];  // exclusive count of empty slots
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x, T = gridDim.x, b = blockIdx.y;

  // a. slot bases and totals
  for (int e = tid; e < E; e += kThreads) base[e] = total[e] = 0;
  for (int i = tid; i < kWarps * kMaxExperts; i += kThreads) (&warp_cnt[0][0])[i] = 0;
  __syncthreads();
  const int* rc = counts + (long long)b * T * E;
  for (long long i = tid; i < (long long)T * E; i += kThreads) {
    const int c = rc[i];
    if (c) {
      const long long tt = i / E;
      const int e = (int)(i - tt * E);
      atomicAdd(&total[e], c);
      if (tt < t) atomicAdd(&base[e], c);
    }
  }
  __syncthreads();

  // b. ranks in token-major, then k, order
  const long long a0 = (long long)t * tile_tokens * K;
  const long long a1 = min((long long)(t + 1) * tile_tokens, (long long)S) * K;
  const long long row_a = (long long)b * S * K;  // pos_c and keep are (B, S, K), contiguous
  const unsigned lower = (1u << lane) - 1u;
  for (long long p = a0; p < a1; p += kThreads) {
    const long long a = p + tid;
    const bool valid = a < a1;
    const int e = valid ? expert_of(top_i, b, a, K, sb, ss, sk) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    const bool leader = valid && __ffs(peers) - 1 == lane;
    if (leader) warp_cnt[warp][e] = __popc(peers);
    __syncthreads();
    if (valid) {
      int slot = base[e] + __popc(peers & lower);
      for (int w = 0; w < warp; ++w) slot += warp_cnt[w][e];
      pos_c[row_a + a] = slot < C ? slot : C - 1;
      const unsigned k = slot < C ? keep_one : 0u;
      if (elem_bytes == 2)
        reinterpret_cast<unsigned short*>(keep)[row_a + a] = (unsigned short)k;
      else
        reinterpret_cast<unsigned*>(keep)[row_a + a] = k;
    }
    __syncthreads();
    if (leader) {
      atomicAdd(&base[e], __popc(peers));
      warp_cnt[warp][e] = 0;
    }
    __syncthreads();
  }

  // c. each token row into the slots of its kept assignments
  const long long nvec = row_bytes / (long long)sizeof(Vec);
  const Vec* xb = reinterpret_cast<const Vec*>(x) + (long long)b * S * nvec;
  Vec* buf = reinterpret_cast<Vec*>(buffers) + (long long)b * E * C * nvec;
  const int s0 = t * tile_tokens, s1 = min(s0 + tile_tokens, S);
  for (int s = s0 + warp; s < s1; s += kWarps) {
    const Vec* src = xb + (long long)s * nvec;
    for (long long v0 = 0; v0 < nvec; v0 += 32 * kUnroll) {
      Vec r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = v0 + u * 32 + lane;
        if (i < nvec) r[u] = src[i];
      }
      for (int k0 = 0; k0 < K; k0 += 32) {
        long long dst = -1;  // the slot's row in this batch row's buffers, or -1: dropped
        if (k0 + lane < K) {
          const long long a = (long long)s * K + k0 + lane;
          if (kept(keep, row_a + a, elem_bytes))
            dst = (long long)expert_of(top_i, b, a, K, sb, ss, sk) * C + pos_c[row_a + a];
        }
        const int n = min(32, K - k0);
        for (int j = 0; j < n; ++j) {
          const long long d = __shfl_sync(0xffffffffu, dst, j);
          if (d < 0) continue;
          Vec* out = buf + d * nvec;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const long long i = v0 + u * 32 + lane;
            if (i < nvec) out[i] = r[u];
          }
        }
      }
    }
  }

  // d. this tile's share of the empty slots
  if (warp == 0) {
    const int per = (E + 31) / 32;
    const int e0 = min(lane * per, E), e1 = min(e0 + per, E);
    long long run = 0;
    for (int e = e0; e < e1; ++e) run += max(0, C - total[e]);
    long long incl = run;
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    long long at = incl - run;
    for (int e = e0; e < e1; ++e) {
      empty_at[e] = at;
      at += max(0, C - total[e]);
    }
    if (lane == 31) empty_at[E] = incl;
  }
  __syncthreads();
  const long long Z = empty_at[E];
  const long long z1 = Z * (t + 1) / T;
  const Vec zero = Vec();
  for (long long z = Z * t / T + warp; z < z1; z += kWarps) {
    int lo = 0, hi = E - 1;  // the last expert whose run of empty slots starts at or before z
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (empty_at[mid] <= z) lo = mid; else hi = mid - 1;
    }
    Vec* out = buf + ((long long)lo * C + total[lo] + (z - empty_at[lo])) * nvec;
    for (long long i = lane; i < nvec; i += 32) out[i] = zero;
  }
}

template <typename Vec>
cudaError_t scatter(dim3 grid, cudaStream_t stream, const void* x, const void* top_i,
                    const void* counts, void* buffers, void* pos_c, void* keep, int S, int K,
                    int E, int C, int tile_tokens, int elem_bytes, unsigned keep_one,
                    long long row_bytes, long long sb, long long ss, long long sk) {
  moe_dispatch_scatter_kernel<Vec><<<grid, kThreads, 0, stream>>>(
      (const unsigned char*)x, (const long long*)top_i, (const int*)counts,
      (unsigned char*)buffers, (long long*)pos_c, (unsigned char*)keep, S, K, E, C,
      tile_tokens, elem_bytes, keep_one, row_bytes, sb, ss, sk);
  return cudaGetLastError();
}

}  // namespace

// x (B, S, d) contiguous; top_i (B, S, K) int64 in strides (sb, ss, sk) of
// elements; buffers (B, E, C, d) in x's dtype, pos_c (B, S, K) int64 and keep
// (B, S, K) in x's dtype, all contiguous and written whole; counts (B, n_tiles,
// E) int32 scratch. keep_one is the bits of 1 in x's dtype (elem_bytes 2 or 4).
extern "C" int moe_dispatch_launch(const void* x, const void* top_i, void* buffers,
                                   void* pos_c, void* keep, void* counts, int B, int S, int K,
                                   int E, int C, int tile_tokens, int n_tiles, int elem_bytes,
                                   int keep_one, long long row_bytes, long long sb,
                                   long long ss, long long sk, void* stream) {
  if (E < 1 || E > kMaxExperts || C < 1 || K < 1 || tile_tokens < 1 || n_tiles < 1 ||
      B < 1 || B > 65535 || (long long)n_tiles * tile_tokens < S ||
      (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)n_tiles, (unsigned)B);
  moe_dispatch_count_kernel<<<grid, kThreads, 0, st>>>(
      (const long long*)top_i, (int*)counts, S, K, E, tile_tokens, sb, ss, sk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(buffers) | (uintptr_t)row_bytes;
  const unsigned one = (unsigned)keep_one;
  if (align % 16 == 0)
    err = scatter<uint4>(grid, st, x, top_i, counts, buffers, pos_c, keep, S, K, E, C,
                         tile_tokens, elem_bytes, one, row_bytes, sb, ss, sk);
  else if (align % 8 == 0)
    err = scatter<uint2>(grid, st, x, top_i, counts, buffers, pos_c, keep, S, K, E, C,
                         tile_tokens, elem_bytes, one, row_bytes, sb, ss, sk);
  else if (align % 4 == 0)
    err = scatter<unsigned>(grid, st, x, top_i, counts, buffers, pos_c, keep, S, K, E, C,
                            tile_tokens, elem_bytes, one, row_bytes, sb, ss, sk);
  else
    err = scatter<unsigned short>(grid, st, x, top_i, counts, buffers, pos_c, keep, S, K, E,
                                  C, tile_tokens, elem_bytes, one, row_bytes, sb, ss, sk);
  return (int)err;
}
