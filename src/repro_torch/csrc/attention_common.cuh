// Shared pieces of the CUDA-core attention kernels (K2 decode, K3's fp32
// prefill, K3b's CUDA-core route; K3's and K3b's tensor-core kernels use
// only kNegInf, mean_v, block_coords and allow_smem from here): dtype conversion, warp
// reductions, and the online-softmax update of a few query rows against
// one 32-key tile staged in shared memory.
//
// Layout of a row's state over a warp: lane l keeps output dims l, l+32,
// ... (DPL of them, D <= 32 * DPL); the running max m and denominator l are
// replicated in every lane. Scores are computed one key per lane, all in
// fp32, so the kernels keep fp32 from the loaded inputs to the final
// division.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr float kNegInf = -1e30f;  // the JAX kernels' NEG_INF
constexpr int kTileK = 32;         // keys per tile: one per lane
constexpr int kWarps = 8;          // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeadDim = 256;   // D the kernels take (gemma's 256 is the widest)

// Row strides, in floats, of the staged q rows and K keys. q rows are
// padded with zeros to a multiple of 8 floats, so float4 reads cover them;
// K rows by 4 floats more, so that the 8 lanes of one float4 read phase,
// each on its own key, hit 32 distinct banks.
__host__ __device__ constexpr int q_stride(int D) { return (D + 7) / 8 * 8; }
__host__ __device__ constexpr int k_stride(int D) { return q_stride(D) + 4; }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DPL>
struct RowState {
  float m;
  float l;
  float acc[DPL];
};

template <int DPL>
__device__ __forceinline__ void row_init(RowState<DPL>& st) {
  st.m = kNegInf;
  st.l = 0.f;
#pragma unroll
  for (int i = 0; i < DPL; ++i) st.acc[i] = 0.f;
}

// Stage keys [k0, k0 + kTileK) of one KV head into shared memory as fp32,
// one element at a time (any D and strides): ks with row stride
// k_stride(D) (its pad columns are left as they are: the kernels zero them
// once), vs with row stride D. Keys at or past `k_stop` are zero-filled.
template <typename T>
__device__ __forceinline__ void load_kv_tile(float* ks, float* vs, const T* k, const T* v,
                                             long long kst, long long vst, int k0,
                                             int k_stop, int D) {
  for (int idx = threadIdx.x; idx < kTileK * D; idx += blockDim.x) {
    const int j = idx / D;
    const int d = idx - j * D;
    const int t = k0 + j;
    float kv = 0.f, vv = 0.f;
    if (t < k_stop) {
      kv = to_float(k[t * kst + d]);
      vv = to_float(v[t * vst + d]);
    }
    ks[j * k_stride(D) + d] = kv;
    vs[j * D + d] = vv;
  }
}

constexpr int kMaxChunks = 4;  // 16-byte chunks of K (and V) per thread: fp32 D = 128

// Chunks per thread that hold one 32-key tile of D <= 32 * DPL elements of
// T: kMaxChunks up to D = 128 (K2 fills them with up to 4 tiles of a
// narrower D), and more for an fp32 tile past it (8 at D = 256).
template <typename T, int DPL>
__host__ __device__ constexpr int tile_chunks() {
  return DPL * (int)sizeof(T) / 4 > kMaxChunks ? DPL * (int)sizeof(T) / 4 : kMaxChunks;
}

// One step's keys of K and V (up to NC 16-byte chunks per thread) in
// registers: where D and the row strides are whole 16-byte chunks and
// the bases 16-byte aligned, the fast way to stage keys, and split in two
// so that a kernel can keep the next keys' loads in flight while it uses
// the current ones.
template <int NC>
struct TileRegs {
  uint4 k[NC], v[NC];
};

template <typename T, int NC>
__device__ __forceinline__ void fetch_tile(TileRegs<NC>& t, const T* kb, const T* vb,
                                           long long kst, long long vst, int k0, int k_stop,
                                           int D, int n_keys) {
  constexpr int kVec = 16 / sizeof(T);
  const int cpr = D / kVec;  // chunks per key row
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int idx = threadIdx.x + c * kThreads;
    const int j = idx / cpr;
    const int d0 = (idx - j * cpr) * kVec;
    t.k[c] = t.v[c] = make_uint4(0, 0, 0, 0);
    if (idx < n_keys * cpr && k0 + j < k_stop) {
      t.k[c] = *reinterpret_cast<const uint4*>(kb + (k0 + j) * kst + d0);
      t.v[c] = *reinterpret_cast<const uint4*>(vb + (k0 + j) * vst + d0);
    }
  }
}

// The keys as fp32 in shared memory, laid out as load_kv_tile lays out a
// tile (so key group g's tile starts at key 32 g).
template <typename T, int NC>
__device__ __forceinline__ void store_tile(const TileRegs<NC>& t, float* ks, float* vs, int D,
                                           int n_keys) {
  constexpr int kVec = 16 / sizeof(T);
  const int cpr = D / kVec;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int idx = threadIdx.x + c * kThreads;
    if (idx >= n_keys * cpr) continue;
    const int j = idx / cpr;
    const int d0 = (idx - j * cpr) * kVec;
    const T* ke = reinterpret_cast<const T*>(&t.k[c]);
    const T* ve = reinterpret_cast<const T*>(&t.v[c]);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      ks[j * k_stride(D) + d0 + e] = to_float(ke[e]);
      vs[j * D + d0 + e] = to_float(ve[e]);
    }
  }
}

// Online-softmax update of NR consecutive query rows (at `q`, row stride
// q_stride(D)) with the staged tile. Lane j scores key j, and each K float4
// and V value read from shared memory serves all NR rows. `valid[r]` says
// whether this lane's key is unmasked for row r; masked scores are set to
// kNegInf exactly as the JAX kernels do, so a row whose first tiles are
// wholly masked is reset (alpha = 0) once a valid key arrives. P V runs
// over all kTileK keys: keys past the tile's end are staged as zeros, which
// their p multiplies. `pw` is the warp's NR x 32 floats that hand each
// lane's p to every lane.
template <int DPL, int NR>
__device__ __forceinline__ void rows_tile(RowState<DPL> (&st)[NR], const float* q,
                                          const float* ks, const float* vs, int D,
                                          const bool (&valid)[NR], float scale, int lane,
                                          float* pw) {
  const int qs = q_stride(D);
  const float4* krow = reinterpret_cast<const float4*>(ks + lane * k_stride(D));
  float sa[NR], sb[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) sa[r] = sb[r] = 0.f;
#pragma unroll 4
  for (int c = 0; c < qs / 4; ++c) {
    const float4 kv = krow[c];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float4 qv = reinterpret_cast<const float4*>(q + r * qs)[c];
      sa[r] = fmaf(qv.x, kv.x, fmaf(qv.y, kv.y, sa[r]));
      sb[r] = fmaf(qv.z, kv.z, fmaf(qv.w, kv.w, sb[r]));
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const float s = valid[r] ? (sa[r] + sb[r]) * scale : kNegInf;
    const float m_new = fmaxf(st[r].m, warp_max(s));
    const float alpha = __expf(st[r].m - m_new);
    const float p = __expf(s - m_new);
    st[r].l = st[r].l * alpha + warp_sum(p);
    st[r].m = m_new;
    pw[r * 32 + lane] = p;
#pragma unroll
    for (int i = 0; i < DPL; ++i) st[r].acc[i] *= alpha;
  }
  __syncwarp();
  const float4* p4 = reinterpret_cast<const float4*>(pw);
#pragma unroll
  for (int j4 = 0; j4 < kTileK / 4; ++j4) {
    float4 p[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) p[r] = p4[r * (32 / 4) + j4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          const float vd = vs[(4 * j4 + e) * D + d];
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            const float pe = e == 0 ? p[r].x : e == 1 ? p[r].y : e == 2 ? p[r].z : p[r].w;
            st[r].acc[i] = fmaf(pe, vd, st[r].acc[i]);
          }
        }
      }
    }
  }
  __syncwarp();  // pw is rewritten by the next tile
}

// What the plain versions give a query row that sees no key: softmax over
// uniform -1e30 scores puts 1/T on every one of the T cache rows, so the
// row's output is the mean of V over [0, T), in fp32 (0 when T is 0).
template <typename T>
__device__ __forceinline__ float mean_v(const T* v, long long vst, int Tk, int d) {
  float s = 0.f;
  for (int t = 0; t < Tk; ++t) s += to_float(v[t * vst + d]);
  return Tk > 0 ? s / (float)Tk : 0.f;
}

// Which (q tile, head, batch) block `idx` of K3's bf16 kernel (and of K3b's
// dQ pass) computes: q tiles from the last (the most key tiles under the
// causal mask) to the first; within a q tile batch-major, heads in order,
// so the R heads of one KV head are neighbours and their K/V tiles come
// from L2. kernels/flash_attention/flash_attention.py:block_order is the
// same map.
__device__ __forceinline__ void block_coords(int idx, int n_qt, int H, int B, int& qt,
                                             int& h, int& b) {
  const int per = H * B;
  qt = n_qt - 1 - idx / per;
  const int rem = idx - (idx / per) * per;
  b = rem / H;
  h = rem - b * H;
}

// Raise a kernel's dynamic shared-memory limit when it needs more than the
// default 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace repro
