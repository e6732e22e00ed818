// K3b flash_attention_bwd: the gradient of K3 (flash_attention.cu) with
// respect to q, k and v, given the forward's output O, its gradient dO and
// each row's log-sum-exp (lse, which K3's forward writes). For each query
// row s of head h and key t of its KV head g = h / (H / G), with P[s, t] =
// exp(scale q_s . k_t - lse_s) where the mask lets row s see key t:
//   delta_s = dO_s . O_s
//   dS[s, t] = P[s, t] (dO_s . v_t - delta_s) where visible, else 0
//   dQ_s = scale sum_t dS[s, t] k_t
//   dK_t = scale sum_{s, h in g} dS[s, t] q_s,   dV_t = sum_{s, h in g} P[s, t] dO_s
// A row that sees no key (a position before 0 under the causal mask, or
// past T + window - 1 with a window) has the softmax of T equal masked
// scores, 1/T on every key: its P is 1/T on each of the T keys for dV, as
// the plain version's and JAX's, and its dS is 0, so dQ and dK get
// nothing from it (kernels/flash_attention/ops.py:flash_attention_bwd is
// the same function in PyTorch ops).
//
// Replaces: nothing on the TPU. The JAX package differentiates its
// attention with XLA (src/repro/kernels/flash_attention/ref.py under
// jax.vjp); the Pallas kernel src/repro/kernels/flash_attention/
// flash_attention.py:flash_attention has no backward.
//
// Bound on the H100: bytes. At TinyLlama's train shape (q, dO (8, 512, 32,
// 64), k, v (8, 512, 4, 64), bf16, causal) the gradient reads q, k, v, O
// and dO and writes dq, dk, dv, about 75 MB, 0.0225 ms at 3.35 TB/s; the
// five products of the causal half take 21.5 GFLOP, 0.0218 ms at the bf16
// tensor-core peak. This design runs seven (S and dP twice, once in each
// pass), about 30 GFLOP, 0.030 ms: the price of writing every gradient
// once, with no atomics, so the same inputs give the same bits.
//
// Launches on the caller's stream:
//  1. delta: one warp per (batch, row, head), fp32.
//  2. dK/dV: one block per (key tile, KV head, batch, head slice), blocks
//     of the first key tiles first (under the causal mask they see the
//     most query tiles). Where (key tile, KV head, batch) blocks alone are
//     fewer than kSliceBlocks, a KV group's R query heads are cut into
//     slices (head_slices: the fewest that divide R and reach it), so the
//     card has blocks to balance; each block walks the
//     (query tile, head) pairs of its slice whose rows see a key of the
//     tile, or see no key at all (query_tiles; kernels/flash_attention/
//     flash_attention.py:bwd_query_tiles mirrors it).
//  3. dQ: one block per (query tile, head, batch), walking the key tiles
//     its rows see (key_tiles, as K3's forward walks them).
//  4. With more than one slice: the slices' fp32 dK and dV partials
//     (scratch, written once each) summed in slice order into dk and dv.
//
// Routes, by dtype and D (neither is a fallback):
//
// bf16 at D <= 128, the tensor cores. Tiles of 64 keys and 64 rows, by TMA
// in the 128-byte swizzle where D is a multiple of 64 and the strides suit
// it, by 16-byte cp.async (or element by element) into the same layout
// otherwise, D zero-padded to 64 or 128 (hopper_common.cuh). dK/dV: with
// the key tile as wgmma's M, S^T = K Q^T and dP^T = V dO^T land in the
// accumulator layout, which is wgmma's register A operand, so P^T and dS^T
// = P^T (dP^T - delta) go straight into dV += P^T dO and dK += dS^T Q. W
// warpgroups (3 at D <= 64, 2 at 128) each take a fixed share of the pairs
// (pair j to warpgroup j % W), each with a two-slot ring of (Q, dO) tiles;
// their sums meet in shared memory in a fixed order at the end. A pair's
// mask is tested against each key's range of visible rows, set once a
// block, and skipped where the pair is wholly visible. dQ: a
// warpgroup a block (126 registers and 48 KB, so four blocks share an SM)
// walks the key tiles with a two-slot (K, V) ring: S = Q K^T, dP = dO V^T,
// dQ += dS K. P and dS enter the products as bf16 (one rounding each,
// against 2e-2 of each gradient's max).
//
// fp32 (the fp32 training entry point) and bf16 at D of 129 to 256
// (gemma's 256), the CUDA cores, fp32 inside and no TF32 (it keeps three
// digits; the gate is 1e-4). Register-tiled SIMT products: a block's 256
// threads own a 64-row tile (keys in the dK/dV pass, query rows in the dQ
// pass) and walk tiles of WT rows of the other side (32 to D = 128, 16 past
// it, to fit shared memory), each a two-stage ring that 16-byte cp.async
// fills under the math on the tile before (bf16 is converted on the way:
// loaded into registers ahead, stored as fp32 after the math). Thread (ty,
// tx) keeps a 4 x WT/16 micro-tile of S and dP (its own rows 4ty..4ty+3,
// walked rows tx + 16j): each float4 it reads from shared memory feeds 4 to
// 8 FMAs. P and dS go through shared memory, and the thread keeps 4 rows x
// 4 (D/64) dims of each accumulator (dK and dV, or dQ): two float4 reads a
// walked row feed 16 FMAs a product. Every sum runs in a fixed order on
// both routes.
#include <algorithm>
#include <initializer_list>
#include <type_traits>

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace repro;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;    // (B, H, Sq) fp32, natural log
  float* delta;        // (B, H, Sq) fp32, written by pass 1
  float* part;         // (2, slices, B, Tk, G, D) fp32 dK, dV partials (slices > 1)
  void* dq;
  void* dk;
  void* dv;
  int B, H, G, Sq, Tk, D;
  // element strides (batch, row, head) of q, k, v, o, dO, dq, dk, dv
  long long qsb, qss, qsh, ksb, kst, ksg, vsb, vst, vsg, osb, oss, osh;
  long long dosb, doss, dosh, dqsb, dqss, dqsh, dksb, dkst, dksg, dvsb, dvst, dvsg;
  int causal, window, q_offset;
  float scale;
  int vec;
  int slices;          // head slices of a KV group in the dK/dV pass
};

// Keys [lo, hi] visible to query row s (lo > hi: none).
__device__ __forceinline__ int key_hi(const BwdArgs& A, int s) {
  return A.causal ? min(s + A.q_offset, A.Tk - 1) : A.Tk - 1;
}
__device__ __forceinline__ int key_lo(const BwdArgs& A, int s) {
  return A.window > 0 ? max(0, s + A.q_offset - A.window + 1) : 0;
}

// P and dS of query row s and key t on the CUDA cores, from the scaled
// score, the row's lse (natural log), dP and delta.
__device__ __forceinline__ void p_ds(const BwdArgs& A, int s, int t, float sc, float lse,
                                     float dp, float dlt, float inv_t, float& p, float& ds) {
  const int lo = key_lo(A, s), hi = key_hi(A, s);
  if (s < A.Sq && t >= lo && t <= hi) {
    p = __expf(sc - lse);
    ds = p * (dp - dlt);
  } else {
    p = s < A.Sq && lo > hi && t < A.Tk ? inv_t : 0.f;   // a row that sees no key
    ds = 0.f;
  }
}

// The query tiles (of `tile` rows) the dK/dV pass walks for the keys [k0,
// k0 + kn), as three runs [a, a + n) in order: tiles of rows before
// position 0 (causal: they see no key), tiles of rows that see one of the
// keys, and tiles of rows past the window's reach of the last key (they
// see none). flash_attention.py:bwd_query_tiles is the same rule.
struct QTiles {
  int a0, n0, a1, n1, a2, n2;
  __device__ __forceinline__ int count() const { return n0 + n1 + n2; }
  __device__ __forceinline__ int at(int j) const {
    return j < n0 ? a0 + j : j < n0 + n1 ? a1 + j - n0 : a2 + j - n0 - n1;
  }
};

__device__ __forceinline__ QTiles query_tiles(const BwdArgs& A, int k0, int kn, int tile) {
  const int n_qt = (A.Sq + tile - 1) / tile;
  const int t_hi = min(k0 + kn, A.Tk) - 1;
  const int s_lo = A.causal ? max(0, k0 - A.q_offset) : 0;
  const int s_hi = A.window > 0 ? min(A.Sq - 1, t_hi + A.window - 1 - A.q_offset) : A.Sq - 1;
  const int n_pre = A.causal ? min(A.Sq, max(0, -A.q_offset)) : 0;
  const int s_suf =
      A.window > 0 ? min(A.Sq, max(0, A.Tk + A.window - 1 - A.q_offset)) : A.Sq;
  QTiles r;
  r.a0 = 0;
  r.n0 = (n_pre + tile - 1) / tile;
  int end = r.n0;                               // the first tile not yet taken
  r.a1 = end;
  r.n1 = 0;
  if (s_lo <= s_hi) {
    r.a1 = max(end, s_lo / tile);
    r.n1 = max(0, s_hi / tile + 1 - r.a1);
    if (r.n1 > 0) end = r.a1 + r.n1;
  }
  r.a2 = end;
  r.n2 = 0;
  if (s_suf < A.Sq) {
    r.a2 = max(end, s_suf / tile);
    r.n2 = max(0, n_qt - r.a2);
  }
  return r;
}

// The key tiles [kb, kb + n) (of `tile` keys) the dQ pass walks for the
// rows [q0, q0 + qn), as K3's forward walks them (flash_attention.py:
// bwd_key_tiles).
__device__ __forceinline__ void key_tiles(const BwdArgs& A, int q0, int qn, int tile, int& kb,
                                          int& n) {
  const int p_lo = q0 + A.q_offset;
  const int p_hi = min(q0 + qn, A.Sq) - 1 + A.q_offset;
  int k_end = A.Tk;
  if (A.causal) k_end = min(k_end, p_hi + 1);
  int k_begin = A.window > 0 ? max(0, p_lo - A.window + 1) : 0;
  k_begin = (k_begin / tile) * tile;
  kb = k_begin;
  n = k_end > k_begin ? (k_end - k_begin + tile - 1) / tile : 0;
}

// The dK/dV pass's block `idx`: key tile (first the ones with the most
// query tiles), batch, KV head and head slice.
__device__ __forceinline__ void kv_block(const BwdArgs& A, int idx, int& kt, int& b, int& g,
                                         int& sl) {
  const int per = A.slices * A.G * A.B;
  kt = idx / per;
  const int rem = idx % per;
  b = rem / (A.G * A.slices);
  g = rem / A.slices % A.G;
  sl = rem % A.slices;
}

// Blocks the dK/dV pass aims to give the card: head slices are added until
// the grid holds this many (or every head has its own). On an H100 80GB
// HBM3 at 700 W (kernel_variants.py k3b), targets of 128 and 512 lost to
// 256 on both routes: on the tensor cores at TinyLlama's 8, 4 and 2 x 512
// (256, 128, 64 blocks: 1, 2, 4 slices), on the CUDA cores at launch.train's
// fp32 8 x 128 (64 blocks: 4 slices, 1.9x faster than none).
constexpr int kSliceBlocks = 256;

// The fewest slices, each of R / slices heads, that give at least `target`
// dK/dV blocks.
int head_slices(int kv_blocks, int R, int target) {
  for (int s = 1; s < R; ++s)
    if (R % s == 0 && (long long)kv_blocks * s >= target) return s;
  return R;
}

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO o O), fp32
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta_kernel(const BwdArgs A) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;  // (b, h, s)
  const int lane = threadIdx.x & 31;
  if (row >= (long long)A.B * A.H * A.Sq) return;
  const int s = (int)(row % A.Sq);
  const int h = (int)(row / A.Sq % A.H);
  const int b = (int)(row / A.Sq / A.H);
  const T* o = static_cast<const T*>(A.o) + b * A.osb + s * A.oss + h * A.osh;
  const T* d = static_cast<const T*>(A.dout) + b * A.dosb + s * A.doss + h * A.dosh;
  float acc = 0.f;
  for (int i = lane; i < A.D; i += 32) acc = fmaf(to_float(o[i]), to_float(d[i]), acc);
  acc = warp_sum(acc);
  if (lane == 0) A.delta[row] = acc;
}

// 4. dK and dV from the slices' partials, summed in slice order.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_slice_sum_kernel(const BwdArgs A) {
  const long long n = (long long)A.B * A.Tk * A.G * A.D;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const int d = (int)(i % A.D);
    const int g = (int)(i / A.D % A.G);
    const int t = (int)(i / A.D / A.G % A.Tk);
    const int b = (int)(i / A.D / A.G / A.Tk);
    float sk = 0.f, sv = 0.f;
    for (int s = 0; s < A.slices; ++s) {
      sk += A.part[s * n + i];
      sv += A.part[(A.slices + s) * n + i];
    }
    static_cast<T*>(A.dk)[b * A.dksb + t * A.dkst + g * A.dksg + d] = from_float<T>(sk * A.scale);
    static_cast<T*>(A.dv)[b * A.dvsb + t * A.dvst + g * A.dvsg + d] = from_float<T>(sv);
  }
}

// Slice sl's partial of dK (which 0) or dV (1): its (B, Tk, G, D) block.
__device__ __forceinline__ float* slice_part(const BwdArgs& A, int which, int sl) {
  return A.part + (long long)(which * A.slices + sl) * A.B * A.Tk * A.G * A.D;
}

// ---------------------------------------------------------------------------
// 2-3. bf16 at D <= 128: tensor cores
// ---------------------------------------------------------------------------
constexpr int kWkv64 = 3;                         // warpgroups a dK/dV block at D <= 64
constexpr int kWq = 1;                            // warpgroups a dQ block
constexpr int kSlotsQ = 2;                        // (K, V) slots a dQ warpgroup

// (row r0 and r0 + 8, columns 8j + c, 8j + c + 1) of an accumulator written
// to `out` rows [row_base, ...) below `rows`, D columns, stride rs: bf16
// times `mul`, or (a slice's partial) fp32 as it is.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* out, long long rs, const float (&acc)[DP / 2],
                                           int row_base, int rows, int D, int vec, int row0,
                                           int cq, float mul) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row_base + row0 + half * 8;
    if (r >= rows) continue;
    bf16* orow = out + r * rs;
#pragma unroll
    for (int jj = 0; jj < DP / 8; ++jj) {
      const int d = jj * 8 + cq;
      const float x0 = acc[jj * 4 + half * 2] * mul, x1 = acc[jj * 4 + half * 2 + 1] * mul;
      if (vec) {
        if (d < D) *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (d < D) orow[d] = __float2bfloat16(x0);
        if (d + 1 < D) orow[d + 1] = __float2bfloat16(x1);
      }
    }
  }
}
template <int DP>
__device__ __forceinline__ void store_rows(float* out, long long rs, const float (&acc)[DP / 2],
                                           int row_base, int rows, int D, int, int row0,
                                           int cq, float) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row_base + row0 + half * 8;
    if (r >= rows) continue;
    float* orow = out + (long long)r * rs;
#pragma unroll
    for (int jj = 0; jj < DP / 8; ++jj) {
      const int d = jj * 8 + cq;
      if (d < D) orow[d] = acc[jj * 4 + half * 2];
      if (d + 1 < D) orow[d + 1] = acc[jj * 4 + half * 2 + 1];
    }
  }
}

// `part` (a warpgroup's ring, thread-major) added into warpgroup 0's sums
// in a fixed order.
template <int N>
__device__ __forceinline__ void add_part(float (&acc)[N], const float* part, int wt) {
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] += part[e * kWgThreads + wt];
}

// Keep a register A operand's registers live up to the wait that ends the
// wgmma reading them.
__device__ __forceinline__ void fence_operand(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[t][r])::"memory");
}

template <int DP, int W>
__global__ void __launch_bounds__(kWgThreads * W)
flash_bwd_dkdv_wgmma_kernel(const BwdArgs A, int tma,
                            const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap dmap) {
  constexpr int kTileBytes = kTile * DP * 2;
  constexpr int kNO = DP / 2;                     // dK (and dV) floats per thread
  constexpr int kSlots = 2;                       // (Q, dO) slots a warpgroup
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads;
  const int wt = tid % kWgThreads;
  const uint32_t ks = base, vs = base + kTileBytes;
  const uint32_t ring = base + (2 + 2 * kSlots * wg) * kTileBytes;
  const uint32_t bars = base + (2 + 2 * kSlots * W) * kTileBytes;   // K/V's, then the slots'
  // each slot's 64 rows of lse (exp2 domain) and delta, after the barriers
  float* rowv = reinterpret_cast<float*>(smem_raw + (bars + 8 * (1 + kSlots * W) - raw)) +
                wg * 2 * kSlots * kTile;

  int kt, b, g, sl;
  kv_block(A, blockIdx.x, kt, b, g, sl);
  const int R = A.H / A.G;
  const int Rs = R / A.slices;                    // heads of this slice
  const int k0 = kt * kTile;
  const int warp = wt >> 5;
  const int lane = tid & 31;
  const int row0 = warp * 16 + (lane >> 2);       // this thread's keys: row0, row0 + 8
  const int cq = (lane & 3) * 2;                  // and queries 8j + cq, 8j + cq + 1
  const float scale_log2 = A.scale * kLog2e;
  const float inv_t = 1.f / (float)A.Tk;

  const bf16* qg = static_cast<const bf16*>(A.q) + b * A.qsb;
  const bf16* dg = static_cast<const bf16*>(A.dout) + b * A.dosb;
  const QTiles qt = query_tiles(A, k0, kTile, kTile);
  const int n_pairs = qt.count() * Rs;
  const int my = n_pairs > wg ? (n_pairs - wg + W - 1) / W : 0;
  auto pair_of = [&](int i, int& q0, int& h) {    // pair wg + i * W: (query tile, head)
    const int j = wg + i * W;
    q0 = qt.at(j / Rs) * kTile;
    h = g * R + sl * Rs + j % Rs;
  };
  auto slot_bar = [&](int i) { return bars + 8 * (1 + kSlots * wg + i % kSlots); };
  auto load_pair = [&](int i) {
    int q0, h;
    pair_of(i, q0, h);
    const uint32_t slot = ring + (i % kSlots) * 2 * kTileBytes;
    if (tma) {
      if (wt == 0) {
        mbar_expect_tx(slot_bar(i), 2 * kTileBytes);
#pragma unroll
        for (int c = 0; c < DP / 64; ++c) {
          tma_load(slot + c * kBlockBytes, &qmap, slot_bar(i), c * 64, q0, h, b);
          tma_load(slot + kTileBytes + c * kBlockBytes, &dmap, slot_bar(i), c * 64, q0, h, b);
        }
      }
    } else {
      load_tile<DP, kWgThreads>(slot, qg + h * A.qsh + q0 * A.qss, A.qss, A.Sq - q0, A.D,
                                A.vec, wt);
      load_tile<DP, kWgThreads>(slot + kTileBytes, dg + h * A.dosh + q0 * A.doss, A.doss,
                                A.Sq - q0, A.D, A.vec, wt);
    }
    float* rv = rowv + (i % kSlots) * 2 * kTile;
    const int s = q0 + wt % kTile;
    const long long at = ((long long)b * A.H + h) * A.Sq + s;
    if (wt < kTile) rv[wt] = s < A.Sq ? A.lse[at] * kLog2e : 0.f;
    else rv[wt] = s < A.Sq ? A.delta[at] : 0.f;
  };
  // pair i's (Q, dO) in its slot for the whole warpgroup
  auto landed = [&](int i) {
    if (tma) {
      mbar_wait(slot_bar(i), (i / kSlots) & 1);
    } else {
      cp_async_wait<kSlots - 2>();                // the next pairs may still be in flight
      fence_async_shared();
    }
    wg_barrier(1 + wg);
  };

  if (tma) {
    if (tid == 0) {
      for (int i = 0; i < 1 + kSlots * W; ++i) mbar_init(bars + 8 * i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      mbar_expect_tx(bars, 2 * kTileBytes);
#pragma unroll
      for (int c = 0; c < DP / 64; ++c) {
        tma_load(ks + c * kBlockBytes, &kmap, bars, c * 64, k0, g, b);
        tma_load(vs + c * kBlockBytes, &vmap, bars, c * 64, k0, g, b);
      }
    }
    for (int i = 0; i < kSlots - 1 && i < my; ++i) load_pair(i);
    mbar_wait(bars, 0);                           // K and V landed
  } else {
    const bf16* kb = static_cast<const bf16*>(A.k) + b * A.ksb + g * A.ksg;
    const bf16* vb = static_cast<const bf16*>(A.v) + b * A.vsb + g * A.vsg;
    load_tile<DP, kWgThreads * W>(ks, kb + k0 * A.kst, A.kst, A.Tk - k0, A.D, A.vec, tid);
    load_tile<DP, kWgThreads * W>(vs, vb + k0 * A.vst, A.vst, A.Tk - k0, A.D, A.vec, tid);
    cp_async_commit();
    for (int i = 0; i < kSlots - 1; ++i) {        // one group each, empty past `my`
      if (i < my) load_pair(i);
      cp_async_commit();
    }
    cp_async_wait<kSlots - 1>();                  // K and V landed for this thread
    fence_async_shared();
    __syncthreads();                              // ... and for every thread
  }

  float dk[kNO], dv[kNO];
#pragma unroll
  for (int e = 0; e < kNO; ++e) dk[e] = dv[e] = 0.f;
  float st[32], dpt[32];

  // S^T = K Q^T and dP^T = V dO^T of pair i: keys are the rows, queries
  // the columns
  auto issue_sdp = [&](int i) {
    const uint32_t qsl = ring + (i % kSlots) * 2 * kTileBytes;
    const uint32_t dsl = qsl + kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < DP / 16; ++t) {
      const uint32_t off = (t / 4) * kBlockBytes + (t % 4) * 32;
      wgmma_ss_n64(st, sw128_desc(ks + off, 16, 1024), sw128_desc(qsl + off, 16, 1024), t > 0);
    }
#pragma unroll
    for (int t = 0; t < DP / 16; ++t) {
      const uint32_t off = (t / 4) * kBlockBytes + (t % 4) * 32;
      wgmma_ss_n64(dpt, sw128_desc(vs + off, 16, 1024), sw128_desc(dsl + off, 16, 1024), t > 0);
    }
    wgmma_commit();
  };
  // The query rows [s_min, s_max] each of this thread's two keys is seen
  // by (none past Tk), and the rows that see no key at all: [0, n_pre)
  // and [s_suf, Sq) (query_tiles' runs).
  int s_min[2], s_max[2];
  bool key_in[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = k0 + row0 + 8 * r;
    key_in[r] = t < A.Tk;
    s_min[r] = A.causal ? t - A.q_offset : 0;
    s_max[r] = key_in[r] ? (A.window > 0 ? min(A.Sq - 1, t - A.q_offset + A.window - 1)
                                         : A.Sq - 1)
                         : -1;
  }
  const int n_pre = A.causal ? min(A.Sq, max(0, -A.q_offset)) : 0;
  const int s_suf =
      A.window > 0 ? min(A.Sq, max(0, A.Tk + A.window - 1 - A.q_offset)) : A.Sq;

  // P^T and dS^T of pair i as wgmma's register A operand (k-step e / 8
  // over the queries). Element e: key row0 + 8 ((e % 4) / 2), query (e /
  // 4) * 8 + e % 2 + cq. Only a pair that is not wholly visible is masked,
  // by selects: no branch while the products before run.
  auto build = [&](int i, uint32_t (&pa)[4][4], uint32_t (&da)[4][4]) {
    int q0, h;
    pair_of(i, q0, h);
    const float* rv = rowv + (i % kSlots) * 2 * kTile;
    const bool full = k0 + kTile <= A.Tk && q0 + kTile <= A.Sq &&
                      (!A.causal || k0 + kTile - 1 <= q0 + A.q_offset) &&
                      (A.window <= 0 || q0 + kTile - 1 + A.q_offset - A.window < k0);
    auto elements = [&](bool masked) {
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        float p[2], ds[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = ((e + u) / 4) * 8 + ((e + u) % 2) + cq;
          const int s = q0 + c, r = ((e + u) % 4) / 2;
          const bool vis = !masked || (s >= s_min[r] && s <= s_max[r]);
          const bool no_key = key_in[r] && (s < n_pre || (s >= s_suf && s < A.Sq));
          const float pe = ex2(st[e + u] * scale_log2 - rv[c]);
          p[u] = vis ? pe : no_key ? inv_t : 0.f;   // a row that sees no key: 1/T
          ds[u] = vis ? pe * (dpt[e + u] - rv[kTile + c]) : 0.f;
        }
        pa[e / 8][(e % 8) / 2] = pack_bf16(p[0], p[1]);
        da[e / 8][(e % 8) / 2] = pack_bf16(ds[0], ds[1]);
      }
    };
    if (full) elements(false);
    else elements(true);
  };
  // dV += P^T dO and dK += dS^T Q of pair i: dO and Q as MN-major B operands
  auto issue_dkdv = [&](int i, uint32_t (&pa)[4][4], uint32_t (&da)[4][4]) {
    const uint32_t qsl = ring + (i % kSlots) * 2 * kTileBytes;
    const uint32_t dsl = qsl + kTileBytes;
    fence_regs(dk);
    fence_regs(dv);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      wgmma_pv<DP>(dv, pa[t], sw128_desc(dsl + t * 16 * 128, kBlockBytes, 1024));
      wgmma_pv<DP>(dk, da[t], sw128_desc(qsl + t * 16 * 128, kBlockBytes, 1024));
    }
    wgmma_commit();
  };
  auto retire = [&]() {                           // every product of this warpgroup done
    wgmma_wait_all();
    fence_regs(dk);
    fence_regs(dv);
  };

  uint32_t pa[4][4], da[4][4];
#pragma unroll 1
  for (int i = 0; i < my; ++i) {
    landed(i);                                    // ... and pair i-1 done
    if (i + kSlots - 1 < my) load_pair(i + kSlots - 1);   // into the slot pair i-1 used
    if (!tma) cp_async_commit();
    issue_sdp(i);
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);
    build(i, pa, da);
    issue_dkdv(i, pa, da);
    retire();
    fence_operand(pa);
    fence_operand(da);
  }
  cp_async_wait<0>();

  // Warpgroups 1.. leave dK and dV in their rings (2 * kNO floats a thread
  // fill two of its tiles), warpgroup 0 adds them to its own.
  float* part = reinterpret_cast<float*>(smem_raw + (ring - raw));
  wg_barrier(1 + wg);                             // the ring's last pair is consumed
  if (wg > 0) {
#pragma unroll
    for (int e = 0; e < kNO; ++e) {
      part[e * kWgThreads + wt] = dk[e];
      part[(kNO + e) * kWgThreads + wt] = dv[e];
    }
  }
  __syncthreads();
  if (wg > 0) return;
#pragma unroll
  for (int w = 1; w < W; ++w) {                   // warpgroup w's ring, in order
    const float* pw = part + w * 2 * kSlots * kTileBytes / 4;
    add_part(dk, pw, wt);
    add_part(dv, pw + kNO * kWgThreads, wt);
  }
  if (A.slices > 1) {                             // this slice's fp32 partials
    const long long off = ((long long)b * A.Tk * A.G + g) * A.D;
    store_rows<DP>(slice_part(A, 0, sl) + off, (long long)A.G * A.D, dk, k0, A.Tk, A.D, 0,
                   row0, cq, 1.f);
    store_rows<DP>(slice_part(A, 1, sl) + off, (long long)A.G * A.D, dv, k0, A.Tk, A.D, 0,
                   row0, cq, 1.f);
    return;
  }
  store_rows<DP>(static_cast<bf16*>(A.dk) + b * A.dksb + g * A.dksg, A.dkst, dk, k0, A.Tk,
                 A.D, A.vec, row0, cq, A.scale);
  store_rows<DP>(static_cast<bf16*>(A.dv) + b * A.dvsb + g * A.dvsg, A.dvst, dv, k0, A.Tk,
                 A.D, A.vec, row0, cq, 1.f);
}

template <int DP, int W, int SLOTS>
__global__ void __launch_bounds__(kWgThreads * W)
flash_bwd_dq_wgmma_kernel(const BwdArgs A, int tma, int n_qt,
                          const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap dmap) {
  constexpr int kTileBytes = kTile * DP * 2;
  constexpr int kNO = DP / 2;
  constexpr int kSlots = SLOTS;                   // (K, V) slots a warpgroup
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads;
  const int wt = tid % kWgThreads;
  const uint32_t qs = base, dos = base + kTileBytes;
  const uint32_t ring = base + (2 + 2 * kSlots * wg) * kTileBytes;
  const uint32_t bars = base + (2 + 2 * kSlots * W) * kTileBytes;   // Q/dO's, then the slots'

  int qt, h, b;
  block_coords(blockIdx.x, n_qt, A.H, A.B, qt, h, b);
  const int q0 = qt * kTile;
  const int g = h / (A.H / A.G);
  const int warp = wt >> 5;
  const int lane = tid & 31;
  const int row0 = warp * 16 + (lane >> 2);       // this thread's rows: row0, row0 + 8
  const int cq = (lane & 3) * 2;                  // and keys 8j + cq, 8j + cq + 1
  const float scale_log2 = A.scale * kLog2e;

  const bf16* kb = static_cast<const bf16*>(A.k) + b * A.ksb + g * A.ksg;
  const bf16* vb = static_cast<const bf16*>(A.v) + b * A.vsb + g * A.vsg;
  int k_begin, n_tiles;
  key_tiles(A, q0, kTile, kTile, k_begin, n_tiles);
  const int my = n_tiles > wg ? (n_tiles - wg + W - 1) / W : 0;
  auto key0 = [&](int i) { return k_begin + (wg + i * W) * kTile; };   // tile wg + i W
  auto slot_bar = [&](int i) { return bars + 8 * (1 + kSlots * wg + i % kSlots); };
  auto load_kv = [&](int i) {
    const int k0 = key0(i);
    const uint32_t slot = ring + (i % kSlots) * 2 * kTileBytes;
    if (tma) {
      if (wt == 0) {
        mbar_expect_tx(slot_bar(i), 2 * kTileBytes);
#pragma unroll
        for (int c = 0; c < DP / 64; ++c) {
          tma_load(slot + c * kBlockBytes, &kmap, slot_bar(i), c * 64, k0, g, b);
          tma_load(slot + kTileBytes + c * kBlockBytes, &vmap, slot_bar(i), c * 64, k0, g, b);
        }
      }
    } else {
      load_tile<DP, kWgThreads>(slot, kb + k0 * A.kst, A.kst, A.Tk - k0, A.D, A.vec, wt);
      load_tile<DP, kWgThreads>(slot + kTileBytes, vb + k0 * A.vst, A.vst, A.Tk - k0, A.D,
                                A.vec, wt);
    }
  };
  auto landed = [&](int i) {                      // tile i's K, V for the whole warpgroup
    if (tma) {
      mbar_wait(slot_bar(i), (i / kSlots) & 1);
    } else {
      cp_async_wait<kSlots - 2>();
      fence_async_shared();
    }
    wg_barrier(1 + wg);
  };

  if (tma) {
    if (tid == 0) {
      for (int i = 0; i < 1 + kSlots * W; ++i) mbar_init(bars + 8 * i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      mbar_expect_tx(bars, 2 * kTileBytes);
#pragma unroll
      for (int c = 0; c < DP / 64; ++c) {
        tma_load(qs + c * kBlockBytes, &qmap, bars, c * 64, q0, h, b);
        tma_load(dos + c * kBlockBytes, &dmap, bars, c * 64, q0, h, b);
      }
    }
    for (int i = 0; i < kSlots - 1 && i < my; ++i) load_kv(i);
    mbar_wait(bars, 0);                           // Q and dO landed
  } else {
    const bf16* qb = static_cast<const bf16*>(A.q) + b * A.qsb + h * A.qsh;
    const bf16* db = static_cast<const bf16*>(A.dout) + b * A.dosb + h * A.dosh;
    load_tile<DP, kWgThreads * W>(qs, qb + q0 * A.qss, A.qss, A.Sq - q0, A.D, A.vec, tid);
    load_tile<DP, kWgThreads * W>(dos, db + q0 * A.doss, A.doss, A.Sq - q0, A.D, A.vec, tid);
    cp_async_commit();
    for (int i = 0; i < kSlots - 1; ++i) {        // one group each, empty past `my`
      if (i < my) load_kv(i);
      cp_async_commit();
    }
    cp_async_wait<kSlots - 1>();
    fence_async_shared();
    __syncthreads();
  }

  // this thread's two rows: lse (exp2 domain), delta, visible keys [lo, hi]
  float lse2[2], dlt[2];
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = q0 + row0 + 8 * r;
    const long long at = ((long long)b * A.H + h) * A.Sq + s;
    lse2[r] = s < A.Sq ? A.lse[at] * kLog2e : 0.f;
    dlt[r] = s < A.Sq ? A.delta[at] : 0.f;
    lo[r] = key_lo(A, s);
    hi[r] = s < A.Sq ? key_hi(A, s) : -1;
  }
  const int p_lo = q0 + A.q_offset;
  const int p_hi = min(q0 + kTile, A.Sq) - 1 + A.q_offset;

  float dq[kNO];
#pragma unroll
  for (int e = 0; e < kNO; ++e) dq[e] = 0.f;
  float s[32], dp[32];

  // S = Q K^T and dP = dO V^T of tile i
  auto issue_sdp = [&](int i) {
    const uint32_t kt = ring + (i % kSlots) * 2 * kTileBytes;
    const uint32_t vt = kt + kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < DP / 16; ++t) {
      const uint32_t off = (t / 4) * kBlockBytes + (t % 4) * 32;
      wgmma_ss_n64(s, sw128_desc(qs + off, 16, 1024), sw128_desc(kt + off, 16, 1024), t > 0);
    }
#pragma unroll
    for (int t = 0; t < DP / 16; ++t) {
      const uint32_t off = (t / 4) * kBlockBytes + (t % 4) * 32;
      wgmma_ss_n64(dp, sw128_desc(dos + off, 16, 1024), sw128_desc(vt + off, 16, 1024), t > 0);
    }
    wgmma_commit();
  };
  // dS of tile i as the register A operand (k-step e / 8 over the keys);
  // element e: row row0 + 8 ((e % 4) / 2), key (e / 4) * 8 + e % 2 + cq
  auto build = [&](int i, uint32_t (&da)[4][4]) {
    const int k0 = key0(i);
    const bool full = k0 + kTile <= A.Tk && (!A.causal || k0 + kTile - 1 <= p_lo) &&
                      (A.window <= 0 || k0 > p_hi - A.window);
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      float ds[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = ((e + u) % 4) / 2;
        const int t = k0 + ((e + u) / 4) * 8 + ((e + u) % 2) + cq;
        const float p = ex2(s[e + u] * scale_log2 - lse2[r]);
        ds[u] = full || (t >= lo[r] && t <= hi[r]) ? p * (dp[e + u] - dlt[r]) : 0.f;
      }
      da[e / 8][(e % 8) / 2] = pack_bf16(ds[0], ds[1]);
    }
  };
  // dQ += dS K of tile i: K as an MN-major B operand
  auto issue_dq = [&](int i, uint32_t (&da)[4][4]) {
    const uint32_t kt = ring + (i % kSlots) * 2 * kTileBytes;
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t)
      wgmma_pv<DP>(dq, da[t], sw128_desc(kt + t * 16 * 128, kBlockBytes, 1024));
    wgmma_commit();
  };
  auto retire = [&]() {
    wgmma_wait_all();
    fence_regs(dq);
  };

  uint32_t da[4][4];
#pragma unroll 1
  for (int i = 0; i < my; ++i) {
    landed(i);                                    // ... and tile i-1 done
    if (i + kSlots - 1 < my) load_kv(i + kSlots - 1);   // into tile i-1's slot
    if (!tma) cp_async_commit();
    issue_sdp(i);
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
    build(i, da);
    issue_dq(i, da);
    retire();
    fence_operand(da);
  }
  cp_async_wait<0>();

  float* part = reinterpret_cast<float*>(smem_raw + (ring - raw));
  wg_barrier(1 + wg);
  if (wg > 0) {
#pragma unroll
    for (int e = 0; e < kNO; ++e) part[e * kWgThreads + wt] = dq[e];
  }
  __syncthreads();
  if (wg > 0) return;
#pragma unroll
  for (int w = 1; w < W; ++w) add_part(dq, part + w * 2 * kSlots * kTileBytes / 4, wt);
  store_rows<DP>(static_cast<bf16*>(A.dq) + b * A.dqsb + h * A.dqsh, A.dqss, dq, q0, A.Sq,
                 A.D, A.vec, row0, cq, A.scale);
}

template <int DP>
int launch_wgmma(const BwdArgs& A, cudaStream_t stream) {
  // TMA where D fills whole 64-column boxes and the strides suit it (`vec`)
  CUtensorMap maps[4] = {};
  int tma = A.vec && A.D % 64 == 0;
  if (tma) {
    tma = tensor_map(&maps[0], A.q, A.D, A.Sq, A.H, A.B, A.qss, A.qsh, A.qsb) &&
          tensor_map(&maps[1], A.k, A.D, A.Tk, A.G, A.B, A.kst, A.ksg, A.ksb) &&
          tensor_map(&maps[2], A.v, A.D, A.Tk, A.G, A.B, A.vst, A.vsg, A.vsb) &&
          tensor_map(&maps[3], A.dout, A.D, A.Sq, A.H, A.B, A.doss, A.dosh, A.dosb);
    if (!tma) return (int)cudaErrorInvalidValue;
  }
  constexpr int Wkv = DP == 64 ? kWkv64 : 2;      // at D = 128 a thread holds 228 registers
  constexpr int kSlots = 2;
  const size_t tiles = 1024 + (size_t)(2 + 2 * kSlotsQ * kWq) * kTile * DP * 2 +
                       8 * (1 + kSlotsQ * kWq);
  const size_t smem_kv = 1024 + (size_t)(2 + 2 * kSlots * Wkv) * kTile * DP * 2 +
                         8 * (1 + kSlots * Wkv) + sizeof(float) * Wkv * 2 * kSlots * kTile;
  auto kv = flash_bwd_dkdv_wgmma_kernel<DP, Wkv>;
  auto dq = flash_bwd_dq_wgmma_kernel<DP, kWq, kSlotsQ>;
  cudaError_t err = allow_smem(kv, smem_kv);
  if (err == cudaSuccess) err = allow_smem(dq, tiles);
  if (err != cudaSuccess) return (int)err;
  const int n_kt = (A.Tk + kTile - 1) / kTile;
  const int n_qt = (A.Sq + kTile - 1) / kTile;
  kv<<<n_kt * A.slices * A.G * A.B, kWgThreads * Wkv, smem_kv, stream>>>(
      A, tma, maps[0], maps[1], maps[2], maps[3]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq<<<n_qt * A.H * A.B, kWgThreads * kWq, tiles, stream>>>(A, tma, n_qt, maps[0], maps[1],
                                                            maps[2], maps[3]);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 2-3. fp32, and bf16 past D = 128: CUDA cores, fp32 inside
// ---------------------------------------------------------------------------
constexpr int kOwn = 64;                          // rows a block owns
constexpr int kWalk64 = 32;                       // walked rows a tile at D <= 64

// Walked rows a tile, by D / 64 rounded up (shared memory holds the owned
// and walked tiles in fp32).
__host__ __device__ constexpr int walk_rows(int dp4) {
  return dp4 == 1 ? kWalk64 : dp4 == 2 ? 32 : 16;
}
// Row stride, in floats, of a staged tile: 4 mod 32, so the 8 rows one
// quarter-warp reads as float4s fall in distinct banks.
__host__ __device__ constexpr int row_stride(int dp4) { return 64 * dp4 + 4; }
constexpr int kPS = kOwn + 4;                     // row stride of the P and dS tiles

// Rows [0, rows) of a (nvalid, D) tensor at `src` (row stride rs) as fp32
// into `dst` (row stride DS), zeros past nvalid rows and in columns [D, DS
// - 4): 16-byte cp.async where `vec` (fp32, D % 4 == 0), element by
// element otherwise.
template <typename T, int DP4>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, long long rs, int rows,
                                           int nvalid, int D, bool async) {
  constexpr int DS = row_stride(DP4);
  if constexpr (std::is_same<T, float>::value) {
    if (async) {
      constexpr int kCpr = 16 * DP4;              // 16-byte chunks a padded row
      for (int i = threadIdx.x; i < rows * kCpr; i += kThreads) {
        const int r = i / kCpr, c = i % kCpr;
        const bool in = r < nvalid && c * 4 < D;
        cp_async16(smem_u32(dst + r * DS + c * 4), in ? src + r * rs + c * 4 : src,
                   in ? 16 : 0);
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < rows * 64 * DP4; i += kThreads) {
    const int r = i / (64 * DP4), d = i % (64 * DP4);
    dst[r * DS + d] = r < nvalid && d < D ? to_float(src[r * rs + d]) : 0.f;
  }
}

// A bf16 tile of ROWS rows (16-byte chunks of 8) held in registers between
// its load and its conversion into shared memory, so that the load runs
// under the math on the tile before.
template <int DP4, int ROWS>
struct Bf16Rows {
  static constexpr int kCpr = 8 * DP4;            // 16-byte chunks a padded row
  static constexpr int kN = (ROWS * kCpr + kThreads - 1) / kThreads;
  uint4 v[kN];
  __device__ __forceinline__ void fetch(const bf16* src, long long rs, int nvalid, int D) {
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int r = i / kCpr, c = i % kCpr;
      v[k] = make_uint4(0, 0, 0, 0);
      if (i < ROWS * kCpr && r < nvalid && c * 8 < D)
        v[k] = *reinterpret_cast<const uint4*>(src + r * rs + c * 8);
    }
  }
  __device__ __forceinline__ void put(float* dst) const {
    constexpr int DS = row_stride(DP4);
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i >= ROWS * kCpr) continue;
      const int r = i / kCpr, c = i % kCpr;
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[k]);
      const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
      const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
      float4* o = reinterpret_cast<float4*>(dst + r * DS + c * 8);
      o[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
      o[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
    }
  }
};

// Thread (ty, tx)'s scores of one (owned, walked) tile pair: s1 = A X^T
// and s2 = B Y^T over its owned rows 4ty + i and walked rows tx + 16j,
// reading D rounded up to 4 columns (the rest are zeros).
template <int DP4, int MW>
__device__ __forceinline__ void tile_scores(const float* As, const float* Bs, const float* Xs,
                                            const float* Ys, int D, int ty, int tx,
                                            float (&s1)[4][MW], float (&s2)[4][MW]) {
  constexpr int DS = row_stride(DP4);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MW; ++j) s1[i][j] = s2[i][j] = 0.f;
  const int d4 = (D + 3) / 4;
#pragma unroll 2
  for (int c = 0; c < d4; ++c) {
    float4 a[4], bb[4], x[MW], y[MW];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = reinterpret_cast<const float4*>(As + (4 * ty + i) * DS)[c];
      bb[i] = reinterpret_cast<const float4*>(Bs + (4 * ty + i) * DS)[c];
    }
#pragma unroll
    for (int j = 0; j < MW; ++j) {
      x[j] = reinterpret_cast<const float4*>(Xs + (tx + 16 * j) * DS)[c];
      y[j] = reinterpret_cast<const float4*>(Ys + (tx + 16 * j) * DS)[c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < MW; ++j) {
        s1[i][j] = fmaf(a[i].x, x[j].x, fmaf(a[i].y, x[j].y,
                   fmaf(a[i].z, x[j].z, fmaf(a[i].w, x[j].w, s1[i][j]))));
        s2[i][j] = fmaf(bb[i].x, y[j].x, fmaf(bb[i].y, y[j].y,
                   fmaf(bb[i].z, y[j].z, fmaf(bb[i].w, y[j].w, s2[i][j]))));
      }
  }
}

// acc[i][4c + e] += w[walked row][4ty + i] * Z[walked row][4tx + 64c + e]
// over the tile's WT walked rows, in row order.
template <int DP4, int WT>
__device__ __forceinline__ void tile_product(float (&acc)[4][4 * DP4], const float* ws,
                                             const float* Zs, int ty, int tx) {
  constexpr int DS = row_stride(DP4);
#pragma unroll 4
  for (int w = 0; w < WT; ++w) {
    const float4 p = reinterpret_cast<const float4*>(ws + w * kPS)[ty];
    const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int c = 0; c < DP4; ++c) {
      const float4 z = reinterpret_cast<const float4*>(Zs + w * DS + 64 * c)[tx];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][4 * c] = fmaf(pv[i], z.x, acc[i][4 * c]);
        acc[i][4 * c + 1] = fmaf(pv[i], z.y, acc[i][4 * c + 1]);
        acc[i][4 * c + 2] = fmaf(pv[i], z.z, acc[i][4 * c + 2]);
        acc[i][4 * c + 3] = fmaf(pv[i], z.w, acc[i][4 * c + 3]);
      }
    }
  }
}

// Owned rows [r0, ...) below `rows` of an accumulator, times `mul`, into
// `out` (row stride rs), D columns.
template <typename T, int DP4>
__device__ __forceinline__ void store_owned(T* out, long long rs, const float (&acc)[4][4 * DP4],
                                            int r0, int rows, int D, int ty, int tx,
                                            float mul) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= rows) continue;
#pragma unroll
    for (int c = 0; c < DP4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * tx + 64 * c + e;
        if (d < D) out[r * rs + d] = from_float<T>(acc[i][4 * c + e] * mul);
      }
  }
}

// The shared memory of a CUDA-core pass, in floats: the owned tiles (A,
// B), a two-stage ring of walked tiles (X, Y), the walked rows' lse and
// delta (dK/dV), then the P and dS tiles (dS alone for dQ).
template <int DP4>
constexpr size_t cc_smem_floats(bool dq) {
  return (size_t)2 * kOwn * row_stride(DP4) + (size_t)4 * walk_rows(DP4) * row_stride(DP4) +
         (size_t)4 * walk_rows(DP4) + (size_t)(dq ? 1 : 2) * walk_rows(DP4) * kPS;
}

// One block a (64-row owned tile, ...) of either pass. dK/dV (DQ false):
// owned keys of KV head g, walked (query tile, head) pairs of its slice,
// A = K, B = V, X = Q, Y = dO; dV += P^T dO, dK += dS^T Q. dQ: owned rows
// of head h, walked key tiles, A = Q, B = dO, X = K, Y = V; dQ += dS K.
template <typename T, int DP4, bool DQ>
__global__ void __launch_bounds__(kThreads) flash_bwd_cc_kernel(const BwdArgs A, int n_qt) {
  constexpr int DS = row_stride(DP4);
  constexpr int WT = walk_rows(DP4);
  constexpr int MW = WT / 16;
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = As + kOwn * DS;
  float* ring = Bs + kOwn * DS;                   // stage s: X at 2s, Y at 2s + 1
  float* rowv = ring + 4 * WT * DS;               // stage s: lse, delta of its rows
  float* ws = rowv + 4 * WT;                      // P (dK/dV), then dS
  float* dss = DQ ? ws : ws + WT * kPS;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int D = A.D;
  const bool async = !kBf16 && A.vec;
  const bool prefetch = kBf16 && A.vec;
  const float inv_t = 1.f / (float)A.Tk;
  const int R = A.H / A.G;

  int o0, b, g, h = 0, sl = 0;                    // owned rows from o0
  const T *xb, *yb;                               // walked tensors' (batch, head) bases
  long long xs, ys;                               // and row strides
  int n_walk, w_begin = 0, Rs = 1;
  QTiles qt{};
  if constexpr (DQ) {
    block_coords(blockIdx.x, n_qt, A.H, A.B, o0, h, b);
    o0 *= kOwn;
    g = h / R;
    key_tiles(A, o0, kOwn, WT, w_begin, n_walk);
    xb = static_cast<const T*>(A.k) + b * A.ksb + g * A.ksg;
    yb = static_cast<const T*>(A.v) + b * A.vsb + g * A.vsg;
    xs = A.kst;
    ys = A.vst;
  } else {
    int kt;
    kv_block(A, blockIdx.x, kt, b, g, sl);
    o0 = kt * kOwn;
    Rs = R / A.slices;
    qt = query_tiles(A, o0, kOwn, WT);
    n_walk = qt.count() * Rs;
    xb = static_cast<const T*>(A.q) + b * A.qsb;
    yb = static_cast<const T*>(A.dout) + b * A.dosb;
    xs = A.qss;
    ys = A.doss;
  }
  // walked tile i: its first row, and (dK/dV) its head
  auto walk_of = [&](int i, int& w0, int& hh) {
    if constexpr (DQ) {
      w0 = w_begin + i * WT;
      hh = h;
    } else {
      w0 = qt.at(i / Rs) * WT;
      hh = g * R + sl * Rs + i % Rs;
    }
  };
  auto walk_base = [&](const T* base, int hh, bool is_x) {
    if constexpr (DQ) return base;
    else return base + hh * (is_x ? A.qsh : A.dosh);
  };
  const int w_rows = DQ ? A.Tk : A.Sq;

  // the owned tiles, once
  {
    const T *ab, *bb;
    long long as_, bs_;
    if constexpr (DQ) {
      ab = static_cast<const T*>(A.q) + b * A.qsb + h * A.qsh + o0 * A.qss;
      bb = static_cast<const T*>(A.dout) + b * A.dosb + h * A.dosh + o0 * A.doss;
      as_ = A.qss;
      bs_ = A.doss;
    } else {
      ab = static_cast<const T*>(A.k) + b * A.ksb + g * A.ksg + o0 * A.kst;
      bb = static_cast<const T*>(A.v) + b * A.vsb + g * A.vsg + o0 * A.vst;
      as_ = A.kst;
      bs_ = A.vst;
    }
    const int nvalid = (DQ ? A.Sq : A.Tk) - o0;
    if constexpr (kBf16) {
      if (prefetch) {
        Bf16Rows<DP4, kOwn> r;
        r.fetch(ab, as_, nvalid, D);
        r.put(As);
        r.fetch(bb, bs_, nvalid, D);
        r.put(Bs);
      } else {
        stage_rows<T, DP4>(As, ab, as_, kOwn, nvalid, D, false);
        stage_rows<T, DP4>(Bs, bb, bs_, kOwn, nvalid, D, false);
      }
    } else {
      stage_rows<T, DP4>(As, ab, as_, kOwn, nvalid, D, async);
      stage_rows<T, DP4>(Bs, bb, bs_, kOwn, nvalid, D, async);
    }
  }
  // the owned rows' lse and delta (dQ)
  float lse[4] = {0.f, 0.f, 0.f, 0.f}, dlt[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (DQ) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = o0 + 4 * ty + i;
      const long long at = ((long long)b * A.H + h) * A.Sq + s;
      if (s < A.Sq) {
        lse[i] = A.lse[at];
        dlt[i] = A.delta[at];
      }
    }
  }

  [[maybe_unused]] Bf16Rows<DP4, WT> px, py;      // bf16: the next walked tile
  // start bringing walked tile i into stage i % 2
  auto issue = [&](int i) {
    int w0, hh;
    walk_of(i, w0, hh);
    float* xd = ring + (i % 2) * 2 * WT * DS;
    const T* x = walk_base(xb, hh, true) + w0 * xs;
    const T* y = walk_base(yb, hh, false) + w0 * ys;
    if constexpr (kBf16) {
      if (prefetch) {
        px.fetch(x, xs, w_rows - w0, D);
        py.fetch(y, ys, w_rows - w0, D);
      } else {
        stage_rows<T, DP4>(xd, x, xs, WT, w_rows - w0, D, false);
        stage_rows<T, DP4>(xd + WT * DS, y, ys, WT, w_rows - w0, D, false);
      }
    } else {
      stage_rows<T, DP4>(xd, x, xs, WT, w_rows - w0, D, async);
      stage_rows<T, DP4>(xd + WT * DS, y, ys, WT, w_rows - w0, D, async);
    }
    if constexpr (!DQ) {                          // the walked rows' lse and delta
      if (tid < 2 * WT) {
        const int s = w0 + tid % WT;
        const long long at = ((long long)b * A.H + hh) * A.Sq + s;
        rowv[(i % 2) * 2 * WT + tid] =
            s >= A.Sq ? 0.f : tid < WT ? A.lse[at] : A.delta[at];
      }
    }
  };
  auto finish = [&](int i) {                      // bf16: the converted tile into its stage
    if constexpr (kBf16) {
      if (prefetch) {
        float* xd = ring + (i % 2) * 2 * WT * DS;
        px.put(xd);
        py.put(xd + WT * DS);
      }
    }
  };

  float acc1[4][4 * DP4], acc2[4][4 * DP4];       // dK/dV: dV, dK; dQ: -, dQ
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4 * DP4; ++e) acc1[i][e] = acc2[i][e] = 0.f;

  if (n_walk > 0) issue(0);
  cp_async_commit();
  if (n_walk > 0) finish(0);
#pragma unroll 1
  for (int i = 0; i < n_walk; ++i) {
    cp_async_wait<0>();
    __syncthreads();                              // tile i landed; tile i-1 consumed
    if (i + 1 < n_walk) issue(i + 1);             // under tile i's math
    cp_async_commit();
    int w0, hh;
    walk_of(i, w0, hh);
    const float* Xs = ring + (i % 2) * 2 * WT * DS;
    const float* Ys = Xs + WT * DS;
    float s1[4][MW], s2[4][MW];
    tile_scores<DP4, MW>(As, Bs, Xs, Ys, D, ty, tx, s1, s2);
    const float* rv = rowv + (i % 2) * 2 * WT;
#pragma unroll
    for (int j = 0; j < MW; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if constexpr (DQ)                         // owned query row, walked key
          p_ds(A, o0 + 4 * ty + r, w0 + tx + 16 * j, s1[r][j] * A.scale, lse[r], s2[r][j],
               dlt[r], 0.f, p[r], ds[r]);
        else                                      // walked query row, owned key
          p_ds(A, w0 + tx + 16 * j, o0 + 4 * ty + r, s1[r][j] * A.scale, rv[tx + 16 * j],
               s2[r][j], rv[WT + tx + 16 * j], inv_t, p[r], ds[r]);
      }
      float4* wrow = reinterpret_cast<float4*>(ws + (tx + 16 * j) * kPS) + ty;
      if constexpr (!DQ) *wrow = make_float4(p[0], p[1], p[2], p[3]);
      reinterpret_cast<float4*>(dss + (tx + 16 * j) * kPS)[ty] =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();                              // P and dS of the tile
    if constexpr (!DQ) tile_product<DP4, WT>(acc1, ws, Ys, ty, tx);   // dV += P^T dO
    tile_product<DP4, WT>(acc2, dss, Xs, ty, tx); // dK += dS^T Q, or dQ += dS K
    if (i + 1 < n_walk) finish(i + 1);            // its stage was tile i-1's
  }
  cp_async_wait<0>();

  if constexpr (DQ) {
    store_owned<T, DP4>(static_cast<T*>(A.dq) + b * A.dqsb + h * A.dqsh, A.dqss, acc2, o0,
                        A.Sq, D, ty, tx, A.scale);
  } else if (A.slices > 1) {                      // this slice's fp32 partials
    const long long off = ((long long)b * A.Tk * A.G + g) * A.D;
    store_owned<float, DP4>(slice_part(A, 0, sl) + off, (long long)A.G * A.D, acc2, o0,
                            A.Tk, D, ty, tx, 1.f);
    store_owned<float, DP4>(slice_part(A, 1, sl) + off, (long long)A.G * A.D, acc1, o0,
                            A.Tk, D, ty, tx, 1.f);
  } else {
    store_owned<T, DP4>(static_cast<T*>(A.dk) + b * A.dksb + g * A.dksg, A.dkst, acc2, o0,
                        A.Tk, D, ty, tx, A.scale);
    store_owned<T, DP4>(static_cast<T*>(A.dv) + b * A.dvsb + g * A.dvsg, A.dvst, acc1, o0,
                        A.Tk, D, ty, tx, 1.f);
  }
}

template <typename T, int DP4>
int launch_cuda_cores(const BwdArgs& A, cudaStream_t stream) {
  const size_t smem_kv = sizeof(float) * cc_smem_floats<DP4>(false);
  const size_t smem_q = sizeof(float) * cc_smem_floats<DP4>(true);
  auto kv = flash_bwd_cc_kernel<T, DP4, false>;
  auto dq = flash_bwd_cc_kernel<T, DP4, true>;
  cudaError_t err = allow_smem(kv, smem_kv);
  if (err == cudaSuccess) err = allow_smem(dq, smem_q);
  if (err != cudaSuccess) return (int)err;
  const int n_kt = (A.Tk + kOwn - 1) / kOwn;
  const int n_qt = (A.Sq + kOwn - 1) / kOwn;
  kv<<<n_kt * A.slices * A.G * A.B, kThreads, smem_kv, stream>>>(A, n_qt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq<<<n_qt * A.H * A.B, kThreads, smem_q, stream>>>(A, n_qt);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_cuda_cores(const BwdArgs& A, cudaStream_t stream) {
  switch ((A.D + 63) / 64) {
    case 1: return launch_cuda_cores<T, 1>(A, stream);
    case 2: return launch_cuda_cores<T, 2>(A, stream);
    case 3: return launch_cuda_cores<T, 3>(A, stream);
    case 4: return launch_cuda_cores<T, 4>(A, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

static_assert(kOwn == kTile, "both routes' dK/dV blocks own 64 keys");

// Head slices of the dK/dV pass for a call.
int slices_for(int B, int H, int G, int Tk) {
  return head_slices((Tk + kTile - 1) / kTile * G * B, H / G, kSliceBlocks);
}

}  // namespace

// The dK/dV pass's head slices for a call of the shape, on either route.
extern "C" int flash_attention_bwd_head_slices(int B, int H, int G, int Tk) {
  if (B <= 0 || H <= 0 || G <= 0 || H % G || Tk <= 0) return 0;
  return slices_for(B, H, G, Tk);
}

// fp32 scratch the call needs: the slices' dK and dV partials (none with
// one slice).
extern "C" long long flash_attention_bwd_scratch_floats(int B, int H, int G, int Tk, int D) {
  const int slices = flash_attention_bwd_head_slices(B, H, G, Tk);
  return slices > 1 ? 2LL * slices * B * Tk * G * D : 0;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dO and the three gradients
// alike); lse (the forward's) and delta (scratch) are contiguous fp32 (B, H,
// Sq); scratch holds flash_attention_bwd_scratch_floats floats. Strides are
// in elements, (batch, row, head) of q, k, v, o, dO, dq, dk, dv in that
// order; the last dim of every tensor is contiguous.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, float* scratch, void* dq, void* dk, void* dv, int dtype,
    int B, int H, int G, int Sq, int Tk, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kst, long long ksg, long long vsb, long long vst, long long vsg,
    long long osb, long long oss, long long osh, long long dosb, long long doss,
    long long dosh, long long dqsb, long long dqss, long long dqsh, long long dksb,
    long long dkst, long long dksg, long long dvsb, long long dvst, long long dvsg,
    int causal, int window, int q_offset, float scale, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || H % G || Sq <= 0 || Tk <= 0 || D <= 0 ||
      D > kMaxHeadDim || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int slices = slices_for(B, H, G, Tk);
  if (slices > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  BwdArgs A{q, k, v, o, dout, lse, delta, scratch, dq, dk, dv, B, H, G, Sq, Tk, D,
            qsb, qss, qsh, ksb, kst, ksg, vsb, vst, vsg, osb, oss, osh,
            dosb, doss, dosh, dqsb, dqss, dqsh, dksb, dkst, dksg, dvsb, dvst, dvsg,
            causal, window, q_offset, scale, 0, slices};
  // 16-byte staging and paired stores: D and every row stride in whole
  // 16-byte chunks, 16-byte aligned bases
  const int per16 = dtype == 0 ? 4 : 8;
  const long long strides[24] = {qsb, qss, qsh, ksb, kst, ksg, vsb, vst, vsg, osb, oss, osh,
                                 dosb, doss, dosh, dqsb, dqss, dqsh, dksb, dkst, dksg,
                                 dvsb, dvst, dvsg};
  bool vec = D % per16 == 0;
  for (const void* p : {q, k, v, o, dout, (const void*)dq, (const void*)dk, (const void*)dv})
    vec = vec && aligned16(p);
  for (long long s : strides) vec = vec && s % per16 == 0;
  A.vec = vec;
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (long long)B * H * Sq;
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  if (dtype == 1) flash_bwd_delta_kernel<bf16><<<blocks, kThreads, 0, st>>>(A);
  else flash_bwd_delta_kernel<float><<<blocks, kThreads, 0, st>>>(A);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int rc;
  if (dtype == 1 && D <= 64) rc = launch_wgmma<64>(A, st);
  else if (dtype == 1 && D <= 128) rc = launch_wgmma<128>(A, st);
  else if (dtype == 1) rc = dispatch_cuda_cores<bf16>(A, st);
  else rc = dispatch_cuda_cores<float>(A, st);
  if (rc != 0 || slices == 1) return rc;
  const long long n = (long long)B * Tk * G * D;
  const unsigned sum_blocks = (unsigned)std::min<long long>((n + kThreads - 1) / kThreads, 4096);
  if (dtype == 1) flash_bwd_slice_sum_kernel<bf16><<<sum_blocks, kThreads, 0, st>>>(A);
  else flash_bwd_slice_sum_kernel<float><<<sum_blocks, kThreads, 0, st>>>(A);
  return (int)cudaGetLastError();
}
