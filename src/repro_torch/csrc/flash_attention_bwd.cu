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
// Three launches on the caller's stream:
//  1. delta: one warp per (batch, row, head), fp32.
//  2. dK/dV: one block per (64-key tile, KV head, batch), blocks of the
//     first key tiles first (under the causal mask they see the most query
//     tiles). The block walks the (query tile, head) pairs of its KV
//     group's R heads whose rows see a key of the tile, or see no key at
//     all (query_tiles; kernels/flash_attention/flash_attention.py:
//     bwd_query_tiles mirrors it). With the key tile as wgmma's M,
//     S^T = K Q^T and dP^T = V dO^T land in the accumulator layout, which
//     is wgmma's register A operand, so P^T = exp2(S^T scale log2e - lse
//     log2e) and dS^T = P^T (dP^T - delta) go straight into dV += P^T dO and
//     dK += dS^T Q with no trip through shared memory, as K3's forward feeds
//     its P. dK and dV of the key tile stay in registers for the whole
//     group and are written once. W warpgroups each take a fixed share of
//     the pairs (pair j to warpgroup j % W), each with its own two-slot
//     ring of (Q, dO) tiles filled by TMA under the products on the tile
//     before; the others' sums are added to warpgroup 0's in shared memory
//     in a fixed order at the end. W is 3 at D <= 64 (165 registers a
//     thread: 12 warps an SM keep each other's latencies covered; on an
//     H100 80GB HBM3 at 700 W, 0.196 ms at the train shape against 0.220
//     with W = 2, kernel_variants.py k3b) and 2 at D = 128, where a thread
//     holds 228 registers.
//  3. dQ: one block per (64-query tile, head, batch), in K3's forward
//     order (block_coords). Q and dO are loaded once; the two warpgroups
//     split the key tiles the rows see (tile j to warpgroup j % 2), each
//     with a two-slot (K, V) ring: S = Q K^T, dP = dO V^T, then dQ += dS K.
//     The two dQ sums meet in shared memory at the end.
// P and dS enter the products as bf16 (one rounding each, against 2e-2 of
// each gradient's max). Tiles come by TMA in the 128-byte swizzle where D
// is a multiple of 64 and the strides suit it, by 16-byte cp.async (or
// element by element) into the same layout otherwise, D zero-padded to 64
// or 128 (hopper_common.cuh).
//
// Routes, by dtype and D (neither is a fallback): bf16 at D <= 128 on the
// tensor cores as above; fp32 (the fp32 training entry point) and bf16 at
// D of 129 to 256 (gemma's 256) on the CUDA cores, fp32 inside, with the
// same two passes over 32-row and 32-key tiles: one key a lane for the
// scores, as K3's fp32 kernel, and each thread keeping four keys' dK and
// dV (or four rows' dQ) over its dims in registers. Every sum runs in a
// fixed order on both routes.
#include <initializer_list>

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
};

// Keys [lo, hi] visible to query row s (lo > hi: none).
__device__ __forceinline__ int key_hi(const BwdArgs& A, int s) {
  return A.causal ? min(s + A.q_offset, A.Tk - 1) : A.Tk - 1;
}
__device__ __forceinline__ int key_lo(const BwdArgs& A, int s) {
  return A.window > 0 ? max(0, s + A.q_offset - A.window + 1) : 0;
}

// The exponential of each route's domain: 2^x for the tensor cores (scores
// and lse times log2 e), e^x for the CUDA cores.
struct Exp2 {
  __device__ __forceinline__ float operator()(float x) const { return ex2(x); }
};
struct ExpE {
  __device__ __forceinline__ float operator()(float x) const { return __expf(x); }
};

// P and dS of query row s and key t, from the scaled score and the row's
// lse in `ex`'s domain, dP and delta.
template <typename Ex>
__device__ __forceinline__ void p_ds(const BwdArgs& A, int s, int t, float sc, float lse,
                                     float dp, float dlt, float inv_t, Ex ex, float& p,
                                     float& ds) {
  const int lo = key_lo(A, s), hi = key_hi(A, s);
  if (s < A.Sq && t >= lo && t <= hi) {
    p = ex(sc - lse);
    ds = p * (dp - dlt);
  } else {
    p = s < A.Sq && lo > hi && t < A.Tk ? inv_t : 0.f;   // a row that sees no key
    ds = 0.f;
  }
}

// The query tiles (of `tile` rows) the dK/dV pass walks for key tile kt,
// as three runs [a, a + n) in order: tiles of rows before position 0
// (causal: they see no key), tiles of rows that see a key of the tile, and
// tiles of rows past the window's reach of the last key (they see none).
// flash_attention.py:bwd_query_tiles is the same rule.
struct QTiles {
  int a0, n0, a1, n1, a2, n2;
  __device__ __forceinline__ int count() const { return n0 + n1 + n2; }
  __device__ __forceinline__ int at(int j) const {
    return j < n0 ? a0 + j : j < n0 + n1 ? a1 + j - n0 : a2 + j - n0 - n1;
  }
};

__device__ __forceinline__ QTiles query_tiles(const BwdArgs& A, int kt, int tile) {
  const int n_qt = (A.Sq + tile - 1) / tile;
  const int t_hi = min(kt * tile + tile, A.Tk) - 1;
  const int s_lo = A.causal ? max(0, kt * tile - A.q_offset) : 0;
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

// The key tiles [kb, kb + n) the dQ pass walks for query tile q0, as K3's
// forward walks them (flash_attention.py:bwd_key_tiles).
__device__ __forceinline__ void key_tiles(const BwdArgs& A, int q0, int tile, int& kb,
                                          int& n) {
  const int p_lo = q0 + A.q_offset;
  const int p_hi = min(q0 + tile, A.Sq) - 1 + A.q_offset;
  int k_end = A.Tk;
  if (A.causal) k_end = min(k_end, p_hi + 1);
  int k_begin = A.window > 0 ? max(0, p_lo - A.window + 1) : 0;
  k_begin = (k_begin / tile) * tile;
  kb = k_begin;
  n = k_end > k_begin ? (k_end - k_begin + tile - 1) / tile : 0;
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

// ---------------------------------------------------------------------------
// 2-3. bf16 at D <= 128: tensor cores
// ---------------------------------------------------------------------------
constexpr int kW = 2;                             // warpgroups a dQ block
constexpr int kWkv64 = 3;                         // warpgroups a dK/dV block at D <= 64

// bf16 (row r0 and r0 + 8, columns 8j + c, 8j + c + 1) of an accumulator
// written to `out` rows [row_base, ...) below `rows`, D columns, stride rs.
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

// `part` (warpgroup 1's ring, thread-major) added into warpgroup 0's sums in
// a fixed order.
template <int N>
__device__ __forceinline__ void add_part(float (&acc)[N], const float* part, int wt) {
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] += part[e * kWgThreads + wt];
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
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads;
  const int wt = tid % kWgThreads;
  const uint32_t ks = base, vs = base + kTileBytes;
  const uint32_t ring = base + (2 + 4 * wg) * kTileBytes;   // 2 slots of (Q, dO)
  const uint32_t bars = base + (2 + 4 * W) * kTileBytes;   // K/V's, then 2 a warpgroup
  // each slot's 64 rows of lse (exp2 domain) and delta, after the barriers
  float* rowv = reinterpret_cast<float*>(smem_raw + (bars + 8 * (1 + 2 * W) - raw)) +
                wg * 4 * kTile;

  const int per = A.G * A.B;
  const int kt = blockIdx.x / per;
  const int b = (blockIdx.x % per) / A.G;
  const int g = blockIdx.x % A.G;
  const int R = A.H / A.G;
  const int k0 = kt * kTile;
  const int warp = wt >> 5;
  const int lane = tid & 31;
  const int row0 = warp * 16 + (lane >> 2);       // this thread's keys: row0, row0 + 8
  const int cq = (lane & 3) * 2;                  // and queries 8j + cq, 8j + cq + 1
  const float scale_log2 = A.scale * kLog2e;
  const float inv_t = 1.f / (float)A.Tk;

  const bf16* qg = static_cast<const bf16*>(A.q) + b * A.qsb;
  const bf16* dg = static_cast<const bf16*>(A.dout) + b * A.dosb;
  const QTiles qt = query_tiles(A, kt, kTile);
  const int n_pairs = qt.count() * R;
  const int my = n_pairs > wg ? (n_pairs - wg + W - 1) / W : 0;
  auto pair_of = [&](int i, int& q0, int& h) {    // pair wg + i * W: (query tile, head)
    const int j = wg + i * W;
    q0 = qt.at(j / R) * kTile;
    h = g * R + j % R;
  };
  auto slot_bar = [&](int i) { return bars + 8 * (1 + 2 * wg + i % 2); };
  auto load_pair = [&](int i) {
    int q0, h;
    pair_of(i, q0, h);
    const uint32_t slot = ring + (i % 2) * 2 * kTileBytes;
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
    float* rv = rowv + (i % 2) * 2 * kTile;
    const int s = q0 + wt % kTile;
    const long long at = ((long long)b * A.H + h) * A.Sq + s;
    if (wt < kTile) rv[wt] = s < A.Sq ? A.lse[at] * kLog2e : 0.f;
    else rv[wt] = s < A.Sq ? A.delta[at] : 0.f;
  };

  if (tma) {
    if (tid == 0) {
      for (int i = 0; i < 1 + 2 * W; ++i) mbar_init(bars + 8 * i, 1);
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
    if (my > 0) load_pair(0);
    mbar_wait(bars, 0);                           // K and V landed
  } else {
    const bf16* kb = static_cast<const bf16*>(A.k) + b * A.ksb + g * A.ksg;
    const bf16* vb = static_cast<const bf16*>(A.v) + b * A.vsb + g * A.vsg;
    load_tile<DP, kWgThreads * W>(ks, kb + k0 * A.kst, A.kst, A.Tk - k0, A.D, A.vec, tid);
    load_tile<DP, kWgThreads * W>(vs, vb + k0 * A.vst, A.vst, A.Tk - k0, A.D, A.vec, tid);
    cp_async_commit();
    if (my > 0) load_pair(0);
    cp_async_commit();
    cp_async_wait<1>();                           // K and V landed for this thread
    fence_async_shared();
    __syncthreads();                              // ... and for every thread
  }

  float dk[kNO], dv[kNO];
#pragma unroll
  for (int e = 0; e < kNO; ++e) dk[e] = dv[e] = 0.f;

  for (int i = 0; i < my; ++i) {
    if (tma) {
      mbar_wait(slot_bar(i), (i / 2) & 1);        // pair i landed
    } else {
      cp_async_wait<0>();
      fence_async_shared();
    }
    wg_barrier(1 + wg);                           // ... for the warpgroup; pair i-1 done
    if (i + 1 < my) load_pair(i + 1);             // into the slot pair i-1 used
    if (!tma) cp_async_commit();
    int q0, h;
    pair_of(i, q0, h);
    const uint32_t qsl = ring + (i % 2) * 2 * kTileBytes;
    const uint32_t dsl = qsl + kTileBytes;
    const float* rv = rowv + (i % 2) * 2 * kTile;

    // S^T = K Q^T and dP^T = V dO^T: keys are the rows, queries the columns
    float st[32], dpt[32];
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
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // P^T and dS^T as wgmma's register A operand (k-step e / 8 over the
    // queries). Element e: key row0 + 8 ((e % 4) / 2), query (e / 4) * 8 +
    // e % 2 + cq. Only a pair that is not wholly visible is masked.
    const bool full = k0 + kTile <= A.Tk && q0 + kTile <= A.Sq &&
                      (!A.causal || k0 + kTile - 1 <= q0 + A.q_offset) &&
                      (A.window <= 0 || q0 + kTile - 1 + A.q_offset - A.window < k0);
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      float p[2], ds[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = ((e + u) / 4) * 8 + ((e + u) % 2) + cq;
        const float sc = st[e + u] * scale_log2;
        if (full) {
          p[u] = ex2(sc - rv[c]);
          ds[u] = p[u] * (dpt[e + u] - rv[kTile + c]);
        } else {
          p_ds(A, q0 + c, k0 + row0 + 8 * (((e + u) % 4) / 2), sc, rv[c], dpt[e + u],
               rv[kTile + c], inv_t, Exp2(), p[u], ds[u]);
        }
      }
      pa[e / 8][(e % 8) / 2] = pack_bf16(p[0], p[1]);
      da[e / 8][(e % 8) / 2] = pack_bf16(ds[0], ds[1]);
    }

    // dV += P^T dO and dK += dS^T Q: dO and Q as MN-major B operands
    fence_regs(dk);
    fence_regs(dv);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      wgmma_pv<DP>(dv, pa[t], sw128_desc(dsl + t * 16 * 128, kBlockBytes, 1024));
      wgmma_pv<DP>(dk, da[t], sw128_desc(qsl + t * 16 * 128, kBlockBytes, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dk);
    fence_regs(dv);
  }
  cp_async_wait<0>();

  // Warpgroups 1.. leave dK and dV in their rings (2 * kNO floats a thread
  // fill its four tiles), warpgroup 0 adds them to its own.
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
    const float* pw = part + w * 4 * kTileBytes / 4;
    add_part(dk, pw, wt);
    add_part(dv, pw + kNO * kWgThreads, wt);
  }
  store_rows<DP>(static_cast<bf16*>(A.dk) + b * A.dksb + g * A.dksg, A.dkst, dk, k0, A.Tk,
                 A.D, A.vec, row0, cq, A.scale);
  store_rows<DP>(static_cast<bf16*>(A.dv) + b * A.dvsb + g * A.dvsg, A.dvst, dv, k0, A.Tk,
                 A.D, A.vec, row0, cq, 1.f);
}

template <int DP>
__global__ void __launch_bounds__(kWgThreads * kW)
flash_bwd_dq_wgmma_kernel(const BwdArgs A, int tma, int n_qt,
                          const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap dmap) {
  constexpr int kTileBytes = kTile * DP * 2;
  constexpr int kNO = DP / 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads;
  const int wt = tid % kWgThreads;
  const uint32_t qs = base, dos = base + kTileBytes;
  const uint32_t ring = base + (2 + 4 * wg) * kTileBytes;   // 2 slots of (K, V)
  const uint32_t bars = base + (2 + 4 * kW) * kTileBytes;   // Q/dO's, then 2 a warpgroup

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
  key_tiles(A, q0, kTile, k_begin, n_tiles);
  const int my = n_tiles > wg ? (n_tiles - wg + kW - 1) / kW : 0;
  auto slot_bar = [&](int i) { return bars + 8 * (1 + 2 * wg + i % 2); };
  auto load_kv = [&](int i) {
    const int k0 = k_begin + (wg + i * kW) * kTile;
    const uint32_t slot = ring + (i % 2) * 2 * kTileBytes;
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

  if (tma) {
    if (tid == 0) {
      for (int i = 0; i < 1 + 2 * kW; ++i) mbar_init(bars + 8 * i, 1);
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
    if (my > 0) load_kv(0);
    mbar_wait(bars, 0);                           // Q and dO landed
  } else {
    const bf16* qb = static_cast<const bf16*>(A.q) + b * A.qsb + h * A.qsh;
    const bf16* db = static_cast<const bf16*>(A.dout) + b * A.dosb + h * A.dosh;
    load_tile<DP, kWgThreads * kW>(qs, qb + q0 * A.qss, A.qss, A.Sq - q0, A.D, A.vec, tid);
    load_tile<DP, kWgThreads * kW>(dos, db + q0 * A.doss, A.doss, A.Sq - q0, A.D, A.vec, tid);
    cp_async_commit();
    if (my > 0) load_kv(0);
    cp_async_commit();
    cp_async_wait<1>();
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

  for (int i = 0; i < my; ++i) {
    if (tma) {
      mbar_wait(slot_bar(i), (i / 2) & 1);
    } else {
      cp_async_wait<0>();
      fence_async_shared();
    }
    wg_barrier(1 + wg);
    if (i + 1 < my) load_kv(i + 1);
    if (!tma) cp_async_commit();
    const int k0 = k_begin + (wg + i * kW) * kTile;
    const uint32_t kt = ring + (i % 2) * 2 * kTileBytes;
    const uint32_t vt = kt + kTileBytes;

    float s[32], dp[32];
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
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // dS as the register A operand (k-step e / 8 over the keys); element e:
    // row row0 + 8 ((e % 4) / 2), key (e / 4) * 8 + e % 2 + cq
    const bool full = k0 + kTile <= A.Tk && (!A.causal || k0 + kTile - 1 <= p_lo) &&
                      (A.window <= 0 || k0 > p_hi - A.window);
    uint32_t da[4][4];
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

    // dQ += dS K: K as an MN-major B operand
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t)
      wgmma_pv<DP>(dq, da[t], sw128_desc(kt + t * 16 * 128, kBlockBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);
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
  add_part(dq, part + 4 * kTileBytes / 4, wt);
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
  const size_t tiles = 1024 + (size_t)(2 + 4 * kW) * kTile * DP * 2 + 8 * (1 + 2 * kW);
  const size_t smem_kv = 1024 + (size_t)(2 + 4 * Wkv) * kTile * DP * 2 + 8 * (1 + 2 * Wkv) +
                         sizeof(float) * Wkv * 4 * kTile;
  auto kv = flash_bwd_dkdv_wgmma_kernel<DP, Wkv>;
  auto dq = flash_bwd_dq_wgmma_kernel<DP>;
  cudaError_t err = allow_smem(kv, smem_kv);
  if (err == cudaSuccess) err = allow_smem(dq, tiles);
  if (err != cudaSuccess) return (int)err;
  const int n_kt = (A.Tk + kTile - 1) / kTile;
  const int n_qt = (A.Sq + kTile - 1) / kTile;
  kv<<<n_kt * A.G * A.B, kWgThreads * Wkv, smem_kv, stream>>>(A, tma, maps[0], maps[1],
                                                             maps[2], maps[3]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq<<<n_qt * A.H * A.B, kWgThreads * kW, tiles, stream>>>(A, tma, n_qt, maps[0], maps[1],
                                                           maps[2], maps[3]);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 2-3. fp32, and bf16 past D = 128: CUDA cores, fp32 inside
// ---------------------------------------------------------------------------
constexpr int kRowsPerWarp = kTileK / kWarps;     // 4 rows (or keys) of a 32-tile a warp

// Rows [r0, r0 + kTileK) of a (rows, D) tensor as fp32 into `dst` (row
// stride ld), zeros past `rows` and in columns [D, ld).
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src, long long rs, int r0,
                                      int rows, int D) {
  for (int idx = threadIdx.x; idx < kTileK * ld; idx += blockDim.x) {
    const int j = idx / ld;
    const int d = idx - j * ld;
    dst[idx] = r0 + j < rows && d < D ? to_float(src[(r0 + j) * rs + d]) : 0.f;
  }
}

// Scores of four rows (`qr`, `dr`: q and dO rows, stride q_stride(D))
// against this lane's key (`kr`, `vr`: its K and V rows): s = q . k and
// dp = dO . v, with float4 reads.
__device__ __forceinline__ void scores4(const float* qr, const float* dr, const float* kr,
                                        const float* vr, int QS, float (&s)[kRowsPerWarp],
                                        float (&dp)[kRowsPerWarp]) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 4
  for (int c = 0; c < QS / 4; ++c) {
    const float4 kv = reinterpret_cast<const float4*>(kr)[c];
    const float4 vv = reinterpret_cast<const float4*>(vr)[c];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float4 a = reinterpret_cast<const float4*>(qr + r * QS)[c];
      const float4 d = reinterpret_cast<const float4*>(dr + r * QS)[c];
      s[r] = fmaf(a.x, kv.x, fmaf(a.y, kv.y, fmaf(a.z, kv.z, fmaf(a.w, kv.w, s[r]))));
      dp[r] = fmaf(d.x, vv.x, fmaf(d.y, vv.y, fmaf(d.z, vv.z, fmaf(d.w, vv.w, dp[r]))));
    }
  }
}

// dK/dV: one block per (32-key tile, KV head, batch). Warp w keeps keys w,
// w + 8, w + 16, w + 24 of the tile over its lanes' dims.
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_f32_kernel(const BwdArgs A) {
  extern __shared__ __align__(16) float smem[];
  const int D = A.D, QS = q_stride(D), KS = k_stride(D);
  float* ks = smem;                               // kTileK x KS
  float* vs = ks + kTileK * KS;                   // kTileK x KS
  float* qs = vs + kTileK * KS;                   // kTileK x QS
  float* dos = qs + kTileK * QS;              // kTileK x QS: dO rows
  float* pb = dos + kTileK * QS;              // kTileK rows x 32 keys: P
  float* sb = pb + kTileK * 32;                   // dS
  float* rl = sb + kTileK * 32;                   // lse, delta of the rows

  const int per = A.G * A.B;
  const int kt = blockIdx.x / per;
  const int b = (blockIdx.x % per) / A.G;
  const int g = blockIdx.x % A.G;
  const int R = A.H / A.G;
  const int k0 = kt * kTileK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float inv_t = 1.f / (float)A.Tk;

  const T* kb = static_cast<const T*>(A.k) + b * A.ksb + g * A.ksg;
  const T* vb = static_cast<const T*>(A.v) + b * A.vsb + g * A.vsg;
  stage(ks, KS, kb, A.kst, k0, A.Tk, D);
  stage(vs, KS, vb, A.vst, k0, A.Tk, D);

  float dk[kRowsPerWarp][DPL], dv[kRowsPerWarp][DPL];
#pragma unroll
  for (int u = 0; u < kRowsPerWarp; ++u)
#pragma unroll
    for (int i = 0; i < DPL; ++i) dk[u][i] = dv[u][i] = 0.f;

  const QTiles qt = query_tiles(A, kt, kTileK);
  const int n_pairs = qt.count() * R;
  for (int j = 0; j < n_pairs; ++j) {
    const int q0 = qt.at(j / R) * kTileK;
    const int h = g * R + j % R;
    __syncthreads();                              // the last pair's rows are consumed
    stage(qs, QS, static_cast<const T*>(A.q) + b * A.qsb + h * A.qsh, A.qss, q0, A.Sq, D);
    stage(dos, QS, static_cast<const T*>(A.dout) + b * A.dosb + h * A.dosh, A.doss, q0,
          A.Sq, D);
    if (threadIdx.x < 2 * kTileK) {
      const int s = q0 + threadIdx.x % kTileK;
      const long long at = ((long long)b * A.H + h) * A.Sq + s;
      rl[threadIdx.x] = s >= A.Sq ? 0.f : threadIdx.x < kTileK ? A.lse[at] : A.delta[at];
    }
    __syncthreads();
    // P and dS of the warp's four rows, one key a lane
    const int r0 = warp * kRowsPerWarp;
    float s[kRowsPerWarp], dp[kRowsPerWarp];
    scores4(qs + r0 * QS, dos + r0 * QS, ks + lane * KS, vs + lane * KS, QS, s, dp);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float p, ds;
      p_ds(A, q0 + r0 + r, k0 + lane, s[r] * A.scale, rl[r0 + r], dp[r], rl[kTileK + r0 + r],
           inv_t, ExpE(), p, ds);
      pb[(r0 + r) * 32 + lane] = p;
      sb[(r0 + r) * 32 + lane] = ds;
    }
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q over the 32 rows, in row order
    for (int r = 0; r < kTileK; ++r) {
      float pk[kRowsPerWarp], sk[kRowsPerWarp];
#pragma unroll
      for (int u = 0; u < kRowsPerWarp; ++u) {
        pk[u] = pb[r * 32 + warp + kWarps * u];
        sk[u] = sb[r * 32 + warp + kWarps * u];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          const float dd = dos[r * QS + d], qd = qs[r * QS + d];
#pragma unroll
          for (int u = 0; u < kRowsPerWarp; ++u) {
            dv[u][i] = fmaf(pk[u], dd, dv[u][i]);
            dk[u][i] = fmaf(sk[u], qd, dk[u][i]);
          }
        }
      }
    }
  }

  T* dkb = static_cast<T*>(A.dk) + b * A.dksb + g * A.dksg;
  T* dvb = static_cast<T*>(A.dv) + b * A.dvsb + g * A.dvsg;
#pragma unroll
  for (int u = 0; u < kRowsPerWarp; ++u) {
    const int t = k0 + warp + kWarps * u;
    if (t >= A.Tk) continue;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) {
        dkb[t * A.dkst + d] = from_float<T>(dk[u][i] * A.scale);
        dvb[t * A.dvst + d] = from_float<T>(dv[u][i]);
      }
    }
  }
}

// dQ: one block per (32-row query tile, head, batch); warp w keeps rows 4w
// to 4w + 3 over its lanes' dims.
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32_kernel(const BwdArgs A) {
  extern __shared__ __align__(16) float smem[];
  const int D = A.D, QS = q_stride(D), KS = k_stride(D);
  float* qs = smem;                               // kTileK x QS
  float* dos = qs + kTileK * QS;              // kTileK x QS: dO rows
  float* ks = dos + kTileK * QS;              // kTileK x KS
  float* vs = ks + kTileK * KS;                   // kTileK x KS
  float* sw = vs + kTileK * KS;                   // each warp's 4 rows x 32 keys of dS

  const int q0 = blockIdx.x * kTileK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (A.H / A.G);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * kRowsPerWarp;

  stage(qs, QS, static_cast<const T*>(A.q) + b * A.qsb + h * A.qsh, A.qss, q0, A.Sq, D);
  stage(dos, QS, static_cast<const T*>(A.dout) + b * A.dosb + h * A.dosh, A.doss, q0,
        A.Sq, D);
  float lse[kRowsPerWarp], dlt[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int s = q0 + r0 + r;
    const long long at = ((long long)b * A.H + h) * A.Sq + s;
    lse[r] = s < A.Sq ? A.lse[at] : 0.f;
    dlt[r] = s < A.Sq ? A.delta[at] : 0.f;
  }
  const T* kb = static_cast<const T*>(A.k) + b * A.ksb + g * A.ksg;
  const T* vb = static_cast<const T*>(A.v) + b * A.vsb + g * A.vsg;

  float dq[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i) dq[r][i] = 0.f;

  int k_begin, n_tiles;
  key_tiles(A, q0, kTileK, k_begin, n_tiles);
  float* my_ds = sw + warp * kRowsPerWarp * 32;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * kTileK;
    __syncthreads();                              // the last tile is consumed (q staged)
    stage(ks, KS, kb, A.kst, k0, A.Tk, D);
    stage(vs, KS, vb, A.vst, k0, A.Tk, D);
    __syncthreads();
    float s[kRowsPerWarp], dp[kRowsPerWarp];
    scores4(qs + r0 * QS, dos + r0 * QS, ks + lane * KS, vs + lane * KS, QS, s, dp);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float p, ds;
      p_ds(A, q0 + r0 + r, k0 + lane, s[r] * A.scale, lse[r], dp[r], dlt[r], 0.f, ExpE(), p,
           ds);
      my_ds[r * 32 + lane] = ds;
    }
    __syncwarp();
    // dQ += dS K over the tile's 32 keys, in key order
    for (int t = 0; t < kTileK; ++t) {
      float dsk[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) dsk[r] = my_ds[r * 32 + t];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          const float kd = ks[t * KS + d];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) dq[r][i] = fmaf(dsk[r], kd, dq[r][i]);
        }
      }
    }
    __syncwarp();                                 // my_ds is rewritten by the next tile
  }

  T* dqb = static_cast<T*>(A.dq) + b * A.dqsb + h * A.dqsh;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int s = q0 + r0 + r;
    if (s >= A.Sq) continue;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) dqb[s * A.dqss + d] = from_float<T>(dq[r][i] * A.scale);
    }
  }
}

template <typename T, int DPL>
int launch_cuda_cores(const BwdArgs& A, cudaStream_t stream) {
  const int QS = q_stride(A.D), KS = k_stride(A.D);
  const size_t smem_kv =
      sizeof(float) * (size_t)(2 * kTileK * KS + 2 * kTileK * QS + 2 * kTileK * 32 + 2 * kTileK);
  const size_t smem_q = sizeof(float) * (size_t)(2 * kTileK * QS + 2 * kTileK * KS +
                                                 kWarps * kRowsPerWarp * 32);
  auto kv = flash_bwd_dkdv_f32_kernel<T, DPL>;
  auto dq = flash_bwd_dq_f32_kernel<T, DPL>;
  cudaError_t err = allow_smem(kv, smem_kv);
  if (err == cudaSuccess) err = allow_smem(dq, smem_q);
  if (err != cudaSuccess) return (int)err;
  const int n_kt = (A.Tk + kTileK - 1) / kTileK;
  kv<<<n_kt * A.G * A.B, kThreads, smem_kv, stream>>>(A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq<<<dim3((A.Sq + kTileK - 1) / kTileK, A.H, A.B), kThreads, smem_q, stream>>>(A);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_cuda_cores(const BwdArgs& A, cudaStream_t stream) {
  switch ((A.D + 31) / 32) {
    case 1: return launch_cuda_cores<T, 1>(A, stream);
    case 2: return launch_cuda_cores<T, 2>(A, stream);
    case 3: return launch_cuda_cores<T, 3>(A, stream);
    case 4: return launch_cuda_cores<T, 4>(A, stream);
    case 5: return launch_cuda_cores<T, 5>(A, stream);
    case 6: return launch_cuda_cores<T, 6>(A, stream);
    case 7: return launch_cuda_cores<T, 7>(A, stream);
    case 8: return launch_cuda_cores<T, 8>(A, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dO and the three gradients
// alike); lse (the forward's) and delta (scratch) are contiguous fp32 (B, H,
// Sq). Strides are in elements, (batch, row, head) of q, k, v, o, dO, dq,
// dk, dv in that order; the last dim of every tensor is contiguous.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int dtype, int B, int H,
    int G, int Sq, int Tk, int D, long long qsb, long long qss, long long qsh, long long ksb,
    long long kst, long long ksg, long long vsb, long long vst, long long vsg, long long osb,
    long long oss, long long osh, long long dosb, long long doss, long long dosh,
    long long dqsb, long long dqss, long long dqsh, long long dksb, long long dkst,
    long long dksg, long long dvsb, long long dvst, long long dvsg, int causal, int window,
    int q_offset, float scale, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || H % G || Sq <= 0 || Tk <= 0 || D <= 0 ||
      D > kMaxHeadDim || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  BwdArgs A{q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, G, Sq, Tk, D,
            qsb, qss, qsh, ksb, kst, ksg, vsb, vst, vsg, osb, oss, osh,
            dosb, doss, dosh, dqsb, dqss, dqsh, dksb, dkst, dksg, dvsb, dvst, dvsg,
            causal, window, q_offset, scale, 0};
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
  if (dtype == 1 && D <= 64) return launch_wgmma<64>(A, st);
  if (dtype == 1 && D <= 128) return launch_wgmma<128>(A, st);
  if (dtype == 1) return dispatch_cuda_cores<bf16>(A, st);
  return dispatch_cuda_cores<float>(A, st);
}
