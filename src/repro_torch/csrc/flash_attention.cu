// K3 flash_attention: forward GQA attention for prefill, causal with an
// optional sliding window (key t visible to query position p when t <= p
// and t > p - window) and a query offset, online softmax in fp32.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py:flash_attention
// (Pallas; grid (B, H, nQ, nK) with the running max / denominator /
// accumulator carried in VMEM scratch across the sequential KV axis).
//
// Bound on the H100: at the served shape (S = 512, D = 64, 32/4 heads)
// bytes, q, k, v read once and o written once over 3.35 TB/s (1.4 us);
// the causal products, 2 * B * H * S^2 * D flops over the 989 TFLOP/s bf16
// tensor-core peak, take over from S ~ 660. At these sizes neither is what
// a simple kernel hits first: one warpgroup per SM sub-partition waits on
// every latency, so the design is about issuing few instructions per tile
// and keeping several warpgroups in flight.
//
// Design (bf16, the served path): a block owns one 64-row q tile of one
// head (64 rows is what a wgmma takes) and W warpgroups (W = 2 up to
// D = 128) that split
// its key tiles between them: tile j goes to warpgroup j % W, which halves
// the longest block's chain of key tiles (the last q tile has 8 at S = 512)
// and puts two warpgroups' latencies side by side. The TPU's sequential KV
// grid axis becomes each warpgroup's loop over its 64-key tiles. Q is
// loaded once; K and V tiles come by TMA (one thread issues a tile, an
// mbarrier per slot counts its bytes) into a two-slot ring per warpgroup,
// so the copy of a warpgroup's next tile runs under the products on its
// current one. TMA writes the 128-byte swizzle that the wgmma descriptors
// name, as 64-column blocks; where D is not a multiple of 64, or the
// strides do not suit TMA, 16-byte cp.async copies write the same layout
// (D zero-padded to 64, 128 or 256). S = Q K^T is wgmma m64n64k16 with both
// operands in shared memory (K-major); the online softmax (max, exp2, row
// sum, rescale) runs in fp32 registers on the accumulator's layout, which
// is also the layout of wgmma's register A operand, and O += P V is wgmma
// m64nDk16 with V as an MN-major B operand. P goes to the tensor cores as a
// bf16 high part and the bf16 rounding of what it leaves, two products per
// k-step: bf16 P alone moved the served prefill logits past their 2e-2
// check. At the end the warpgroups' partial (max, sum, O) meet in shared
// memory. Key tiles wholly above the causal diagonal or outside the window
// are never loaded, and only a tile that crosses the diagonal, a window
// edge or the ragged end of T is masked. Blocks run the q tiles with the
// most key tiles first, and the R = H / G heads that share a KV head are
// neighbours, so their K/V tiles come from L2. Masked scores are -1e30 as
// in the JAX kernel; a row that sees no key (a causal position past T with
// a window, or before 0 through a negative offset) gets what the plain
// version gives it, the mean of V over [0, T).
//
// At D = 256 (gemma) the block is one warpgroup (W = 1) with the same
// two-slot ring: Q and two (K, V) slots of 64 x 256 bf16 are 5 x 32 KB
// (164 KB with the alignment pad), where two warpgroups' rings would need
// 289 KB of the 227 KB a block may have. O += P V is one m64n256k16 per
// k-step, and O takes 128 fp32 registers a thread beside S's 32 and P's
// 32; a block of 128 threads may use 255. Of the three layouts that fit
// (this one; two warpgroups with one slot each; two warpgroups splitting
// O's columns over a shared P), this is the one that changes nothing but
// the instance: the copy of a tile still runs under the products on the
// one before, and no hand-off is added. Its cost is a chain of up to 8
// key tiles in the last q tile at S = 512 where W = 2 halves it; with
// 164 KB a block, one block runs on an SM either way.
//
// fp32 inputs take the CUDA-core kernel below (fp32 scores from the loaded
// values, 32-key tiles, one key per lane): TF32 would keep ~3 digits and
// miss the fp32 tolerance. The choice is by dtype; neither is a fallback.
//
// Given an fp32 (B, H, Sq) `lse`, both kernels also write each row's
// log-sum-exp of its scaled scores (natural log; -1e30 for a row that sees
// no key, as the plain helper gives), which K3b (flash_attention_bwd.cu)
// reads to recompute P. Served calls pass null and write only O; the O
// they write is the same either way.
#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace repro;

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kRowsPerWarp = 4;
constexpr int kTileQ = kWarps * kRowsPerWarp;

template <int DPL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int H, int G,
                     int Sq, int Tk, int D, long long qsb, long long qss, long long qsh,
                     long long ksb, long long kst, long long ksg,
                     long long vsb, long long vst, long long vsg,
                     long long osb, long long oss, long long osh,
                     int causal, int window, int q_offset, float scale, int vec,
                     float* __restrict__ lse) {
  extern __shared__ __align__(16) float smem[];
  const int QS = q_stride(D), KS = k_stride(D);
  float* qs = smem;                        // kTileQ x QS
  float* ks = qs + kTileQ * QS;            // kTileK x KS
  float* vs = ks + kTileK * KS;            // kTileK x D
  float* pbuf = vs + kTileK * D;           // kWarps x kRowsPerWarp x 32: each warp's p

  const int q0 = blockIdx.x * kTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + g * ksg;
  const float* vb = v + b * vsb + g * vsg;

  // q rows (zero past Sq and in the pad columns), and K's pad columns.
  for (int idx = threadIdx.x; idx < kTileQ * QS; idx += blockDim.x) {
    const int r = idx / QS;
    const int d = idx - r * QS;
    const int sq = q0 + r;
    qs[idx] = sq < Sq && d < D ? qb[sq * qss + d] : 0.f;
  }
  for (int idx = threadIdx.x; idx < kTileK * (QS - D); idx += blockDim.x) {
    const int j = idx / (QS - D);
    ks[j * KS + D + idx - j * (QS - D)] = 0.f;
  }

  // Keys any row of this tile can see.
  const int p_lo = q0 + q_offset;
  const int p_hi = min(q0 + kTileQ, Sq) - 1 + q_offset;
  int k_end = Tk;
  if (causal) k_end = min(k_end, p_hi + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, p_lo - window + 1);
  k_begin = (k_begin / kTileK) * kTileK;

  RowState<DPL> st[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) row_init(st[rr]);

  for (int k0 = k_begin; k0 < k_end; k0 += kTileK) {
    __syncthreads();  // the previous tile (and, first time, q) is consumed/ready
    if (vec) {
      TileRegs<tile_chunks<float, DPL>()> t;
      fetch_tile(t, kb, vb, kst, vst, k0, Tk, D, kTileK);
      store_tile<float>(t, ks, vs, D, kTileK);
    } else {
      load_kv_tile(ks, vs, kb, vb, kst, vst, k0, Tk, D);
    }
    __syncthreads();
    const int t = k0 + lane;
    bool valid[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int p = q0 + warp * kRowsPerWarp + rr + q_offset;
      valid[rr] = t < Tk && (!causal || t <= p) && (window <= 0 || t > p - window);
    }
    rows_tile<DPL, kRowsPerWarp>(st, qs + warp * kRowsPerWarp * QS, ks, vs, D, valid, scale,
                                 lane, pbuf + warp * kRowsPerWarp * 32);
  }

  float* ob = o + b * osb + h * osh;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int sq = q0 + warp * kRowsPerWarp + rr;
    if (sq >= Sq) continue;
    const int p = sq + q_offset;  // keys [lo, hi] are visible to this row
    const int hi = causal ? min(p, Tk - 1) : Tk - 1;
    const int lo = window > 0 ? max(0, p - window + 1) : 0;
    if (lse != nullptr && lane == 0)
      lse[((long long)b * H + h) * Sq + sq] = lo > hi ? kNegInf : st[rr].m + logf(st[rr].l);
    if (lo > hi) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) ob[sq * oss + d] = mean_v(vb, vst, Tk, d);
      }
      continue;
    }
    const float inv = 1.f / fmaxf(st[rr].l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) ob[sq * oss + d] = st[rr].acc[i] * inv;
    }
  }
}

template <int DPL>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
               int H, int G, int Sq, int Tk, int D, const long long* s, int causal,
               int window, int q_offset, float scale, int vec, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(kTileQ * q_stride(D) + kTileK * k_stride(D) +
                                               kTileK * D + kThreads * kRowsPerWarp);
  auto kernel = flash_fwd_f32_kernel<DPL>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kTileQ - 1) / kTileQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, H, G, Sq, Tk, D,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
      causal, window, q_offset, scale, vec, lse);
  return (int)cudaGetLastError();
}

int dispatch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                 int H, int G, int Sq, int Tk, int D, const long long* s, int causal,
                 int window, int q_offset, float scale, int vec, cudaStream_t stream) {
  switch ((D + 31) / 32) {
    case 1: return launch_f32<1>(q, k, v, o, lse, B, H, G, Sq, Tk, D, s, causal, window, q_offset, scale, vec, stream);
    case 2: return launch_f32<2>(q, k, v, o, lse, B, H, G, Sq, Tk, D, s, causal, window, q_offset, scale, vec, stream);
    case 3: return launch_f32<3>(q, k, v, o, lse, B, H, G, Sq, Tk, D, s, causal, window, q_offset, scale, vec, stream);
    case 4: return launch_f32<4>(q, k, v, o, lse, B, H, G, Sq, Tk, D, s, causal, window, q_offset, scale, vec, stream);
    case 5: return launch_f32<5>(q, k, v, o, lse, B, H, G, Sq, Tk, D, s, causal, window, q_offset, scale, vec, stream);
    case 6: return launch_f32<6>(q, k, v, o, lse, B, H, G, Sq, Tk, D, s, causal, window, q_offset, scale, vec, stream);
    case 7: return launch_f32<7>(q, k, v, o, lse, B, H, G, Sq, Tk, D, s, causal, window, q_offset, scale, vec, stream);
    case 8: return launch_f32<8>(q, k, v, o, lse, B, H, G, Sq, Tk, D, s, causal, window, q_offset, scale, vec, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), K/V rings filled by TMA or cp.async
// ---------------------------------------------------------------------------
// Issue and commit O += (P_hi + P_lo) V for one 64-key tile: 16 keys per
// k-step, V MN-major (D contiguous) at shared address `vt`.
template <int DP>
__device__ __forceinline__ void issue_pv(float (&acc)[DP / 2], const uint32_t (&pa)[4][4],
                                         const uint32_t (&pb)[4][4], uint32_t vt) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const uint64_t dv = sw128_desc(vt + t * 16 * 128, kBlockBytes, 1024);
    wgmma_pv<DP>(acc, pa[t], dv);
    wgmma_pv<DP>(acc, pb[t], dv);
  }
  wgmma_commit();
}

// W warpgroups share one q tile of one head and split its key tiles
// between them (tile j goes to warpgroup j % W), each with its own
// two-slot K/V ring and barrier; their partial (max, sum, O) meet in
// shared memory at the end. That keeps several warps per scheduler busy
// where one warpgroup alone would wait on every latency, and cuts the
// longest block's chain of key tiles by W.
template <int DP, int W>
__global__ void __launch_bounds__(kWgThreads * W)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o, int B, int H,
                       int G, int Sq, int Tk, int D, long long qsb, long long qss,
                       long long qsh, long long ksb, long long kst, long long ksg,
                       long long vsb, long long vst, long long vsg, long long osb,
                       long long oss, long long osh, int causal, int window,
                       int q_offset, float scale_log2, int n_qt, int vec, int tma,
                       float* __restrict__ lse,
                       const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap) {
  constexpr int kTileBytes = kTile * DP * 2;      // one 64-row tile, DP columns
  constexpr int kNO = DP / 2;                     // O accumulator floats per thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms are 1024-B aligned
  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads;
  const int wt = tid % kWgThreads;
  const uint32_t qs = base;
  const uint32_t ring = base + (1 + 4 * wg) * kTileBytes;  // 2 slots of (K, V)
  const uint32_t bars = base + (1 + 4 * W) * kTileBytes;  // Q's, then 2 per warpgroup

  int qt, h, b;
  block_coords(blockIdx.x, n_qt, H, B, qt, h, b);
  const int q0 = qt * kTile;
  const int g = h / (H / G);
  const int warp = wt >> 5;
  const int lane = tid & 31;
  const int row0 = warp * 16 + (lane >> 2);       // this thread's rows: row0, row0 + 8
  const int cq = (lane & 3) * 2;                  // and columns 8j + cq, 8j + cq + 1

  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + g * ksg;
  const bf16* vb = v + b * vsb + g * vsg;

  // Keys any row of this tile can see, in whole tiles.
  const int p_lo = q0 + q_offset;
  const int p_hi = min(q0 + kTile, Sq) - 1 + q_offset;
  int k_end = Tk;
  if (causal) k_end = min(k_end, p_hi + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, p_lo - window + 1);
  k_begin = (k_begin / kTile) * kTile;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kTile - 1) / kTile : 0;
  const int my_tiles = n_tiles > wg ? (n_tiles - wg + W - 1) / W : 0;
  auto slot_bar = [&](int i) { return bars + 8 * (1 + 2 * wg + i % 2); };
  // This warpgroup's i-th key tile into slot i % 2: by TMA (one thread
  // issues it, the slot's mbarrier counts its bytes) or by cp.async.
  auto load_kv = [&](int i) {
    const int k0 = k_begin + (wg + i * W) * kTile;
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
      load_tile<DP, kWgThreads>(slot, kb + k0 * kst, kst, Tk - k0, D, vec, wt);
      load_tile<DP, kWgThreads>(slot + kTileBytes, vb + k0 * vst, vst, Tk - k0, D, vec, wt);
    }
  };

  if (tma) {
    if (tid == 0) {
      for (int i = 0; i < 1 + 2 * W; ++i) mbar_init(bars + 8 * i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      mbar_expect_tx(bars, kTileBytes);
#pragma unroll
      for (int c = 0; c < DP / 64; ++c)
        tma_load(qs + c * kBlockBytes, &qmap, bars, c * 64, q0, h, b);
    }
    if (my_tiles > 0) load_kv(0);
    mbar_wait(bars, 0);                           // Q landed
  } else {
    load_tile<DP, kWgThreads * W>(qs, qb + q0 * qss, qss, Sq - q0, D, vec, tid);
    cp_async_commit();
    if (my_tiles > 0) load_kv(0);
    cp_async_commit();
    cp_async_wait<1>();                           // Q landed for this thread
    fence_async_shared();
    __syncthreads();                              // ... and for every thread
  }

  float acc[kNO];
#pragma unroll
  for (int i = 0; i < kNO; ++i) acc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < my_tiles; ++i) {
    if (tma) {
      mbar_wait(slot_bar(i), (i / 2) & 1);        // tile i landed
    } else {
      cp_async_wait<0>();                         // tile i landed for this thread
      fence_async_shared();
    }
    wg_barrier(1 + wg);                           // ... for the warpgroup; tile i-1 done
    if (i + 1 < my_tiles) load_kv(i + 1);         // into the slot tile i-1 used
    if (!tma) cp_async_commit();
    const int k0 = k_begin + (wg + i * W) * kTile;
    const uint32_t kt = ring + (i % 2) * 2 * kTileBytes;
    const uint32_t vt = kt + kTileBytes;

    // S = Q K^T over DP / 16 k-steps of 32 bytes inside each column block.
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < DP / 16; ++t) {
      const uint32_t off = (t / 4) * kBlockBytes + (t % 4) * 32;
      wgmma_ss_n64(s, sw128_desc(qs + off, 16, 1024), sw128_desc(kt + off, 16, 1024), t > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Scale into the exp2 domain; mask (to -1e30, as the JAX kernel does)
    // only a tile that needs it. Row r sees the tile's columns
    // [lo_r, hi_r]; this thread's column e is (e / 4) * 8 + e % 2 + cq.
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] *= scale_log2;
    const bool full = k0 + kTile <= Tk && (!causal || k0 + kTile - 1 <= p_lo) &&
                      (window <= 0 || k0 > p_hi - window);
    if (!full) {
      int lo[2], hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = q0 + row0 + 8 * r + q_offset;
        hi[r] = (causal ? min(p, Tk - 1) : Tk - 1) - k0 - cq;
        lo[r] = (window > 0 ? p - window + 1 : 0) - k0 - cq;
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int c = (e / 4) * 8 + (e % 2), r = (e % 4) / 2;
        if (c < lo[r] || c > hi[r]) s[e] = kNegInf;
      }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      if ((e % 4) < 2) mx0 = fmaxf(mx0, s[e]);
      else mx1 = fmaxf(mx1, s[e]);
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // P as wgmma's register A operand (k-step e / 8), split into a bf16
    // high part and the bf16 rounding of what it leaves, so that P V keeps
    // ~16 bits of P (bf16 P alone moved the served logits past the 2e-2
    // check).
    float sum0 = 0.f, sum1 = 0.f;
    uint32_t pa[4][4], pb[4][4];
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const float mm = (e % 4) < 2 ? mn0 : mn1;
      const float e0 = ex2(s[e] - mm), e1 = ex2(s[e + 1] - mm);
      if ((e % 4) < 2) sum0 += e0 + e1;
      else sum1 += e0 + e1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(e0, e1);
      pa[e / 8][(e % 8) / 2] = *reinterpret_cast<const uint32_t*>(&hi);
      pb[e / 8][(e % 8) / 2] = pack_bf16(e0 - __low2float(hi), e1 - __high2float(hi));
    }
    l0 = l0 * a0 + sum0;                          // partial over this thread's columns
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int e = 0; e < kNO; ++e) acc[e] *= (e % 4) < 2 ? a0 : a1;

    fence_regs(acc);
    wgmma_fence();
    issue_pv<DP>(acc, pa, pb, vt);
    wgmma_wait_all();
    fence_regs(acc);
  }
  cp_async_wait<0>();

  // Warpgroups 1.. leave (O, m, l) in their own ring, thread-major, and
  // warpgroup 0 folds them into its own.
  float* part = reinterpret_cast<float*>(smem_raw + (ring - raw));
  if (W > 1) {
    wg_barrier(1 + wg);                           // the ring's last tile is consumed
    if (wg > 0) {
#pragma unroll
      for (int e = 0; e < kNO; ++e) part[e * kWgThreads + wt] = acc[e];
      part[(kNO + 0) * kWgThreads + wt] = m0;
      part[(kNO + 1) * kWgThreads + wt] = m1;
      part[(kNO + 2) * kWgThreads + wt] = l0;
      part[(kNO + 3) * kWgThreads + wt] = l1;
    }
    __syncthreads();
    if (wg > 0) return;
    float mw0[W], mw1[W];
    float M0 = m0, M1 = m1;
#pragma unroll
    for (int w = 1; w < W; ++w) {
      const float* pw = part + w * 4 * kTileBytes / 4;
      mw0[w] = pw[(kNO + 0) * kWgThreads + wt];
      mw1[w] = pw[(kNO + 1) * kWgThreads + wt];
      M0 = fmaxf(M0, mw0[w]);
      M1 = fmaxf(M1, mw1[w]);
    }
    float f0 = ex2(m0 - M0), f1 = ex2(m1 - M1);
    l0 *= f0;
    l1 *= f1;
#pragma unroll
    for (int e = 0; e < kNO; ++e) acc[e] *= (e % 4) < 2 ? f0 : f1;
#pragma unroll
    for (int w = 1; w < W; ++w) {
      const float* pw = part + w * 4 * kTileBytes / 4;
      f0 = ex2(mw0[w] - M0);
      f1 = ex2(mw1[w] - M1);
      l0 = fmaf(pw[(kNO + 2) * kWgThreads + wt], f0, l0);
      l1 = fmaf(pw[(kNO + 3) * kWgThreads + wt], f1, l1);
#pragma unroll
      for (int e = 0; e < kNO; ++e)
        acc[e] = fmaf(pw[e * kWgThreads + wt], (e % 4) < 2 ? f0 : f1, acc[e]);
    }
    m0 = M0;                                      // the row maxima of the merged sums
    m1 = M1;
  }

#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
  }
  bf16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int sq = q0 + row0 + half * 8;
    if (sq >= Sq) continue;
    const int p = sq + q_offset;                  // keys [lo, hi] are visible to this row
    const int hi = causal ? min(p, Tk - 1) : Tk - 1;
    const int lo = window > 0 ? max(0, p - window + 1) : 0;
    bf16* orow = ob + sq * oss;
    if (lse != nullptr && (lane & 3) == 0)        // log2 domain back to natural log
      lse[((long long)b * H + h) * Sq + sq] =
          lo > hi ? kNegInf : ((half ? m1 : m0) + log2f(half ? l1 : l0)) * 0.6931471805599453f;
    if (lo > hi) {
      for (int jj = 0; jj < DP / 8; ++jj)
        for (int e = 0; e < 2; ++e)
          if (jj * 8 + cq + e < D)
            orow[jj * 8 + cq + e] = __float2bfloat16(mean_v(vb, vst, Tk, jj * 8 + cq + e));
      continue;
    }
    const float inv = 1.f / fmaxf(half ? l1 : l0, 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DP / 8; ++jj) {
      const int d = jj * 8 + cq;
      const float x0 = acc[jj * 4 + half * 2] * inv, x1 = acc[jj * 4 + half * 2 + 1] * inv;
      if (vec) {
        if (d < D) *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (d < D) orow[d] = __float2bfloat16(x0);
        if (d + 1 < D) orow[d + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int DP, int W>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                int H, int G, int Sq, int Tk, int D, const long long* s, int causal,
                int window, int q_offset, float scale, int vec, cudaStream_t stream) {
  // TMA where D fills whole 64-column boxes (and the strides suit it, which
  // `vec` says); cp.async otherwise.
  CUtensorMap maps[3] = {};
  int tma = vec && D % 64 == 0;
  if (tma) {
    tma = tensor_map(&maps[0], q, D, Sq, H, B, s[1], s[2], s[0]) &&
          tensor_map(&maps[1], k, D, Tk, G, B, s[4], s[5], s[3]) &&
          tensor_map(&maps[2], v, D, Tk, G, B, s[7], s[8], s[6]);
    if (!tma) return (int)cudaErrorInvalidValue;
  }
  const size_t smem = 1024 + (size_t)(1 + 4 * W) * kTile * DP * 2 + 8 * (1 + 2 * W);
  auto kernel = flash_fwd_wgmma_kernel<DP, W>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Sq + kTile - 1) / kTile;
  kernel<<<n_qt * H * B, kWgThreads * W, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, B, H, G, Sq, Tk, D,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
      causal, window, q_offset, scale * kLog2e, n_qt, vec, tma, lse, maps[0], maps[1],
      maps[2]);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, in the order
// q (b, s, h), k (b, t, g), v (b, t, g), o (b, s, h); the last dim of every
// tensor is contiguous. lse: null, or a contiguous fp32 (B, H, Sq) for each
// row's log-sum-exp.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      float* lse, int dtype, int B, int H, int G, int Sq,
                                      int Tk, int D,
                                      long long qsb, long long qss, long long qsh,
                                      long long ksb, long long kst, long long ksg,
                                      long long vsb, long long vst, long long vsg,
                                      long long osb, long long oss, long long osh,
                                      int causal, int window, int q_offset, float scale,
                                      void* stream) {
  const long long s[12] = {qsb, qss, qsh, ksb, kst, ksg, vsb, vst, vsg, osb, oss, osh};
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || H <= 0 || G <= 0 || H % G || D <= 0 || D > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  // 16-byte staging (and paired stores of O) needs D and every row stride
  // in whole 16-byte chunks (8 bf16, 4 fp32) and 16-byte aligned bases.
  const int per16 = dtype == 0 ? 4 : 8;
  bool vec = D % per16 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
  for (int i = 0; i < 12; ++i) vec = vec && s[i] % per16 == 0;
  if (dtype == 0)
    return dispatch_f32(q, k, v, o, lse, B, H, G, Sq, Tk, D, s, causal, window, q_offset,
                        scale, vec, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (D <= 64)
    return launch_bf16<64, 2>(q, k, v, o, lse, B, H, G, Sq, Tk, D, s, causal, window, q_offset,
                              scale, vec, st);
  if (D <= 128)
    return launch_bf16<128, 2>(q, k, v, o, lse, B, H, G, Sq, Tk, D, s, causal, window, q_offset,
                               scale, vec, st);
  return launch_bf16<256, 1>(q, k, v, o, lse, B, H, G, Sq, Tk, D, s, causal, window, q_offset,
                             scale, vec, st);
}
