// The former design of K4's tensor-core route, kept for kernel_variants.py k4
// (variant "C B^T shared by 2 heads through shared memory"): one warpgroup in
// turn computes S = C B^T for a slice of two heads and hands it over through
// shared memory. Only its tensor-core route is here (route 1; the CUDA-core
// route is ssd_chunk.cu's). The library (kernels/build.py) builds csrc/*.cu
// only, not this.

// K4 ssd_chunk: the intra-chunk part of Mamba2's SSD dual form. For each
// (batch, head, chunk) of Q positions with log decays a, inputs x (Q, P) and
// one B/C group (Q, N):
//   cs = cumsum(a); L[i, j] = exp(cs_i - cs_j) for i >= j, else 0
//   y_diag = (C B^T o L) x                               (Q, P), x's dtype
//   states = ((B o exp(cs_last - cs))^T x)^T             (P, N), fp32
//   out_decay = exp(cs)                                  (Q,), fp32
//
// Replaces: src/repro/kernels/ssd_chunk/ssd_chunk.py:ssd_chunk (Pallas
// `_ssd_kernel`; grid (batch*heads, chunks), the whole chunk resident in
// VMEM, three MXU products per step).
//
// Bound on the H100: bytes. At Mamba2-370m's prefill of 512 tokens (32
// heads of 64, one group of N = 128, Q = 256) the kernel must read x, a, B,
// C and write y_diag, states and out_decay, 6.7 MB, 0.0020 ms at 3.35 TB/s;
// its 0.55 GFLOP (C B^T once per group, causal halves) take 0.0006 ms at
// the bf16 tensor-core peak. Two routes, chosen by the wrapper from dtype
// and shape (kernels/ssd_chunk/ssd_chunk.py:route); neither falls back on
// the other.
//
// Tensor cores (bf16; Q % 64 == 0, 16 <= N <= 256 and P <= 128, both
// multiples of 16). The work is cut into items, one block each, and every
// item owns a (batch, chunk, group) and a slice of kSlice heads of that
// group; a block has one warpgroup per head of its slice.
//  - a y item also owns a 64-row tile i. For each key tile j <= i one
//    warpgroup (j % kSlice, in turn) computes S = C_i B_j^T (wgmma
//    m64n64k16, C and B bf16 K-major in shared memory, fp32 accumulators)
//    and leaves it in shared memory; then every warpgroup builds S o L_h of
//    its head in registers (exp only where i >= j, selected, never
//    multiplied by a mask; ex2.approx of the log2e-scaled difference of
//    the cumsums) and adds (S o L_h) x_h[j] into its y accumulator (wgmma
//    with the register A operand, x_h MN-major in shared memory). C B^T is
//    thus computed once per (chunk, group, row tile) for every kSlice
//    heads, not once per head, and the heads' products run side by side.
//  - a state item computes each head's states_h = (x_h o w_h)^T B (m = P,
//    n = N, k = Q) with w_h = exp(cs_last - cs), and out_decay: x_h comes
//    out of shared memory transposed by ldmatrix.trans into the register A
//    operand and is scaled by w_h there; B, the same for the group's heads,
//    is loaded once per block and stays bf16 in shared memory as the
//    MN-major B operand. Only the head's own operand is built per head.
// Both register-built operands go to the tensor cores as a sum of bf16
// parts, each the bf16 rounding of what the parts before it leave, one
// product per part: three for S o L (with two, many more of y's bf16
// roundings differ from the plain version's; kernel_variants.py k4 counts
// them) and two for x o w (one misses the fp32 states' 1e-4, as bf16 P
// missed K3's logits check). B, C
// and x are bf16 already, so their products are exact in the fp32
// accumulators. B, C and x tiles come by TMA (one thread
// issues, an mbarrier per slot counts the bytes) into a two-slot ring, so
// the next key tile's copy runs under the current tile's products; where
// N or P is not a multiple of 64, or a stride or base does not suit TMA,
// 16-byte cp.async copies (or, for strides that are not whole 16 bytes,
// element gathers) write the same swizzled layout, zero-padded to
// 64-column blocks. Operands stay bf16 in shared memory.
// Balance: a y item of row tile i walks i + 1 key tiles, and a state item
// all Q / 64 of them, so costs differ up to 4:1 at Q = 256. The host ranks
// the item kinds by a wgmma count (order_items) and the grid runs the
// heaviest kind first, so that the light items fill in behind the heavy
// ones instead of a heavy kind finishing alone in a second wave. At the
// served shape the 160 items are all resident at once (two per SM), and
// the order puts the heaviest on SMs of their own. This needs no scheduler
// state and no atomics, where a persistent grid would need both.
//
// Each head reads its group h / (H / G) of B and C (the
// per-head broadcast is never materialised); positions at or past L (a
// ragged last chunk) count as a = 0, x = 0, B = 0, C = 0, the JAX model's
// zero padding, and their y rows are not written; element strides are
// taken for every operand, so the model's (b, l, h, p) layout launches
// without a transposing copy.
#include <algorithm>

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace repro;

struct SsdArgs {
  const void* x;
  const float* a;
  const void* B;
  const void* C;
  void* y;
  float* states;
  float* decay;
  int H, G, L, Q, P, N, nc;
  long long xsb, xst, xsh, asb, ast, ash, bsb, bst, bsg, csb, cst, csg, ysb, yst, ysh;
};

// One warp writes cs[i] = sum(a[0 .. i]) for i < n, with a = 0 at or past
// `valid`: each lane sums one contiguous segment, then a warp scan adds the
// segments before it.
__device__ __forceinline__ void warp_cumsum(float* cs, const float* a, long long ast, int n,
                                            int valid, int lane) {
  const int seg = (n + 31) / 32;
  const int lo = min(lane * seg, n);
  const int hi = min(lo + seg, n);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += i < valid ? a[i * ast] : 0.f;
    cs[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  const float before = incl - run;
  for (int i = lo; i < hi; ++i) cs[i] += before;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int kSlice = 2;          // heads of one group per item, sharing C B^T
constexpr int kPartsSL = 3;        // bf16 parts of S o L (y product)
constexpr int kPartsXW = 2;        // bf16 parts of x o w (state product)
constexpr int kMaxRowTiles = 16;   // Q <= 1024

struct TcArgs {
  const bf16* x;
  const float* a;
  const bf16* B;
  const bf16* C;
  bf16* y;
  float* states;
  float* decay;
  int batch, H, G, L, Q, P, N, nc, R, n_slices, n_it, tma, vec;
  long long xsb, xst, xsh, asb, ast, ash, bsb, bst, bsg, csb, cst, csg, ysb, yst, ysh;
  int order[kMaxRowTiles + 1];     // item kinds, heaviest first: row tile, or n_it = state
};

// (v0, v1) as NP packed bf16 pairs, parts[k][t][r], whose sum is (v0, v1)
// to 8 more bits per part: each part is the bf16 rounding of what the
// parts before it leave.
template <int NP>
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t (&parts)[NP][4][4],
                                           int t, int r) {
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    parts[k][t][r] = *reinterpret_cast<const uint32_t*>(&h);
    v0 -= __low2float(h);
    v1 -= __high2float(h);
  }
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// Block `idx`'s item: its kind (a row tile, or n_it for a state item) and
// its index within the kind, walking the kinds in the host's order. Every
// kind has one item per (batch, chunk, group, slice of heads).
__device__ __forceinline__ void item_of(const TcArgs& A, int idx, int& kind, int& rest) {
  const int cnt = A.batch * A.nc * A.G * A.n_slices;
  kind = A.n_it;
  rest = 0;
  for (int k = 0; k <= A.n_it; ++k) {
    if (idx < cnt) {
      kind = A.order[k];
      rest = idx;
      return;
    }
    idx -= cnt;
  }
}

// Shared-memory layout of a block (from a 1024-byte aligned base): C tile
// (NB column blocks), S as fp32 in the accumulator's layout (thread-major,
// so each thread reads its own 32 floats without bank conflicts), a
// two-slot ring of (B tile, kSlice x tiles), cs and w for each head, and
// three mbarriers (C, slot 0, slot 1).
template <int PB, int NB>
struct Layout {
  static constexpr int kTileB = NB * kBlockBytes;   // 64 rows of B or C
  static constexpr int kTileX = PB * kBlockBytes;   // 64 rows of x
  static constexpr int kSBytes = 32 * kWgThreads * 4;
  static constexpr int kSlot = kTileB + kSlice * kTileX;
  static constexpr int kThreads = kSlice * kWgThreads;
  static size_t bytes(int Q) {
    return 1024 + (size_t)kTileB + kSBytes + 2 * (size_t)kSlot +
           sizeof(float) * 2 * kSlice * (size_t)Q + 8 * 3;
  }
};

// Where a block's item lies: (batch, chunk, group, slice of kSlice heads).
struct Slice {
  int b, c, g, h0, nh, t0, valid;
};

__device__ __forceinline__ Slice slice_of(const TcArgs& A, int rest) {
  Slice s;
  const int sl = rest % A.n_slices;
  rest /= A.n_slices;
  s.g = rest % A.G;
  rest /= A.G;
  s.c = rest % A.nc;
  s.b = rest / A.nc;
  s.h0 = s.g * A.R + sl * kSlice;
  s.nh = min(kSlice, A.R - sl * kSlice);
  s.t0 = s.c * A.Q;
  s.valid = min(A.Q, A.L - s.t0);                  // positions of this chunk that exist
  return s;
}

// Key tile kt (rows [kt * 64, kt * 64 + 64) of the chunk: B, and x of each
// head of the slice) into ring slot `slot`: by TMA (one thread issues it,
// `bar` counts its bytes) or by cp.async from every thread.
template <int PB, int NB>
__device__ __forceinline__ void load_keys(const TcArgs& A, const Slice& s, int kt,
                                          uint32_t slot, uint32_t bar, const CUtensorMap* xmap,
                                          const CUtensorMap* bmap) {
  using Lay = Layout<PB, NB>;
  const int j0 = kt * kTile;
  if (A.tma) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, Lay::kTileB + s.nh * Lay::kTileX);
#pragma unroll
      for (int cb = 0; cb < NB; ++cb)
        tma_load(slot + cb * kBlockBytes, bmap, bar, cb * 64, s.t0 + j0, s.g, s.b);
      for (int hh = 0; hh < s.nh; ++hh)
#pragma unroll
        for (int cb = 0; cb < PB; ++cb)
          tma_load(slot + Lay::kTileB + hh * Lay::kTileX + cb * kBlockBytes, xmap, bar,
                   cb * 64, s.t0 + j0, s.h0 + hh, s.b);
    }
  } else {
    const bf16* Bc = A.B + s.b * A.bsb + s.g * A.bsg + (long long)(s.t0 + j0) * A.bst;
    const bf16* xc = A.x + s.b * A.xsb + s.h0 * A.xsh + (long long)(s.t0 + j0) * A.xst;
    load_tile<NB * 64, Lay::kThreads>(slot, Bc, A.bst, s.valid - j0, A.N, A.vec, threadIdx.x);
    for (int hh = 0; hh < s.nh; ++hh)
      load_tile<PB * 64, Lay::kThreads>(slot + Lay::kTileB + hh * Lay::kTileX, xc + hh * A.xsh,
                                        A.xst, s.valid - j0, A.P, A.vec, threadIdx.x);
  }
}

// Wait until key tile kt's slot has landed for every thread.
__device__ __forceinline__ void wait_keys(const TcArgs& A, int kt, uint32_t bars) {
  if (A.tma) {
    mbar_wait(bars + 8 * (1 + kt % 2), (kt / 2) & 1);
  } else {
    cp_async_wait<0>();
    fence_async_shared();
  }
  __syncthreads();
}

// y rows [i0, i0 + 64) of the slice's heads (see the note at the top):
// warpgroup wg owns head h0 + wg, and warpgroup kt % kSlice computes the
// S tile of key tile kt for all of them.
template <int PB, int NB>
__device__ __forceinline__ void y_item(const TcArgs& A, int rest, int it, uint32_t ctile,
                                       float* sbuf, uint32_t ring, float* cs, uint32_t bars,
                                       const CUtensorMap* xmap, const CUtensorMap* bmap,
                                       const CUtensorMap* cmap) {
  using Lay = Layout<PB, NB>;
  constexpr int kNY = PB * 32;                     // y accumulator floats per thread
  const Slice s = slice_of(A, rest);
  const int i0 = it * kTile;
  if (i0 >= s.valid) return;                        // uniform: rows past L are not written
  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads;
  const int wt = tid % kWgThreads;
  const int warp = wt >> 5;
  const int lane = tid & 31;
  const int row0 = warp * 16 + (lane >> 2);        // this thread's rows: row0, row0 + 8
  const int cq = (lane & 3) * 2;                   // and columns 8j + cq, 8j + cq + 1
  const bool mine = wg < s.nh;                     // this warpgroup has a head
  const int n_kt = it + 1;
  float* csh = cs + wg * A.Q;

  if (A.tma) {
    if (tid == 0) {
      mbar_expect_tx(bars, Lay::kTileB);
#pragma unroll
      for (int cb = 0; cb < NB; ++cb)
        tma_load(ctile + cb * kBlockBytes, cmap, bars, cb * 64, s.t0 + i0, s.g, s.b);
    }
  } else {
    const bf16* Cc = A.C + s.b * A.csb + s.g * A.csg + (long long)(s.t0 + i0) * A.cst;
    load_tile<NB * 64, Lay::kThreads>(ctile, Cc, A.cst, s.valid - i0, A.N, A.vec, tid);
  }
  load_keys<PB, NB>(A, s, 0, ring, bars + 8, xmap, bmap);
  if (!A.tma) cp_async_commit();
  // each head's cs over the keys these rows see, while the first tiles are
  // in flight
  if (mine && warp == 0)
    warp_cumsum(csh, A.a + s.b * A.asb + (s.h0 + wg) * A.ash + (long long)s.t0 * A.ast, A.ast,
                i0 + kTile, s.valid, lane);
  __syncthreads();
  float csi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) csi[r] = mine ? csh[i0 + row0 + 8 * r] : 0.f;
  if (A.tma) mbar_wait(bars, 0);                    // C landed

  float acc[kNY];
#pragma unroll
  for (int e = 0; e < kNY; ++e) acc[e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    wait_keys(A, kt, bars);                        // tile kt landed; tile kt-1 consumed
    if (kt + 1 < n_kt)                             // into the slot tile kt-1 used
      load_keys<PB, NB>(A, s, kt + 1, ring + ((kt + 1) % 2) * Lay::kSlot,
                        bars + 8 * (1 + (kt + 1) % 2), xmap, bmap);
    if (!A.tma) cp_async_commit();
    const uint32_t bt = ring + (kt % 2) * Lay::kSlot;

    // S = C_i B_j^T over N / 16 k-steps of 32 bytes inside each column
    // block, by one warpgroup, into sbuf for all of them
    if (wg == kt % kSlice) {
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < NB * 4; ++t) {
        const uint32_t off = (t / 4) * kBlockBytes + (t % 4) * 32;
        wgmma_ss_n64(sc, sw128_desc(ctile + off, 16, 1024), sw128_desc(bt + off, 16, 1024),
                     t > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
#pragma unroll
      for (int e = 0; e < 32; ++e) sbuf[e * kWgThreads + wt] = sc[e];
    }
    __syncthreads();                               // S of tile kt is in sbuf
    if (mine) {
      const bool diag = kt == it;                  // only this tile crosses i >= j
      const int j0 = kt * kTile;
      float csj[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) csj[q] = csh[j0 + (q / 2) * 8 + cq + q % 2];
      // S o L_h as wgmma's register A operand (k-step e / 8), in kPartsSL
      // bf16 parts
      uint32_t pa[kPartsSL][4][4];
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int r = (e % 4) / 2;
        const int col = (e / 4) * 8 + cq;
        const bool k0 = !diag || col <= row0 + 8 * r;
        const bool k1 = !diag || col + 1 <= row0 + 8 * r;
        // the difference first, then the log2e scale: a scaled cumsum of
        // |cs| ~ 300 would carry ~3e-5 of rounding into every exponent
        const float v0 =
            k0 ? sbuf[e * kWgThreads + wt] * ex2((csi[r] - csj[(e / 4) * 2]) * kLog2e) : 0.f;
        const float v1 =
            k1 ? sbuf[(e + 1) * kWgThreads + wt] * ex2((csi[r] - csj[(e / 4) * 2 + 1]) * kLog2e)
               : 0.f;
        split_bf16<kPartsSL>(v0, v1, pa, e / 8, (e % 8) / 2);
      }
      const uint32_t xt = bt + Lay::kTileB + wg * Lay::kTileX;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const uint64_t dx = sw128_desc(xt + t * 16 * 128, kBlockBytes, 1024);
#pragma unroll
        for (int k = 0; k < kPartsSL; ++k) wgmma_pv<PB * 64>(acc, pa[k][t], dx);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
  }
  cp_async_wait<0>();
  if (!mine) return;

  bf16* yb = A.y + s.b * A.ysb + (s.h0 + wg) * A.ysh + (long long)s.t0 * A.yst;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + row0 + 8 * half;
    if (i >= s.valid) continue;
#pragma unroll
    for (int jj = 0; jj < PB * 8; ++jj) {
      const int p = jj * 8 + cq;                   // P % 16 == 0: p < P means p + 1 < P
      if (p < A.P)
        *reinterpret_cast<__nv_bfloat162*>(yb + i * A.yst + p) =
            __floats2bfloat162_rn(acc[jj * 4 + half * 2], acc[jj * 4 + half * 2 + 1]);
    }
  }
}

// The (P, N) states and out_decay of the slice's heads in one (batch,
// chunk): warpgroup wg owns head h0 + wg; the B tiles are loaded once for
// all of them.
template <int PB, int NB>
__device__ __forceinline__ void state_item(const TcArgs& A, int rest, uint32_t ring, float* cs,
                                           uint32_t bars, const CUtensorMap* xmap,
                                           const CUtensorMap* bmap) {
  using Lay = Layout<PB, NB>;
  const Slice s = slice_of(A, rest);
  const int n_kt = (s.valid + kTile - 1) / kTile;  // key tiles past L add nothing
  const int steps = PB * n_kt;                     // (64-row slice of P, key tile)
  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads;
  const int wt = tid % kWgThreads;
  const int warp = wt >> 5;
  const int lane = tid & 31;
  const int row0 = warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  const bool mine = wg < s.nh;
  const int h = s.h0 + wg;
  float* csh = cs + 2 * wg * A.Q;
  float* w = csh + A.Q;

  load_keys<PB, NB>(A, s, 0, ring, bars + 8, xmap, bmap);
  if (!A.tma) cp_async_commit();
  if (mine && warp == 0)
    warp_cumsum(csh, A.a + s.b * A.asb + h * A.ash + (long long)s.t0 * A.ast, A.ast, A.Q,
                s.valid, lane);
  __syncthreads();
  const long long chunk = ((long long)s.b * A.H + h) * A.nc + s.c;
  if (mine) {
    const float cs_last = csh[A.Q - 1];
    for (int i = wt; i < A.Q; i += kWgThreads) {
      A.decay[chunk * A.Q + i] = expf(csh[i]);
      w[i] = expf(cs_last - csh[i]);
    }
  }

  float acc[NB][32];
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[cb][e] = 0.f;

  for (int st = 0; st < steps; ++st) {
    const int mt = st / n_kt;
    const int kt = st - mt * n_kt;
    wait_keys(A, st, bars);                        // (and, the first time, w is ready)
    if (st + 1 < steps)
      load_keys<PB, NB>(A, s, (st + 1) % n_kt, ring + ((st + 1) % 2) * Lay::kSlot,
                        bars + 8 * (1 + (st + 1) % 2), xmap, bmap);
    if (!A.tma) cp_async_commit();
    if (!mine) continue;
    const uint32_t bt = ring + (st % 2) * Lay::kSlot;
    const uint32_t xt = bt + Lay::kTileB + wg * Lay::kTileX + mt * kBlockBytes;

    // (x_h o w_h)^T as the register A operand: ldmatrix.trans hands lane l
    // the pairs (x[j][p], x[j + 1][p]) of rows p = row0 (+8), keys
    // j = 16 t + cq (+8), which is the A fragment of rows p, columns j.
    uint32_t pa[kPartsXW][4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = 16 * t + ((lane >> 4) << 3) + (lane & 7);   // this lane's row address
      const int chunk16 = 2 * warp + ((lane >> 3) & 1);
      uint32_t r[4];
      ldmatrix_x4_trans(r, xt + j * 128 + ((chunk16 ^ (j & 7)) << 4));
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int jk = kt * kTile + 16 * t + 8 * (k / 2) + cq;
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r[k]));
        split_bf16<kPartsXW>(xv.x * w[jk], xv.y * w[jk + 1], pa, t, k);
      }
    }
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) fence_regs(acc[cb]);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) {
        const uint64_t db = sw128_desc(bt + cb * kBlockBytes + t * 16 * 128, kBlockBytes, 1024);
#pragma unroll
        for (int k = 0; k < kPartsXW; ++k) wgmma_rs_n64(acc[cb], pa[k][t], db);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) fence_regs(acc[cb]);

    if (kt == n_kt - 1) {                          // rows [64 mt, 64 mt + 64) are complete
      float* out = A.states + chunk * A.P * A.N;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = mt * kTile + row0 + 8 * half;
#pragma unroll
        for (int cb = 0; cb < NB; ++cb)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int n = cb * 64 + jj * 8 + cq;   // N % 16 == 0: n < N means n + 1 < N
            if (p < A.P && n < A.N)
              *reinterpret_cast<float2*>(out + (long long)p * A.N + n) =
                  make_float2(acc[cb][jj * 4 + half * 2], acc[cb][jj * 4 + half * 2 + 1]);
            acc[cb][jj * 4 + half * 2] = acc[cb][jj * 4 + half * 2 + 1] = 0.f;
          }
      }
    }
  }
  cp_async_wait<0>();
}

template <int PB, int NB>
__global__ void __launch_bounds__(kSlice * kWgThreads)
ssd_chunk_tc_kernel(const __grid_constant__ TcArgs A, const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap bmap,
                    const __grid_constant__ CUtensorMap cmap) {
  using Lay = Layout<PB, NB>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms are 1024-B aligned
  const uint32_t ctile = base;
  float* sbuf = reinterpret_cast<float*>(smem_raw + (base + Lay::kTileB - raw));
  const uint32_t ring = base + Lay::kTileB + Lay::kSBytes;
  float* cs = reinterpret_cast<float*>(smem_raw + (ring + 2 * Lay::kSlot - raw));
  const uint32_t bars = ring + 2 * Lay::kSlot + sizeof(float) * 2 * kSlice * A.Q;
  if (A.tma) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  int kind, rest;
  item_of(A, blockIdx.x, kind, rest);
  if (kind == A.n_it)
    state_item<PB, NB>(A, rest, ring, cs, bars, &xmap, &bmap);
  else
    y_item<PB, NB>(A, rest, kind, ctile, sbuf, ring, cs, bars, &xmap, &bmap, &cmap);
}

// The host's balance model, in m64n64k16 wgmma steps on a block's longest
// warpgroup: a y item of row tile i walks i + 1 key tiles, each an S of
// N / 16 steps plus its head's 8 P / 64 products (4 k-steps, two parts)
// and exponents (counted as 4); a state item walks every key tile with
// 8 N / 64 products per 64-row slice of P.
void order_items(TcArgs& A, int PB, int NB) {
  int cost[kMaxRowTiles + 1];
  for (int it = 0; it < A.n_it; ++it) cost[it] = (it + 1) * (4 * NB + 8 * PB + 4);
  cost[A.n_it] = 8 * NB * PB * A.n_it;
  for (int k = 0; k <= A.n_it; ++k) A.order[k] = k;
  std::stable_sort(A.order, A.order + A.n_it + 1,
                   [&](int u, int v) { return cost[u] > cost[v]; });
}

template <int PB, int NB>
int launch_tc_t(TcArgs& A, const CUtensorMap* maps, cudaStream_t stream) {
  using Lay = Layout<PB, NB>;
  const size_t smem = Lay::bytes(A.Q);
  auto kernel = ssd_chunk_tc_kernel<PB, NB>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  order_items(A, PB, NB);
  const int items = A.batch * A.nc * A.G * A.n_slices * (A.n_it + 1);
  kernel<<<items, Lay::kThreads, smem, stream>>>(A, maps[0], maps[1], maps[2]);
  return (int)cudaGetLastError();
}

// A stride of a dimension of extent 1 is never used to address; TMA still
// wants a nonzero one.
long long nz(long long stride, long long alt) { return stride != 0 ? stride : alt; }

int launch_tc(const SsdArgs& s, int batch, cudaStream_t stream) {
  const int Q = s.Q, P = s.P, N = s.N;
  if (Q % kTile || Q / kTile > kMaxRowTiles || N % 16 || N < 16 || N > 256 || P % 16 ||
      P > 128 || s.ysb % 2 || s.yst % 2 || s.ysh % 2 || !aligned16(s.y))
    return (int)cudaErrorInvalidValue;
  TcArgs A{};
  A.x = static_cast<const bf16*>(s.x);
  A.a = s.a;
  A.B = static_cast<const bf16*>(s.B);
  A.C = static_cast<const bf16*>(s.C);
  A.y = static_cast<bf16*>(s.y);
  A.states = s.states;
  A.decay = s.decay;
  A.batch = batch, A.H = s.H, A.G = s.G, A.L = s.L, A.Q = Q, A.P = P, A.N = N, A.nc = s.nc;
  A.R = s.H / s.G;
  A.n_slices = (A.R + kSlice - 1) / kSlice;
  A.n_it = Q / kTile;
  A.xsb = s.xsb, A.xst = s.xst, A.xsh = s.xsh, A.asb = s.asb, A.ast = s.ast, A.ash = s.ash;
  A.bsb = s.bsb, A.bst = s.bst, A.bsg = s.bsg, A.csb = s.csb, A.cst = s.cst, A.csg = s.csg;
  A.ysb = s.ysb, A.yst = s.yst, A.ysh = s.ysh;
  // 16-byte copies need every row start of x, B and C on 16 bytes; TMA
  // also whole 64-column blocks of N and P.
  const long long st[9] = {s.xsb, s.xst, s.xsh, s.bsb, s.bst, s.bsg, s.csb, s.cst, s.csg};
  A.vec = aligned16(s.x) && aligned16(s.B) && aligned16(s.C);
  for (long long v : st) A.vec = A.vec && v % 8 == 0;
  CUtensorMap maps[3] = {};
  A.tma = A.vec && P % 64 == 0 && N % 64 == 0;
  if (A.tma) {
    const long long xh = nz(s.xsh, s.xst * s.L), bg = nz(s.bsg, s.bst * s.L),
                    cg = nz(s.csg, s.cst * s.L);
    A.tma = tensor_map(&maps[0], s.x, P, s.L, s.H, batch, s.xst, xh, nz(s.xsb, xh * s.H)) &&
            tensor_map(&maps[1], s.B, N, s.L, s.G, batch, s.bst, bg, nz(s.bsb, bg * s.G)) &&
            tensor_map(&maps[2], s.C, N, s.L, s.G, batch, s.cst, cg, nz(s.csb, cg * s.G));
    if (!A.tma) return (int)cudaErrorInvalidValue;
  }
  const int PB = P > 64 ? 2 : 1;
  const int NB = N <= 64 ? 1 : N <= 128 ? 2 : 4;
  if (PB == 1 && NB == 1) return launch_tc_t<1, 1>(A, maps, stream);
  if (PB == 1 && NB == 2) return launch_tc_t<1, 2>(A, maps, stream);
  if (PB == 1 && NB == 4) return launch_tc_t<1, 4>(A, maps, stream);
  if (PB == 2 && NB == 1) return launch_tc_t<2, 1>(A, maps, stream);
  if (PB == 2 && NB == 2) return launch_tc_t<2, 2>(A, maps, stream);
  return launch_tc_t<2, 4>(A, maps, stream);
}

}  // namespace

// ssd_chunk.cu's entry point, taking route 1 (the tensor cores, bfloat16)
// only; anything else returns cudaErrorInvalidValue.
extern "C" int ssd_chunk_launch(const void* x, const void* a, const void* B, const void* C,
                                void* y, void* states, void* decay, int dtype, int route,
                                int batch, int H, int G, int L, int Q, int P, int N,
                                long long xsb, long long xst, long long xsh, long long asb,
                                long long ast, long long ash, long long bsb, long long bst,
                                long long bsg, long long csb, long long cst, long long csg,
                                long long ysb, long long yst, long long ysh, void* stream) {
  SsdArgs args{x, static_cast<const float*>(a), B, C, y, static_cast<float*>(states),
               static_cast<float*>(decay), H, G, L, Q, P, N, (L + Q - 1) / Q,
               xsb, xst, xsh, asb, ast, ash, bsb, bst, bsg, csb, cst, csg, ysb, yst, ysh};
  cudaStream_t st = (cudaStream_t)stream;
  if (G <= 0 || H % G) return (int)cudaErrorInvalidValue;
  if (route == 1 && dtype == 1) return launch_tc(args, batch, st);
  return (int)cudaErrorInvalidValue;
}
