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
// multiples of 16). The work is cut into items, one block of one warpgroup
// each, and every item owns a (batch, chunk, head):
//  - a y item also owns a 64-row tile i. For each key tile j <= i the
//    warpgroup computes S = C_i B_j^T (wgmma m64n64k16, C and B bf16
//    K-major in shared memory, fp32 accumulators), builds S o L_h from the
//    accumulator fragment straight into the register A operand (exp only
//    where i >= j, selected, never multiplied by a mask; ex2.approx of the
//    log2e-scaled difference of the cumsums) and adds (S o L_h) x_h[j] into
//    its y accumulator (wgmma with the register A operand, x_h MN-major in
//    shared memory), as K3 builds P from S. S never leaves the registers:
//    the heads of a group each compute their own, which costs N / 16
//    products a key tile and saves a hand-over through shared memory and a
//    block-wide barrier. Step j issues S of tile j, then y's product of
//    tile j - 1, waits for the older group only (wgmma.wait_group 1) and
//    builds S o L of tile j while that product runs; two register A
//    operands alternate. No product stays in flight from one step into the
//    next: one in flight across the loop's branches makes ptxas serialize
//    every wgmma of the kernel (its warning C7515).
//  - a state item computes states_h = (x_h o w_h)^T B (m = P, n = N, k = Q)
//    with w_h = exp(cs_last - cs), and out_decay: x_h comes out of shared
//    memory transposed by ldmatrix.trans into the register A operand and is
//    scaled by w_h there; B stays bf16 in shared memory as the MN-major B
//    operand.
// Both register-built operands go to the tensor cores as a sum of bf16
// parts, each the bf16 rounding of what the parts before it leave, one
// product per part: three for S o L (with two, many more of y's bf16
// roundings differ from the plain version's; kernel_variants.py k4 counts
// them) and two for x o w (one misses the fp32 states' 1e-4, as bf16 P
// missed K3's logits check). B, C
// and x are bf16 already, so their products are exact in the fp32
// accumulators. B, C and x tiles come by TMA (one thread issues, an
// mbarrier per slot counts the bytes) into two-slot rings, one for B and
// one for x, so the next key tile's copies run under the current tile's
// products (a y item frees a B slot when its S is done and an x slot when
// its y product is); where N or P is not a multiple of 64, or a stride or
// base does not suit TMA, 16-byte cp.async copies (or, for strides that
// are not whole 16 bytes, element gathers) write the same swizzled layout,
// zero-padded to 64-column blocks. Operands stay bf16 in shared memory.
// Balance: a y item of row tile i walks i + 1 key tiles, and a state item
// all Q / 64 of them, so costs differ up to 4:1 at Q = 256. The host ranks
// the item kinds by a wgmma count (order_items) and the grid runs the
// heaviest kind first, so that the light items fill in behind the heavy
// ones instead of a heavy kind finishing alone in a second wave. This
// needs no scheduler state and no atomics, where a persistent grid would
// need both.
//
// CUDA cores (fp32, and bf16 shapes the tensor-core route does not take,
// such as chunk 32 or N = 8): fp32 on 256 threads, tiles staged in
// shared memory as fp32. Grid (Q / 64 + 1, chunks, batch * heads): blocks
// 0 .. Q/64 - 1 each compute 64 rows of y_diag over the 32-row key tiles at
// or below their diagonal; the last block of each chunk computes the
// (P, N) state and out_decay. fp32 keeps fp32 products from the loaded
// values: bf16 tensor cores would keep ~3 digits of fp32 inputs and miss
// 1e-4, as K3's fp32 kernel does for the same reason.
//
// Both routes: each head reads its group h / (H / G) of B and C (the
// per-head broadcast is never materialised); positions at or past L (a
// ragged last chunk) count as a = 0, x = 0, B = 0, C = 0, the JAX model's
// zero padding, and their y rows are not written; element strides are
// taken for every operand, so the model's (b, l, h, p) layout launches
// without a transposing copy.
#include <algorithm>

#include "attention_common.cuh"
#include "hopper_common.cuh"
#include "ssd_common.cuh"

namespace {

using namespace repro;

// ---------------------------------------------------------------------------
// CUDA cores: any shape the wrapper takes, fp32 and bf16
// ---------------------------------------------------------------------------
constexpr int kSsdThreads = 256;
constexpr int kSsdWarps = kSsdThreads / 32;
constexpr int kTileI = 64;                     // y rows per block
constexpr int kTileJ = 32;                     // key rows per staged tile: one per lane
constexpr int kRowsPerWarp = kTileI / kSsdWarps;
constexpr int kMaxAcc = 32;                    // accumulators per thread
constexpr int kLoadBatch = 8;                  // staging loads in flight per thread

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

// Stage a rows x width tile into shared memory: element (r, e) comes from
// load(r, e) and goes to store(r, e, value). Each thread issues kLoadBatch
// independent global loads before it stores any, so the loads' latency
// overlaps instead of adding up trip by trip.
template <typename Load, typename Store>
__device__ __forceinline__ void stage(int rows, int width, Load load, Store store) {
  const int total = rows * width;
  for (int base = threadIdx.x; base < total; base += kLoadBatch * blockDim.x) {
    float v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int idx = base + u * blockDim.x;
      v[u] = idx < total ? load(idx / width, idx % width) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < total) store(idx / width, idx % width, v[u]);
    }
  }
}

// Stage key rows [j0, j0 + kTileJ) of the chunk: B transposed as bt[n][j]
// (row stride kTileJ + 1, so both staging and reading are free of bank
// conflicts) and x as xs[j][p], x scaled by w[j] when w is given. Rows at or
// past `valid` are zero.
template <typename T>
__device__ __forceinline__ void stage_keys(float* bt, float* xs, const T* Bb, const T* xb,
                                           long long bst, long long xst, int j0, int valid,
                                           int N, int P, const float* w) {
  stage(kTileJ, N,
        [&](int j, int n) { return j0 + j < valid ? to_float(Bb[(j0 + j) * bst + n]) : 0.f; },
        [&](int j, int n, float v) { bt[n * (kTileJ + 1) + j] = v; });
  stage(kTileJ, P,
        [&](int j, int p) {
          const int jj = j0 + j;
          if (jj >= valid) return 0.f;
          const float xv = to_float(xb[jj * xst + p]);
          return w != nullptr ? xv * w[jj] : xv;
        },
        [&](int j, int p, float v) { xs[j * P + p] = v; });
}

template <typename T>
__global__ void __launch_bounds__(kSsdThreads) ssd_chunk_kernel(const SsdArgs args) {
  extern __shared__ float smem[];
  const int Q = args.Q, P = args.P, N = args.N;
  const int n_itiles = (Q + kTileI - 1) / kTileI;
  const int tile = blockIdx.x;
  const int c = blockIdx.y;
  const int bh = blockIdx.z;
  const int b = bh / args.H;
  const int h = bh - b * args.H;
  const int g = h / (args.H / args.G);
  const int t0 = c * Q;
  const int valid = min(Q, args.L - t0);  // positions of this chunk that exist

  // float4-read arrays first (16-byte aligned), then the rest.
  float* ct = smem;                           // kTileI x N       C rows
  float* ss = ct + kTileI * N;                // kTileI x kTileJ  masked scores
  float* bt = ss + kTileI * kTileJ;           // N x (kTileJ + 1) B^T
  float* xs = bt + N * (kTileJ + 1);          // kTileJ x P
  float* cs = xs + kTileJ * P;                // Q                cumsum(a)
  float* w = cs + Q;                          // Q                exp(cs_last - cs)

  const T* xb = static_cast<const T*>(args.x) + b * args.xsb + h * args.xsh +
                (long long)t0 * args.xst;
  const float* ab = args.a + b * args.asb + h * args.ash + (long long)t0 * args.ast;
  const T* Bb = static_cast<const T*>(args.B) + b * args.bsb + g * args.bsg +
                (long long)t0 * args.bst;
  const T* Cb = static_cast<const T*>(args.C) + b * args.csb + g * args.csg +
                (long long)t0 * args.cst;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // cs = cumsum(a) over the chunk (a = 0 past `valid`)
  if (warp == 0) warp_cumsum(cs, ab, args.ast, Q, valid, lane);
  __syncthreads();

  if (tile == n_itiles) {
    // The chunk's state and out_decay. Thread (n, p0) owns p in
    // [p0 * pc, p0 * pc + pc) of column n.
    const float cs_last = cs[Q - 1];
    const long long chunk = (long long)bh * args.nc + c;
    for (int i = threadIdx.x; i < Q; i += blockDim.x) {
      args.decay[chunk * Q + i] = expf(cs[i]);
      w[i] = expf(cs_last - cs[i]);
    }
    const int tn = kSsdThreads / N;
    const int pc = (P + tn - 1) / tn;
    const int n = threadIdx.x % N;
    const int p0 = threadIdx.x / N;
    const bool active = p0 < tn;
    float acc[kMaxAcc];
#pragma unroll
    for (int k = 0; k < kMaxAcc; ++k) acc[k] = 0.f;
    for (int j0 = 0; j0 < valid; j0 += kTileJ) {
      __syncthreads();  // w is ready; the previous tile is consumed
      stage_keys(bt, xs, Bb, xb, args.bst, args.xst, j0, valid, N, P, w);
      __syncthreads();
      if (active) {
        const int nj = min(kTileJ, valid - j0);
        for (int j = 0; j < nj; ++j) {
          const float bv = bt[n * (kTileJ + 1) + j];
          const float* xrow = xs + j * P + p0 * pc;
#pragma unroll
          for (int k = 0; k < kMaxAcc; ++k)
            if (k < pc && p0 * pc + k < P) acc[k] = fmaf(xrow[k], bv, acc[k]);
        }
      }
    }
    if (active) {
      float* out = args.states + chunk * P * N;
#pragma unroll
      for (int k = 0; k < kMaxAcc; ++k) {
        const int p = p0 * pc + k;
        if (k < pc && p < P) out[(long long)p * N + n] = acc[k];
      }
    }
    return;
  }

  const int i0 = tile * kTileI;
  if (i0 >= valid) return;  // uniform over the block
  const int i_end = min(i0 + kTileI, valid);
  stage(kTileI, N,
        [&](int i, int n) { return i0 + i < valid ? to_float(Cb[(i0 + i) * args.cst + n]) : 0.f; },
        [&](int i, int n, float v) { ct[i * N + n] = v; });
  // y rows r0 + k * tp of column p belong to this thread.
  const int tp = kSsdThreads / P;
  const int p = threadIdx.x % P;
  const int r0 = threadIdx.x / P;
  const bool active = r0 < tp;
  float acc[kMaxAcc];
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) acc[k] = 0.f;

  for (int j0 = 0; j0 < i_end; j0 += kTileJ) {
    __syncthreads();  // C (first time) is staged; the previous tile is consumed
    stage_keys<T>(bt, xs, Bb, xb, args.bst, args.xst, j0, valid, N, P, nullptr);
    __syncthreads();
    // Scores of rows warp + kSsdWarps * k against key j0 + lane.
    float s[kRowsPerWarp];
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) s[k] = 0.f;
    const float* brow = bt + lane;
    for (int n = 0; n < N; n += 4) {
      const float b0 = brow[(n + 0) * (kTileJ + 1)];
      const float b1 = brow[(n + 1) * (kTileJ + 1)];
      const float b2 = brow[(n + 2) * (kTileJ + 1)];
      const float b3 = brow[(n + 3) * (kTileJ + 1)];
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        const float4 cv =
            *reinterpret_cast<const float4*>(ct + (warp + kSsdWarps * k) * N + n);
        s[k] = fmaf(cv.x, b0, s[k]);
        s[k] = fmaf(cv.y, b1, s[k]);
        s[k] = fmaf(cv.z, b2, s[k]);
        s[k] = fmaf(cv.w, b3, s[k]);
      }
    }
    const int jj = j0 + lane;
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const int i = warp + kSsdWarps * k;
      const int ii = i0 + i;
      const bool keep = jj <= ii && ii < valid;
      const float d = keep ? cs[ii] - cs[jj] : 0.f;  // never exp of i < j
      ss[i * kTileJ + lane] = keep ? s[k] * expf(d) : 0.f;
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < kTileJ; j += 4) {
        const float x0 = xs[(j + 0) * P + p];
        const float x1 = xs[(j + 1) * P + p];
        const float x2 = xs[(j + 2) * P + p];
        const float x3 = xs[(j + 3) * P + p];
#pragma unroll
        for (int k = 0; k < kMaxAcc; ++k) {
          const int r = r0 + k * tp;
          if (r < kTileI) {
            const float4 sv = *reinterpret_cast<const float4*>(ss + r * kTileJ + j);
            acc[k] = fmaf(sv.x, x0, acc[k]);
            acc[k] = fmaf(sv.y, x1, acc[k]);
            acc[k] = fmaf(sv.z, x2, acc[k]);
            acc[k] = fmaf(sv.w, x3, acc[k]);
          }
        }
      }
    }
  }
  if (active) {
    T* yb = static_cast<T*>(args.y) + b * args.ysb + h * args.ysh + (long long)t0 * args.yst;
#pragma unroll
    for (int k = 0; k < kMaxAcc; ++k) {
      const int ii = i0 + r0 + k * tp;
      if (r0 + k * tp < kTileI && ii < valid) yb[ii * args.yst + p] = from_float<T>(acc[k]);
    }
  }
}

template <typename T>
int launch_cc(const SsdArgs& args, int batch, cudaStream_t stream) {
  const int n_itiles = (args.Q + kTileI - 1) / kTileI;
  const size_t smem = sizeof(float) * ((size_t)kTileI * args.N + kTileI * kTileJ +
                                       (size_t)args.N * (kTileJ + 1) +
                                       (size_t)kTileJ * args.P + 2 * (size_t)args.Q);
  auto kernel = ssd_chunk_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_itiles + 1, args.nc, batch * args.H);
  kernel<<<grid, kSsdThreads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
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
  int batch, H, G, L, Q, P, N, nc, R, n_it, tma, vec;
  long long xsb, xst, xsh, asb, ast, ash, bsb, bst, bsg, csb, cst, csg, ysb, yst, ysh;
  int order[kMaxRowTiles + 1];     // item kinds, heaviest first: row tile, or n_it = state
};

// Block `idx`'s item: its kind (a row tile, or n_it for a state item) and
// its index within the kind, walking the kinds in the host's order. Every
// kind has one item per (batch, chunk, head).
__device__ __forceinline__ void item_of(const TcArgs& A, int idx, int& kind, int& rest) {
  const int cnt = A.batch * A.nc * A.H;
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

// Where a block's item lies: (batch, chunk, head), and the head's group.
// Neighbouring blocks take neighbouring heads, which read the same B and C.
struct Head {
  int b, c, h, g, t0, valid;
};

__device__ __forceinline__ Head head_of(const TcArgs& A, int rest) {
  Head s;
  s.h = rest % A.H;
  rest /= A.H;
  s.c = rest % A.nc;
  s.b = rest / A.nc;
  s.g = s.h / A.R;
  s.t0 = s.c * A.Q;
  s.valid = min(A.Q, A.L - s.t0);                  // positions of this chunk that exist
  return s;
}

// One bf16 operand (x, B or C): element strides (batch, position, head or
// group), its row width and its tensor map.
struct Operand {
  const bf16* p;
  long long sb, st, si;
  int width;
  const CUtensorMap* map;
};

// Shared memory of a block (from a 1024-byte aligned base): the C tile, a
// two-slot ring of B tiles, a two-slot ring of x tiles, cs and w, and five
// mbarriers: C, the B slots, the x slots (a state item brings a step's B
// and x through its B slot's barrier).
template <int PB, int NB>
struct Smem {
  static constexpr int kTileB = NB * kBlockBytes;   // 64 rows of B or C
  static constexpr int kTileX = PB * kBlockBytes;   // 64 rows of x
  static size_t bytes(int Q) {
    return 1024 + 3 * (size_t)kTileB + 2 * (size_t)kTileX + sizeof(float) * 2 * (size_t)Q +
           8 * 5;
  }
  uint32_t c, b0, x0, bars;
  float* cs;                                        // cumsum(a), Q floats; then w
  __device__ __forceinline__ uint32_t b(int slot) const { return b0 + slot * kTileB; }
  __device__ __forceinline__ uint32_t x(int slot) const { return x0 + slot * kTileX; }
  __device__ __forceinline__ uint32_t bar(int i) const { return bars + 8 * i; }
};

// Rows [row, row + 64) of operand o at (b, idx) into BLOCKS swizzled
// 64-column blocks at dst: by TMA (thread 0 issues a box per block, and
// `expect` has told `bar` the bytes), or by cp.async from every thread,
// zeros past `nvalid` rows and past the width.
template <int BLOCKS>
__device__ __forceinline__ void load_rows(const TcArgs& A, const Operand& o, int b, int idx,
                                          int row, int nvalid, uint32_t dst, uint32_t bar) {
  if (A.tma) {
    if (threadIdx.x == 0)
#pragma unroll
      for (int cb = 0; cb < BLOCKS; ++cb)
        tma_load(dst + cb * kBlockBytes, o.map, bar, cb * 64, row, idx, b);
  } else {
    load_tile<BLOCKS * 64, kWgThreads>(dst, o.p + b * o.sb + idx * o.si + (long long)row * o.st,
                                       o.st, nvalid, o.width, A.vec, threadIdx.x);
  }
}

__device__ __forceinline__ void expect(const TcArgs& A, uint32_t bar, int bytes) {
  if (A.tma && threadIdx.x == 0) mbar_expect_tx(bar, bytes);
}

// Wait until the `use`-th phase of `bar` has landed for every thread: by
// TMA, its mbarrier; by cp.async, all but this thread's `Newer` latest
// commit groups, then the warpgroup.
template <int Newer>
__device__ __forceinline__ void landed(const TcArgs& A, uint32_t bar, int use) {
  if (A.tma) {
    mbar_wait(bar, use & 1);
  } else {
    cp_async_wait<Newer>();
    fence_async_shared();
    wg_barrier(1);
  }
}

// y rows [i0, i0 + 64) of one head (see the note at the top). Step kt
// issues S of key tile kt and then y's product of tile kt - 1, waits for
// the older group (S) only, and builds S o L of tile kt while that product
// runs; the two register A operands alternate. No product is in flight
// from one step into the next. cp.async commits two groups a step, the B
// tile two ahead and the x tile one ahead (empty where there is none), so
// each wait knows how many newer groups may stay in flight.
template <int PB, int NB>
__device__ __forceinline__ void y_item(const TcArgs& A, const Head& s, int it,
                                       const Smem<PB, NB>& m, const Operand& xo,
                                       const Operand& bo, const Operand& co) {
  using M = Smem<PB, NB>;
  constexpr int kNY = PB * 32;                     // y accumulator floats per thread
  using Operand16 = uint32_t[kPartsSL][4][4];      // S o L as kPartsSL bf16 parts
  const int i0 = it * kTile;
  if (i0 >= s.valid) return;                        // uniform: rows past L are not written
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = warp * 16 + (lane >> 2);        // this thread's rows: row0, row0 + 8
  const int cq = (lane & 3) * 2;                   // and columns 8j + cq, 8j + cq + 1
  const int n_kt = it + 1;

  auto load_b = [&](int kt) {                      // B of key tile kt into slot kt % 2
    expect(A, m.bar(1 + kt % 2), M::kTileB);
    load_rows<NB>(A, bo, s.b, s.g, s.t0 + kt * kTile, s.valid - kt * kTile, m.b(kt % 2),
                  m.bar(1 + kt % 2));
  };
  auto load_x = [&](int kt) {                      // x of key tile kt into slot kt % 2
    expect(A, m.bar(3 + kt % 2), M::kTileX);
    load_rows<PB>(A, xo, s.b, s.h, s.t0 + kt * kTile, s.valid - kt * kTile, m.x(kt % 2),
                  m.bar(3 + kt % 2));
  };
  // once every thread is past S of tile kt and y's product of tile kt - 1:
  // B slot kt % 2 and x slot (kt + 1) % 2 take the tiles that go there next
  auto refill = [&](int kt) {
    wg_barrier(1);
    if (kt + 2 < n_kt) load_b(kt + 2);
    if (!A.tma) cp_async_commit();
    if (kt + 1 < n_kt) load_x(kt + 1);
    if (!A.tma) cp_async_commit();
  };

  // commit groups (cp.async): [C, B 0], then [B 1], [x 0] as refill(-1)'s
  expect(A, m.bar(0), M::kTileB);
  load_rows<NB>(A, co, s.b, s.g, s.t0 + i0, s.valid - i0, m.c, m.bar(0));
  load_b(0);
  if (!A.tma) cp_async_commit();
  if (n_kt > 1) load_b(1);
  if (!A.tma) cp_async_commit();
  load_x(0);
  if (!A.tma) cp_async_commit();
  // cs over the keys these rows see, while the first tiles are in flight
  if (warp == 0)
    warp_cumsum(m.cs, A.a + s.b * A.asb + s.h * A.ash + (long long)s.t0 * A.ast, A.ast,
                i0 + kTile, s.valid, lane);
  wg_barrier(1);
  float csi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) csi[r] = m.cs[i0 + row0 + 8 * r];

  float acc[kNY];
#pragma unroll
  for (int e = 0; e < kNY; ++e) acc[e] = 0.f;
  float sc[32];
  Operand16 pa0, pa1;                              // S o L of even and of odd key tiles

  // S = C_i B_kt^T over N / 16 k-steps of 32 bytes inside each column block
  auto issue_s = [&](int kt) {
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < NB * 4; ++t) {
      const uint32_t off = (t / 4) * kBlockBytes + (t % 4) * 32;
      wgmma_ss_n64(sc, sw128_desc(m.c + off, 16, 1024), sw128_desc(m.b(kt % 2) + off, 16, 1024),
                   t > 0);
    }
    wgmma_commit();
  };
  // y += (S o L_h) x_h of key tile kt, x_h MN-major in its slot
  auto issue_y = [&](int kt, Operand16& pa) {
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint64_t dx = sw128_desc(m.x(kt % 2) + t * 16 * 128, kBlockBytes, 1024);
#pragma unroll
      for (int k = 0; k < kPartsSL; ++k) wgmma_pv<PB * 64>(acc, pa[k][t], dx);
    }
    wgmma_commit();
  };
  // S o L_h of key tile kt, from sc, as wgmma's register A operand
  // (k-step e / 8) in kPartsSL bf16 parts
  auto build = [&](int kt, Operand16& pa) {
    const bool diag = kt == it;                    // only this tile crosses i >= j
    const int j0 = kt * kTile;
    float csj[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) csj[q] = m.cs[j0 + (q / 2) * 8 + cq + q % 2];
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int r = (e % 4) / 2;
      const int col = (e / 4) * 8 + cq;
      const bool k0 = !diag || col <= row0 + 8 * r;
      const bool k1 = !diag || col + 1 <= row0 + 8 * r;
      // the difference first, then the log2e scale: a scaled cumsum of
      // |cs| ~ 300 would carry ~3e-5 of rounding into every exponent
      const float v0 = k0 ? sc[e] * ex2((csi[r] - csj[(e / 4) * 2]) * kLog2e) : 0.f;
      const float v1 = k1 ? sc[e + 1] * ex2((csi[r] - csj[(e / 4) * 2 + 1]) * kLog2e) : 0.f;
      split_bf16<kPartsSL>(v0, v1, pa, e / 8, (e % 8) / 2);
    }
  };
  // key tile kt >= 1: prev holds S o L of tile kt - 1, cur takes tile kt's
  auto step = [&](int kt, Operand16& prev, Operand16& cur) {
    landed<3>(A, m.bar(1 + kt % 2), kt / 2);       // B of tile kt
    issue_s(kt);
    landed<2>(A, m.bar(3 + (kt - 1) % 2), (kt - 1) / 2);   // x of tile kt - 1
    issue_y(kt - 1, prev);
    wgmma_wait<1>();                               // S of tile kt; y's product runs on
    fence_regs(sc);
    build(kt, cur);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_operand(prev);
    refill(kt);
  };

  landed<2>(A, m.bar(0), 0);                       // C
  landed<2>(A, m.bar(1), 0);                       // B of key tile 0
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(sc);
  refill(0);
  build(0, pa0);
#pragma unroll 1
  for (int kt = 1; kt < n_kt; kt += 2) {
    step(kt, pa0, pa1);
    if (kt + 1 < n_kt) step(kt + 1, pa1, pa0);
  }
  const int last = n_kt - 1;                       // its S o L is in pa0 if even, else pa1
  landed<2>(A, m.bar(3 + last % 2), last / 2);
  if (last % 2 == 0) {
    issue_y(last, pa0);
    wgmma_wait<0>();
    fence_operand(pa0);
  } else {
    issue_y(last, pa1);
    wgmma_wait<0>();
    fence_operand(pa1);
  }
  fence_regs(acc);
  cp_async_wait<0>();

  bf16* yb = A.y + s.b * A.ysb + s.h * A.ysh + (long long)s.t0 * A.yst;
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

// The (P, N) states and out_decay of one head in one (batch, chunk): step
// st takes the 64-row slice st / n_kt of P against key tile st % n_kt.
template <int PB, int NB>
__device__ __forceinline__ void state_item(const TcArgs& A, const Head& s,
                                           const Smem<PB, NB>& m, const Operand& xo,
                                           const Operand& bo) {
  using M = Smem<PB, NB>;
  const int n_kt = (s.valid + kTile - 1) / kTile;  // key tiles past L add nothing
  const int steps = PB * n_kt;                     // (64-row slice of P, key tile)
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  float* cs = m.cs;
  float* w = cs + A.Q;

  auto load = [&](int st) {                        // step st's B and x into slot st % 2
    const int j0 = (st % n_kt) * kTile;
    expect(A, m.bar(1 + st % 2), M::kTileB + M::kTileX);
    load_rows<NB>(A, bo, s.b, s.g, s.t0 + j0, s.valid - j0, m.b(st % 2), m.bar(1 + st % 2));
    load_rows<PB>(A, xo, s.b, s.h, s.t0 + j0, s.valid - j0, m.x(st % 2), m.bar(1 + st % 2));
    if (!A.tma) cp_async_commit();
  };
  load(0);
  if (warp == 0)
    warp_cumsum(cs, A.a + s.b * A.asb + s.h * A.ash + (long long)s.t0 * A.ast, A.ast, A.Q,
                s.valid, lane);
  wg_barrier(1);
  const long long chunk = ((long long)s.b * A.H + s.h) * A.nc + s.c;
  const float cs_last = cs[A.Q - 1];
  for (int i = tid; i < A.Q; i += kWgThreads) {
    A.decay[chunk * A.Q + i] = expf(cs[i]);
    w[i] = expf(cs_last - cs[i]);
  }

  float acc[NB][32];
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[cb][e] = 0.f;

  for (int st = 0; st < steps; ++st) {
    const int mt = st / n_kt;
    const int kt = st - mt * n_kt;
    landed<0>(A, m.bar(1 + st % 2), st / 2);
    wg_barrier(1);                                 // (and, the first time, w is ready)
    if (st + 1 < steps) load(st + 1);              // into the slot step st - 1 used
    const uint32_t bt = m.b(st % 2);
    const uint32_t xt = m.x(st % 2) + mt * kBlockBytes;

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
    wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) fence_regs(acc[cb]);
    fence_operand(pa);

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
__global__ void __launch_bounds__(kWgThreads)
ssd_chunk_tc_kernel(const __grid_constant__ TcArgs A, const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap bmap,
                    const __grid_constant__ CUtensorMap cmap) {
  using M = Smem<PB, NB>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms are 1024-B aligned
  M m;
  m.c = base;
  m.b0 = base + M::kTileB;
  m.x0 = base + 3 * M::kTileB;
  const uint32_t cs = m.x0 + 2 * M::kTileX;
  m.cs = reinterpret_cast<float*>(smem_raw + (cs - raw));
  m.bars = cs + sizeof(float) * 2 * A.Q;
  if (A.tma) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < 5; ++i) mbar_init(m.bar(i), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  int kind, rest;
  item_of(A, blockIdx.x, kind, rest);
  const Head s = head_of(A, rest);
  const Operand xo{A.x, A.xsb, A.xst, A.xsh, A.P, &xmap};
  const Operand bo{A.B, A.bsb, A.bst, A.bsg, A.N, &bmap};
  const Operand co{A.C, A.csb, A.cst, A.csg, A.N, &cmap};
  if (kind == A.n_it)
    state_item<PB, NB>(A, s, m, xo, bo);
  else
    y_item<PB, NB>(A, s, kind, m, xo, bo, co);
}

// The host's balance model, in m64n64k16 wgmma steps: a y item of row tile
// i walks i + 1 key tiles, each an S of N / 16 steps plus 4 kPartsSL P / 64
// products and the exponents (counted as 4); a state item walks every key
// tile with 4 kPartsXW N / 64 products per 64-row slice of P.
void order_items(TcArgs& A, int PB, int NB) {
  int cost[kMaxRowTiles + 1];
  for (int it = 0; it < A.n_it; ++it) cost[it] = (it + 1) * (4 * NB + 4 * kPartsSL * PB + 4);
  cost[A.n_it] = 4 * kPartsXW * NB * PB * A.n_it;
  for (int k = 0; k <= A.n_it; ++k) A.order[k] = k;
  std::stable_sort(A.order, A.order + A.n_it + 1,
                   [&](int u, int v) { return cost[u] > cost[v]; });
}

template <int PB, int NB>
int launch_tc_t(TcArgs& A, const CUtensorMap* maps, cudaStream_t stream) {
  const size_t smem = Smem<PB, NB>::bytes(A.Q);
  auto kernel = ssd_chunk_tc_kernel<PB, NB>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  order_items(A, PB, NB);
  const int items = A.batch * A.nc * A.H * (A.n_it + 1);
  kernel<<<items, kWgThreads, smem, stream>>>(A, maps[0], maps[1], maps[2]);
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

// route: 0 = CUDA cores (dtype 0 = float32 or 1 = bfloat16 for x, B, C and
// y), 1 = tensor cores (bfloat16 only); a is float32. Element strides in
// the order x (b, t, h), a (b, t, h), B (b, t, g), C (b, t, g), y (b, t, h);
// the last dim of x, B, C and y is contiguous. states is (batch, H, nc, P,
// N) and decay (batch, H, nc, Q), both contiguous fp32, with nc =
// ceil(L / Q). The wrapper checks each route's shapes: for the CUDA cores
// N % 4 == 0, N <= 256, P <= 128 and each thread's share of a state
// column, ceil(P / (256 / N)), at most 32; for the tensor cores Q % 64 ==
// 0 (Q <= 1024), N and P multiples of 16, 16 <= N <= 256, P <= 128. A
// shape or dtype the route does not take returns cudaErrorInvalidValue.
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
  if (route == 1) return dtype == 1 ? launch_tc(args, batch, st) : (int)cudaErrorInvalidValue;
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_cc<float>(args, batch, st);
  if (dtype == 1) return launch_cc<__nv_bfloat16>(args, batch, st);
  return (int)cudaErrorInvalidValue;
}
