// K4b ssd_chunk_bwd: the gradient of K4 (ssd_chunk.cu) with respect to x,
// a, B and C, given the gradients dy, dstates and ddecay of its three
// outputs. For each (batch, head, chunk) of Q positions, with cs =
// cumsum(a), L[i, j] = exp(cs_i - cs_j) for i >= j (else 0), S = C B^T,
// M = S o L, w_j = exp(cs_last - cs_j) and dM[i, j] = dy_i . x_j:
//   dx_j = sum_{i >= j} M[i, j] dy_i + w_j (dstates B_j)
//   dC_i = sum_{j <= i} (dM o L)[i, j] B_j
//   dB_j = sum_{i >= j} (dM o L)[i, j] C_i + w_j (dstates^T x_j)
//   dcs_i = sum_j G[i, j] - sum_k G[k, i] - u_i + [i = last] sum_j u_j
//           + ddecay_i exp(cs_i),   G = dM o M,   u_j = w_j x_j . dstates B_j
//   da_i = sum_{k >= i} dcs_k
// (kernels/ssd_chunk/ref.py:ssd_chunk_bwd_ref is the same closed form in
// PyTorch.)
//
// Replaces: nothing on the TPU. The JAX package differentiates
// src/repro/models/ssm.py:ssd_chunked with XLA (the Pallas kernel
// src/repro/kernels/ssd_chunk/ssd_chunk.py:ssd_chunk has no backward).
//
// Bound on the H100: bytes. At Mamba2-370m's train shape (8 x 512 tokens,
// 32 heads of 64, one group of N = 128, Q = 256) the gradient reads x, a,
// B, C, dy, dstates and ddecay and writes dx, da, dB and dC, 72.9 MB,
// 0.0218 ms at 3.35 TB/s; its five Q x Q products over the causal half and
// the state terms, 17.4 GFLOP, take 0.0176 ms at the bf16 tensor-core
// peak (0.26 ms at the 67 TFLOP/s fp32 peak of the CUDA cores, the fp32
// route's bound). Two routes, chosen by the wrapper as K4's are
// (kernels/ssd_chunk/ssd_chunk.py:bwd_route); neither falls back on the
// other.
//
// Tensor cores (bf16; Q % 64 == 0 up to 1024, N and P multiples of 16,
// 16 <= N <= 256, 16 <= P <= 128). Four passes on the caller's stream:
//  1. dstates as kPartsST bf16 parts, zero-padded to 64-row and 64-column
//     blocks (ssd_chunk_bwd_parts_kernel), so the state terms load them as
//     tiles.
//  2. Items of one warpgroup, each a (batch, chunk, group), a 64-position
//     tile and a slice of the group's heads (head_slices: 4 of 8 heads at
//     the train shape), the kinds ranked
//     by a cost model and the heaviest launched first:
//     - a row item owns rows i: key tiles outside, heads inside; S = C_i
//       B_kt^T once a key tile (wgmma, k = N), dM = dy_h[i] x_h[kt]^T (k =
//       P), dS = dM o L_h built in the accumulator fragment (the exponent
//       only where i >= j, selected: fast decays overflow above the
//       diagonal), the row sums of G = dS o S by quad shuffles (one owner
//       thread a row adds them in shared memory), dC_i += dS B_kt from dS as
//       the register A operand;
//     - a dB item owns keys j: row tiles outside, heads inside; S^T = B_j
//       C_i^T and dM^T = x_h[j] dy_h[i]^T with the key tile as wgmma's M (so
//       nothing is transposed through shared memory), dS^T in the fragment,
//       the column sums of G as the row sums of G^T, dB_j += dS^T C_i; with
//       the last row tile each head's T2 = x_h[j] dstates_h (x_h[j]
//       ldmatrix'd as the A operand), dB_j += w_j T2;
//     - a dx item owns keys j: heads outside, row tiles inside; S^T again
//       for every head (kernel_variants.py k4b: recomputing S in the other
//       kinds too costs 3%), M^T = S^T o L_h^T, dx_j += M^T dy_h[i]; after a
//       head's row tiles T1 = B_j dstates_h^T, dx_j += w_j T1 and u_j = w_j
//       x_h[j] . T1_j; dx_j and u_j are written per head.
//     M, dS and dstates enter the tensor cores as sums of kPartsM, kPartsDS
//     and kPartsST bf16 parts (each the bf16 rounding of what the parts
//     before it leave); B, C, x and dy are bf16 already, so every product
//     is exact to fp32 accumulation. dC_i and dB_j are summed over the
//     slice's heads in registers, in a fixed order, and written once as
//     the slice's fp32 partial. Tiles come by TMA (cp.async where a stride
//     or width does not suit it) into two-slot rings with an mbarrier a
//     slot, a step ahead of the products; the dstates tiles of a head's
//     state term are issued with the step before it. Two blocks fit an SM
//     at the train shape (about 106 KB of shared memory, 220 registers).
//     Every product group is waited for before the loop goes on: a wgmma
//     in flight across a loop's branches makes ptxas serialize them all.
//  3. dB and dC: the slices' partials summed in slice order, in bf16.
//  4. da, as on the CUDA cores (below).
//
// CUDA cores (fp32, and bf16 shapes the tensor cores do not take): fp32 on
// the CUDA cores from the loaded values. Tiles are staged in shared memory
// as fp32, a warp a row at a time with all of a row's loads in flight (no
// index division per element); S and dM of a 32 x 32 block take one key a
// lane and four rows a warp, so each column value loaded serves four rows;
// a thread keeps its output rows of dC, dx and dB in registers (16 and 8
// a thread up to N = 128 and P = 64, where two blocks fit an SM). Two
// passes on the caller's stream:
//  1. Items of 256 threads, each owning a 32-position tile of one (batch,
//     chunk, head); grid (2 x tiles, chunks, batch * heads).
//     - A row item owns rows i of the tile and walks the key tiles j <= i:
//       it recomputes S and dM for each 32 x 32 block (one key per lane,
//       four rows per warp), forms dS = dM o L in shared memory, adds dS B_j
//       into its dC rows (registers) and the row sums of G (warp sums).
//     - A column item owns keys j of the tile and walks the row tiles
//       i >= j: it recomputes S and dM, keeps M and dS transposed in shared
//       memory, adds M^T dy_i into dx_j and dS^T C_i into dB_j (registers)
//       and the column sums of G (one per lane, summed over the warps in a
//       fixed order at the end). Then the state terms: dstates of the chunk
//       in shared memory, w_j dstates B_j into dx_j, w_j dstates^T x_j into
//       dB_j, and u_j.
//  2. One warp per (batch, chunk, head) turns the row sums, the column sums,
//     u and ddecay into dcs and its reverse cumsum da.
// Each head writes its own dB and dC as fp32 partials; the wrapper sums a
// group's heads.
//
// Both routes: every sum runs in a fixed order (no atomics), so the same
// inputs give the same bits on every call. Each head reads its group h /
// (H / G) of B and C; positions at or past L (a ragged last chunk) count
// as a = 0, x = 0, B = 0, C = 0, dy = 0, the JAX model's zero padding:
// their dx, da, dB and dC rows are not written, but their ddecay still
// reaches da through the reverse cumsum. Element strides are taken for x,
// a, B, C, dy and the outputs, so the model's (b, l, h, p) layout launches
// without a copy.
#include <algorithm>

#include "attention_common.cuh"
#include "hopper_common.cuh"
#include "ssd_common.cuh"

namespace {

using namespace repro;

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kT = 32;                      // positions per tile: one key per lane
constexpr int kRows = kT / kBwdWarps;       // rows of a 32 x 32 block per warp
constexpr int kTs = kT + 1;                 // row stride of a transposed tile
constexpr int kMs = kT + 4;                 // row stride of dS / M^T, read as float4

struct BwdArgs {
  const void* x;
  const float* a;
  const void* B;
  const void* C;
  const void* dy;
  const float* dstates;
  const float* ddecay;
  void* dx;
  float* da;
  float* dB;
  float* dC;
  float* rowg;  // (batch * H, nc, Q): row sums of G
  float* colg;  // column sums of G
  float* u;     // the state term u
  int H, G, L, Q, P, N, nc, P4;
  long long xsb, xst, xsh, asb, ast, ash, bsb, bst, bsg, csb, cst, csg, dysb, dyst, dysh;
  long long dxsb, dxst, dxsh, dasb, dast, dash, dbsb, dbst, dbsh, dcsb, dcst, dcsh;
};

// Shared-memory layout of pass 1, in floats. `ring` holds the walked tile's
// rows (C as crow, kT x N, and dy as dyr, kT x P4; float4 reads), and in
// a column item's state step dstates (P x (N + 1)) and w dstates B (kT x
// (P + 1)); `bt` and `xt` the B and x columns of the tile the item walks
// (row item) or owns (column item), transposed; `mm` dS (row item) or M^T
// and dS^T (column item); `red` the column sums per warp; `cs` cumsum(a).
struct BwdSmem {
  int bt, xt, mm, red, cs, total;
};

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }

__host__ __device__ inline BwdSmem bwd_smem(int Q, int P, int P4, int N) {
  BwdSmem m;
  const int rows = kT * (N + P4), state = P * (N + 1) + kT * (P + 1);
  const int ring = rows > state ? rows : state;
  m.bt = round4(ring);
  m.xt = m.bt + N * kTs;
  m.mm = round4(m.xt + P4 * kTs);
  m.red = m.mm + 2 * kT * kMs;
  m.cs = m.red + kBwdWarps * kT;
  m.total = m.cs + Q;
  return m;
}

// Rows [r0, r0 + rows) of src (row stride st), `width` wide, zero past
// `valid` and from `width` to `pad` (<= 256), handed to store(r, e, value):
// warp w takes rows w, w + kBwdWarps, ..., each lane every 32nd element of
// a row, with all of a row's loads in flight before its stores.
template <typename T, typename Store>
__device__ __forceinline__ void stage_tile(const T* src, long long st, int r0, int rows,
                                           int valid, int width, int pad, Store store) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kBwdWarps) {
    const T* row = src + (long long)(r0 + r) * st;
    const bool ok = r0 + r < valid;
    float v[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int e = lane + 32 * m;
      v[m] = ok && e < width ? to_float(row[e]) : 0.f;
    }
#pragma unroll
    for (int m = 0; m < 8; ++m)
      if (lane + 32 * m < pad) store(r, lane + 32 * m, v[m]);
  }
}

// Rows [r0, r0 + kT) into dst row-major (row stride `pad`).
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, long long st, int r0,
                                           int valid, int width, int pad) {
  stage_tile(src, st, r0, kT, valid, width, pad,
             [&](int r, int e, float v) { dst[r * pad + e] = v; });
}

// The same rows transposed: dst[e * kTs + r], `pad` rows of kTs.
template <typename T>
__device__ __forceinline__ void stage_cols(float* dst, const T* src, long long st, int r0,
                                           int valid, int width, int pad) {
  stage_tile(src, st, r0, kT, valid, width, pad,
             [&](int r, int e, float v) { dst[e * kTs + r] = v; });
}

// S[r, lane] = C_r . B_lane and dM[r, lane] = dy_r . x_lane for the kRows
// rows r = warp + kBwdWarps * k of the staged rows (crow, dyr) and the key
// `lane` of the staged transposed columns (bt, xt); each column value
// loaded serves all kRows rows.
__device__ __forceinline__ void scores(const float* crow, const float* dyr, const float* bt,
                                       const float* xt, int warp, int N, int P4, int lane,
                                       float (&s)[kRows], float (&dm)[kRows]) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) s[k] = dm[k] = 0.f;
  for (int n = 0; n < N; n += 4) {
    const float b0 = bt[(n + 0) * kTs + lane], b1 = bt[(n + 1) * kTs + lane];
    const float b2 = bt[(n + 2) * kTs + lane], b3 = bt[(n + 3) * kTs + lane];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const float4 cv =
          *reinterpret_cast<const float4*>(crow + (warp + kBwdWarps * k) * N + n);
      s[k] = fmaf(cv.x, b0, s[k]);
      s[k] = fmaf(cv.y, b1, s[k]);
      s[k] = fmaf(cv.z, b2, s[k]);
      s[k] = fmaf(cv.w, b3, s[k]);
    }
  }
  for (int p = 0; p < P4; p += 4) {
    const float x0 = xt[(p + 0) * kTs + lane], x1 = xt[(p + 1) * kTs + lane];
    const float x2 = xt[(p + 2) * kTs + lane], x3 = xt[(p + 3) * kTs + lane];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const float4 dv =
          *reinterpret_cast<const float4*>(dyr + (warp + kBwdWarps * k) * P4 + p);
      dm[k] = fmaf(dv.x, x0, dm[k]);
      dm[k] = fmaf(dv.y, x1, dm[k]);
      dm[k] = fmaf(dv.z, x2, dm[k]);
      dm[k] = fmaf(dv.w, x3, dm[k]);
    }
  }
}

// acc[k] += sum_q m[(o0 + k * step) * kMs + q] * v(q) over q < kT, for the
// k < count rows of this thread that lie below kT.
template <int MAX, typename V>
__device__ __forceinline__ void accumulate(float (&acc)[MAX], const float* m, int o0,
                                           int step, int count, V v) {
  for (int q = 0; q < kT; q += 4) {
    const float v0 = v(q), v1 = v(q + 1), v2 = v(q + 2), v3 = v(q + 3);
#pragma unroll
    for (int k = 0; k < MAX; ++k) {
      const int r = o0 + k * step;
      if (k < count && r < kT) {
        const float4 mv = *reinterpret_cast<const float4*>(m + r * kMs + q);
        acc[k] = fmaf(mv.x, v0, acc[k]);
        acc[k] = fmaf(mv.y, v1, acc[k]);
        acc[k] = fmaf(mv.z, v2, acc[k]);
        acc[k] = fmaf(mv.w, v3, acc[k]);
      }
    }
  }
}

// AN and AP: a thread's accumulators of a kT x N and a kT x P output, at
// least ceil(kT / (kBwdThreads / N)) and the same for P: 16 and 8 up to N =
// 128 and P = 64 (Mamba2's and jamba's widths), where the kernel fits two
// blocks an SM; 32 and 16 up to N = 256 and P = 128.
template <typename T, int AN, int AP>
__global__ void __launch_bounds__(kBwdThreads, AN <= 16 ? 2 : 1)
    ssd_chunk_bwd_kernel(const BwdArgs A) {
  extern __shared__ float smem[];
  const int Q = A.Q, P = A.P, N = A.N, P4 = A.P4;
  const int n_tiles = (Q + kT - 1) / kT;
  const bool column = blockIdx.x >= n_tiles;
  const int o0 = (column ? blockIdx.x - n_tiles : blockIdx.x) * kT;  // the owned tile
  const int c = blockIdx.y;
  const int bh = blockIdx.z;
  const int b = bh / A.H;
  const int h = bh - b * A.H;
  const int g = h / (A.H / A.G);
  const int t0 = c * Q;
  const int valid = min(Q, A.L - t0);  // positions of this chunk that exist
  if (o0 >= valid) return;             // uniform over the block

  const BwdSmem m = bwd_smem(Q, P, P4, N);
  float* crow = smem;
  float* dyr = smem + kT * N;
  float* bt = smem + m.bt;
  float* xt = smem + m.xt;
  float* mm = smem + m.mm;
  float* cs = smem + m.cs;

  const T* xb = static_cast<const T*>(A.x) + b * A.xsb + h * A.xsh + (long long)t0 * A.xst;
  const T* Bb = static_cast<const T*>(A.B) + b * A.bsb + g * A.bsg + (long long)t0 * A.bst;
  const T* Cb = static_cast<const T*>(A.C) + b * A.csb + g * A.csg + (long long)t0 * A.cst;
  const T* dyb = static_cast<const T*>(A.dy) + b * A.dysb + h * A.dysh + (long long)t0 * A.dyst;
  const long long pos = ((long long)bh * A.nc + c) * Q;  // this chunk in rowg / colg / u
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (warp == 0) warp_cumsum(cs, A.a + b * A.asb + h * A.ash + (long long)t0 * A.ast, A.ast, Q,
                             valid, lane);

  // thread (n, rn) owns column n of rows rn, rn + tn, ... of a kT x N output
  const int tn = kBwdThreads / N;
  const int cnt_n = (kT + tn - 1) / tn;
  const int n = threadIdx.x % N;
  const int rn = threadIdx.x / N;
  const bool act_n = rn < tn;

  if (!column) {
    // ---- row item: dC_i and the row sums of G for rows i of the tile
    const int i_end = min(o0 + kT, valid);
    stage_rows<T>(crow, Cb, A.cst, o0, valid, N, N);
    stage_rows<T>(dyr, dyb, A.dyst, o0, valid, P, P4);
    float acc[AN];
#pragma unroll
    for (int k = 0; k < AN; ++k) acc[k] = 0.f;
    float rowg[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) rowg[k] = 0.f;
    for (int j0 = 0; j0 < i_end; j0 += kT) {
      __syncthreads();  // rows and cs are staged (first); the previous tile is consumed
      stage_cols<T>(bt, Bb, A.bst, j0, valid, N, N);
      stage_cols<T>(xt, xb, A.xst, j0, valid, P, P4);
      __syncthreads();
      const int j = j0 + lane;
      float s[kRows], dm[kRows];
      scores(crow, dyr, bt, xt, warp, N, P4, lane, s, dm);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int r = warp + kBwdWarps * k;
        const int i = o0 + r;
        const bool keep = j <= i && i < valid;
        const float d = keep ? cs[i] - cs[j] : 0.f;  // never exp of i < j
        const float ds = keep ? dm[k] * expf(d) : 0.f;
        mm[r * kMs + lane] = ds;
        rowg[k] += warp_sum(ds * s[k]);
      }
      __syncthreads();
      if (act_n) accumulate(acc, mm, rn, tn, cnt_n, [&](int q) { return bt[n * kTs + q]; });
    }
    if (act_n) {
#pragma unroll
      for (int k = 0; k < AN; ++k) {
        const int r = rn + k * tn;
        if (k < cnt_n && r < kT && o0 + r < valid)
          A.dC[b * A.dcsb + (long long)(t0 + o0 + r) * A.dcst + h * A.dcsh + n] = acc[k];
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int i = o0 + warp + kBwdWarps * k;
        if (i < valid) A.rowg[pos + i] = rowg[k];
      }
    }
    return;
  }

  // ---- column item: dx_j, dB_j, the column sums of G and u for keys j of
  // the tile
  float* mt = mm;             // M^T: mt[key * kMs + row]
  float* dst = mm + kT * kMs;  // (dM o L)^T
  const int tp = kBwdThreads / P;
  const int cnt_p = (kT + tp - 1) / tp;
  const int p = threadIdx.x % P;
  const int rp = threadIdx.x / P;
  const bool act_p = rp < tp;
  stage_cols<T>(bt, Bb, A.bst, o0, valid, N, N);
  stage_cols<T>(xt, xb, A.xst, o0, valid, P, P4);
  float ax[AP];
#pragma unroll
  for (int k = 0; k < AP; ++k) ax[k] = 0.f;
  float ab[AN];
#pragma unroll
  for (int k = 0; k < AN; ++k) ab[k] = 0.f;
  float colg = 0.f;  // this warp's rows' share of key `lane`'s column sum
  const int j = o0 + lane;
  for (int i0 = o0; i0 < valid; i0 += kT) {
    __syncthreads();  // columns and cs are staged (first); the previous tile is consumed
    stage_rows<T>(crow, Cb, A.cst, i0, valid, N, N);
    stage_rows<T>(dyr, dyb, A.dyst, i0, valid, P, P4);
    __syncthreads();
    float s[kRows], dm[kRows];
    scores(crow, dyr, bt, xt, warp, N, P4, lane, s, dm);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = warp + kBwdWarps * k;
      const int i = i0 + r;
      const bool keep = j <= i && i < valid;
      const float d = keep ? cs[i] - cs[j] : 0.f;  // never exp of i < j
      const float l = keep ? expf(d) : 0.f;
      const float ds = dm[k] * l;
      mt[lane * kMs + r] = s[k] * l;
      dst[lane * kMs + r] = ds;
      colg = fmaf(ds, s[k], colg);
    }
    __syncthreads();
    if (act_p) accumulate(ax, mt, rp, tp, cnt_p, [&](int q) { return dyr[q * P4 + p]; });
    if (act_n) accumulate(ab, dst, rn, tn, cnt_n, [&](int q) { return crow[q * N + n]; });
  }

  // the state terms: w_j dstates B_j into dx_j, w_j dstates^T x_j into dB_j
  float* dsts = smem;                // P x (N + 1)
  float* sx = smem + P * (N + 1);    // kT x (P + 1): w_j dstates B_j
  float* red = smem + m.red;         // kBwdWarps x kT column sums
  __syncthreads();                   // the last walked tile is consumed
  const float* dsb = A.dstates + ((long long)bh * A.nc + c) * P * N;
  stage_tile(dsb, N, 0, P, P, N, N, [&](int r, int e, float v) { dsts[r * (N + 1) + e] = v; });
  red[warp * kT + lane] = colg;
  __syncthreads();
  const float cs_last = cs[Q - 1];
  // each dstates value is loaded once for all of a thread's keys (keys past
  // the tile read the tile's last column and are dropped)
  if (act_p) {
    float v[AP];
#pragma unroll
    for (int k = 0; k < AP; ++k) v[k] = 0.f;
    for (int e = 0; e < N; ++e) {
      const float d = dsts[p * (N + 1) + e];
#pragma unroll
      for (int k = 0; k < AP; ++k) v[k] = fmaf(d, bt[e * kTs + min(rp + k * tp, kT - 1)], v[k]);
    }
#pragma unroll
    for (int k = 0; k < AP; ++k) {
      const int key = rp + k * tp;
      if (k < cnt_p && key < kT) {
        const float vk = o0 + key < valid ? v[k] * expf(cs_last - cs[o0 + key]) : 0.f;
        ax[k] += vk;
        sx[key * (P + 1) + p] = vk;
      }
    }
  }
  if (act_n) {
    float v[AN];
#pragma unroll
    for (int k = 0; k < AN; ++k) v[k] = 0.f;
    for (int e = 0; e < P; ++e) {
      const float d = dsts[e * (N + 1) + n];
#pragma unroll
      for (int k = 0; k < AN; ++k) v[k] = fmaf(d, xt[e * kTs + min(rn + k * tn, kT - 1)], v[k]);
    }
#pragma unroll
    for (int k = 0; k < AN; ++k) {
      const int key = rn + k * tn;
      if (k < cnt_n && key < kT && o0 + key < valid)
        ab[k] = fmaf(expf(cs_last - cs[o0 + key]), v[k], ab[k]);
    }
  }
  __syncthreads();
  // u_j = x_j . (w_j dstates B_j), a warp per key
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int key = warp + kBwdWarps * k;
    float part = 0.f;
    for (int e = lane; e < P; e += 32) part = fmaf(sx[key * (P + 1) + e], xt[e * kTs + key], part);
    part = warp_sum(part);
    if (lane == 0 && o0 + key < valid) A.u[pos + o0 + key] = part;
  }
  if (threadIdx.x < kT && o0 + threadIdx.x < valid) {
    float sum = 0.f;
    for (int w = 0; w < kBwdWarps; ++w) sum += red[w * kT + threadIdx.x];
    A.colg[pos + o0 + threadIdx.x] = sum;
  }
  if (act_p) {
    T* dxb = static_cast<T*>(A.dx) + b * A.dxsb + h * A.dxsh + (long long)t0 * A.dxst;
#pragma unroll
    for (int k = 0; k < AP; ++k) {
      const int key = rp + k * tp;
      if (k < cnt_p && key < kT && o0 + key < valid)
        dxb[(long long)(o0 + key) * A.dxst + p] = from_float<T>(ax[k]);
    }
  }
  if (act_n) {
#pragma unroll
    for (int k = 0; k < AN; ++k) {
      const int key = rn + k * tn;
      if (k < cnt_n && key < kT && o0 + key < valid)
        A.dB[b * A.dbsb + (long long)(t0 + o0 + key) * A.dbst + h * A.dbsh + n] = ab[k];
    }
  }
}

// Pass 2, one warp per (chunk, batch * head): dcs from the row and column
// sums, u and ddecay, then da = its reverse cumsum within the chunk (each
// lane sums a contiguous segment from its end, a warp scan adds the
// segments after it).
__global__ void __launch_bounds__(32) ssd_chunk_bwd_da_kernel(const BwdArgs A) {
  extern __shared__ float smem[];
  const int Q = A.Q;
  const int c = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / A.H;
  const int h = bh - b * A.H;
  const int t0 = c * Q;
  const int valid = min(Q, A.L - t0);
  const int lane = threadIdx.x;
  float* cs = smem;
  float* dcs = smem + Q;
  warp_cumsum(cs, A.a + b * A.asb + h * A.ash + (long long)t0 * A.ast, A.ast, Q, valid, lane);
  __syncwarp();
  const long long pos = ((long long)bh * A.nc + c) * Q;
  float U = 0.f;
  for (int i = lane; i < valid; i += 32) U += A.u[pos + i];
  U = warp_sum(U);
  for (int i = lane; i < Q; i += 32) {
    float v = A.ddecay[pos + i] * expf(cs[i]);
    if (i < valid) v += A.rowg[pos + i] - A.colg[pos + i] - A.u[pos + i];
    if (i == Q - 1) v += U;
    dcs[i] = v;
  }
  __syncwarp();
  const int seg = (Q + 31) / 32;
  const int lo = min(lane * seg, Q);
  const int hi = min(lo + seg, Q);
  float run = 0.f;
  for (int i = hi - 1; i >= lo; --i) {
    run += dcs[i];
    dcs[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float down = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += down;
  }
  const float after = incl - run;
  float* dab = A.da + b * A.dasb + h * A.dash + (long long)t0 * A.dast;
  for (int i = lo; i < hi && i < valid; ++i) dab[(long long)i * A.dast] = dcs[i] + after;
}

template <typename T>
int launch_cc(const BwdArgs& A, int batch, cudaStream_t stream) {
  const BwdSmem m = bwd_smem(A.Q, A.P, A.P4, A.N);
  const size_t smem = sizeof(float) * (size_t)m.total;
  auto kernel = A.N <= 128 && A.P <= 64 ? ssd_chunk_bwd_kernel<T, 16, 8>
                                        : ssd_chunk_bwd_kernel<T, 32, 16>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (A.Q + kT - 1) / kT;
  kernel<<<dim3(2 * n_tiles, A.nc, batch * A.H), kBwdThreads, smem, stream>>>(A);
  return (int)cudaGetLastError();
}

int launch_da(const BwdArgs& A, int batch, cudaStream_t stream) {
  ssd_chunk_bwd_da_kernel<<<dim3(A.nc, batch * A.H), 32, 2 * sizeof(float) * A.Q, stream>>>(A);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int kPartsM = 2;         // bf16 parts of M^T (the dx product)
constexpr int kPartsDS = 2;        // bf16 parts of dS and dS^T (the dC and dB products)
constexpr int kPartsST = 2;        // bf16 parts of dstates (the state terms)
constexpr int kMaxTiles = 16;      // Q <= 1024
constexpr int kMaxSliceHeads = 32;
constexpr int kMaxCs = 8192;       // floats of cumsums a block keeps: heads x Q
constexpr int kBwdItems = 768;     // work items to aim for (132 SMs, two blocks each)
constexpr size_t kMaxSmem = 232448; // shared memory a block may have on sm_90
constexpr size_t kTwoBlockSmem = 115712;  // and each of two blocks on one SM

struct TcBwdArgs {
  const bf16* x;
  const float* a;
  const bf16* B;
  const bf16* C;
  const bf16* dy;
  bf16* dsp;                       // dstates in bf16 parts, padded: (batch * H * nc,
                                   // kPartsST, PB * 64, NB * 64), written by pass 1
  bf16* dx;
  float* rowg;                     // (batch * H, nc, Q): row sums of G
  float* colg;                     // column sums of G
  float* u;                        // the state term u
  float* dBp;                      // (batch, L, G, slices, N): a slice of heads' dB
  float* dCp;                      // and dC
  int batch, H, G, L, Q, P, N, nc, R, n_t, slices, hs, halves, st_round, tma, vec;
  long long xsb, xst, xsh, asb, ast, ash, bsb, bst, bsg, csb, cst, csg, dysb, dyst, dysh;
  long long dxsb, dxst, dxsh;
  int order[3 * kMaxTiles];        // item kinds, heaviest first: kind * n_t + tile
};

// A block's item: (batch, chunk, group), a slice of the group's heads
// [h0, h0 + nheads) and a half of N (N = 256 only). Neighbouring blocks take
// the other slices of the same tile, which read the same B and C.
struct BwdItem {
  int b, c, g, sl, nh, t0, valid, h0, nheads;
};

__device__ __forceinline__ void item_of(const TcBwdArgs& A, int idx, int& kind, BwdItem& s) {
  const int cnt = A.batch * A.nc * A.G * A.slices * A.halves;
  const int k = idx / cnt;
  kind = A.order[k];
  int rest = idx - k * cnt;
  s.nh = rest % A.halves;
  rest /= A.halves;
  s.sl = rest % A.slices;
  rest /= A.slices;
  s.g = rest % A.G;
  rest /= A.G;
  s.c = rest % A.nc;
  s.b = rest / A.nc;
  s.t0 = s.c * A.Q;
  s.valid = min(A.Q, A.L - s.t0);
  s.h0 = s.g * A.R + s.sl * A.hs;
  s.nheads = min(A.hs, A.R - s.sl * A.hs);
}

// One bf16 operand (x, dy, B or C): element strides (batch, position, head
// or group), its row width and its tensor map.
struct BOperand {
  const bf16* p;
  long long sb, st, si;
  int width;
  const CUtensorMap* map;
};

// Rows [row, row + 64) of operand o at (b, idx) into BLOCKS swizzled
// 64-column blocks at dst: by TMA (thread 0, a box per block; `expect` has
// told `bar` the bytes), or by cp.async from every thread, zeros past
// `nvalid` rows and past the width.
template <int BLOCKS>
__device__ __forceinline__ void load_rows(const TcBwdArgs& A, const BOperand& o, int b, int idx,
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

__device__ __forceinline__ void expect(const TcBwdArgs& A, uint32_t bar, int bytes) {
  if (A.tma && threadIdx.x == 0) mbar_expect_tx(bar, bytes);
}

// Shared memory of a block, from a 1024-byte aligned base: a fixed tile
// (C_i of a row item, B_j of a column item), ring 1 (two slots: B of a row
// item's key tile, x_h[j] of a column item's head), ring 2 (two slots: a
// step's x_h[kt] and dy_h[i], or C_i and dy_h[i]), dstates in bf16 parts
// (column items: `st_round` tiles, each a part of a 64-row block of P), the cumsums of
// the slice's heads, the row sums of G and six mbarriers (the fixed tile,
// ring 1's slots, ring 2's slots, the dstates region). Each kind lays out
// its own slots; the block has the largest of the three.
enum BwdKind { kRowItem = 0, kColBItem = 1, kColXItem = 2 };

template <int PB, int NB>
struct BwdLayout {
  static constexpr int kTileN = NB * kBlockBytes;          // 64 rows of B or C
  static constexpr int kTileP = PB * kBlockBytes;          // 64 rows of x or dy
  __host__ __device__ static constexpr int slot1(int kind) {
    return kind == kColXItem ? kTileP : kTileN;
  }
  __host__ __device__ static constexpr int slot2(int kind) {
    return kind == kColXItem ? kTileN + kTileP : 2 * kTileP;
  }
  static size_t bytes(int kind, int hs, int Q, int st_round) {
    const size_t tiles = kTileN + 2 * (size_t)slot1(kind) + 2 * (size_t)slot2(kind) +
                         (kind == kRowItem ? 0 : (size_t)st_round * kTileN);
    return 1024 + tiles + sizeof(float) * ((size_t)hs * Q + (size_t)hs * kTile) + 8 * 6;
  }
  __device__ __forceinline__ void lay_out(int kind, int st_round, int hs, int Q) {
    fix = (raw + 1023u) & ~1023u;                          // swizzle atoms are 1024-B aligned
    s1 = slot1(kind);
    s2 = slot2(kind);
    r1 = fix + kTileN;
    r2 = r1 + 2 * s1;
    dst = r2 + 2 * s2;
    const uint32_t c = dst + (kind == kRowItem ? 0 : st_round * kTileN);
    cs = reinterpret_cast<float*>(gen + (c - raw));
    sums = cs + hs * Q;
    bars = c + sizeof(float) * (hs * Q + hs * kTile);
  }
  uint32_t fix, r1, r2, dst, bars, s1, s2;
  float* cs;                                              // hs x Q
  float* sums;                                            // hs x 64: row or column sums of G
  unsigned char* gen;                                     // the generic address of `raw`
  uint32_t raw;
  __device__ __forceinline__ uint32_t ring1(int slot) const { return r1 + slot * s1; }
  __device__ __forceinline__ uint32_t ring2(int slot) const { return r2 + slot * s2; }
  __device__ __forceinline__ uint32_t bar(int i) const { return bars + 8 * i; }
  template <typename V>
  __device__ __forceinline__ const V* at(uint32_t addr) const {
    return reinterpret_cast<const V*>(gen + (addr - raw));
  }
};

// Wait until the `use`-th phase of `bar` has landed (TMA only; cp.async
// waits for everything once a step).
__device__ __forceinline__ void landed(const TcBwdArgs& A, uint32_t bar, int use) {
  if (A.tma) mbar_wait(bar, use & 1);
}
__device__ __forceinline__ void step_barrier(const TcBwdArgs& A) {
  if (!A.tma) {
    cp_async_wait<0>();
    fence_async_shared();
  }
  wg_barrier(1);
}

__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int t) {   // K-major, k-step t
  return sw128_desc(tile + (t / 4) * kBlockBytes + (t % 4) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t mndesc(uint32_t tile, int t) {  // MN-major, k-step t
  return sw128_desc(tile + t * 16 * 128, kBlockBytes, 1024);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A row item: rows i of row tile `t`, for the heads of its slice. Key
// tiles outside, heads inside: S = C_i B_kt^T once a key tile, then for
// each head dM = dy_h[i] x_h[kt]^T, dS = dM o L_h in the accumulator
// fragment (exp only where i >= j, selected), the row sums of G = dS o S
// (quad shuffles, then one owner thread a row adds them in shared memory)
// and dC_i += dS B_kt from dS as the register A operand in kPartsDS bf16
// parts. dC_i is summed over the slice's heads and key tiles in registers
// and written once, a partial of the slice.
template <int PB, int NB>
__device__ __forceinline__ void row_item(const TcBwdArgs& A, const BwdItem& s, int t,
                                         const BwdLayout<PB, NB>& m, const BOperand& xo,
                                         const BOperand& dyo, const BOperand& bo,
                                         const BOperand& co) {
  using M = BwdLayout<PB, NB>;
  constexpr int NBC = NB < 2 ? NB : 2;             // 64-column blocks of dC an item keeps
  const int i0 = t * kTile;
  if (i0 >= s.valid) return;                       // uniform: rows past L are not written
  const int n_kt = t + 1;
  const int steps = n_kt * s.nheads;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = warp * 16 + (lane >> 2);        // this thread's rows: row0, row0 + 8
  const int cq = (lane & 3) * 2;                   // and columns 8j + cq, 8j + cq + 1

  auto load_b = [&](int kt) {                      // B of key tile kt into ring 1 slot kt % 2
    expect(A, m.bar(1 + kt % 2), M::kTileN);
    load_rows<NB>(A, bo, s.b, s.g, s.t0 + kt * kTile, s.valid - kt * kTile, m.ring1(kt % 2),
                  m.bar(1 + kt % 2));
  };
  auto load_step = [&](int st) {                   // x_h[kt] and dy_h[i] into ring 2
    const int kt = st / s.nheads, h = s.h0 + st % s.nheads;
    const uint32_t bar = m.bar(3 + st % 2), slot = m.ring2(st % 2);
    expect(A, bar, 2 * M::kTileP);
    load_rows<PB>(A, xo, s.b, h, s.t0 + kt * kTile, s.valid - kt * kTile, slot, bar);
    load_rows<PB>(A, dyo, s.b, h, s.t0 + i0, s.valid - i0, slot + M::kTileP, bar);
  };
  expect(A, m.bar(0), M::kTileN);
  load_rows<NB>(A, co, s.b, s.g, s.t0 + i0, s.valid - i0, m.fix, m.bar(0));
  load_b(0);
  load_step(0);
  if (!A.tma) cp_async_commit();
  // the cumsums of the slice's heads over the positions these rows see
  for (int hi = warp; hi < s.nheads; hi += 4)
    warp_cumsum(m.cs + hi * A.Q, A.a + s.b * A.asb + (s.h0 + hi) * A.ash + (long long)s.t0 * A.ast,
                A.ast, i0 + kTile, s.valid, lane);
  for (int k = tid; k < s.nheads * kTile; k += kWgThreads) m.sums[k] = 0.f;

  float dc[NBC * 32];
#pragma unroll
  for (int e = 0; e < NBC * 32; ++e) dc[e] = 0.f;
  float sc[32], dm[32];
  uint32_t pa[kPartsDS][4][4];
#pragma unroll 1
  for (int st = 0; st < steps; ++st) {
    const int kt = st / s.nheads, hi = st % s.nheads;
    if (st == 0) landed(A, m.bar(0), 0);
    if (hi == 0) landed(A, m.bar(1 + kt % 2), kt / 2);
    landed(A, m.bar(3 + st % 2), st / 2);
    step_barrier(A);                               // copies landed; step st - 1 is done
    if (st + 1 < steps) load_step(st + 1);         // into the slot step st - 1 used
    if (hi == 0 && kt + 1 < n_kt) load_b(kt + 1);  // into the slot key tile kt - 1 used
    if (!A.tma) cp_async_commit();
    const uint32_t bt = m.ring1(kt % 2);
    const uint32_t xt = m.ring2(st % 2), dyt = xt + M::kTileP;
    if (hi == 0) {                                 // S = C_i B_kt^T, once for the slice
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < NB * 4; ++k) wgmma_ss_n64(sc, kdesc(m.fix, k), kdesc(bt, k), k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
    }
    wgmma_fence();                                 // dM = dy_h[i] x_h[kt]^T
#pragma unroll
    for (int k = 0; k < PB * 4; ++k) wgmma_ss_n64(dm, kdesc(dyt, k), kdesc(xt, k), k > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dm);

    const float* cs = m.cs + hi * A.Q;
    const bool diag = kt == t;                     // only this tile crosses i >= j
    const int j0 = kt * kTile;
    float csi[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) csi[r] = cs[i0 + row0 + 8 * r];
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int r = (e % 4) / 2;
      const int col = (e / 4) * 8 + cq;
      const bool k0 = !diag || col <= row0 + 8 * r;
      const bool k1 = !diag || col + 1 <= row0 + 8 * r;
      // the difference first, then the log2e scale (as K4)
      const float d0 = k0 ? dm[e] * ex2((csi[r] - cs[j0 + col]) * kLog2e) : 0.f;
      const float d1 = k1 ? dm[e + 1] * ex2((csi[r] - cs[j0 + col + 1]) * kLog2e) : 0.f;
      rs[r] = fmaf(d0, sc[e], rs[r]);
      rs[r] = fmaf(d1, sc[e + 1], rs[r]);
      split_bf16<kPartsDS>(d0, d1, pa, e / 8, (e % 8) / 2);
    }
    fence_regs(dc);                                // dC_i += dS B_kt, B_kt MN-major
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint64_t db = mndesc(bt + s.nh * 2 * kBlockBytes, k);
#pragma unroll
      for (int q = 0; q < kPartsDS; ++q) wgmma_pv<NBC * 64>(dc, pa[q][k], db);
    }
    wgmma_commit();
#pragma unroll
    for (int r = 0; r < 2; ++r) rs[r] = quad_sum(rs[r]);
    wgmma_wait<0>();
    fence_regs(dc);
    fence_operand(pa);
    if (cq == 0) {                                 // the quad's first thread owns its rows
#pragma unroll
      for (int r = 0; r < 2; ++r) m.sums[hi * kTile + row0 + 8 * r] += rs[r];
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + row0 + 8 * half;
    if (i >= s.valid) continue;
    float* out = A.dCp + (((long long)(s.b * A.L + s.t0 + i) * A.G + s.g) * A.slices + s.sl) * A.N;
#pragma unroll
    for (int jj = 0; jj < NBC * 8; ++jj) {
      const int n = s.nh * NBC * 64 + jj * 8 + cq;  // N % 16 == 0: n < N means n + 1 < N
      if (n < A.N)
        *reinterpret_cast<float2*>(out + n) =
            make_float2(dc[jj * 4 + half * 2], dc[jj * 4 + half * 2 + 1]);
    }
    if (s.nh == 0 && cq == 0)
      for (int hi = 0; hi < s.nheads; ++hi)
        A.rowg[((long long)(s.b * A.H + s.h0 + hi) * A.nc + s.c) * A.Q + i] =
            m.sums[hi * kTile + row0 + 8 * half];
  }
}

// The state terms of head h read dstates_h in kPartsST bf16 parts (pass 1,
// ssd_chunk_bwd_parts_kernel, wrote them padded to 64-row blocks of P and
// 64-column blocks of N): tile q = pr * kPartsST + k is part k of rows
// [64 pr, 64 pr + 64), K-major and swizzled in shared memory as a B or C
// tile, the B operand of T1 = B_j dstates_h^T and (MN-major) of T2 =
// x_h[j] dstates_h. The dst region takes st_round tiles a round.
__device__ __forceinline__ int dst_tiles(int PB) { return PB * kPartsST; }

template <int PB, int NB>
__device__ __forceinline__ void load_dst_round(const TcBwdArgs& A, const BwdLayout<PB, NB>& m,
                                               const CUtensorMap* dmap, long long bhc,
                                               int round) {
  using M = BwdLayout<PB, NB>;
  const int q0 = round * A.st_round;
  const int n = min(A.st_round, dst_tiles(PB) - q0);
  if (A.tma && threadIdx.x == 0) mbar_expect_tx(m.bar(5), n * M::kTileN);
  for (int s = 0; s < n; ++s) {
    const int q = q0 + s;
    const long long row = ((bhc * kPartsST + q % kPartsST) * PB + q / kPartsST) * kTile;
    const uint32_t dst = m.dst + s * M::kTileN;
    if (A.tma) {
      if (threadIdx.x == 0)
#pragma unroll
        for (int cb = 0; cb < NB; ++cb)
          tma_load(dst + cb * kBlockBytes, dmap, m.bar(5), cb * 64, (int)row, 0, 0);
    } else {
      load_tile<NB * 64, kWgThreads>(dst, A.dsp + row * (NB * 64), NB * 64, kTile, NB * 64,
                                     true, threadIdx.x);
    }
  }
}

// The rounds of head h's dstates tiles: round 0 was issued at the top of
// the head's last step (ahead of that step's prefetch, so a cp.async wait
// for all but the newest group sees it), each later one after the round
// before it is consumed. use(q, tile) issues and waits for tile q's
// products.
template <int PB, int NB, typename Use>
__device__ __forceinline__ void with_dstates(const TcBwdArgs& A, const BwdLayout<PB, NB>& m,
                                             const CUtensorMap* dmap, long long bhc,
                                             int& dst_use, Use use) {
  using M = BwdLayout<PB, NB>;
  const int rounds = (dst_tiles(PB) + A.st_round - 1) / A.st_round;
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    if (r > 0) {
      wg_barrier(1);                               // the round before is consumed
      load_dst_round<PB, NB>(A, m, dmap, bhc, r);
      if (!A.tma) cp_async_commit();
    }
    if (A.tma) {
      mbar_wait(m.bar(5), dst_use & 1);
    } else {
      if (r == 0) cp_async_wait<1>();
      else cp_async_wait<0>();
      fence_async_shared();
      wg_barrier(1);
    }
    ++dst_use;
    const int q0 = r * A.st_round;
    for (int s = 0; s < A.st_round && q0 + s < dst_tiles(PB); ++s)
      use(q0 + s, m.dst + s * M::kTileN);
  }
}

// A dB item: keys j of tile `t`, dB_j summed over the heads of its slice.
// Row tiles outside, heads inside: S^T = B_j C_i^T once a row tile (the key
// tile as wgmma's M, so nothing is transposed through shared memory), then
// for each head dM^T = x_h[j] dy_h[i]^T, dS^T = dM^T o L_h^T in the
// fragment, the column sums of G as the row sums of G^T (quad shuffles,
// one owner thread a key in shared memory) and dB_j += dS^T C_i from dS^T
// as the register A operand. With the last row tile each head adds its
// state term w_j x_h[j] dstates_h (T2, x_h[j] as ldmatrix'd A operand).
template <int PB, int NB>
__device__ __forceinline__ void colb_item(const TcBwdArgs& A, const BwdItem& s, int t,
                                          const BwdLayout<PB, NB>& m, const BOperand& xo,
                                          const BOperand& dyo, const BOperand& bo,
                                          const BOperand& co, const CUtensorMap* dmap) {
  using M = BwdLayout<PB, NB>;
  constexpr int NBC = NB < 2 ? NB : 2;
  const int j0 = t * kTile;
  if (j0 >= s.valid) return;                       // uniform: keys past L are not written
  const int n_it = (s.valid + kTile - 1) / kTile - t;
  const int steps = n_it * s.nheads;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = warp * 16 + (lane >> 2);        // this thread's keys: row0, row0 + 8
  const int cq = (lane & 3) * 2;                   // and rows 8j + cq, 8j + cq + 1

  auto load_c = [&](int k) {                       // C of row tile t + k into ring 1 slot k % 2
    const int i0 = (t + k) * kTile;
    expect(A, m.bar(1 + k % 2), M::kTileN);
    load_rows<NB>(A, co, s.b, s.g, s.t0 + i0, s.valid - i0, m.ring1(k % 2), m.bar(1 + k % 2));
  };
  auto load_step = [&](int st) {                   // x_h[j] and dy_h[i] into ring 2
    const int i0 = (t + st / s.nheads) * kTile, h = s.h0 + st % s.nheads;
    const uint32_t bar = m.bar(3 + st % 2), slot = m.ring2(st % 2);
    expect(A, bar, 2 * M::kTileP);
    load_rows<PB>(A, xo, s.b, h, s.t0 + j0, s.valid - j0, slot, bar);
    load_rows<PB>(A, dyo, s.b, h, s.t0 + i0, s.valid - i0, slot + M::kTileP, bar);
  };
  expect(A, m.bar(0), M::kTileN);
  load_rows<NB>(A, bo, s.b, s.g, s.t0 + j0, s.valid - j0, m.fix, m.bar(0));
  load_c(0);
  load_step(0);
  if (!A.tma) cp_async_commit();
  for (int hi = warp; hi < s.nheads; hi += 4)      // the whole chunk: w needs cs_last
    warp_cumsum(m.cs + hi * A.Q, A.a + s.b * A.asb + (s.h0 + hi) * A.ash + (long long)s.t0 * A.ast,
                A.ast, A.Q, s.valid, lane);
  for (int k = tid; k < s.nheads * kTile; k += kWgThreads) m.sums[k] = 0.f;

  float db[NBC * 32];
#pragma unroll
  for (int e = 0; e < NBC * 32; ++e) db[e] = 0.f;
  float sct[32], dmt[32];
  uint32_t pd[kPartsDS][4][4];
  int dst_use = 0;                                 // rounds of the dst region's barrier
#pragma unroll 1
  for (int st = 0; st < steps; ++st) {
    const int k_it = st / s.nheads, hi = st % s.nheads;
    const int h = s.h0 + hi;
    const int i0 = (t + k_it) * kTile;
    if (st == 0) landed(A, m.bar(0), 0);
    if (hi == 0) landed(A, m.bar(1 + k_it % 2), k_it / 2);
    landed(A, m.bar(3 + st % 2), st / 2);
    step_barrier(A);                               // copies landed; step st - 1 is done
    const long long bhc = (long long)(s.b * A.H + h) * A.nc + s.c;
    if (k_it + 1 == n_it) {                        // the head's state term comes this step
      load_dst_round<PB, NB>(A, m, dmap, bhc, 0);
      if (!A.tma) cp_async_commit();
    }
    if (st + 1 < steps) load_step(st + 1);
    if (hi == 0 && k_it + 1 < n_it) load_c(k_it + 1);
    if (!A.tma) cp_async_commit();
    const uint32_t ct = m.ring1(k_it % 2);
    const uint32_t xt = m.ring2(st % 2), dyt = xt + M::kTileP;
    if (hi == 0) {                                 // S^T = B_j C_i^T, once for the slice
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < NB * 4; ++k) wgmma_ss_n64(sct, kdesc(m.fix, k), kdesc(ct, k), k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sct);
    }
    wgmma_fence();                                 // dM^T = x_h[j] dy_h[i]^T
#pragma unroll
    for (int k = 0; k < PB * 4; ++k) wgmma_ss_n64(dmt, kdesc(xt, k), kdesc(dyt, k), k > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dmt);

    const float* cs = m.cs + hi * A.Q;
    const bool diag = k_it == 0;                   // only the key tile's own row tile crosses
    float csj[2], cg[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) csj[r] = cs[j0 + row0 + 8 * r];
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int r = (e % 4) / 2;
      const int col = (e / 4) * 8 + cq;
      const bool k0 = !diag || col >= row0 + 8 * r;
      const bool k1 = !diag || col + 1 >= row0 + 8 * r;
      const float d0 = k0 ? dmt[e] * ex2((cs[i0 + col] - csj[r]) * kLog2e) : 0.f;
      const float d1 = k1 ? dmt[e + 1] * ex2((cs[i0 + col + 1] - csj[r]) * kLog2e) : 0.f;
      cg[r] = fmaf(d0, sct[e], cg[r]);
      cg[r] = fmaf(d1, sct[e + 1], cg[r]);
      split_bf16<kPartsDS>(d0, d1, pd, e / 8, (e % 8) / 2);
    }
    fence_regs(db);                                // dB_j += dS^T C_i, C MN-major
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint64_t dc = mndesc(ct + s.nh * 2 * kBlockBytes, k);
#pragma unroll
      for (int q = 0; q < kPartsDS; ++q) wgmma_pv<NBC * 64>(db, pd[q][k], dc);
    }
    wgmma_commit();
#pragma unroll
    for (int r = 0; r < 2; ++r) cg[r] = quad_sum(cg[r]);
    wgmma_wait<0>();
    fence_regs(db);
    fence_operand(pd);
    if (cq == 0) {                                 // the quad's first thread owns its keys
#pragma unroll
      for (int r = 0; r < 2; ++r) m.sums[hi * kTile + row0 + 8 * r] += cg[r];
    }
    if (k_it + 1 < n_it) continue;

    // the last row tile: head h's state term, dB_j += w_j x_h[j] dstates_h
    float w[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) w[r] = ex2((cs[A.Q - 1] - csj[r]) * kLog2e);
    float t2[NBC * 32];
#pragma unroll
    for (int e = 0; e < NBC * 32; ++e) t2[e] = 0.f;
    with_dstates<PB, NB>(A, m, dmap, bhc, dst_use, [&](int q, uint32_t dq) {
      const int pr = q / kPartsST;
      uint32_t xa[4][4];                           // x_h[j], block pr of P, as the A operand
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = warp * 16 + (lane & 15), c16 = 2 * k + (lane >> 4);
        ldmatrix_x4(xa[k], xt + pr * kBlockBytes + r * 128 + ((c16 ^ (r & 7)) << 4));
      }
      fence_regs(t2);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_pv<NBC * 64>(t2, xa[k], mndesc(dq + s.nh * 2 * kBlockBytes, k));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(t2);
    });
#pragma unroll
    for (int e = 0; e < NBC * 32; ++e) db[e] = fmaf(w[(e % 4) / 2], t2[e], db[e]);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = j0 + row0 + 8 * half;
    if (j >= s.valid) continue;
    float* out = A.dBp + (((long long)(s.b * A.L + s.t0 + j) * A.G + s.g) * A.slices + s.sl) * A.N;
#pragma unroll
    for (int jj = 0; jj < NBC * 8; ++jj) {
      const int n = s.nh * NBC * 64 + jj * 8 + cq;
      if (n < A.N)
        *reinterpret_cast<float2*>(out + n) =
            make_float2(db[jj * 4 + half * 2], db[jj * 4 + half * 2 + 1]);
    }
    if (s.nh == 0 && cq == 0)
      for (int hi = 0; hi < s.nheads; ++hi)
        A.colg[((long long)(s.b * A.H + s.h0 + hi) * A.nc + s.c) * A.Q + j] =
            m.sums[hi * kTile + row0 + 8 * half];
  }
}

// A dx item: keys j of tile `t`, dx_j of each head of its slice. Heads
// outside, row tiles inside: S^T = B_j C_i^T (recomputed for every head),
// M^T = S^T o L_h^T in the fragment and dx_j += M^T dy_h[i] from M^T as the
// register A operand in kPartsM bf16 parts. After a head's row tiles its
// state term T1 = B_j dstates_h^T: dx_j += w_j T1 and u_j = w_j x_h[j] .
// T1_j; then dx_j and u_j of the head are written.
template <int PB, int NB>
__device__ __forceinline__ void colx_item(const TcBwdArgs& A, const BwdItem& s, int t,
                                          const BwdLayout<PB, NB>& m, const BOperand& xo,
                                          const BOperand& dyo, const BOperand& bo,
                                          const BOperand& co, const CUtensorMap* dmap) {
  using M = BwdLayout<PB, NB>;
  const int j0 = t * kTile;
  if (j0 >= s.valid || s.nh > 0) return;           // uniform: dx once, keys past L not written
  const int n_it = (s.valid + kTile - 1) / kTile - t;
  const int steps = s.nheads * n_it;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = warp * 16 + (lane >> 2);        // this thread's keys: row0, row0 + 8
  const int cq = (lane & 3) * 2;                   // and rows 8j + cq, 8j + cq + 1

  auto load_x = [&](int hi) {                      // x_h[j] of head hi into ring 1
    expect(A, m.bar(1 + hi % 2), M::kTileP);
    load_rows<PB>(A, xo, s.b, s.h0 + hi, s.t0 + j0, s.valid - j0, m.ring1(hi % 2),
                  m.bar(1 + hi % 2));
  };
  auto load_step = [&](int st) {                   // C_i and dy_h[i] into ring 2
    const int h = s.h0 + st / n_it, i0 = (t + st % n_it) * kTile;
    const uint32_t bar = m.bar(3 + st % 2), slot = m.ring2(st % 2);
    expect(A, bar, M::kTileN + M::kTileP);
    load_rows<NB>(A, co, s.b, s.g, s.t0 + i0, s.valid - i0, slot, bar);
    load_rows<PB>(A, dyo, s.b, h, s.t0 + i0, s.valid - i0, slot + M::kTileN, bar);
  };
  expect(A, m.bar(0), M::kTileN);
  load_rows<NB>(A, bo, s.b, s.g, s.t0 + j0, s.valid - j0, m.fix, m.bar(0));
  load_x(0);
  load_step(0);
  if (!A.tma) cp_async_commit();
  for (int hi = warp; hi < s.nheads; hi += 4)      // the whole chunk: w needs cs_last
    warp_cumsum(m.cs + hi * A.Q, A.a + s.b * A.asb + (s.h0 + hi) * A.ash + (long long)s.t0 * A.ast,
                A.ast, A.Q, s.valid, lane);

  float dx[PB * 32];
#pragma unroll
  for (int e = 0; e < PB * 32; ++e) dx[e] = 0.f;
  float sct[32];
  uint32_t pm[kPartsM][4][4];
  int dst_use = 0;                                 // rounds of the dst region's barrier
#pragma unroll 1
  for (int st = 0; st < steps; ++st) {
    const int hi = st / n_it, k_it = st % n_it;
    const int h = s.h0 + hi;
    const int i0 = (t + k_it) * kTile;
    if (st == 0) landed(A, m.bar(0), 0);
    if (k_it == 0) landed(A, m.bar(1 + hi % 2), hi / 2);
    landed(A, m.bar(3 + st % 2), st / 2);
    step_barrier(A);                               // copies landed; step st - 1 is done
    const long long bhc = (long long)(s.b * A.H + h) * A.nc + s.c;
    if (k_it + 1 == n_it) {                        // the head's state term comes this step
      load_dst_round<PB, NB>(A, m, dmap, bhc, 0);
      if (!A.tma) cp_async_commit();
    }
    if (st + 1 < steps) load_step(st + 1);
    if (k_it + 1 == n_it && hi + 1 < s.nheads) load_x(hi + 1);
    if (!A.tma) cp_async_commit();
    const uint32_t xt = m.ring1(hi % 2);
    const uint32_t ct = m.ring2(st % 2), dyt = ct + M::kTileN;

    wgmma_fence();                                 // S^T = B_j C_i^T
#pragma unroll
    for (int k = 0; k < NB * 4; ++k) wgmma_ss_n64(sct, kdesc(m.fix, k), kdesc(ct, k), k > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sct);

    const float* cs = m.cs + hi * A.Q;
    const bool diag = k_it == 0;
    float csj[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) csj[r] = cs[j0 + row0 + 8 * r];
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int r = (e % 4) / 2;
      const int col = (e / 4) * 8 + cq;
      const bool k0 = !diag || col >= row0 + 8 * r;
      const bool k1 = !diag || col + 1 >= row0 + 8 * r;
      const float v0 = k0 ? sct[e] * ex2((cs[i0 + col] - csj[r]) * kLog2e) : 0.f;
      const float v1 = k1 ? sct[e + 1] * ex2((cs[i0 + col + 1] - csj[r]) * kLog2e) : 0.f;
      split_bf16<kPartsM>(v0, v1, pm, e / 8, (e % 8) / 2);
    }
    fence_regs(dx);                                // dx_j += M^T dy_h[i], dy MN-major
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int q = 0; q < kPartsM; ++q) wgmma_pv<PB * 64>(dx, pm[q][k], mndesc(dyt, k));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dx);
    fence_operand(pm);
    if (k_it + 1 < n_it) continue;

    // ---- head h is through its row tiles: its state term, then dx_j and u_j
    const long long pos = ((long long)(s.b * A.H + h) * A.nc + s.c) * A.Q;
    float w[2], up[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) w[r] = ex2((cs[A.Q - 1] - csj[r]) * kLog2e);
    float t1[32];                                  // B_j dstates_h^T, a block of P
    with_dstates<PB, NB>(A, m, dmap, bhc, dst_use, [&](int q, uint32_t dq) {
      if (q % kPartsST == 0) {
#pragma unroll
        for (int e = 0; e < 32; ++e) t1[e] = 0.f;
      }
      fence_regs(t1);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < NB * 4; ++k) wgmma_ss_n64(t1, kdesc(m.fix, k), kdesc(dq, k), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(t1);
      if (q % kPartsST + 1 < kPartsST) return;
#pragma unroll
      for (int pr = 0; pr < PB; ++pr) {            // block q / kPartsST is complete
        if (pr != q / kPartsST) continue;
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const int r = (e % 4) / 2;
          const int c = (e / 4) * 8 + cq;          // column within this block of P
          const int row = row0 + 8 * r;
          const float v0 = w[r] * t1[e], v1 = w[r] * t1[e + 1];
          dx[pr * 32 + e] += v0;
          dx[pr * 32 + e + 1] += v1;
          const float2 xv = __bfloat1622float2(*m.template at<__nv_bfloat162>(
              xt + pr * kBlockBytes + row * 128 + (((c / 8) ^ (row & 7)) << 4) + (c % 8) * 2));
          up[r] = fmaf(xv.x, v0, fmaf(xv.y, v1, up[r]));
        }
      }
    });
    bf16* dxb = A.dx + s.b * A.dxsb + h * A.dxsh + (long long)s.t0 * A.dxst;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      up[r] = quad_sum(up[r]);
      const int j = j0 + row0 + 8 * r;
      if (j >= s.valid) continue;
      if (cq == 0) A.u[pos + j] = up[r];
#pragma unroll
      for (int pr = 0; pr < PB; ++pr)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int p = pr * kTile + jj * 8 + cq;  // P % 16 == 0: p < P means p + 1 < P
          if (p < A.P)
            *reinterpret_cast<__nv_bfloat162*>(dxb + (long long)j * A.dxst + p) =
                __floats2bfloat162_rn(dx[pr * 32 + jj * 4 + r * 2],
                                      dx[pr * 32 + jj * 4 + r * 2 + 1]);
        }
    }
#pragma unroll
    for (int e = 0; e < PB * 32; ++e) dx[e] = 0.f;
  }
  cp_async_wait<0>();
}

template <int PB, int NB>
__global__ void __launch_bounds__(kWgThreads)
ssd_chunk_bwd_tc_kernel(const __grid_constant__ TcBwdArgs A,
                        const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap dymap,
                        const __grid_constant__ CUtensorMap bmap,
                        const __grid_constant__ CUtensorMap cmap,
                        const __grid_constant__ CUtensorMap dmap) {
  using M = BwdLayout<PB, NB>;
  extern __shared__ unsigned char smem_raw[];
  int kind;
  BwdItem s;
  item_of(A, blockIdx.x, kind, s);
  M m;
  m.gen = smem_raw;
  m.raw = smem_u32(smem_raw);
  m.lay_out(kind / A.n_t, A.st_round, A.hs, A.Q);
  if (A.tma) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < 6; ++i) mbar_init(m.bar(i), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  const BOperand xo{A.x, A.xsb, A.xst, A.xsh, A.P, &xmap};
  const BOperand dyo{A.dy, A.dysb, A.dyst, A.dysh, A.P, &dymap};
  const BOperand bo{A.B, A.bsb, A.bst, A.bsg, A.N, &bmap};
  const BOperand co{A.C, A.csb, A.cst, A.csg, A.N, &cmap};
  const int tile = kind % A.n_t;
  if (kind / A.n_t == kRowItem)
    row_item<PB, NB>(A, s, tile, m, xo, dyo, bo, co);
  else if (kind / A.n_t == kColBItem)
    colb_item<PB, NB>(A, s, tile, m, xo, dyo, bo, co, &dmap);
  else
    colx_item<PB, NB>(A, s, tile, m, xo, dyo, bo, co, &dmap);
}

// Pass 1 of the tensor-core route: dstates (batch * H * nc, P, N) fp32 as
// kPartsST bf16 parts, each the bf16 rounding of what the ones before it
// leave, zero-padded to prows rows and ncols columns (64-row and 64-column
// blocks): dsp[((bhc * kPartsST + k) * prows + p) * ncols + n]. The items'
// state terms load them as they load B and C tiles.
__global__ void __launch_bounds__(256)
ssd_chunk_bwd_parts_kernel(const float* ds, bf16* dsp, long long bhcs, int P, int N, int prows,
                           int ncols) {
  const int chunks = ncols / 8;                    // 16-byte chunks of a bf16 row
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       q < bhcs * prows * chunks; q += (long long)gridDim.x * blockDim.x) {
    const int n0 = (int)(q % chunks) * 8;
    const long long rq = q / chunks;
    const int p = (int)(rq % prows);
    const long long bhc = rq / prows;
    float v[8];
    if (p < P && n0 < N) {                         // N % 16 == 0: whole chunks
      const float* src = ds + (bhc * P + p) * N + n0;
      const float4 lo = *reinterpret_cast<const float4*>(src);
      const float4 hi = *reinterpret_cast<const float4*>(src + 4);
      v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
      v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < kPartsST; ++k) {
      uint4 w;
      uint32_t* wp = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(v[e], v[e + 1]);
        wp[e / 2] = *reinterpret_cast<const uint32_t*>(&h2);
        v[e] -= __low2float(h2);
        v[e + 1] -= __high2float(h2);
      }
      *reinterpret_cast<uint4*>(dsp + ((bhc * kPartsST + k) * prows + p) * ncols + n0) = w;
    }
  }
}

// Pass 3 of the tensor-core route: dB and dC (bf16, (batch, L, G, N) at the
// caller's strides) as the sums of the slices' partials, in slice order.
__global__ void __launch_bounds__(256)
ssd_chunk_bwd_group_sum_kernel(const float* dBp, const float* dCp, bf16* dB, bf16* dC, int L,
                               int G, int slices, int N, long long rows, long long dbsb,
                               long long dbst, long long dbsg, long long dcsb, long long dcst,
                               long long dcsg) {
  const bool is_c = blockIdx.y == 1;
  const float* part = is_c ? dCp : dBp;
  bf16* out = is_c ? dC : dB;
  const long long sb = is_c ? dcsb : dbsb, st = is_c ? dcst : dbst, sg = is_c ? dcsg : dbsg;
  const int pairs = N / 2;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < rows * pairs;
       q += (long long)gridDim.x * blockDim.x) {
    const long long row = q / pairs;                 // (b, t, g)
    const int n = (int)(q - row * pairs) * 2;
    const int g = (int)(row % G);
    const long long bt = row / G;
    const int t = (int)(bt % L);
    const int b = (int)(bt / L);
    const float* p = part + row * slices * N + n;
    float2 acc = make_float2(0.f, 0.f);
    for (int sl = 0; sl < slices; ++sl) {
      const float2 v = *reinterpret_cast<const float2*>(p + (long long)sl * N);
      acc.x += v.x;
      acc.y += v.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(out + b * sb + t * st + g * sg + n) =
        __floats2bfloat162_rn(acc.x, acc.y);
  }
}

// The host's balance model, in m64n64k16 wgmma steps (an n128 counts 2),
// with 8 for a step's exponents and selections and 16 for staging a
// head's dstates: a row item of row tile t walks t + 1 key tiles (S for
// the slice, then dM and dC's products for each head); a dB item of key
// tile t the row tiles from t on (S^T, then dM^T and dB's products for
// each head) and then each head's T2; a dx item, for each head, the same
// row tiles (S^T and dx's product) and the head's T1.
void order_bwd_items(TcBwdArgs& A, int PB, int NB) {
  const int NBC = NB < 2 ? NB : 2;
  int cost[3 * kMaxTiles];
  for (int t = 0; t < A.n_t; ++t) {
    const int n_it = A.n_t - t;
    cost[kRowItem * A.n_t + t] = (t + 1) * (4 * NB + A.hs * (4 * PB + 4 * kPartsDS * NBC + 8));
    cost[kColBItem * A.n_t + t] = n_it * (4 * NB + A.hs * (4 * PB + 4 * kPartsDS * NBC + 8)) +
                                  A.hs * (kPartsST * 4 * PB * NBC + 16);
    cost[kColXItem * A.n_t + t] =
        A.hs * (n_it * (4 * NB + 4 * kPartsM * PB + 8) + kPartsST * 4 * NB * PB + 16);
  }
  for (int k = 0; k < 3 * A.n_t; ++k) A.order[k] = k;
  std::stable_sort(A.order, A.order + 3 * A.n_t, [&](int u, int v) { return cost[u] > cost[v]; });
}

template <int PB, int NB>
int launch_tc_t(TcBwdArgs& A, const CUtensorMap* maps, cudaStream_t stream) {
  using M = BwdLayout<PB, NB>;
  // the dstates parts a round stages: all of them where they fit
  auto bytes = [&] {
    return std::max({M::bytes(kRowItem, A.hs, A.Q, A.st_round),
                     M::bytes(kColBItem, A.hs, A.Q, A.st_round),
                     M::bytes(kColXItem, A.hs, A.Q, A.st_round)});
  };
  // as many dstates tiles a round as leave room for two blocks an SM (at
  // least one), or failing that for one
  for (A.st_round = PB * kPartsST; A.st_round > 1 && bytes() > kTwoBlockSmem; --A.st_round) {
  }
  const size_t smem = bytes();
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = ssd_chunk_bwd_tc_kernel<PB, NB>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  order_bwd_items(A, PB, NB);
  const int items = 3 * A.n_t * A.batch * A.nc * A.G * A.slices * A.halves;
  kernel<<<items, kWgThreads, smem, stream>>>(A, maps[0], maps[1], maps[2], maps[3], maps[4]);
  return (int)cudaGetLastError();
}

// A stride of a dimension of extent 1 is never used to address; TMA still
// wants a nonzero one.
long long nz(long long stride, long long alt) { return stride != 0 ? stride : alt; }

// How many slices of a group's R = H / G heads keep dB and dC partials:
// the fewest that give at least kBwdItems items (a row, a dB and a dx item
// a 64-position tile, per half of N past 128), at most kMaxSliceHeads and
// kMaxCs / Q heads a slice. At Mamba2-370m's train shape (8 x 512 tokens,
// one group of 32 heads, chunk 256) that is 4 slices of 8 heads, 768 items.
int head_slices(int batch, int H, int G, int L, int Q, int N) {
  const int R = H / G;
  const long long base = std::max(
      1LL, (long long)batch * ((L + Q - 1) / Q) * G * 3 * (Q / kTile) * (N > 128 ? 2 : 1));
  const long long want = (kBwdItems + base - 1) / base;
  const int hs = (int)std::max(1LL, std::min({(R + want - 1) / want, (long long)kMaxSliceHeads,
                                              (long long)(kMaxCs / Q)}));
  return (R + hs - 1) / hs;
}

// The tensor-core route's scratch past the row and column sums and u, in
// floats: the slices' partials of dB and dC, then dstates in bf16 parts.
long long tc_scratch_floats(int batch, int H, int G, int L, int Q, int P, int N) {
  const long long nc = (L + Q - 1) / Q;
  const int slices = head_slices(batch, H, G, L, Q, N);
  const int prows = P > 64 ? 128 : 64;
  const int ncols = N <= 64 ? 64 : N <= 128 ? 128 : 256;
  return 2LL * batch * L * G * slices * N +
         (long long)batch * H * nc * kPartsST * prows * ncols / 2;
}

int launch_tc(const BwdArgs& s, int batch, float* parts, cudaStream_t stream) {
  const int Q = s.Q, P = s.P, N = s.N, R = s.H / s.G;
  if (Q % kTile || Q / kTile > kMaxTiles || N % 16 || N < 16 || N > 256 || P % 16 || P < 16 ||
      P > 128)
    return (int)cudaErrorInvalidValue;
  const int slices = head_slices(batch, s.H, s.G, s.L, Q, N);
  const int hs = (R + slices - 1) / slices;
  if ((R + hs - 1) / hs != slices || hs > kMaxSliceHeads || (long long)hs * Q > kMaxCs)
    return (int)cudaErrorInvalidValue;
  const long long out_st[9] = {s.dxsb, s.dxst, s.dxsh, s.dbsb, s.dbst, s.dbsh,
                               s.dcsb, s.dcst, s.dcsh};
  for (long long v : out_st)
    if (v % 2) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)s.dx | (uintptr_t)s.dB | (uintptr_t)s.dC) & 3) return (int)cudaErrorInvalidValue;
  TcBwdArgs A{};
  A.x = static_cast<const bf16*>(s.x);
  A.a = s.a;
  A.B = static_cast<const bf16*>(s.B);
  A.C = static_cast<const bf16*>(s.C);
  A.dy = static_cast<const bf16*>(s.dy);
  A.dx = static_cast<bf16*>(s.dx);
  A.rowg = s.rowg, A.colg = s.colg, A.u = s.u;
  const long long part = (long long)batch * s.L * s.G * slices * N;
  A.dBp = parts;
  A.dCp = parts + part;
  A.dsp = reinterpret_cast<bf16*>(parts + 2 * part);
  A.batch = batch, A.H = s.H, A.G = s.G, A.L = s.L, A.Q = Q, A.P = P, A.N = N, A.nc = s.nc;
  A.R = R, A.n_t = Q / kTile, A.slices = slices, A.hs = hs, A.halves = N > 128 ? 2 : 1;
  A.xsb = s.xsb, A.xst = s.xst, A.xsh = s.xsh, A.asb = s.asb, A.ast = s.ast, A.ash = s.ash;
  A.bsb = s.bsb, A.bst = s.bst, A.bsg = s.bsg, A.csb = s.csb, A.cst = s.cst, A.csg = s.csg;
  A.dysb = s.dysb, A.dyst = s.dyst, A.dysh = s.dysh;
  A.dxsb = s.dxsb, A.dxst = s.dxst, A.dxsh = s.dxsh;
  // 16-byte copies need every row start of x, dy, B and C on 16 bytes; TMA
  // also whole 64-column blocks of N and P.
  const long long st[12] = {s.xsb, s.xst, s.xsh, s.dysb, s.dyst, s.dysh,
                            s.bsb, s.bst, s.bsg, s.csb, s.cst, s.csg};
  A.vec = aligned16(s.x) && aligned16(s.dy) && aligned16(s.B) && aligned16(s.C);
  for (long long v : st) A.vec = A.vec && v % 8 == 0;
  CUtensorMap maps[5] = {};
  A.tma = A.vec && P % 64 == 0 && N % 64 == 0;
  const int PB = P > 64 ? 2 : 1;
  const int NB = N <= 64 ? 1 : N <= 128 ? 2 : 4;
  const long long bhcs = (long long)batch * s.H * s.nc;
  if (A.tma) {
    const long long xh = nz(s.xsh, s.xst * s.L), dh = nz(s.dysh, s.dyst * s.L),
                    bg = nz(s.bsg, s.bst * s.L), cg = nz(s.csg, s.cst * s.L);
    A.tma = tensor_map(&maps[0], s.x, P, s.L, s.H, batch, s.xst, xh, nz(s.xsb, xh * s.H)) &&
            tensor_map(&maps[1], s.dy, P, s.L, s.H, batch, s.dyst, dh, nz(s.dysb, dh * s.H)) &&
            tensor_map(&maps[2], s.B, N, s.L, s.G, batch, s.bst, bg, nz(s.bsb, bg * s.G)) &&
            tensor_map(&maps[3], s.C, N, s.L, s.G, batch, s.cst, cg, nz(s.csb, cg * s.G));
    const long long rows = bhcs * kPartsST * PB * 64;  // dstates' parts, rows of NB * 64
    A.tma = A.tma && tensor_map(&maps[4], A.dsp, NB * 64, (int)rows, 1, 1, NB * 64,
                                rows * NB * 64, rows * NB * 64);
    if (!A.tma) return (int)cudaErrorInvalidValue;
  }
  ssd_chunk_bwd_parts_kernel<<<(unsigned)std::min<long long>((bhcs * PB * 64 * NB * 8 + 255) / 256,
                                                             8192), 256, 0, stream>>>(
      s.dstates, A.dsp, bhcs, P, N, PB * 64, NB * 64);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if (PB == 1 && NB == 1) err = launch_tc_t<1, 1>(A, maps, stream);
  else if (PB == 1 && NB == 2) err = launch_tc_t<1, 2>(A, maps, stream);
  else if (PB == 1 && NB == 4) err = launch_tc_t<1, 4>(A, maps, stream);
  else if (PB == 2 && NB == 1) err = launch_tc_t<2, 1>(A, maps, stream);
  else if (PB == 2 && NB == 2) err = launch_tc_t<2, 2>(A, maps, stream);
  else err = launch_tc_t<2, 4>(A, maps, stream);
  if (err) return err;
  const long long rows = (long long)batch * s.L * s.G;
  const long long blocks = std::min<long long>((rows * (N / 2) + 255) / 256, 4096);
  ssd_chunk_bwd_group_sum_kernel<<<dim3((unsigned)blocks, 2), 256, 0, stream>>>(
      A.dBp, A.dCp, reinterpret_cast<bf16*>(s.dB), reinterpret_cast<bf16*>(s.dC), s.L, s.G,
      slices, N, rows, s.dbsb, s.dbst, s.dbsh, s.dcsb, s.dcst, s.dcsh);
  return (int)cudaGetLastError();
}
}  // namespace

// route 0 = CUDA cores (dtype 0 = float32 or 1 = bfloat16 for x, B, C, dy
// and dx; dB and dC are per-head fp32 partials (batch, L, H, N), which the
// caller sums over a group's heads), 1 = tensor cores (bfloat16 only; dB
// and dC are bf16 (batch, L, G, N), summed over the group here from the
// partials of head_slices slices of its heads). a,
// dstates, ddecay and da are float32. Element strides (b, t, h or g) in
// the order x, a, B, C, dy, dx, da, dB, dC; the last dim of x, B, C, dy,
// dx, dB and dC is contiguous. dstates is (batch, H, nc, P, N) and ddecay
// (batch, H, nc, Q), both contiguous, nc = ceil(L / Q). scratch holds 3 *
// batch * H * nc * Q floats, and on the tensor cores more (for the slices'
// partials and dstates in bf16 parts; ssd_chunk_bwd_scratch_floats says
// how many in all). The CUDA cores take N % 4 == 0, 4 <= N <= 256, 1 <= P
// <= 128 and 1 <= Q <= 1024; the tensor cores Q % 64 == 0 up to 1024, N
// and P multiples of 16, 16 <= N <= 256 and 16 <= P <= 128. Anything else
// returns cudaErrorInvalidValue.
// The floats of scratch ssd_chunk_bwd_launch needs for a call on `route`.
extern "C" long long ssd_chunk_bwd_scratch_floats(int route, int batch, int H, int G, int L,
                                                  int Q, int P, int N) {
  const long long per = (long long)batch * H * ((L + Q - 1) / Q) * Q;
  return 3 * per + (route == 1 ? tc_scratch_floats(batch, H, G, L, Q, P, N) : 0);
}

// The slices of a group's heads the tensor-core route keeps partials for.
extern "C" int ssd_chunk_bwd_head_slices(int batch, int H, int G, int L, int Q, int N) {
  return head_slices(batch, H, G, L, Q, N);
}

extern "C" int ssd_chunk_bwd_launch(
    const void* x, const void* a, const void* B, const void* C, const void* dy,
    const void* dstates, const void* ddecay, void* dx, void* da, void* dB, void* dC,
    void* scratch, int dtype, int route, int batch, int H, int G, int L, int Q, int P, int N,
    long long xsb, long long xst, long long xsh, long long asb, long long ast,
    long long ash, long long bsb, long long bst, long long bsg, long long csb, long long cst,
    long long csg, long long dysb, long long dyst, long long dysh, long long dxsb,
    long long dxst, long long dxsh, long long dasb, long long dast, long long dash,
    long long dbsb, long long dbst, long long dbsh, long long dcsb, long long dcst,
    long long dcsh, void* stream) {
  if (G <= 0 || H % G || N % 4 || N < 4 || N > kBwdThreads || P < 1 || P > 128 || Q < 1 ||
      Q > 1024 || (route != 0 && route != 1) || (route == 1 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int nc = (L + Q - 1) / Q;
  const long long per = (long long)batch * H * nc * Q;
  float* s = static_cast<float*>(scratch);
  BwdArgs A{x, static_cast<const float*>(a), B, C, dy,
            static_cast<const float*>(dstates), static_cast<const float*>(ddecay), dx,
            static_cast<float*>(da), static_cast<float*>(dB), static_cast<float*>(dC),
            s, s + per, s + 2 * per, H, G, L, Q, P, N, nc, (P + 3) / 4 * 4,
            xsb, xst, xsh, asb, ast, ash, bsb, bst, bsg, csb, cst, csg, dysb, dyst, dysh,
            dxsb, dxst, dxsh, dasb, dast, dash, dbsb, dbst, dbsh, dcsb, dcst, dcsh};
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (route == 1) err = launch_tc(A, batch, s + 3 * per, st);
  else if (dtype == 0) err = launch_cc<float>(A, batch, st);
  else if (dtype == 1) err = launch_cc<__nv_bfloat16>(A, batch, st);
  else return (int)cudaErrorInvalidValue;
  return err ? err : launch_da(A, batch, st);
}
