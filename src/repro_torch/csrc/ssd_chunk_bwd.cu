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
// Bound on the H100: operations. At Mamba2-370m's train shape (8 x 512
// tokens, 32 heads of 64, one group of N = 128, Q = 256) the gradient reads
// x, a, B, C, dy, dstates and ddecay and writes dx, da, dB and dC, about 75
// MB, 0.022 ms at 3.35 TB/s; its five Q x Q products over the causal half
// (S and dM again, then dx, dB, dC) are about 18 GFLOP, 0.26 ms at the
// 67 TFLOP/s fp32 peak of the CUDA cores.
//
// Design: fp32 on the CUDA cores from the loaded values, for bf16 and fp32
// inputs alike (a simple kernel first; the four products would go to the
// tensor cores in a later design). Tiles are staged in shared memory as
// fp32, a warp a row at a time with all of a row's loads in flight (no
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
// Every sum runs in a fixed order (no atomics), so the same inputs give the
// same bits on every call. Each head writes its own dB and dC as fp32
// partials; the wrapper sums a group's heads.
//
// Each head reads its group h / (H / G) of B and C; positions at or past L
// (a ragged last chunk) count as a = 0, x = 0, B = 0, C = 0, dy = 0, the
// JAX model's zero padding: their dx, da, dB and dC rows are not written,
// but their ddecay still reaches da through the reverse cumsum. Element
// strides are taken for x, a, B, C, dy and the outputs, so the model's
// (b, l, h, p) layout launches without a copy.
#include <algorithm>

#include "attention_common.cuh"
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
int launch_bwd(const BwdArgs& A, int batch, cudaStream_t stream) {
  const BwdSmem m = bwd_smem(A.Q, A.P, A.P4, A.N);
  const size_t smem = sizeof(float) * (size_t)m.total;
  auto kernel = A.N <= 128 && A.P <= 64 ? ssd_chunk_bwd_kernel<T, 16, 8>
                                        : ssd_chunk_bwd_kernel<T, 32, 16>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (A.Q + kT - 1) / kT;
  kernel<<<dim3(2 * n_tiles, A.nc, batch * A.H), kBwdThreads, smem, stream>>>(A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_bwd_da_kernel<<<dim3(A.nc, batch * A.H), 32, 2 * sizeof(float) * A.Q, stream>>>(A);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0 = float32 or 1 = bfloat16 for x, B, C, dy and dx; a, dstates,
// ddecay, da and the per-head partials dB and dC (batch, L, H, N) are
// float32. Element strides (b, t, h or g) in the order x, a, B, C, dy, dx,
// da, dB, dC; the last dim of x, B, C, dy, dx, dB and dC is contiguous.
// dstates is (batch, H, nc, P, N) and ddecay (batch, H, nc, Q), both
// contiguous, nc = ceil(L / Q). scratch holds 3 * batch * H * nc * Q
// floats. Takes N % 4 == 0, 4 <= N <= 256, 1 <= P <= 128 and 1 <= Q <=
// 1024; anything else returns cudaErrorInvalidValue.
extern "C" int ssd_chunk_bwd_launch(
    const void* x, const void* a, const void* B, const void* C, const void* dy,
    const void* dstates, const void* ddecay, void* dx, void* da, void* dB, void* dC,
    void* scratch, int dtype, int batch, int H, int G, int L, int Q, int P, int N,
    long long xsb, long long xst, long long xsh, long long asb, long long ast, long long ash,
    long long bsb, long long bst, long long bsg, long long csb, long long cst, long long csg,
    long long dysb, long long dyst, long long dysh, long long dxsb, long long dxst,
    long long dxsh, long long dasb, long long dast, long long dash, long long dbsb,
    long long dbst, long long dbsh, long long dcsb, long long dcst, long long dcsh,
    void* stream) {
  if (G <= 0 || H % G || N % 4 || N < 4 || N > kBwdThreads || P < 1 || P > 128 || Q < 1 ||
      Q > 1024)
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
  if (dtype == 0) return launch_bwd<float>(A, batch, st);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(A, batch, st);
  return (int)cudaErrorInvalidValue;
}
