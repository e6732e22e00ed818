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
// its 0.84-1.9 GFLOP take at most 0.0019 ms at the bf16 tensor-core peak.
//
// Design: the TPU kept a (Q, Q) score matrix and the whole chunk in VMEM;
// a block here has 227 KB of shared memory, so the chunk is cut into tiles
// and spread over more blocks. Grid (Q / 64 + 1, chunks, batch * heads):
// blocks 0 .. Q/64 - 1 each compute 64 rows of y_diag, looping over the
// 32-row key tiles at or below their diagonal (tiles above it are never
// loaded); the last block of each chunk computes the (P, N) state and
// out_decay. Every block rebuilds cs with one warp scan. Products run in
// fp32 on the CUDA cores from tiles staged in shared memory as fp32;
// exp(cs_i - cs_j) is evaluated only where i >= j and selected, never
// multiplied by a mask, so no inf * 0 arises. Each head reads its group
// h / (H / G) of B and C: the per-head broadcast is never materialised.
// Positions at or past L (a ragged last chunk) are staged as a = 0, x = 0,
// B = 0, C = 0, which is the JAX model's zero padding, and their y rows are
// not written. Element strides are taken for every operand, so the model's
// (b, l, h, p) layout launches without a transposing copy. wgmma tiles fed
// by TMA are the later step toward the bound.
#include "attention_common.cuh"

namespace {

using namespace repro;

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

  // cs = cumsum(a) over the chunk (a = 0 past `valid`): the block loads a,
  // each lane of warp 0 sums one contiguous segment, then a warp scan adds
  // the segments before.
  for (int i = threadIdx.x; i < Q; i += blockDim.x)
    cs[i] = i < valid ? ab[i * args.ast] : 0.f;
  __syncthreads();
  if (warp == 0) {
    const int seg = (Q + 31) / 32;
    const int lo = min(lane * seg, Q);
    const int hi = min(lo + seg, Q);
    float run = 0.f;
    for (int i = lo; i < hi; ++i) {
      run += cs[i];
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
int launch(const SsdArgs& args, int batch, cudaStream_t stream) {
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

}  // namespace

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16; a is float32.
// Element strides in the order x (b, t, h), a (b, t, h), B (b, t, g),
// C (b, t, g), y (b, t, h); the last dim of x, B, C and y is contiguous.
// states is (batch, H, nc, P, N) and decay (batch, H, nc, Q), both
// contiguous fp32, with nc = ceil(L / Q). The wrapper checks that
// N % 4 == 0, N <= 256, P <= 128 and that each thread's share of a state
// column, ceil(P / (256 / N)), is at most 32.
extern "C" int ssd_chunk_launch(const void* x, const void* a, const void* B, const void* C,
                                void* y, void* states, void* decay, int dtype, int batch,
                                int H, int G, int L, int Q, int P, int N, long long xsb,
                                long long xst, long long xsh, long long asb, long long ast,
                                long long ash, long long bsb, long long bst, long long bsg,
                                long long csb, long long cst, long long csg, long long ysb,
                                long long yst, long long ysh, void* stream) {
  SsdArgs args{x, static_cast<const float*>(a), B, C, y, static_cast<float*>(states),
               static_cast<float*>(decay), H, G, L, Q, P, N, (L + Q - 1) / Q,
               xsb, xst, xsh, asb, ast, ash, bsb, bst, bsg, csb, cst, csg, ysb, yst, ysh};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(args, batch, st);
  if (dtype == 1) return launch<__nv_bfloat16>(args, batch, st);
  return (int)cudaErrorInvalidValue;
}
