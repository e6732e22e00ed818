// K1 relay_assemble: the permutation gather that puts landed multipath
// chunks back into logical order, out[i] = staged[perm[i]].
//
// Replaces: src/repro/kernels/relay_copy/relay_copy.py:relay_assemble
// (Pallas, scalar-prefetched perm driving the input BlockSpec).
//
// Bound on the H100: bytes. Every byte of the slab is read once and written
// once, so the least time is 2 * bytes / 3.35 TB/s (a 507 MB bf16 weight
// leaf: about 0.30 ms).
//
// Design: grid (n_chunks, blocks per row). Each block reads its row's
// source index perm[blockIdx.x] itself (the TPU's scalar prefetch has no
// counterpart; one cached load per block is enough) and copies its share
// of the row in 16-byte vectors, neighbouring threads on neighbouring
// addresses, with a scalar tail when the row is not a multiple of 16 bytes
// or not 16-byte aligned. It works on bytes, so one kernel serves every
// dtype bit-exactly. Several blocks per row keep enough loads in flight to
// approach the memory rate; a TMA bulk copy is a later refinement.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void relay_assemble_kernel(const unsigned char* __restrict__ staged,
                                      const int* __restrict__ perm,
                                      unsigned char* __restrict__ out,
                                      long long row_bytes) {
  const long long row = blockIdx.x;
  const long long src_row = perm[row];
  const unsigned char* src = staged + src_row * row_bytes;
  unsigned char* dst = out + row * row_bytes;
  const long long tid = (long long)blockIdx.y * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.y * blockDim.x;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const long long nvec = row_bytes >> 4;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (long long i = tid; i < nvec; i += stride) d4[i] = s4[i];
    done = nvec << 4;
  }
  for (long long i = done + tid; i < row_bytes; i += stride) dst[i] = src[i];
}

}  // namespace

extern "C" int relay_assemble_launch(const void* staged, const void* perm, void* out,
                                     long long n_chunks, long long row_bytes,
                                     void* stream) {
  const int threads = 256;
  const long long nvec = (row_bytes + 15) / 16;
  long long per_row = (nvec + threads * 4 - 1) / (threads * 4);  // ~4 vectors a thread
  if (per_row < 1) per_row = 1;
  if (per_row > 65535) per_row = 65535;
  dim3 grid((unsigned)n_chunks, (unsigned)per_row);
  relay_assemble_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)staged, (const int*)perm, (unsigned char*)out, row_bytes);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
