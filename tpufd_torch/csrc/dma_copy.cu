// HBM -> HBM copy kernel behind the DMA-copy health probe
// (`dma-copy-gbps`, python -m tpufd_torch health --extended).
//
// Replaces: tpufd/health.py::_dma_copy_fn, the Pallas kernel that
// dma_copy_gbps drives. It copies a (rows, cols) bf16 array n times; each
// repeat splits the rows into `chunks` disjoint row blocks and runs one
// async DMA per block. n is a run-time scalar (SMEM there, a kernel
// argument here), so one binary serves every calibration length of the
// differential timer.
//
// What bounds it: bytes. One repeat reads the array once and writes it
// once and does no arithmetic. At the probe's shape (131072 x 1024 bf16,
// 256 MiB) that is 2 x 256 MiB per repeat; at the 3.35 TB/s of an H100
// SXM data sheet the least time is 0.160 ms per repeat.
//
// Design. Grid (blocks_per_chunk, chunks): blockIdx.y picks the chunk and
// the blocks of one chunk sweep it with 16-byte (uint4) loads and stores
// in a grid-stride loop, kUnroll vectors in flight per thread. The n
// repeats run inside the kernel.
//  - L2 residency: every repeat sweeps the whole chunk before a thread
//    comes back to an address, so the reuse distance is a full pass over
//    the array (hundreds of MiB against a 50 MB L2) and the repeats are
//    served from HBM, not from L2.
//  - The repeats are idempotent. No __restrict__, and a compiler memory
//    barrier ends each repeat, so the compiler cannot fold them into one.
//  - The repeats of different blocks are not ordered against each other
//    (the TPU kernel waits on every chunk's DMA before the next repeat).
//    The copy is idempotent, so the result is the same.
//  - A chunk whose base is not 16-byte aligned, or whose length is not a
//    whole number of vectors, is copied with a scalar head and tail around
//    the vector body. An input and output that are not aligned alike are
//    copied element by element.
// SM threads issue the loads here, where the TPU's DMA engines move the
// data without the vector unit. A TMA bulk-copy design (cp.async.bulk with
// an mbarrier) is the counterpart of that mechanism.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kElemsPerVec = 8;  // bf16 elements in one uint4
// Blocks per SM that fill its 2048 resident threads at kThreads each.
constexpr int kBlocksPerSm = 2048 / kThreads;

__global__ void __launch_bounds__(kThreads)
    dma_copy_kernel(const uint16_t* in, uint16_t* out,
                    long long chunk_elems, long long n) {
  const long long base = static_cast<long long>(blockIdx.y) * chunk_elems;
  const uint16_t* src = in + base;
  uint16_t* dst = out + base;

  // Scalar head: the elements before src's first 16-byte boundary, or the
  // whole chunk when src and dst are not aligned alike.
  const uintptr_t src_mis = reinterpret_cast<uintptr_t>(src) & 15;
  const uintptr_t dst_mis = reinterpret_cast<uintptr_t>(dst) & 15;
  long long head = static_cast<long long>(((16 - src_mis) & 15) / 2);
  if (src_mis != dst_mis || head > chunk_elems) head = chunk_elems;
  const long long vecs = (chunk_elems - head) / kElemsPerVec;
  const long long tail = head + vecs * kElemsPerVec;
  const uint4* vsrc = reinterpret_cast<const uint4*>(src + head);
  uint4* vdst = reinterpret_cast<uint4*>(dst + head);

  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;

  for (long long r = 0; r < n; ++r) {
    for (long long i = tid; i < head; i += stride) dst[i] = src[i];
    for (long long i = tail + tid; i < chunk_elems; i += stride) {
      dst[i] = src[i];
    }
    for (long long i = tid; i < vecs; i += stride * kUnroll) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = i + u * stride;
        if (j < vecs) v[u] = vsrc[j];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = i + u * stride;
        if (j < vecs) vdst[j] = v[u];
      }
    }
    asm volatile("" ::: "memory");
  }
}

}  // namespace

// Copies in -> out, a contiguous (rows, cols) bf16 array, n times in
// `chunks` row blocks, on `stream`. Returns the launch's cudaError_t
// (cudaGetLastError()); cudaErrorInvalidValue for a shape the kernel does
// not take. Does not synchronise.
extern "C" int tpufd_dma_copy(const void* in, void* out, long long rows,
                              long long cols, int chunks, long long n,
                              void* stream) {
  if (rows <= 0 || cols <= 0 || chunks <= 0 || chunks > 65535 || n <= 0 ||
      rows % chunks != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long chunk_elems = rows / chunks * cols;
  // Enough blocks to fill every SM, split over the chunks, and no more
  // than a chunk has work for.
  const long long per_step = static_cast<long long>(kThreads) * kUnroll;
  const long long needed =
      (chunk_elems / kElemsPerVec + per_step - 1) / per_step;
  long long per_chunk = static_cast<long long>(sms) * kBlocksPerSm / chunks;
  if (per_chunk > needed) per_chunk = needed;
  if (per_chunk < 1) per_chunk = 1;

  const dim3 grid(static_cast<unsigned>(per_chunk),
                  static_cast<unsigned>(chunks));
  dma_copy_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(in), static_cast<uint16_t*>(out),
      chunk_elems, n);
  return static_cast<int>(cudaGetLastError());
}
