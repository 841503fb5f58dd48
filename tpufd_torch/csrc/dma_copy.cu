// HBM -> HBM copy kernel behind the DMA-copy health probe
// (`dma-copy-gbps`, python -m tpufd_torch health --extended).
//
// Replaces: tpufd/health.py::_dma_copy_fn, the Pallas kernel that
// dma_copy_gbps drives. It copies a (rows, cols) bf16 array n times; each
// repeat splits the rows into `chunks` disjoint row blocks and starts one
// async DMA per block before it waits on any. n is a run-time scalar (SMEM
// there, a kernel argument here), so one binary serves every calibration
// length of the differential timer.
//
// What bounds it: bytes. One repeat reads the array once and writes it
// once and does no arithmetic. At the probe's shape (131072 x 1024 bf16,
// 256 MiB) that is 2 x 256 MiB per repeat; at the 3350 GB/s of an H100
// SXM data sheet the least time is about 0.1603 ms per repeat.
//
// Design. The bytes go through registers in 16-byte vectors, and the
// grid sweeps the array in order. An earlier design moved them with the
// Tensor Memory Accelerator's bulk copy (one issuing thread per block,
// global -> shared -> global through a ring of 32 KiB stages under
// mbarriers, the counterpart of the TPU's DMA engines), each resident
// block owning a fixed lane of tiles. Its twelve variants of tile, stages,
// stores in flight and blocks per SM all sat within about 1% of each other
// at 87% of the bound, behind the card's own copy_. The same resident
// lanes moved through registers sat on the same plateau, whatever the
// loads in flight and threads per block: left to themselves the lanes
// drift apart and spread the traffic over the whole array. A grid whose
// blocks the hardware starts in order keeps it in one narrow front, and
// passes copy_ (PERF.md keeps the measurements).
//  - The grid. Block (x, y, z) copies one sweep of kThreads 16-byte
//    vectors, one a thread: sweep x / chunks of chunk x % chunks, in repeat
//    y + z * 65535 (grid y and z hold n). Blocks start in the order of
//    their index, so each repeat sweeps every chunk from front to back,
//    the chunks together (as the TPU kernel starts every chunk's DMA
//    before it waits), and the next repeat starts only behind it.
//  - Loads in flight. Thread t of a sweep loads vector t (neighbouring
//    threads on neighbouring addresses) and stores it. The SM holds as
//    many blocks as its registers and threads allow, 2048 threads: 32 KiB
//    in flight, above the ~20 KiB an SM that Little's law asks of DRAM's
//    latency at 3.35 TB/s. One vector a thread and 256 threads a block won
//    on the card against more vectors a thread and other block sizes
//    (PERF.md keeps the times).
//  - Cache hints. Loads and stores are streaming (.cs, evict-first in L1
//    and L2): no byte is used twice within a repeat.
//  - Every repeat from HBM. An address comes back only in the next
//    repeat, after the whole array's 2 x 256 MiB of traffic (at the
//    probe's shape) against a 50 MB L2. (Sweeping back and forth would
//    serve each turnaround from L2.) A block copies its sweep once and
//    exits, so there is no loop of repeats for the compiler to fold.
//  - Edges, in the same kernel. The bytes before a chunk's first 16-byte
//    boundary and a tail of fewer than 16 bytes are copied element by
//    element, once a repeat, by threads of the chunk's first sweep. An
//    input and output that are not aligned alike modulo 16 are copied
//    element by element in full (the wrapper counts such launches).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // a block's threads: one 16-byte vector each
constexpr long long kMaxGridX = 2147483647;  // a grid's x extent
constexpr long long kMaxGridYZ = 65535;      // its y and z extents

static_assert(kThreads % 32 == 0 && kThreads <= 1024,
              "whole warps, at most a block's 1024 threads");
static_assert(kThreads >= 14, "head and tail are at most 7 elements each");

// Sweeps a chunk of `chunk_elems` elements takes, counted as if its body
// were all of it: an aligned body is shorter by its head and tail.
__host__ __device__ __forceinline__ long long sweeps_of(long long chunk_elems) {
  return (chunk_elems + kThreads * 8 - 1) / (kThreads * 8);
}

__device__ __forceinline__ uint4 load_streaming(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.cs.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void store_streaming(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
               :
               : "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w));
}

__global__ void __launch_bounds__(kThreads)
    dma_copy_kernel(const uint16_t* in, uint16_t* out, long long chunk_elems,
                    long long n) {
  // Block (x, y, z) copies sweep x / chunks of chunk x % chunks in repeat
  // y + z * gridDim.y.
  const long long repeat =
      blockIdx.y + static_cast<long long>(blockIdx.z) * gridDim.y;
  if (repeat >= n) return;
  const long long chunks = gridDim.x / sweeps_of(chunk_elems);
  const long long sweep = blockIdx.x / chunks;
  const long long base = (blockIdx.x % chunks) * chunk_elems;
  const uint16_t* src = in + base;
  uint16_t* dst = out + base;

  if ((reinterpret_cast<uintptr_t>(in) & 15) !=
      (reinterpret_cast<uintptr_t>(out) & 15)) {
    // Not aligned alike: the sweep's elements one by one, 8 a thread,
    // neighbouring threads on neighbouring elements.
    const long long first = sweep * kThreads * 8 + threadIdx.x;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const long long i = first + static_cast<long long>(k) * kThreads;
      if (i < chunk_elems) dst[i] = src[i];
    }
    return;
  }

  // The chunk's 16-byte-aligned body: after `head` elements, `vecs`
  // vectors of 8 elements, then the tail's fewer than 8.
  long long head = ((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) / 2;
  if (head > chunk_elems) head = chunk_elems;
  const long long vecs = (chunk_elems - head) / 8;
  if (sweep == 0) {
    // The head's elements, then the tail's, by the chunk's first sweep.
    const long long e = threadIdx.x;
    const long long i = e < head ? e : head + vecs * 8 + (e - head);
    if (i < chunk_elems) dst[i] = src[i];
  }

  const long long v = sweep * kThreads + threadIdx.x;
  if (v < vecs) {
    const uint4 data =
        load_streaming(reinterpret_cast<const uint4*>(src + head) + v);
    store_streaming(reinterpret_cast<uint4*>(dst + head) + v, data);
  }
}

bool shape_ok(long long rows, long long cols, int chunks) {
  return rows > 0 && cols > 0 && chunks > 0 && chunks <= 65535 &&
         rows % chunks == 0 &&
         sweeps_of(rows / chunks * cols) <= kMaxGridX / chunks;
}

}  // namespace

// Copies in -> out, a contiguous (rows, cols) bf16 array, n times in
// `chunks` row blocks, on `stream`. Returns the launch's cudaError_t
// (cudaGetLastError()); cudaErrorInvalidValue for a shape or an n the
// kernel does not take (n up to 65535^2). Does not synchronise.
extern "C" int tpufd_dma_copy(const void* in, void* out, long long rows,
                              long long cols, int chunks, long long n,
                              void* stream) {
  if (!shape_ok(rows, cols, chunks) || n <= 0 ||
      n > kMaxGridYZ * kMaxGridYZ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long ny = n < kMaxGridYZ ? n : kMaxGridYZ;
  const dim3 grid(
      static_cast<unsigned>(chunks * sweeps_of(rows / chunks * cols)),
      static_cast<unsigned>(ny), static_cast<unsigned>((n + ny - 1) / ny));
  dma_copy_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(in), static_cast<uint16_t*>(out),
      rows / chunks * cols, n);
  return static_cast<int>(cudaGetLastError());
}

// The launch tpufd_dma_copy makes for this shape on the current device, as
// plan[0..3]: threads per block, blocks (sweeps) per chunk and repeat,
// resident blocks per SM, and bytes per block sweep. Returns a cudaError_t
// as tpufd_dma_copy does.
extern "C" int tpufd_dma_copy_plan(long long rows, long long cols,
                                   int chunks, long long* plan) {
  if (!shape_ok(rows, cols, chunks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int resident = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, dma_copy_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = kThreads;
  plan[1] = sweeps_of(rows / chunks * cols);
  plan[2] = resident;
  plan[3] = kThreads * 16;
  return static_cast<int>(cudaSuccess);
}
