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
// SXM data sheet the least time is about 0.160 ms per repeat.
//
// Design. The TPU kernel moves the data with DMA engines while its vector
// unit idles; the counterpart here is the Tensor Memory Accelerator's bulk
// copy (cp.async.bulk without a tensor map, so only the runtime API is
// linked), global -> shared -> global, and no SM thread loads or stores
// the 16-byte-aligned body.
//  - Residency. Grid (blocks_per_chunk, chunks), with blocks_per_chunk =
//    SMs x resident blocks per SM / chunks, the residency taken from the
//    occupancy API for this block size and shared memory, so the whole
//    grid is resident at once and every chunk's copies are in flight
//    together, as the TPU kernel starts every DMA before it waits. More
//    chunks than the grid holds (down to one row each) run in more than
//    one wave.
//  - Lanes. The body of a chunk is cut into tiles of kTileBytes (the last
//    may be shorter). Block x of the chunk owns tiles x, x + B, x + 2B,
//    ... (B blocks per chunk) in every repeat, and no other block touches
//    them, so the blocks of a chunk sweep it from front to back together.
//  - The pipeline. One thread per block issues every copy through a ring
//    of kStages stages in dynamic shared memory, one mbarrier per stage.
//    The block's m-th tile loads into stage m % kStages
//    (mbarrier::complete_tx); when its barrier's phase completes (the
//    parity flips on each wrap of the ring), a bulk store writes it out
//    (bulk_group), and the next tile loads into the stage whose store,
//    the (m - kStores)-th, wait_group.read kStores says has finished
//    reading shared memory. So kStages - kStores loads and up to kStores
//    stores are in flight at all times. A full wait_group 0 ends the
//    block, so it never exits before its stores land.
//  - The repeats. A block sweeps its lane n times; its tile count, and
//    with it the ring's parity, runs on across repeats, so the ring never
//    drains between them. An address is touched only by the block that
//    owns it, which comes back to it after moving its whole lane (about
//    2 MiB at the probe's shape), while the other resident blocks move
//    theirs: some 512 MiB of traffic against a 50 MB L2, so every repeat
//    is served from HBM. (A grid of more chunks than it holds at once
//    gives each block a small lane that can stay in L2; the probe uses 2.)
//  - Edges, in the same kernel. The bytes before a chunk's first 16-byte
//    boundary and a tail of fewer than 16 bytes are copied element by
//    element by the other threads of the chunk's first block. An input and
//    output that are not aligned alike modulo 16 are copied element by
//    element in full.
//  - Tile, stages and stores in flight are compile-time constants (the
//    macros below), chosen by measurement on the card with
//    `python -m tpufd_torch.tune_dma_copy`: 32 KiB x 6 stages, 1 store,
//    one block of 128 threads per SM (197 KB of shared memory). The
//    candidates lie within about 1% of each other; PERF.md keeps their
//    times.

#include <cuda_runtime.h>

#include <cstdint>

#ifndef TPUFD_DMA_TILE_KIB
#define TPUFD_DMA_TILE_KIB 32
#endif
#ifndef TPUFD_DMA_STAGES
#define TPUFD_DMA_STAGES 6
#endif
#ifndef TPUFD_DMA_STORES
#define TPUFD_DMA_STORES 1
#endif

namespace {

constexpr int kThreads = 128;  // warp 0 issues the copies, 1-3 the edges
constexpr int kEdgeThreads = kThreads - 32;
constexpr unsigned kTileBytes = TPUFD_DMA_TILE_KIB * 1024u;
constexpr int kStages = TPUFD_DMA_STAGES;
// Bulk stores a block may keep reading shared memory while it loads: the
// ring holds kStages - kStores loads in flight and kStores stores.
constexpr int kStores = TPUFD_DMA_STORES;
// The ring, one 8-byte mbarrier per stage, and slack to align the ring to
// 128 bytes.
constexpr int kSmemBytes = kStages * kTileBytes + kStages * 8 + 128;
// A wait on a tile that outlives this traps, so a pipeline fault ends the
// launch with an error instead of hanging the card.
constexpr unsigned long long kWaitLimitNs = 10000000000ull;

static_assert(kTileBytes % 128 == 0, "tiles keep the ring 128-byte aligned");
// A barrier phase counts at most 2^20 - 1 transaction bytes.
static_assert(kTileBytes < (1u << 20), "tile too large for one phase");
static_assert(kStores >= 1 && kStores < kStages,
              "the ring needs a stage to store from and one to load into");
static_assert(kSmemBytes <= 232448, "more than a block's shared memory");
static_assert(kEdgeThreads >= 14, "head and tail are at most 7 each");

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits until the phase of parity `parity` of the barrier at `bar` has
// completed.
__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  unsigned long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = global_ns();
    } else if (global_ns() - start > kWaitLimitNs) {
      __trap();
    }
  }
}

__device__ __forceinline__ void bulk_load(uint32_t stage, const char* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :
               : "r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :
      : "r"(stage), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(char* dst, uint32_t stage,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :
               : "l"(dst), "r"(stage), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
    dma_copy_kernel(const uint16_t* in, uint16_t* out, long long chunk_elems,
                    long long n) {
  const long long base = static_cast<long long>(blockIdx.y) * chunk_elems;
  const uint16_t* src = in + base;
  uint16_t* dst = out + base;

  if ((reinterpret_cast<uintptr_t>(in) & 15) !=
      (reinterpret_cast<uintptr_t>(out) & 15)) {
    // Not aligned alike: every thread of the chunk's blocks copies
    // elements; a compiler barrier ends each repeat, so none is folded.
    const long long tid =
        static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long r = 0; r < n; ++r) {
      for (long long i = tid; i < chunk_elems; i += stride) dst[i] = src[i];
      asm volatile("" ::: "memory");
    }
    return;
  }

  // The chunk's 16-byte-aligned body: after `head` elements, `body` bytes,
  // a multiple of 16.
  long long head = ((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) / 2;
  if (head > chunk_elems) head = chunk_elems;
  const long long body = ((chunk_elems - head) * 2) & ~15ll;

  if (threadIdx.x >= 32) {
    // Head and tail of this block's chunk, by its first block, once per
    // repeat. Volatile, so the repeats are not folded.
    const long long tail = head + body / 2;
    const long long e = threadIdx.x - 32;
    const long long i = e < head ? e : tail + (e - head);
    if (blockIdx.x != 0 || i >= chunk_elems) return;
    const volatile uint16_t* vsrc = src;
    volatile uint16_t* vdst = dst;
    for (long long r = 0; r < n; ++r) vdst[i] = vsrc[i];
    return;
  }
  if (threadIdx.x != 0) return;

  // This block's lane: tiles blockIdx.x + j * gridDim.x of the body, for
  // j < lane, swept n times.
  const long long tiles = (body + kTileBytes - 1) / kTileBytes;
  if (blockIdx.x >= tiles) return;
  const long long lane = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long long total = n * lane;
  const char* body_src = reinterpret_cast<const char*>(src + head);
  char* body_dst = reinterpret_cast<char*>(dst + head);
  // Byte offset in the body, and length, of the block's k-th tile.
  auto offset_of = [&](long long k) {
    return (blockIdx.x + (k % lane) * gridDim.x) * kTileBytes;
  };
  auto bytes_at = [&](long long offset) {
    return static_cast<uint32_t>(
        body - offset < kTileBytes ? body - offset : kTileBytes);
  };

  extern __shared__ unsigned char smem[];
  const uint32_t ring = (shared_address(smem) + 127) & ~127u;
  const uint32_t bars = ring + kStages * kTileBytes;
  for (int s = 0; s < kStages; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :
                 : "r"(bars + 8 * s)
                 : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");

  auto load = [&](long long k) {
    const int s = static_cast<int>(k % kStages);
    const long long offset = offset_of(k);
    bulk_load(ring + s * kTileBytes, body_src + offset, bytes_at(offset),
              bars + 8 * s);
  };

  long long loaded = 0;  // tiles this block has loaded, and stored
  for (; loaded < kStages - kStores && loaded < total; ++loaded) load(loaded);
  for (long long stored = 0; stored < total; ++stored) {
    const int s = static_cast<int>(stored % kStages);
    wait_phase(bars + 8 * s, static_cast<uint32_t>((stored / kStages) & 1));
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const long long offset = offset_of(stored);
    bulk_store(body_dst + offset, ring + s * kTileBytes, bytes_at(offset));
    if (loaded < total) {
      // The next load reuses the stage of the kStores-th store before this
      // one: wait until every store but the kStores newest has read
      // shared memory.
      asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kStores)
                   : "memory");
      load(loaded++);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

bool shape_ok(long long rows, long long cols, int chunks) {
  return rows > 0 && cols > 0 && chunks > 0 && chunks <= 65535 &&
         rows % chunks == 0;
}

// Blocks per chunk and resident blocks per SM for `chunks` on the current
// device. Sets the kernel's dynamic shared memory limit first, which the
// launch and the occupancy query both need.
cudaError_t plan_launch(int chunks, long long* blocks_per_chunk,
                        int* resident_per_sm) {
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dma_copy_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      resident_per_sm, dma_copy_kernel, kThreads, kSmemBytes);
  if (err != cudaSuccess) return err;
  if (*resident_per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long per = static_cast<long long>(sms) * *resident_per_sm /
                        chunks;
  *blocks_per_chunk = per < 1 ? 1 : per;
  return cudaSuccess;
}

}  // namespace

// Copies in -> out, a contiguous (rows, cols) bf16 array, n times in
// `chunks` row blocks, on `stream`. Returns the launch's cudaError_t
// (cudaGetLastError()); cudaErrorInvalidValue for a shape the kernel does
// not take. Does not synchronise.
extern "C" int tpufd_dma_copy(const void* in, void* out, long long rows,
                              long long cols, int chunks, long long n,
                              void* stream) {
  if (!shape_ok(rows, cols, chunks) || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long per_chunk = 0;
  int resident = 0;
  const cudaError_t err = plan_launch(chunks, &per_chunk, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(per_chunk),
                  static_cast<unsigned>(chunks));
  dma_copy_kernel<<<grid, kThreads, kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(in), static_cast<uint16_t*>(out),
      rows / chunks * cols, n);
  return static_cast<int>(cudaGetLastError());
}

// The launch tpufd_dma_copy makes for this shape on the current device, as
// plan[0..5]: threads per block, blocks per chunk, resident blocks per SM,
// tile bytes, stages, and dynamic shared memory bytes per block. Returns a
// cudaError_t as tpufd_dma_copy does.
extern "C" int tpufd_dma_copy_plan(long long rows, long long cols,
                                   int chunks, long long* plan) {
  if (!shape_ok(rows, cols, chunks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long per_chunk = 0;
  int resident = 0;
  const cudaError_t err = plan_launch(chunks, &per_chunk, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = kThreads;
  plan[1] = per_chunk;
  plan[2] = resident;
  plan[3] = kTileBytes;
  plan[4] = kStages;
  plan[5] = kSmemBytes;
  return static_cast<int>(cudaSuccess);
}
