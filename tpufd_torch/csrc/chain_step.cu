// One step of the matmul chain behind the matmul health probe
// (`matmul-tflops`, python -m tpufd_torch health), as one kernel:
//
//   out = bf16(0.5f * (tanhf(float(bf16(x @ x))) + float(x)))
//
// for a square, row-major bf16 x of size n, n a multiple of 8, out a
// second buffer of the same shape. The product is accumulated in float32
// and rounded to bf16 (that is p, as the configuration stores it); the
// tail is computed in float32 with the accurate tanhf and rounded once,
// round-to-nearest-even, as csrc/chain_tail.cu does. Only the order in
// which the product is summed differs from cuBLAS's.
//
// Replaces: no Pallas kernel. It is the counterpart of XLA's fusion of the
// chain body `jnp.tanh(acc @ acc) * 0.5 + acc * 0.5` (tpufd/health.py:188,
// the body of _matmul_chain), where the tail never leaves the product.
// Before it the port ran each step as three operations: cuBLAS's memset,
// cuBLAS's GEMM writing p (32 MiB at 4096^2) and the chain-tail kernel
// reading p and x back and writing x.
//
// What bounds it: operations. 2 * 4096^3 per step at the 989 TFLOP/s bf16
// of an H100 SXM data sheet is 0.139 ms; the bytes (x read, out written,
// 64 MiB) take 0.020 ms at 3350 GB/s.
//
// Design. Persistent: one block per SM (384 threads), in clusters of two
// along M, each cluster walking output tiles of 256 x 256, each block the
// 128 x 256 half of it. Warpgroups:
//   0, 1  consumers: each a 64 x 256 slab with wgmma m64n256k16 (float32
//         accumulators in 128 registers a thread, A K-major and B
//         MN-major, both from shared memory under the 128-byte swizzle),
//         then the slab rounded to bf16 into a shared buffer p;
//   2     warp 8: the TMA producer (one thread): a ring of kStages stages
//         of A (128 x 64, the block's own) and B (64 x 256, shared by the
//         cluster: each block loads two of the four 64-column chunks and
//         multicasts them to both blocks, so the L2 serves each B tile
//         once per cluster);
//         warps 9-11: the epilogue. They read p from shared memory and x
//         from global memory in 16-byte vectors, compute the tail and
//         store out, while the consumers run the next tile's main loop.
// A stage is released to the producers of both blocks once both blocks'
// consumers are done with it (the empty barrier counts four arrivals).
// The last tile of a block has no main loop to hide behind: all twelve
// warps run its epilogue, with more loads in flight. Each launch may start
// while the previous step ends (programmatic dependent launch) and waits
// for it before it touches memory.
// The edges: TMA fills what lies past n with zeros, and the epilogue
// writes only rows and 8-column groups inside n.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;  // rows of a block's tile
constexpr int kBN = 256;  // columns of a tile
constexpr int kBK = 64;   // depth of a stage: one 128-byte swizzle row
constexpr int kCluster = 2;
constexpr int kStages = 3;  // 3 x 48 KiB and p (66 KiB): 211 KiB of 227
constexpr int kThreads = 384;
constexpr int kConsumerThreads = 256;
constexpr int kEpilogueWarps = 3;       // warps 9, 10, 11
constexpr int kGroupRows = 8;           // tile rows walked together
// A block's last tile: its epilogue rows below this are the consumers'
// (12 a warp), the rest the producer warpgroup's (8 a warp).
constexpr int kLastConsumerRows = 96;
constexpr int kChunk = 64;              // B columns per TMA box (128 bytes)
constexpr uint32_t kAStage = kBM * kBK * 2;       // 16 KiB
constexpr uint32_t kBChunk = kBK * kChunk * 2;    // 8 KiB
constexpr uint32_t kBStage = kBN * kBK * 2;       // 32 KiB
constexpr uint32_t kStageBytes = kAStage + kBStage;
constexpr uint32_t kPStride = kBN * 2 + 16;  // padded: no bank conflicts
constexpr uint32_t kBOffset = kStages * kAStage;
constexpr uint32_t kPOffset = kBOffset + kStages * kBStage;
constexpr uint32_t kBarOffset = kPOffset + kBM * kPStride;
constexpr uint32_t kSmemBytes = kBarOffset + 8 * (2 * kStages + 2) + 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Arrives on the barrier at the same shared offset in block `cta` of the
// cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The cluster barrier for threads that may arrive apart within a warp.
__device__ __forceinline__ void cluster_sync_divergent() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The same box into the same shared offset of every block in `mask`,
// completing on each one's barrier at `bar`'s offset.
__device__ __forceinline__ void tma_load_multicast(const CUtensorMap* map,
                                                   uint32_t dst, uint32_t bar,
                                                   uint16_t mask, int c0,
                                                   int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(c0),
      "r"(c1)
      : "memory");
}

// A wgmma shared-memory descriptor under the 128-byte swizzle; offsets in
// bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma's fences and waits.
__device__ __forceinline__ void fence_accumulators(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A (64 x 16, K-major) * B (16 x 256, MN-major), bf16 in, float32
// accumulate; d is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The tail of two elements packed as bf16 pairs, each as
// csrc/chain_tail.cu computes it: float32, the accurate tanhf, one
// rounding to nearest even.
__device__ __forceinline__ uint32_t tail_pair(uint32_t p, uint32_t a) {
  const float lo = 0.5f * (tanhf(__uint_as_float(p << 16)) +
                           __uint_as_float(a << 16));
  const float hi = 0.5f * (tanhf(__uint_as_float(p & 0xffff0000u)) +
                           __uint_as_float(a & 0xffff0000u));
  return pack_bf16(lo, hi);
}

__device__ __forceinline__ uint4 tail_vector(uint4 p, uint4 a) {
  return make_uint4(tail_pair(p.x, a.x), tail_pair(p.y, a.y),
                    tail_pair(p.z, a.z), tail_pair(p.w, a.w));
}

// One warp's share of a tile's epilogue: rows first, first + step, ...
// below `end` of the block's tile, each as 32 lanes x 8 columns, kDepth
// rows at a time so that kDepth loads of x are in flight together.
template <int kDepth>
__device__ __forceinline__ void epilogue_rows(const uint8_t* pbuf,
                                              const uint16_t* __restrict__ x,
                                              uint16_t* __restrict__ out,
                                              int n, int m0, int n0,
                                              int first, int step,
                                              int end) {
  const int lane = threadIdx.x % 32;
  const int col = n0 + lane * 8;
  if (col >= n) return;
  const int rows = min(end, n - m0);
#pragma unroll 1
  for (int r = first; r < rows; r += kDepth * step) {
    uint4 a[kDepth];
#pragma unroll
    for (int i = 0; i < kDepth; ++i) {
      const int row = r + i * step;
      if (row < rows) {
        a[i] = __ldg(reinterpret_cast<const uint4*>(
            x + static_cast<size_t>(m0 + row) * n + col));
      }
    }
#pragma unroll
    for (int i = 0; i < kDepth; ++i) {
      const int row = r + i * step;
      if (row < rows) {
        const uint4 p = *reinterpret_cast<const uint4*>(
            pbuf + row * kPStride + lane * 16);
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(m0 + row) * n +
                                  col) = tail_vector(p, a[i]);
      }
    }
  }
}

// Where cluster tile t of `tiles` lies: the rows m0 of this block's half
// and the columns n0. Tiles go in groups of kGroupRows tile rows, column by
// column inside a group, so that the tiles in flight at once read a few
// row and column panels of x again and again from the L2.
__device__ __forceinline__ void tile_origin(int t, int tiles, int tiles_n,
                                            uint32_t rank, int& m0, int& n0) {
  const int tiles_m = tiles / tiles_n;
  const int group = t / (kGroupRows * tiles_n);
  const int rows = min(kGroupRows, tiles_m - group * kGroupRows);
  const int in = t - group * kGroupRows * tiles_n;
  m0 = (group * kGroupRows + in % rows) * kBM * kCluster + rank * kBM;
  n0 = (in / rows) * kBN;
}

__global__ void __launch_bounds__(kThreads, 1)
    chain_step_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      const uint16_t* __restrict__ x,
                      uint16_t* __restrict__ out, int n, int tiles_n,
                      int tiles) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // 1024-byte alignment for the swizzle; the same offset in both blocks.
  uint8_t* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t a_stages = base;
  const uint32_t b_stages = base + kBOffset;
  uint8_t* pbuf = smem + kPOffset;
  const uint32_t bars = base + kBarOffset;
  const uint32_t full0 = bars;                    // + 8 * stage
  const uint32_t empty0 = bars + 8 * kStages;     // + 8 * stage
  const uint32_t p_full = bars + 16 * kStages;
  const uint32_t p_empty = p_full + 8;

  const int warp = threadIdx.x / 32;
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  const int cluster = blockIdx.x / kCluster;
  const int clusters = gridDim.x / kCluster;
  const int kblocks = (n + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2 * kCluster);  // 2 consumer warpgroups
    }
    mbar_init(p_full, kConsumerThreads);
    mbar_init(p_empty, kEpilogueWarps * 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(&map_a))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(&map_b))
                 : "memory");
  }
  cluster_sync_all();
  // Launched behind the previous step (programmatic dependent launch): it
  // may start once every block of that step has begun, and waits here
  // until that step has finished and its writes are visible, so the set-up
  // above overlaps the previous step's end.
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  asm volatile("griddepcontrol.wait;" ::: "memory");

  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;");
    if (warp == 8) {
      if (threadIdx.x % 32 == 0) {
        // The producer: one thread keeps the ring full.
        int stage = 0;
        uint32_t phase = 0;
        for (int t = cluster; t < tiles; t += clusters) {
          int m0, n0;
          tile_origin(t, tiles, tiles_n, rank, m0, n0);
          for (int kb = 0; kb < kblocks; ++kb) {
            const uint32_t full = full0 + 8 * stage;
            mbar_wait(empty0 + 8 * stage, phase ^ 1);
            mbar_expect_tx(full, kStageBytes);
            tma_load(&map_a, a_stages + stage * kAStage, full, kb * kBK, m0);
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int chunk = 2 * rank + c;
              tma_load_multicast(&map_b,
                                 b_stages + stage * kBStage + chunk * kBChunk,
                                 full, (1 << kCluster) - 1,
                                 n0 + chunk * kChunk, kb * kBK);
            }
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
      __syncwarp();
    } else {
      // The epilogue warps: each tile's p but the last as the consumers
      // leave it.
      uint32_t phase = 0;
      for (int t = cluster; t + clusters < tiles; t += clusters) {
        int m0, n0;
        tile_origin(t, tiles, tiles_n, rank, m0, n0);
        mbar_wait(p_full, phase);
        epilogue_rows<4>(pbuf, x, out, n, m0, n0, warp - 9, kEpilogueWarps,
                         kBM);
        mbar_arrive(p_empty);
        phase ^= 1;
      }
    }
    // The last tile has no main loop to hide behind: all twelve warps run
    // its epilogue, these four its last rows.
    if (cluster < tiles) {
      const int before = (tiles - 1 - cluster) / clusters;
      int m0, n0;
      tile_origin(cluster + before * clusters, tiles, tiles_n, rank, m0, n0);
      mbar_wait(p_full, before & 1);
      epilogue_rows<4>(pbuf, x, out, n, m0, n0, kLastConsumerRows + warp - 8,
                       4, kBM);
    }
    cluster_sync_divergent();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;");
    const int wg = warp / 4;  // 0 or 1: rows 64 * wg of the block's tile
    const bool signals = threadIdx.x % 128 == 0;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.0f;
    int stage = 0;
    uint32_t phase = 0;
    uint32_t p_phase = 0;
    for (int t = cluster; t < tiles; t += clusters) {
      int m0, n0;
      tile_origin(t, tiles, tiles_n, rank, m0, n0);
      int held = -1;  // the stage whose wgmmas may still be reading
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint64_t da =
            smem_desc(a_stages + stage * kAStage + wg * (kAStage / 2), 16,
                      1024);
        const uint64_t db =
            smem_desc(b_stages + stage * kBStage, kBChunk, 1024);
        fence_accumulators(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // A steps 32 bytes along its swizzled rows, B two 8-row groups.
          wgmma_m64n256k16(d, da + 2 * kk, db + 128 * kk, (kb | kk) != 0);
        }
        wgmma_commit();
        fence_accumulators(d);
        if (held >= 0) {
          wgmma_wait<1>();
          fence_accumulators(d);
          if (signals) {
            mbar_arrive_cluster(empty0 + 8 * held, 0);
            mbar_arrive_cluster(empty0 + 8 * held, 1);
          }
        }
        held = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_accumulators(d);
      if (signals) {
        mbar_arrive_cluster(empty0 + 8 * held, 0);
        mbar_arrive_cluster(empty0 + 8 * held, 1);
      }
      // The slab, rounded to bf16, into p once the epilogue has read the
      // previous tile's.
      mbar_wait(p_empty, p_phase ^ 1);
      const int lane = threadIdx.x % 32;
      uint8_t* row = pbuf + (wg * 64 + (warp % 4) * 16 + lane / 4) * kPStride +
                     (lane % 4) * 4;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        *reinterpret_cast<uint32_t*>(row + j * 16) =
            pack_bf16(d[4 * j], d[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(row + 8 * kPStride + j * 16) =
            pack_bf16(d[4 * j + 2], d[4 * j + 3]);
      }
      mbar_arrive(p_full);
      if (t + clusters >= tiles) {
        // The last tile: its first rows, all of a warp's loads in flight.
        mbar_wait(p_full, p_phase);
        epilogue_rows<12>(pbuf, x, out, n, m0, n0, warp, 8,
                          kLastConsumerRows);
        break;
      }
      p_phase ^= 1;
    }
    cluster_sync_divergent();
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the CUDA runtime has
// loaded into the process, so that the library links against nothing
// beyond the runtime.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* cuda = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (cuda == nullptr) cuda = dlopen("libcuda.so.1", RTLD_NOW);
    if (cuda != nullptr) {
      fn = reinterpret_cast<EncodeTiled>(
          dlsym(cuda, "cuTensorMapEncodeTiled"));
    }
  }
  return fn;
}

// A tiled map over the row-major n x n bf16 array at `base`, boxes of
// `box_rows` rows x 64 columns, 128-byte swizzle, zeros past the edges.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, long long n,
            uint32_t box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n) * 2};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t element_strides[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, element_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

// Clusters the card holds at once, asked once per device (0: not yet).
int resident_clusters(int device) {
  static int clusters[kMaxDevices] = {};
  if (clusters[device] > 0) return clusters[device];
  cudaError_t err = cudaFuncSetAttribute(
      chain_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = kCluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.gridDim = dim3(kCluster, 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = kSmemBytes;
  config.attrs = attribute;
  config.numAttrs = 1;
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, chain_step_kernel, &config);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (count < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  clusters[device] = count;
  return count;
}

}  // namespace

// out = bf16(0.5 * (tanh(bf16(x @ x)) + x)) for a row-major n x n bf16 x,
// n >= 8 a multiple of 8, x and out 16-byte aligned and apart, on
// `stream`. Returns the launch's cudaError_t (cudaGetLastError());
// cudaErrorInvalidValue for arguments it does not take. Does not
// synchronise.
extern "C" int tpufd_chain_step(const void* x, void* out, long long n,
                                void* stream) {
  if (n < 8 || n % 8 != 0 || n > (1 << 20) || x == out ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
       15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const int clusters = resident_clusters(device);
  if (clusters < 0) return -clusters;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map_a, map_b;
  if (!encode(fn, &map_a, x, n, kBM) || !encode(fn, &map_b, x, n, kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_m = static_cast<int>((n + kBM * kCluster - 1) /
                                       (kBM * kCluster));
  const int tiles_n = static_cast<int>((n + kBN - 1) / kBN);
  const int tiles = tiles_m * tiles_n;
  const int grid = kCluster * (tiles < clusters ? tiles : clusters);

  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attribute[2];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = kCluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  attribute[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute[1].val.programmaticStreamSerializationAllowed = 1;
  config.gridDim = dim3(grid, 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = kSmemBytes;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attribute;
  config.numAttrs = 2;
  err = cudaLaunchKernelEx(&config, chain_step_kernel, map_a, map_b,
                           static_cast<const uint16_t*>(x),
                           static_cast<uint16_t*>(out), static_cast<int>(n),
                           tiles_n, tiles);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
