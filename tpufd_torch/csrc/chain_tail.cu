// Elementwise tail of one matmul-chain step behind the matmul health
// probe (`matmul-tflops`, python -m tpufd_torch health):
//
//   acc = bf16(0.5f * (tanhf(float(p)) + float(acc)))   in place,
//
// where p is the bf16 product acc @ acc. One rounding per element.
//
// Replaces: no Pallas kernel. It is the counterpart of XLA's fusion of the
// chain body `jnp.tanh(acc @ acc) * 0.5 + acc * 0.5`
// (tpufd/health.py::_matmul_chain), whose elementwise tail XLA runs as one
// pass. Eager PyTorch ran it as three (tanh, add_, mul_), each a full
// read and write of the 4096 x 4096 bf16 array, so the probe measured
// about 224 MiB of elementwise traffic per step beside the GEMM where the
// reference measures one pass.
//
// What bounds it: bytes. Per element it reads p and acc and writes acc:
// 6 bytes, 96 MiB per step at the probe's shape, about 0.030 ms at the
// 3350 GB/s of an H100 SXM data sheet. tanhf costs a few tens of
// instructions an element, well under that time on 132 SMs.
//
// Design. A grid-stride loop of 16-byte vectors (8 bf16 of p, 8 of acc)
// when p and acc are aligned alike modulo 16: the elements before acc's
// first 16-byte boundary and a tail of fewer than 8 go one by one. When
// they are aligned unlike, every element goes one by one. The grid covers
// the card's SMs a few blocks deep; no shared memory, no synchronisation.
// tanhf is the accurate CUDA math function (no fast-math flag), and the
// float -> bf16 rounding is round-to-nearest-even, as PyTorch's cast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ uint16_t tail_one(uint16_t p, uint16_t a) {
  const float pf = __uint_as_float(static_cast<uint32_t>(p) << 16);
  const float af = __uint_as_float(static_cast<uint32_t>(a) << 16);
  return __bfloat16_as_ushort(__float2bfloat16_rn(0.5f * (tanhf(pf) + af)));
}

__global__ void __launch_bounds__(kThreads)
    chain_tail_kernel(const uint16_t* p, uint16_t* acc, long long n) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;

  if ((reinterpret_cast<uintptr_t>(p) & 15) !=
      (reinterpret_cast<uintptr_t>(acc) & 15)) {
    for (long long i = tid; i < n; i += stride) acc[i] = tail_one(p[i], acc[i]);
    return;
  }

  // `head` elements up to acc's (and so p's) first 16-byte boundary, then
  // `vectors` of 8 elements, then the tail.
  long long head = ((16 - (reinterpret_cast<uintptr_t>(acc) & 15)) & 15) / 2;
  if (head > n) head = n;
  const long long vectors = (n - head) / 8;
  const long long tail = head + vectors * 8;

  const uint4* pv = reinterpret_cast<const uint4*>(p + head);
  uint4* av = reinterpret_cast<uint4*>(acc + head);
  for (long long v = tid; v < vectors; v += stride) {
    const uint4 pw = pv[v];
    uint4 aw = av[v];
    const uint32_t* ps = reinterpret_cast<const uint32_t*>(&pw);
    uint32_t* as = reinterpret_cast<uint32_t*>(&aw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t lo = tail_one(ps[k] & 0xffffu, as[k] & 0xffffu);
      const uint32_t hi = tail_one(ps[k] >> 16, as[k] >> 16);
      as[k] = lo | (hi << 16);
    }
    av[v] = aw;
  }
  // Head (at most 7) and tail (at most 7), one element a thread.
  if (tid < head) acc[tid] = tail_one(p[tid], acc[tid]);
  const long long t = tail + tid;
  if (t < n) acc[t] = tail_one(p[t], acc[t]);
}

}  // namespace

// acc = bf16(0.5 * (tanh(p) + acc)) over n contiguous bf16 elements, in
// place, on `stream`. Returns the launch's cudaError_t (cudaGetLastError());
// cudaErrorInvalidValue for n < 1. Does not synchronise.
extern "C" int tpufd_chain_tail(const void* p, void* acc, long long n,
                                void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Enough blocks for one vector a thread, up to kBlocksPerSm per SM.
  const long long per_block = 8ll * kThreads;
  const long long want = (n + per_block - 1) / per_block;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
  chain_tail_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(p), static_cast<uint16_t*>(acc), n);
  return static_cast<int>(cudaGetLastError());
}
