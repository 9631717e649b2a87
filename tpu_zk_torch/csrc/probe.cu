// Probes of the card's integer multiply-add rates.  Not kernels of any path:
// chip_smoke.py times them to turn a count of multiply-adds into the least
// time the card could take for them.
//
// tzk_wide_mad_probe times the instruction field.cuh's CIOS issues,
// (uint64_t)a * b + c: a 32 x 32-bit product added to a 64-bit word.  One
// Montgomery product of N 32-bit limbs is 2 N^2 of them, and that is the unit
// in which the field and curve kernels' operation bounds are counted.
// tzk_imad_probe times the 32-bit form x * a + b beside it, to show how the
// two rates stand to each other.
//
// tzk_logic_probe times 32-bit funnel shifts and logic ops, two a step
// (x <- rotl32(x, s) ^ k, with s and k run-time values so that no two steps
// fold into one): the instructions of csrc/keccak.cu's permutation, whose
// operation bound is counted in them.

#include <cuda_runtime.h>

#include <cstdint>

namespace tzk {

constexpr int kProbeThreads = 256;
constexpr int kProbeChains = 8;

// Every thread runs kProbeChains independent chains x <- x * a + b.
__global__ void __launch_bounds__(kProbeThreads) imad_probe_kernel(uint32_t* __restrict__ out, int iters, uint32_t a, uint32_t b) {
  uint32_t x[kProbeChains];
#pragma unroll
  for (int c = 0; c < kProbeChains; ++c) x[c] = threadIdx.x + c;
#pragma unroll 8
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < kProbeChains; ++c) x[c] = x[c] * a + b;
  }
  uint32_t acc = 0;
#pragma unroll
  for (int c = 0; c < kProbeChains; ++c) acc ^= x[c];
  out[(int64_t)blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

// Every thread runs kProbeChains independent chains acc <- lo(acc) * a + acc,
// one wide multiply-add each.
__global__ void __launch_bounds__(kProbeThreads) wide_mad_probe_kernel(uint32_t* __restrict__ out, int iters, uint32_t a) {
  uint64_t acc[kProbeChains];
#pragma unroll
  for (int c = 0; c < kProbeChains; ++c) acc[c] = ((uint64_t)(threadIdx.x + 1) << 32) | (uint32_t)(c + 1);
#pragma unroll 8
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < kProbeChains; ++c) acc[c] = (uint64_t)(uint32_t)acc[c] * a + acc[c];
  }
  uint64_t all = 0;
#pragma unroll
  for (int c = 0; c < kProbeChains; ++c) all ^= acc[c];
  out[(int64_t)blockIdx.x * blockDim.x + threadIdx.x] = (uint32_t)all ^ (uint32_t)(all >> 32);
}

// Every thread runs kProbeChains independent chains x <- rotl32(x, s) ^ k:
// one funnel shift and one logic op a step.
__global__ void __launch_bounds__(kProbeThreads) logic_probe_kernel(uint32_t* __restrict__ out, int iters, uint32_t s, uint32_t k) {
  uint32_t x[kProbeChains];
#pragma unroll
  for (int c = 0; c < kProbeChains; ++c) x[c] = threadIdx.x * 0x9E3779B9u + c;
#pragma unroll 8
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < kProbeChains; ++c) x[c] = __funnelshift_l(x[c], x[c], s) ^ k;
  }
  uint32_t acc = 0;
#pragma unroll
  for (int c = 0; c < kProbeChains; ++c) acc ^= x[c];
  out[(int64_t)blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

}  // namespace tzk

extern "C" {

// out: [blocks * 256] int32.  Launches blocks x 256 threads, each doing
// 8 * iters multiply-adds; returns cudaGetLastError().
int tzk_imad_probe(void* out, int blocks, int iters, uint32_t a, uint32_t b, void* stream) {
  using namespace tzk;
  if (blocks <= 0 || iters <= 0) return (int)cudaErrorInvalidValue;
  imad_probe_kernel<<<blocks, kProbeThreads, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<uint32_t*>(out),
                                                                                      iters, a, b);
  return (int)cudaGetLastError();
}

// The same launch shape and count, of wide (32 x 32 + 64 -> 64 bit)
// multiply-adds.
int tzk_wide_mad_probe(void* out, int blocks, int iters, uint32_t a, void* stream) {
  using namespace tzk;
  if (blocks <= 0 || iters <= 0) return (int)cudaErrorInvalidValue;
  wide_mad_probe_kernel<<<blocks, kProbeThreads, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<uint32_t*>(out),
                                                                                          iters, a);
  return (int)cudaGetLastError();
}

// The same launch shape, 8 * iters steps a thread of one funnel shift and one
// logic op each: 2 * 8 * iters 32-bit logic/shift instructions a thread.
int tzk_logic_probe(void* out, int blocks, int iters, uint32_t s, uint32_t k, void* stream) {
  using namespace tzk;
  if (blocks <= 0 || iters <= 0) return (int)cudaErrorInvalidValue;
  logic_probe_kernel<<<blocks, kProbeThreads, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<uint32_t*>(out),
                                                                                      iters, s, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
