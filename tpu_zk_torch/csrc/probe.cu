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
// tzk_mont_probe runs chains of Montgomery products x <- x * y, each by
// field.cuh's mont_mul or by mont_mul_eo, in one kernel: one chain of ``iters``
// products a thread from the same inputs, so the two products' outputs must
// be equal limb for limb and their times compare the products alone.
//
// tzk_logic_probe times 32-bit funnel shifts and logic ops, two a step
// (x <- rotl32(x, s) ^ k, with s and k run-time values so that no two steps
// fold into one): the instructions of csrc/keccak.cu's permutation, whose
// operation bound is counted in them.
//
// tzk_latency_probe runs one thread's single chain of the same step,
// x <- rotl32(x, s) ^ k: each instruction waits for the one before it, so
// its time over 2 * iters instructions is the latency of one dependent
// funnel shift or logic op, in which K7's bound is counted (a sponge is one
// serial chain of permutations, csrc/sponge.cu).
//
// tzk_empty_probe launches a kernel that does nothing, one thread: timed
// over a run of launches from Python, it gives what a launch costs by
// itself, the floor under a kernel as short as K7 (csrc/sponge.cu).

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

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

// One thread, one chain x <- rotl32(x, s) ^ k: every instruction depends on
// the one before it.
__global__ void latency_probe_kernel(uint32_t* __restrict__ out, int iters, uint32_t s, uint32_t k) {
  uint32_t x = 0x9E3779B9u;
#pragma unroll 16
  for (int i = 0; i < iters; ++i) x = __funnelshift_l(x, x, s) ^ k;
  out[0] = x;
}

__global__ void empty_kernel() {}

// Thread i: x = a[i], then x <- x * b[i] ``iters`` times; out[i] = x.
template <int N, bool EVEN_ODD>
__global__ void __launch_bounds__(kProbeThreads)
    mont_probe_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                      int64_t n, int iters, FieldParams f) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[N], y[N];
  load_elem<N>(a + i * 2 * N, x);
  load_elem<N>(b + i * 2 * N, y);
  for (int k = 0; k < iters; ++k) {
    uint32_t z[N];
    if constexpr (EVEN_ODD) {
      mont_mul_eo<N>(z, x, y, f);
    } else {
      mont_mul<N>(z, x, y, f);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = z[j];
  }
  store_elem<N>(out + i * 2 * N, x);
}

template <int N>
int mont_probe_launch(const void* a, const void* b, void* out, int64_t n, int iters, int even_odd, const FieldParams& f,
                      cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kProbeThreads - 1) / kProbeThreads);
  const auto* pa = static_cast<const uint32_t*>(a);
  const auto* pb = static_cast<const uint32_t*>(b);
  auto* po = static_cast<uint32_t*>(out);
  if (even_odd) {
    mont_probe_kernel<N, true><<<blocks, kProbeThreads, 0, stream>>>(pa, pb, po, n, iters, f);
  } else {
    mont_probe_kernel<N, false><<<blocks, kProbeThreads, 0, stream>>>(pa, pb, po, n, iters, f);
  }
  return (int)cudaGetLastError();
}

}  // namespace tzk

extern "C" {

// a, b, out: [n, L] int32 16-bit limbs, L = 16 or 24; even_odd picks
// mont_mul_eo, else mont_mul.  out[i] = a[i] b[i]^iters R^(-iters) (Montgomery).
int tzk_mont_probe(const void* a, const void* b, void* out, int64_t n, int iters, int even_odd, int L,
                   const uint32_t* p32, uint32_t n0inv, void* stream) {
  using namespace tzk;
  if (n <= 0 || iters < 0 || (L != 16 && L != 24)) return (int)cudaErrorInvalidValue;
  const FieldParams f = make_params(p32, L / 2, n0inv);
  auto st = static_cast<cudaStream_t>(stream);
  return L == 16 ? mont_probe_launch<8>(a, b, out, n, iters, even_odd, f, st)
                 : mont_probe_launch<12>(a, b, out, n, iters, even_odd, f, st);
}

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

// One block of one thread running iters dependent steps of one funnel
// shift and one logic op: 2 * iters instructions in one chain.
int tzk_latency_probe(void* out, int iters, uint32_t s, uint32_t k, void* stream) {
  using namespace tzk;
  if (iters <= 0) return (int)cudaErrorInvalidValue;
  latency_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<uint32_t*>(out), iters, s, k);
  return (int)cudaGetLastError();
}

// One launch of the empty kernel, one block of one thread.
int tzk_empty_probe(void* stream) {
  tzk::empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
