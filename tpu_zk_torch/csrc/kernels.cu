// The port's field kernels, behind a plain C interface loaded with ctypes
// (tpu_zk_torch/_build.py builds this file with nvcc for sm_90a).
//
// K1 tzk_mont_mul -- elementwise Montgomery product.
//   Replaces tpu_zk/fields/pallas_kernels.py:142 mont_mul_pallas.  One thread
//   per element: load 2N 16-bit limbs as N 32-bit limbs, 32-bit CIOS, one
//   conditional subtract, store.  Bound by device memory: it moves 3 element
//   tables (read a, read b, write out; 2 with a broadcast b) for ~N^2 wide
//   multiplies per element.
//
// K2 tzk_fold -- fused sumcheck fold + per-block wide sums.
//   Replaces tpu_zk/fields/pallas_kernels.py:222 fold_pallas and
//   tpu_zk/fields/mxu_mul.py:296 fold_mxu_lm (same function).  folded =
//   lo + r*(hi - lo) mod p for each of T pairs of each row; each CUDA block
//   also writes the strict wide sum of its `block` folded values, which the
//   caller reduces across blocks.  The TPU kernels carried that sum in
//   scratch across a sequential grid; here blocks run in no order, so each
//   writes its own partial row.  Bound by device memory: 3 half-table passes
//   (read lo, read hi, write folded) -- one table read plus a half-table write.
//
// K3 tzk_addsub -- elementwise modular add or subtract.
//   Replaces tpu_zk/fields/pallas_kernels.py:176 addsub_pallas and :294
//   addsub_lm_pallas (bodies _add_rows :123, _sub_rows :130).  One thread per
//   element: repack to N 32-bit limbs, one carry (or borrow) chain and one
//   conditional correction by p, store.  The TPU kernels propagated 16-bit
//   carries across limb rows; here a 32-bit add-with-carry chain in registers
//   does it.  Bound by device memory: it moves 3 element tables (2 with a
//   broadcast b) for ~2N integer adds per element.
//
// All launch on the caller's stream, allocate nothing, and return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace tzk {

constexpr int kMulThreads = 256;
constexpr int kAddSubThreads = 256;
constexpr int kFoldThreads = 256;
constexpr int kWarps = kFoldThreads / 32;

template <int N>
__global__ void __launch_bounds__(kMulThreads)
    mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                    int64_t m, int64_t b_stride, FieldParams f) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  uint32_t x[N], y[N], z[N];
  load_elem<N>(a + i * 2 * N, x);
  load_elem<N>(b + i * b_stride, y);
  mont_mul<N>(z, x, y, f);
  store_elem<N>(out + i * 2 * N, z);
}

template <int N, bool kSub>
__global__ void __launch_bounds__(kAddSubThreads)
    addsub_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                  int64_t m, int64_t b_stride, FieldParams f) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  uint32_t x[N], y[N], z[N];
  load_elem<N>(a + i * 2 * N, x);
  load_elem<N>(b + i * b_stride, y);
  if (kSub) {
    mod_sub<N>(z, x, y, f);
  } else {
    mod_add<N>(z, x, y, f);
  }
  store_elem<N>(out + i * 2 * N, z);
}

template <int N>
__global__ void __launch_bounds__(kFoldThreads)
    fold_kernel(const uint32_t* __restrict__ flat, const uint32_t* __restrict__ r, uint32_t* __restrict__ folded,
                uint32_t* __restrict__ sums, int64_t T, int64_t block, int64_t G, FieldParams f) {
  constexpr int L = 2 * N;
  const int64_t row = blockIdx.x / G;
  const int64_t g = blockIdx.x % G;
  const uint32_t* lo_row = flat + row * 2 * T * L;
  const uint32_t* hi_row = lo_row + T * L;
  uint32_t* out_row = folded + row * T * L;

  uint32_t rr[N];
  load_elem<N>(r, rr);

  // lazy 16-bit-limb sums: each stays < block * 2^16 <= 2^32
  uint32_t acc[L];
#pragma unroll
  for (int k = 0; k < L; ++k) acc[k] = 0;

  const int64_t begin = g * block;
  const int64_t end = begin + block < T ? begin + block : T;
  for (int64_t e = begin + threadIdx.x; e < end; e += kFoldThreads) {
    uint32_t lo[N], hi[N], d[N], m[N], o[N];
    load_elem<N>(lo_row + e * L, lo);
    load_elem<N>(hi_row + e * L, hi);
    mod_sub<N>(d, hi, lo, f);
    mont_mul<N>(m, d, rr, f);
    mod_add<N>(o, m, lo, f);
    store_elem<N>(out_row + e * L, o);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      acc[2 * k] += o[k] & 0xFFFFu;
      acc[2 * k + 1] += o[k] >> 16;
    }
  }

  __shared__ uint32_t part[kWarps][L];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    uint32_t v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, off);
    if (lane == 0) part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // carry the lazy limbs into L + 2 strict 16-bit limbs
    uint32_t* s = sums + (row * G + g) * (L + 2);
    uint64_t c = 0;
    for (int k = 0; k < L; ++k) {
      uint64_t v = c;
      for (int w = 0; w < kWarps; ++w) v += part[w][k];
      s[k] = (uint32_t)(v & 0xFFFFu);
      c = v >> 16;
    }
    s[L] = (uint32_t)(c & 0xFFFFu);
    s[L + 1] = (uint32_t)((c >> 16) & 0xFFFFu);
  }
}

}  // namespace tzk

extern "C" {

// a, out: [m, L] int32 16-bit limbs; b: [m, L], or [L] when b_broadcast.
int tzk_mont_mul(const void* a, const void* b, void* out, int64_t m, int b_broadcast, int L, const uint32_t* p32,
                 uint32_t n0inv, void* stream) {
  using namespace tzk;
  const FieldParams f = make_params(p32, L / 2, n0inv);
  const int64_t blocks = (m + kMulThreads - 1) / kMulThreads;
  const int64_t b_stride = b_broadcast ? 0 : L;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const uint32_t*>(a);
  const auto* pb = static_cast<const uint32_t*>(b);
  auto* po = static_cast<uint32_t*>(out);
  switch (L) {
    case 16:
      mont_mul_kernel<8><<<(unsigned)blocks, kMulThreads, 0, s>>>(pa, pb, po, m, b_stride, f);
      break;
    case 24:
      mont_mul_kernel<12><<<(unsigned)blocks, kMulThreads, 0, s>>>(pa, pb, po, m, b_stride, f);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// a, out: [m, L] int32 16-bit limbs; b: [m, L], or [L] when b_broadcast.
// out = a - b mod p when subtract, else a + b mod p.
int tzk_addsub(const void* a, const void* b, void* out, int64_t m, int b_broadcast, int subtract, int L,
               const uint32_t* p32, void* stream) {
  using namespace tzk;
  const FieldParams f = make_params(p32, L / 2, 0);
  const int64_t blocks = (m + kAddSubThreads - 1) / kAddSubThreads;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;
  const int64_t b_stride = b_broadcast ? 0 : L;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const uint32_t*>(a);
  const auto* pb = static_cast<const uint32_t*>(b);
  auto* po = static_cast<uint32_t*>(out);
  const unsigned grid = (unsigned)blocks;
  switch (L) {
    case 16:
      if (subtract) {
        addsub_kernel<8, true><<<grid, kAddSubThreads, 0, s>>>(pa, pb, po, m, b_stride, f);
      } else {
        addsub_kernel<8, false><<<grid, kAddSubThreads, 0, s>>>(pa, pb, po, m, b_stride, f);
      }
      break;
    case 24:
      if (subtract) {
        addsub_kernel<12, true><<<grid, kAddSubThreads, 0, s>>>(pa, pb, po, m, b_stride, f);
      } else {
        addsub_kernel<12, false><<<grid, kAddSubThreads, 0, s>>>(pa, pb, po, m, b_stride, f);
      }
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// flat: [B, 2T, L]; r: [L]; folded: [B, T, L]; sums: [B, ceil(T/block), L+2].
int tzk_fold(const void* flat, const void* r, void* folded, void* sums, int64_t B, int64_t T, int64_t block, int L,
             const uint32_t* p32, uint32_t n0inv, void* stream) {
  using namespace tzk;
  const FieldParams f = make_params(p32, L / 2, n0inv);
  const int64_t G = (T + block - 1) / block;
  const int64_t blocks = B * G;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* pf = static_cast<const uint32_t*>(flat);
  const auto* pr = static_cast<const uint32_t*>(r);
  auto* po = static_cast<uint32_t*>(folded);
  auto* ps = static_cast<uint32_t*>(sums);
  switch (L) {
    case 16:
      fold_kernel<8><<<(unsigned)blocks, kFoldThreads, 0, s>>>(pf, pr, po, ps, T, block, G, f);
      break;
    case 24:
      fold_kernel<12><<<(unsigned)blocks, kFoldThreads, 0, s>>>(pf, pr, po, ps, T, block, G, f);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
