// K6 tzk_ntt_pass -- one batched radix-m DIF pass of the multi-pass NTT,
// behind a plain C interface loaded with ctypes (tpu_zk_torch/_build.py
// builds this file with nvcc for sm_90a).
//
// Replaces tpu_zk/ntt/sixstep.py:112 _batched_dif (Gentleman-Sande sweep
// _dif_sweep :71, optional pre-twiddle and 1/N scale) and
// tpu_zk/fields/mxu_mul.py:405 dft_mxu (the same pass as a digit matmul on
// the MXU, 1/N folded into the last pass's matrix): both compute, for each
// column, the m-point DFT of its m elements (after an optional elementwise
// pre-twiddle), emitted with the output digit bit-reversed, and optionally
// scaled.
//
// Layout.  The table is viewed as [A, m, C, L]: the transform axis is the
// middle one, a column is one (a, c) pair, and its m elements lie C * L
// words apart.  The pass writes the output digit back to the same axis, so
// the six-step plan (ntt/sixstep.py) runs every pass on the same flat table
// with no transpose between passes: the TPU kernel's [L, m, B] blocks needed
// an XLA transpose before and after each pass.
//
// Design.  One block holds cpb neighbouring columns (cpb * m <= 1024
// elements, at most 32 KB of dynamic shared memory): loaded once, with the
// pre-twiddle multiplied on load, repacked from 16-bit limbs to 8 32-bit
// limbs and kept limb-major ([limb][element]) so that neighbouring threads
// touch neighbouring words.  log2(m) butterfly stages run in shared memory,
// __syncthreads() between them: lo = u + v, hi = (u - v) * w with w read
// from the plan's [S, m/2] stage table (a few hundred KB, cached).  The
// optional Montgomery scale is applied on store, and the plan's last pass
// stores each element at its natural-order row (``dst``), so no gather
// follows the transform.  Each element crosses device memory once each way
// per pass.
//
// Bound.  By operations: every butterfly whose twiddle is not w^0 = 1 is one
// CIOS product of 8 32-bit limbs (2 * 8^2 wide multiply-adds), and so is each
// pre-twiddle that is not 1 and each scaled element.  A radix-m pass makes
// N/2 log2 m - N (m - 1) / m butterfly products (slot 0 of every group is
// w^0).  At 2^24, three passes of 2^8 with pre-twiddles on two of them, that
// is about 11 N products: about 3.2 ms at the card's probed rate of wide
// multiply-adds, against about 3 ms for the bytes of three passes.  The
// modular adds ride along.  This kernel multiplies by w^0 too.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace tzk {

constexpr int kNttThreads = 256;
constexpr int kNttMaxElems = 1024;  // elements per block: 32 KB of shared memory at 8 limbs

template <int N>
__global__ void __launch_bounds__(kNttThreads)
    ntt_pass_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ tws,
                    const uint32_t* __restrict__ pre, const uint32_t* __restrict__ scale,
                    const int64_t* __restrict__ dst, uint32_t* __restrict__ out, int log_m, int64_t C, int cpb,
                    int64_t col_blocks, FieldParams f) {
  constexpr int L = 2 * N;
  extern __shared__ uint32_t smem[];  // [N][E]
  const int m = 1 << log_m;
  const int E = cpb * m;
  const int64_t a = blockIdx.x / col_blocks;
  const int64_t c0 = (blockIdx.x % col_blocks) * cpb;
  const int ncols = C - c0 < cpb ? (int)(C - c0) : cpb;

  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int col = e % cpb;
    const int n = e / cpb;
    uint32_t v[N];
    if (col < ncols) {
      const int64_t off = ((a * m + n) * C + c0 + col) * L;
      load_elem<N>(x + off, v);
      if (pre != nullptr) {
        uint32_t w[N], t[N];
        load_elem<N>(pre + off, w);
        mont_mul<N>(t, v, w, f);
#pragma unroll
        for (int j = 0; j < N; ++j) v[j] = t[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = 0;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) smem[j * E + e] = v[j];
  }
  __syncthreads();

  for (int s = 0; s < log_m; ++s) {
    const int h_log = log_m - s - 1;  // butterfly half-width H = 2^h_log
    const uint32_t* tw_stage = tws + (int64_t)s * (m / 2) * L;
    for (int b = threadIdx.x; b < E / 2; b += blockDim.x) {
      const int col = b % cpb;
      const int bb = b / cpb;
      const int j = bb & ((1 << h_log) - 1);
      const int nu = ((bb >> h_log) << (h_log + 1)) + j;
      const int iu = nu * cpb + col;
      const int iv = iu + (cpb << h_log);
      uint32_t u[N], v[N], lo[N], d[N], w[N], hi[N];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        u[k] = smem[k * E + iu];
        v[k] = smem[k * E + iv];
      }
      load_elem<N>(tw_stage + (int64_t)j * L, w);
      mod_add<N>(lo, u, v, f);
      mod_sub<N>(d, u, v, f);
      mont_mul<N>(hi, d, w, f);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        smem[k * E + iu] = lo[k];
        smem[k * E + iv] = hi[k];
      }
    }
    __syncthreads();
  }

  uint32_t sc[N];
  if (scale != nullptr) load_elem<N>(scale, sc);
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int col = e % cpb;
    if (col >= ncols) continue;
    const int n = e / cpb;
    uint32_t v[N];
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = smem[j * E + e];
    if (scale != nullptr) {
      uint32_t t[N];
      mont_mul<N>(t, v, sc, f);
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = t[j];
    }
    const int64_t pos = (a * m + n) * C + c0 + col;
    const int64_t row = dst != nullptr ? (int64_t)__ldg(reinterpret_cast<const long long*>(dst) + pos) : pos;
    store_elem<N>(out + row * L, v);
  }
}

}  // namespace tzk

extern "C" {

// x, out: [A, m = 2^log_m, C, L] int32 16-bit limbs (out may not alias x);
// tws: [log_m, m/2, L], stage s slot j = w_m^(j << s) (Montgomery); pre:
// [A, m, C, L] or null; scale: [L] (Montgomery) or null; dst: [A m C] int64
// output row of each position, or null for the position itself.  L = 16 only.
int tzk_ntt_pass(const void* x, const void* tws, const void* pre, const void* scale, const void* dst, void* out,
                 int64_t A, int log_m, int64_t C, int L, const uint32_t* p32, uint32_t n0inv, void* stream) {
  using namespace tzk;
  if (L != 16 || log_m < 0 || (1 << log_m) > kNttMaxElems || A <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const FieldParams f = make_params(p32, L / 2, n0inv);
  const int m = 1 << log_m;
  const int cpb = C < kNttMaxElems / m ? (int)C : kNttMaxElems / m;
  const int64_t col_blocks = (C + cpb - 1) / cpb;
  const int64_t blocks = A * col_blocks;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)cpb * m * (L / 2) * sizeof(uint32_t);
  ntt_pass_kernel<8><<<(unsigned)blocks, kNttThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(tws), static_cast<const uint32_t*>(pre),
      static_cast<const uint32_t*>(scale), static_cast<const int64_t*>(dst), static_cast<uint32_t*>(out), log_m, C,
      cpb, col_blocks, f);
  return (int)cudaGetLastError();
}

}  // extern "C"
