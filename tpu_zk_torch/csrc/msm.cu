// The MSM bucket kernels (K4), behind a plain C interface loaded with ctypes
// (tpu_zk_torch/_build.py builds this file with nvcc for sm_90a).
//
// They replace tpu_zk/curves/ec_pallas.py:114 msm_buckets_pallas and :273
// msm_buckets13_pallas: K4a its bucket accumulation, K4b its tail, the
// per-lane weighted bucket total of :239-269.  The TPU kernels carry a
// bucket table of 16 buckets (signed base-32 digits) in VMEM across a
// sequential grid and pick buckets by one-hot masks.  Here the digits are
// signed c-bit ones, c up to 16 (2^(c-1) buckets a window, so a 254-bit
// scalar takes 16 adds a point, not 53), and the caller sorts each window's
// points by bucket (curves/msm_pippenger.py), so no kernel routes or masks.
//
// K4a tzk_msm_buckets -- one thread sums one unit: a run of at most R
//   consecutive entries of a bucket's list into one partial point.  An entry
//   is a point index with the sign in bit 31 (Y negated), or, with no entry
//   list, the row itself: the same kernel then sums the partials of a bucket
//   that spans several units, pass after pass, and the segment totals of K4b
//   into window sums.  The caller cuts every list into units of at most R, so
//   every thread of a warp does about the same number of adds whatever the
//   scalars: all-equal scalars put each window's points into one bucket and
//   take a few more (short) passes, never 2^24 adds on one thread.  Each
//   thread sums its unit in order, so two launches give the same limbs.
//   Bound by operations: per entry one complete add of 12 Montgomery products
//   (mul_b3 does the products by 3b with additions) of 2 N^2 wide
//   multiply-adds, (uint64_t)a * b + c on 32-bit limbs -- the instruction
//   whose rate csrc/probe.cu measures -- against 4 + 3 * 2N * 4 bytes read
//   (an entry and a point of 16-bit limbs).  The design's answer: the adds
//   are a serial chain per thread, so the next entry's index and point are
//   loaded before the current add and their latency hides under its ~2,000
//   instructions; two warps a scheduler then keep it issuing (kUnitMinBlocks).
//
// K4b tzk_msm_bucket_reduce -- one thread per (window, segment of m
//   buckets): the running sums acc += S_b; tot += acc from the segment's top
//   bucket down give sum_b (b - lo + 1) S_b over the segment's buckets
//   lo..hi-1, and lo * acc, by double-and-add over the bits of lo, makes
//   the weights the true b + 1.  Bound by operations too, counted from the
//   function: weighing a window's B buckets takes 2 adds a bucket by running
//   sums, and carrying its S segments' offsets 2 adds a segment by a second
//   running sum over their sums.  The double-and-add offsets here take
//   more adds than that (up to 2 (c - 1) a segment), still few beside K4a's
//   (2^c adds a window against N).
//
// Points cross as rows of int32 16-bit limbs, [.., 3, 2N] (X, Y, Z), the
// package's layout; a thread repacks to 32-bit limbs on load and back on
// store.  Both kernels launch on the caller's stream, allocate nothing, and
// return cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "ec.cuh"

namespace tzk {

constexpr int kUnitThreads = 128;
constexpr int kReduceThreads = 128;
// K4a's blocks per SM that the compiler must leave registers for: 2 leaves
// 255 a thread, and the N = 8 kernel needs about 210 of them, with no spills
// (3 and 4 blocks spill and were no faster on the H100: PERF.md).
constexpr int kUnitMinBlocks = 2;

template <int N, int K>
__global__ void __launch_bounds__(kUnitThreads, kUnitMinBlocks)
    msm_units_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                     const uint32_t* __restrict__ pz, int64_t stride, const int32_t* __restrict__ entries,
                     const int32_t* __restrict__ units, const uint32_t* __restrict__ one_limbs,
                     uint32_t* __restrict__ out, int64_t n_units, FieldParams f) {
  constexpr int L = 2 * N;
  const int64_t u = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= n_units) return;
  const int32_t start = units[2 * u];
  const int32_t count = units[2 * u + 1];
  PointN<N> acc;
  if (count == 0) {
    uint32_t one[N];
    load_elem<N>(one_limbs, one);
    set_identity<N>(acc, one);
  } else {
    // an entry: a point index, its sign in bit 31; with no entry list, the row itself
    int32_t e = entries ? __ldg(entries + start) : start;
    load_point<N>(px, py, pz, e & 0x7FFFFFFF, stride, acc);
    if (e < 0) neg_y<N>(acc.y, f);
    PointN<N> next;
    if (count > 1) {
      e = entries ? __ldg(entries + start + 1) : start + 1;
      load_point<N>(px, py, pz, e & 0x7FFFFFFF, stride, next);
    }
    for (int k = 1; k < count; ++k) {
      PointN<N> q = next;
      const bool negative = e < 0;
      if (k + 1 < count) {  // the next entry's loads go out before this add
        e = entries ? __ldg(entries + start + k + 1) : start + k + 1;
        load_point<N>(px, py, pz, e & 0x7FFFFFFF, stride, next);
      }
      if (negative) neg_y<N>(q.y, f);
      ec_add<N, K>(acc, acc, q, f);
    }
  }
  store_point_row<N>(out + u * 3 * L, acc);
}

template <int N, int K>
__global__ void __launch_bounds__(kReduceThreads)
    msm_reduce_kernel(const uint32_t* __restrict__ buckets, uint32_t* __restrict__ out, int64_t threads, int B,
                      int m, int S, FieldParams f) {
  constexpr int L = 2 * N;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= threads) return;
  const int64_t w = t / S;
  const int lo = (int)(t % S) * m;
  const int hi = min(lo + m, B);
  const uint32_t* row = buckets + w * B * 3 * L;

  PointN<N> acc, tot;
  load_point<N>(row, row + L, row + 2 * L, hi - 1, 3 * L, acc);
  tot = acc;
  for (int b = hi - 2; b >= lo; --b) {
    PointN<N> s;
    load_point<N>(row, row + L, row + 2 * L, b, 3 * L, s);
    ec_add<N, K>(acc, acc, s, f);
    ec_add<N, K>(tot, tot, acc, f);
  }
  // tot = sum_b (b - lo + 1) S_b; add lo * acc, most significant bit first
  if (lo > 0) {
    PointN<N> off = acc;
    for (int bit = 30 - __clz(lo); bit >= 0; --bit) {
      ec_add<N, K>(off, off, off, f);
      if ((lo >> bit) & 1) ec_add<N, K>(off, off, acc, f);
    }
    ec_add<N, K>(tot, tot, off, f);
  }
  store_point_row<N>(out + t * 3 * L, tot);
}

}  // namespace tzk

// (L, 3b) -> the kernel instantiation: BN254 G1 (L = 16, 3b = 9), BLS12-381 G1 (L = 24, 3b = 12)
#define TZK_MSM_DISPATCH(L, b3, KERNEL, ...)                         \
  if ((L) == 16 && (b3) == 9) {                                      \
    KERNEL<8, 9><<<(unsigned)blocks, threads_per_block, 0, s>>>(__VA_ARGS__); \
  } else if ((L) == 24 && (b3) == 12) {                              \
    KERNEL<12, 12><<<(unsigned)blocks, threads_per_block, 0, s>>>(__VA_ARGS__); \
  } else {                                                           \
    return (int)cudaErrorInvalidValue;                               \
  }

extern "C" {

// px, py, pz: coordinate rows of 16-bit limbs (Montgomery projective), row i
// at p* + i * stride words; entries: [E] int32 (index | sign << 31) or null
// (entry k is row k); units: [n_units, 2] int32 (start, count) into the
// entries; one: [L] limbs; out: [n_units, 3, L] int32 limbs (written).
int tzk_msm_buckets(const void* px, const void* py, const void* pz, int64_t stride, const void* entries,
                    const void* units, const void* one, void* out, int64_t n_units, int L, int b3,
                    const uint32_t* p32, uint32_t n0inv, void* stream) {
  using namespace tzk;
  const FieldParams f = make_params(p32, L / 2, n0inv);
  const int threads_per_block = kUnitThreads;
  const int64_t blocks = (n_units + threads_per_block - 1) / threads_per_block;
  if (blocks <= 0 || blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TZK_MSM_DISPATCH(L, b3, msm_units_kernel, static_cast<const uint32_t*>(px), static_cast<const uint32_t*>(py),
                   static_cast<const uint32_t*>(pz), stride, static_cast<const int32_t*>(entries),
                   static_cast<const int32_t*>(units), static_cast<const uint32_t*>(one),
                   static_cast<uint32_t*>(out), n_units, f)
  return (int)cudaGetLastError();
}

// buckets: [W, B, 3, L] int32 limbs; out: [W, S, 3, L] with S = ceil(B / m),
// out[w, j] = sum over b in [j m, min((j + 1) m, B)) of (b + 1) buckets[w, b].
int tzk_msm_bucket_reduce(const void* buckets, void* out, int W, int B, int m, int L, int b3,
                          const uint32_t* p32, uint32_t n0inv, void* stream) {
  using namespace tzk;
  if (W < 1 || B < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const FieldParams f = make_params(p32, L / 2, n0inv);
  const int S = (B + m - 1) / m;
  const int64_t threads = (int64_t)W * S;
  const int threads_per_block = kReduceThreads;
  const int64_t blocks = (threads + threads_per_block - 1) / threads_per_block;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TZK_MSM_DISPATCH(L, b3, msm_reduce_kernel, static_cast<const uint32_t*>(buckets), static_cast<uint32_t*>(out),
                   threads, B, m, S, f)
  return (int)cudaGetLastError();
}

}  // extern "C"
