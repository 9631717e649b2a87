// The MSM bucket kernels (K4), behind a plain C interface loaded with ctypes
// (tpu_zk_torch/_build.py builds this file with nvcc for sm_90a).
//
// K4a tzk_msm_buckets -- Pippenger bucket accumulation, every window in one
//   launch.  Replaces tpu_zk/curves/ec_pallas.py:114 msm_buckets_pallas and
//   the accumulation stage of :273 msm_buckets13_pallas (signed base-32
//   codes idx | sign << 5 | skip << 6, conditional Y negate).  The TPU
//   kernels carry a per-window bucket table in VMEM across a sequential grid
//   and pick buckets by one-hot masks over K lanes.  Here blocks run in no
//   order and nothing carries over, so one thread owns one (window, lane):
//   it walks points lane, lane + P, lane + 2P, ... (neighbouring threads read
//   neighbouring points and code bytes), and for each does one read, complete
//   add and write of the bucket its code names.  The thread's 16 buckets are
//   a 16 * 3 * N-word stretch of a scratch tensor that is also the output,
//   [W, P, 16, 3, N] words: a bucket is 96 (N = 8) or 144 (N = 12) contiguous
//   bytes moved as 16-byte words, so a warp whose threads name 32 different
//   buckets still uses every byte of every sector it touches (a lane-minor
//   layout would use 4 of each 32).  No atomics and no sort: the result does
//   not depend on scheduling.
//   Bound by operations: per point and window one complete add = 14
//   Montgomery products (12 of them needed: the two by b3 could be a few
//   additions) of 2 N^2 wide multiply-adds each -- (uint64_t)a * b + c, the
//   instruction field.cuh's CIOS issues, whose rate csrc/probe.cu measures --
//   against ~(3 * 2N * 4) point bytes read and 2 * 3 * N * 4 bucket bytes,
//   most of which stay in L2.
//   P is chosen by the wrapper from tzk_msm_resident_threads so that W * P
//   threads are one full wave of the card: a second, part-filled wave would
//   double the time of a kernel whose threads all run equally long.
//
// K4b tzk_msm_bucket_reduce -- the weighted bucket total of each (window,
//   lane): acc += S_b; tot += acc for b = 15 .. 0, so tot = sum_b (b+1) S_b.
//   Replaces the tail of msm_buckets13_pallas (ec_pallas.py:239-269).  One
//   thread per (window, lane), 32 complete adds; writes 16-bit limbs
//   [W * P, 3, 2N] for the tree over lanes that follows in PyTorch.  Bound by
//   operations too, and small beside K4a (32 adds against N/P per thread).
//
// Both launch on the caller's stream, allocate nothing, and return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "ec.cuh"

namespace tzk {

constexpr int kMsmThreads = 128;
constexpr int kBuckets = 16;
// blocks per SM the compiler must leave room for: caps the registers of a
// thread at 168 (N = 8) and 255 (N = 12)
constexpr int min_blocks(int n) { return n <= 8 ? 3 : 2; }

template <int N>
__global__ void __launch_bounds__(kMsmThreads, min_blocks(N))
    msm_buckets_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                       const uint32_t* __restrict__ pz, const uint8_t* __restrict__ codes,
                       const uint32_t* __restrict__ b3_limbs, const uint32_t* __restrict__ one_limbs,
                       uint32_t* __restrict__ buckets, int64_t n, int64_t threads, int lanes, FieldParams f) {
  constexpr int L = 2 * N;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= threads) return;
  const int64_t w = t / lanes;
  const int64_t lane = t % lanes;
  uint32_t* mine = buckets + t * (kBuckets * 3 * N);

  uint32_t b3[N], one[N];
  load_elem<N>(b3_limbs, b3);
  load_elem<N>(one_limbs, one);
  {
    PointN<N> id;
    set_identity<N>(id, one);
    for (int b = 0; b < kBuckets; ++b) store_point_words<N>(mine + b * 3 * N, id);
  }

  const uint8_t* my_codes = codes + w * n;
  for (int64_t i = lane; i < n; i += lanes) {
    const uint32_t code = my_codes[i];
    if (code & 64u) continue;  // digit 0
    PointN<N> q, acc;
    load_elem<N>(px + i * L, q.x);
    load_elem<N>(py + i * L, q.y);
    load_elem<N>(pz + i * L, q.z);
    if (code & 32u) neg_y<N>(q.y, f);
    uint32_t* slot = mine + (code & 15u) * (3 * N);
    load_point_words<N>(slot, acc);
    ec_add<N>(acc, acc, q, b3, f);
    store_point_words<N>(slot, acc);
  }
}

template <int N>
__global__ void __launch_bounds__(kMsmThreads)
    msm_bucket_reduce_kernel(const uint32_t* __restrict__ buckets, const uint32_t* __restrict__ b3_limbs,
                             const uint32_t* __restrict__ one_limbs, uint32_t* __restrict__ out, int64_t threads,
                             FieldParams f) {
  constexpr int L = 2 * N;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= threads) return;
  const uint32_t* mine = buckets + t * (kBuckets * 3 * N);
  uint32_t b3[N], one[N];
  load_elem<N>(b3_limbs, b3);
  load_elem<N>(one_limbs, one);
  PointN<N> acc, tot;
  set_identity<N>(acc, one);
  set_identity<N>(tot, one);
  for (int b = kBuckets - 1; b >= 0; --b) {
    PointN<N> s;
    load_point_words<N>(mine + b * 3 * N, s);
    ec_add<N>(acc, acc, s, b3, f);
    ec_add<N>(tot, tot, acc, b3, f);
  }
  uint32_t* o = out + t * 3 * L;
  store_elem<N>(o, tot.x);
  store_elem<N>(o + L, tot.y);
  store_elem<N>(o + 2 * L, tot.z);
}

template <int N>
static int resident_threads() {
  int device = 0, sms = 0, blocks = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, msm_buckets_kernel<N>, kMsmThreads, 0);
  if (e != cudaSuccess) return -(int)e;
  return sms * blocks * kMsmThreads;
}

}  // namespace tzk

extern "C" {

// px, py, pz: [n, L] int32 16-bit limbs (Montgomery projective); codes: [W, n]
// bytes; b3, one: [L] limbs; buckets: [W, lanes, 16, 3, L/2] words (written).
int tzk_msm_buckets(const void* px, const void* py, const void* pz, const void* codes, const void* b3,
                    const void* one, void* buckets, int64_t n, int W, int lanes, int L, const uint32_t* p32,
                    uint32_t n0inv, void* stream) {
  using namespace tzk;
  const FieldParams f = make_params(p32, L / 2, n0inv);
  const int64_t threads = (int64_t)W * lanes;
  const int64_t blocks = (threads + kMsmThreads - 1) / kMsmThreads;
  if (blocks <= 0 || blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint32_t*>(px);
  const auto* y = static_cast<const uint32_t*>(py);
  const auto* z = static_cast<const uint32_t*>(pz);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* pb3 = static_cast<const uint32_t*>(b3);
  const auto* pone = static_cast<const uint32_t*>(one);
  auto* bk = static_cast<uint32_t*>(buckets);
  switch (L) {
    case 16:
      msm_buckets_kernel<8><<<(unsigned)blocks, kMsmThreads, 0, s>>>(x, y, z, c, pb3, pone, bk, n, threads, lanes, f);
      break;
    case 24:
      msm_buckets_kernel<12><<<(unsigned)blocks, kMsmThreads, 0, s>>>(x, y, z, c, pb3, pone, bk, n, threads, lanes, f);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// buckets: [threads, 16, 3, L/2] words; out: [threads, 3, L] int32 16-bit limbs.
int tzk_msm_bucket_reduce(const void* buckets, const void* b3, const void* one, void* out, int64_t threads, int L,
                          const uint32_t* p32, uint32_t n0inv, void* stream) {
  using namespace tzk;
  const FieldParams f = make_params(p32, L / 2, n0inv);
  const int64_t blocks = (threads + kMsmThreads - 1) / kMsmThreads;
  if (blocks <= 0 || blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* bk = static_cast<const uint32_t*>(buckets);
  const auto* pb3 = static_cast<const uint32_t*>(b3);
  const auto* pone = static_cast<const uint32_t*>(one);
  auto* o = static_cast<uint32_t*>(out);
  switch (L) {
    case 16:
      msm_bucket_reduce_kernel<8><<<(unsigned)blocks, kMsmThreads, 0, s>>>(bk, pb3, pone, o, threads, f);
      break;
    case 24:
      msm_bucket_reduce_kernel<12><<<(unsigned)blocks, kMsmThreads, 0, s>>>(bk, pb3, pone, o, threads, f);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Threads of tzk_msm_buckets that the current card keeps resident at once
// (SMs x blocks per SM x threads per block) for limb count L; a negative
// value is minus a cudaError_t.
int tzk_msm_resident_threads(int L) {
  switch (L) {
    case 16:
      return tzk::resident_threads<8>();
    case 24:
      return tzk::resident_threads<12>();
    default:
      return -(int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
