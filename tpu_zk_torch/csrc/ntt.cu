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
// scaled.  The MXU's digit matmul answered a VPU with no multiply-high; a
// 254-bit modular product has no tensor-core form worth taking, so this
// kernel is CUDA-core integer arithmetic.
//
// Layout.  The table is viewed as [A, m, C, L]: the transform axis is the
// middle one, a column is one (a, c) pair, and its m elements lie C * L
// words apart.  The pass writes the output digit back to the same axis, so
// the six-step plan (ntt/sixstep.py) runs every pass on the same flat table
// with no transpose between passes.
//
// Bound.  By operations: one Montgomery product (CIOS over 8 32-bit limbs:
// 2 * 8^2 wide multiply-adds, or 4 * 8^2 32-bit ones) per butterfly whose
// twiddle is not w^0 = 1, per pre-twiddle and per scaled element.  A radix-m
// pass needs N/2 log2 m - N (m - 1) / m butterfly products (slot 0 of every
// group of every stage is w^0).  At 2^24, three passes of 2^8 with
// pre-twiddles on two, that is 184,549,377 products, about 11 N: ~2.8 ms at
// the card's probed rate of 32-bit multiply-adds.  The bytes: 64 an element
// (16-bit limbs in int32 words), read and written once a pass, and the
// pre-twiddle read on passes 1 and 2: ~2.6 ms for the three passes.
//
// Design, against that bound:
// 1. No product by w^0.  Slot 0 of every group of every stage is hi = u - v.
//    The kernel makes exactly the products above plus the pre-twiddles that
//    equal 1 (it multiplies by every pre-twiddle); with ``products`` non-null
//    each thread writes how many it made.
// 2. Full blocks on every pass.  A tile is a block's threads * r elements:
//    E / m neighbouring columns of the flattened (a, c) pairs (two at
//    m = 2^8, where blocks of 128 threads do best), so a pass with C = 1
//    (the plans' last) fills its blocks as pass 0 does.  Persistent blocks,
//    as many as the card holds, walk over the tiles.
// 3. Butterflies in registers.  A thread holds r = 4 elements of one column
//    and runs two stages on them in registers; threads exchange through
//    shared memory (32-bit limbs, two 16-byte planes, bank groups mixed by
//    tile_slot) only between such rounds: a 2^8 pass is four radix-4 rounds
//    with three barriers where the radix-2 kernel had eight.  Stage s slot j
//    is w_m^(j << s), stage 0's slot j << s, so one table of m/2 twiddles
//    (tws[0], 32-bit limbs in shared memory, 4 KB at m = 2^8) serves every
//    stage: tws[1:] and tws[:, 0] are never read.  The twiddle a lane needs
//    depends on its offset in the group, and the rounds are laid out so that
//    a warp shares it wherever the group is narrow, where most of the w^0
//    slots are: the skip is whole warps.  One copy of a round's code serves
//    every round (its first stage is a run-time value), and pre and scale
//    run in loops that rotate the registers: the code of a product inlined
//    at every butterfly of every round overflowed the instruction cache.
// 4. Loads under the arithmetic.  A thread loads its round-0 elements (and
//    pre) straight into registers and stores its last round's elements from
//    them; six blocks of 128 threads an SM (80 registers a thread; at
//    m = 2^10 two of 256) keep the loads of some under the products of the
//    others, and a barrier holds only four warps.  Slower in the same chip
//    calls (PERF.md): blocks of 256 or 64 threads; cp.async of each
//    thread's next elements into shared memory (64 raw bytes an element,
//    one block an SM with pre); fetching a tile by 16-byte pieces in
//    device-memory order through shared memory, by the block or by the
//    warp, or by shuffles inside each quad of lanes.
// 5. The product is field.cuh's mont_mul_eo (even/odd carry chains), the add
//    and subtract mod_add_cc / mod_sub_cc: with mont_mul in its place the
//    kernel is slower by more than the 2 % that the product's rule asks.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "field.cuh"

namespace tzk {

constexpr int kNttN = 8;             // 32-bit limbs of an element: L = 16 only
constexpr int kNttLogRadix = 2;      // a thread holds r = 2^2 elements of a column
constexpr int kNttLogThreads = 7;    // a block, at least m / r threads; a tile holds its threads * r elements
constexpr int kNttMaxLogM = 10;

template <int LOG_M>
struct NttTile {
  static constexpr int M = 1 << LOG_M;
  static constexpr int LOG_R = LOG_M < kNttLogRadix ? LOG_M : kNttLogRadix;
  static constexpr int R = 1 << LOG_R;                    // elements a thread holds
  static constexpr int LOG_THREADS = kNttLogThreads > LOG_M - LOG_R ? kNttLogThreads : LOG_M - LOG_R;
  static constexpr int THREADS = 1 << LOG_THREADS;        // a block
  // threads an SM holds (__launch_bounds__): 768 at 80 registers, where the
  // 48 KB tiles of m = 2^10 do better with 512 at 128 (no spills)
  static constexpr int SM_THREADS = LOG_M == 10 ? 512 : 768;
  static constexpr int LOG_E = LOG_THREADS + LOG_R;
  static constexpr int E = 1 << LOG_E;                    // elements a tile holds
  static constexpr int LOG_COLS = LOG_E - LOG_M;
  static constexpr int COLS = 1 << LOG_COLS;              // columns a tile holds
  static constexpr int TW = M / 2;                        // the twiddles w_m^j, j < m/2
  static constexpr int FULL = LOG_R ? LOG_M / LOG_R : 0;  // rounds of log2 r stages
  static constexpr int PART = LOG_R ? LOG_M % LOG_R : 0;  // stages of a last, shorter round
  static_assert(LOG_COLS >= 0, "a tile holds at least one column");
};

// A round runs the stages s0 .. s0 + Q - 1 on groups of P = 2^Q elements that
// lie D = m / 2^(s0 + Q) apart inside one block of G = m / 2^s0 consecutive
// elements.  Group z of a tile is column z % COLS, block (z / COLS) mod 2^s0,
// offset z / (COLS 2^s0) in [0, D); thread t holds the groups t,
// t + THREADS, ... (r / P of them), so its column is t % COLS in every
// round, and a warp's lanes share their offset once COLS 2^s0 >= 32.  s0 is a
// run-time value, so that one copy of a round's code serves every round.
template <int LOG_M, int Q>
struct NttRound {
  using T = NttTile<LOG_M>;
  static constexpr int P = 1 << Q;
  static constexpr int GROUPS = T::R / P;
  int s0;
  __device__ int offset(int z) const { return z >> (T::LOG_COLS + s0); }
  __device__ int elem(int z, int p) const {
    return (((z >> T::LOG_COLS) & ((1 << s0) - 1)) << (LOG_M - s0)) + offset(z) + (p << (LOG_M - s0 - Q));
  }
};

// An element's slot in a tile buffer: element i of column col is i COLS + col,
// its low three bits (which of the eight 16-byte bank groups) mixed with the
// bits above, so that the lanes of a warp that differ in column, block or
// offset land in different banks.
template <int LOG_M>
__device__ __forceinline__ int tile_slot(int i, int col) {
  const int e = (i << NttTile<LOG_M>::LOG_COLS) + col;
  return e ^ (((e >> 3) ^ (e >> 6) ^ (e >> 9) ^ (e >> 12)) & 7);
}

// A tile buffer holds 32-bit limbs in two 16-byte planes: words 0-3 at
// plane[slot], words 4-7 at plane[E + slot].
template <int LOG_M>
__device__ __forceinline__ void tile_load(const uint4* buf, int slot, uint32_t (&v)[kNttN]) {
  const uint4 lo = buf[slot], hi = buf[NttTile<LOG_M>::E + slot];
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w, v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

template <int LOG_M>
__device__ __forceinline__ void tile_store(uint4* buf, int slot, const uint32_t (&v)[kNttN]) {
  buf[slot] = make_uint4(v[0], v[1], v[2], v[3]);
  buf[NttTile<LOG_M>::E + slot] = make_uint4(v[4], v[5], v[6], v[7]);
}

// The position of element 0 of column ``col`` of tile ``tile``, or -1 past the
// last column.
template <int LOG_M>
__device__ __forceinline__ int64_t column_base(int64_t tile, int col, int64_t C, int64_t n_cols) {
  const int64_t q = tile * NttTile<LOG_M>::COLS + col;
  if (q >= n_cols) return -1;
  const int64_t a = q / C;
  return a * NttTile<LOG_M>::M * C + (q - a * C);
}

// lo = u + v, hi = (u - v) w_m^tw_index; with ``one`` (tw_index = 0) hi = u - v, no product
template <int LOG_M>
__device__ __forceinline__ void butterfly(uint32_t (&u)[kNttN], uint32_t (&v)[kNttN], bool one, int tw_index,
                                          const uint4* tw, const FieldParams& f, unsigned& made) {
  uint32_t d[kNttN];
  mod_sub_cc<kNttN>(d, u, v, f);
  mod_add_cc<kNttN>(u, u, v, f);
  if (one) {
#pragma unroll
    for (int k = 0; k < kNttN; ++k) v[k] = d[k];
  } else {
    const uint4 lo = tw[tw_index], hi = tw[NttTile<LOG_M>::TW + tw_index];
    const uint32_t w[kNttN] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    mont_mul_eo<kNttN>(v, d, w, f);
    ++made;
  }
}

// A round's groups to (STORE) or from the tile buffer.
template <int LOG_M, int Q, bool STORE>
__device__ __forceinline__ void exchange(uint32_t (&v)[NttTile<LOG_M>::R][kNttN], uint4* buf, NttRound<LOG_M, Q> rd) {
  using T = NttTile<LOG_M>;
#pragma unroll
  for (int kk = 0; kk < rd.GROUPS; ++kk) {
    const int z = threadIdx.x + kk * T::THREADS;
#pragma unroll
    for (int p = 0; p < rd.P; ++p) {
      const int slot = tile_slot<LOG_M>(rd.elem(z, p), z & (T::COLS - 1));
      if constexpr (STORE) {
        tile_store<LOG_M>(buf, slot, v[kk * rd.P + p]);
      } else {
        tile_load<LOG_M>(buf, slot, v[kk * rd.P + p]);
      }
    }
  }
}

// A round's Q stages on the groups in registers.
template <int LOG_M, int Q>
__device__ __forceinline__ void butterflies(uint32_t (&v)[NttTile<LOG_M>::R][kNttN], const uint4* tw,
                                            NttRound<LOG_M, Q> rd, const FieldParams& f, unsigned& made) {
  const int d_log = LOG_M - rd.s0 - Q;  // log2 D
#pragma unroll
  for (int kk = 0; kk < rd.GROUPS; ++kk) {
    const int off = rd.offset(threadIdx.x + kk * NttTile<LOG_M>::THREADS);
#pragma unroll
    for (int l = 0; l < Q; ++l) {
      const int half = rd.P >> (l + 1);
#pragma unroll
      for (int p = 0; p < rd.P; ++p) {
        if (p & half) continue;
        // the pair's offset in its half-group is j = off + (p mod half) D, and stage s0 + l reads slot
        // j << (s0 + l): w^0 exactly where p mod half = 0 (known here) and off = 0 (shared by a warp's lanes)
        const int rest = p & (half - 1);
        const int j = off + (rest << d_log);
        butterfly<LOG_M>(v[kk * rd.P + p], v[kk * rd.P + p + half], rest == 0 && off == 0, j << (rd.s0 + l), tw, f,
                         made);
      }
    }
  }
}

// v[0] <- v[1] <- ... <- v[R-1] <- v[0]: a loop that handles v[0] and rotates
// visits every element with one copy of its body
template <int R>
__device__ __forceinline__ void rotate(uint32_t (&v)[R][kNttN]) {
#pragma unroll
  for (int k = 0; k < kNttN; ++k) {
    const uint32_t first = v[0][k];
#pragma unroll
    for (int p = 0; p + 1 < R; ++p) v[p][k] = v[p + 1][k];
    v[R - 1][k] = first;
  }
}

// v[0] <- v[0] * b
__device__ __forceinline__ void times(uint32_t (&v)[kNttN], const uint32_t (&b)[kNttN], const FieldParams& f) {
  uint32_t y[kNttN];
  mont_mul_eo<kNttN>(y, v, b, f);
#pragma unroll
  for (int k = 0; k < kNttN; ++k) v[k] = y[k];
}

template <int LOG_M>
__global__ void __launch_bounds__(NttTile<LOG_M>::THREADS, NttTile<LOG_M>::SM_THREADS / NttTile<LOG_M>::THREADS)
    ntt_pass_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ tws,
                    const uint32_t* __restrict__ pre, const uint32_t* __restrict__ scale,
                    const int64_t* __restrict__ dst, uint32_t* __restrict__ out, int64_t C, int64_t n_cols,
                    int64_t n_tiles, FieldParams f, unsigned long long* __restrict__ products) {
  using T = NttTile<LOG_M>;
  using Full = NttRound<LOG_M, T::LOG_R>;
  using Part = NttRound<LOG_M, T::PART>;
  using First = std::conditional_t<(T::FULL > 0), Full, Part>;
  using Last = std::conditional_t<(T::PART > 0 || T::FULL == 0), Part, Full>;
  constexpr int L = 2 * kNttN;
  constexpr int ROUNDS = T::FULL + (T::PART > 0);
  extern __shared__ uint4 smem[];
  uint4* xt = smem;           // [2][E]: the tile between rounds
  uint4* tw = xt + 2 * T::E;  // [2][TW]: w_m^j, j = 1 .. m/2 - 1
  const int t = threadIdx.x;
  const int col = t & (T::COLS - 1);
  const First first{0};
  const Last last{T::PART > 0 || T::FULL == 0 ? T::FULL * T::LOG_R : (T::FULL - 1) * T::LOG_R};
  unsigned made = 0;

  for (int j = t + 1; j < T::TW; j += T::THREADS) {
    uint32_t w[kNttN];
    load_elem<kNttN>(tws + (int64_t)j * L, w);
    tw[j] = make_uint4(w[0], w[1], w[2], w[3]);
    tw[T::TW + j] = make_uint4(w[4], w[5], w[6], w[7]);
  }
  uint32_t sc[kNttN];
  if (scale != nullptr) load_elem<kNttN>(scale, sc);
  __syncthreads();  // the twiddles

  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t base = column_base<LOG_M>(tile, col, C, n_cols);
    const bool live = base >= 0;
    uint32_t v[T::R][kNttN];

    // round 0's elements, straight into registers (the other blocks of the SM compute meanwhile), times pre
    if (live) {
#pragma unroll
      for (int p = 0; p < T::R; ++p) load_elem<kNttN>(x + (base + (int64_t)first.elem(t, p) * C) * L, v[p]);
      if (pre != nullptr) {
#pragma unroll 1
        for (int p = 0; p < T::R; ++p) {  // v[0] holds element p
          uint32_t w[kNttN];
          load_elem<kNttN>(pre + (base + (int64_t)first.elem(t, p) * C) * L, w);
          times(v[0], w, f);
          ++made;
          rotate(v);
        }
      }
    }

    // the rounds of log2 r stages, one copy of their code, then a shorter last round where log2 r does not
    // divide log2 m; every round but the last stores its elements for the next
#pragma unroll 1
    for (int k = 0; k < T::FULL; ++k) {
      const Full rd{k * T::LOG_R};
      if (k > 0) {
        __syncthreads();  // round k - 1's stores
        if (live) exchange<LOG_M, T::LOG_R, false>(v, xt, rd);
      }
      if (live) butterflies<LOG_M, T::LOG_R>(v, tw, rd, f, made);
      if (k + 1 < ROUNDS) {
        if (k == 0) __syncthreads();  // the last tile's last round has read the buffer
        if (live) exchange<LOG_M, T::LOG_R, true>(v, xt, rd);
      }
    }
    if constexpr (T::PART > 0) {
      const Part rd{T::FULL * T::LOG_R};
      __syncthreads();
      if (live) {
        exchange<LOG_M, T::PART, false>(v, xt, rd);
        butterflies<LOG_M, T::PART>(v, tw, rd, f, made);
      }
    }

    if (live) {  // the last round's elements: scale, then store at their (natural-order) rows
#pragma unroll 1
      for (int r = 0; r < T::R; ++r) {  // v[0] holds element p of group kk
        const int kk = r / last.P, p = r % last.P;
        if (scale != nullptr) {
          times(v[0], sc, f);
          ++made;
        }
        const int64_t pos = base + (int64_t)last.elem(t + kk * T::THREADS, p) * C;
        const int64_t row = dst != nullptr ? (int64_t)__ldg(reinterpret_cast<const long long*>(dst) + pos) : pos;
        store_elem<kNttN>(out + row * L, v[0]);
        rotate(v);
      }
    }
  }
  if (products != nullptr) products[(int64_t)blockIdx.x * T::THREADS + t] = made;
}

// Shared memory of one block, in bytes (48 KB at m = 2^10).
template <int LOG_M>
constexpr size_t ntt_smem_bytes() {
  using T = NttTile<LOG_M>;
  return (2 * (size_t)T::E + 2 * (size_t)T::TW) * sizeof(uint4);
}

namespace {
// blocks an SM holds, by card and log_m (0: not asked yet), and each card's
// SMs, kept for the first kNttCards device ordinals (a card above them asks
// at every launch); in an unnamed namespace, so that two libraries built
// from variants of this file and loaded in one process keep their own
constexpr int kNttCards = 64;
int ntt_blocks_per_sm[kNttCards][kNttMaxLogM + 1];
int ntt_sms[kNttCards];
}  // namespace

template <int LOG_M>
int ntt_launch(const uint32_t* x, const uint32_t* tws, const uint32_t* pre, const uint32_t* scale, const int64_t* dst,
               uint32_t* out, int64_t A, int64_t C, const FieldParams& f, unsigned long long* products,
               int64_t count_slots, cudaStream_t stream) {
  using T = NttTile<LOG_M>;
  constexpr size_t smem = ntt_smem_bytes<LOG_M>();
  static_assert(smem <= 48 * 1024, "a block takes at most 48 KB of shared memory without opting in");
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);  // the card this launch goes to
  if (err != cudaSuccess) return (int)err;
  int asked_blocks = 0, asked_sms = 0;
  int& blocks_per_sm = dev < kNttCards ? ntt_blocks_per_sm[dev][LOG_M] : asked_blocks;
  int& sms = dev < kNttCards ? ntt_sms[dev] : asked_sms;
  if (blocks_per_sm == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, ntt_pass_kernel<LOG_M>, T::THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    if (blocks_per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  }
  // persistent blocks: as many as the card holds at once, each walking over tiles
  const int64_t n_cols = A * C;
  const int64_t n_tiles = (n_cols + T::COLS - 1) / T::COLS;
  int64_t grid = (int64_t)blocks_per_sm * sms;
  if (grid > n_tiles) grid = n_tiles;
  if (products != nullptr && grid > count_slots / T::THREADS) grid = count_slots / T::THREADS;
  ntt_pass_kernel<LOG_M><<<(unsigned)grid, T::THREADS, smem, stream>>>(x, tws, pre, scale, dst, out, C, n_cols,
                                                                        n_tiles, f, products);
  return (int)cudaGetLastError();
}

}  // namespace tzk

extern "C" {

// x, out: [A, m = 2^log_m, C, L] int32 16-bit limbs (out may not alias x);
// tws: [log_m, m/2, L] stage twiddles (Montgomery), of which only tws[0, 1:]
// is read (stage s slot j is tws[0, j << s], slot 0 is w^0); pre: [A, m, C, L]
// or null; scale: [L] (Montgomery) or null; dst: [A m C] int64 output row of
// each position, or null for the position itself.  products: null, or
// [A m C + 1024] uint64 whose first (grid x threads) words receive each
// thread's count of Montgomery products.  L = 16 only.
int tzk_ntt_pass(const void* x, const void* tws, const void* pre, const void* scale, const void* dst, void* out,
                 int64_t A, int log_m, int64_t C, int L, const uint32_t* p32, uint32_t n0inv, void* products,
                 void* stream) {
  using namespace tzk;
  if (L != 2 * kNttN || log_m < 0 || log_m > kNttMaxLogM || A <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const FieldParams f = make_params(p32, kNttN, n0inv);
  const auto* xs = static_cast<const uint32_t*>(x);
  const auto* tw = static_cast<const uint32_t*>(tws);
  const auto* pr = static_cast<const uint32_t*>(pre);
  const auto* sc = static_cast<const uint32_t*>(scale);
  const auto* ds = static_cast<const int64_t*>(dst);
  auto* o = static_cast<uint32_t*>(out);
  auto* cnt = static_cast<unsigned long long*>(products);
  auto st = static_cast<cudaStream_t>(stream);
  // the products buffer holds A m C + 1024 counts: at least the threads of every tile
  const int64_t count_slots = A * C * ((int64_t)1 << log_m) + 1024;
  switch (log_m) {
#define TZK_NTT_CASE(k) \
  case k:               \
    return ntt_launch<k>(xs, tw, pr, sc, ds, o, A, C, f, cnt, count_slots, st);
    TZK_NTT_CASE(0)
    TZK_NTT_CASE(1)
    TZK_NTT_CASE(2)
    TZK_NTT_CASE(3)
    TZK_NTT_CASE(4)
    TZK_NTT_CASE(5)
    TZK_NTT_CASE(6)
    TZK_NTT_CASE(7)
    TZK_NTT_CASE(8)
    TZK_NTT_CASE(9)
    TZK_NTT_CASE(10)
#undef TZK_NTT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
