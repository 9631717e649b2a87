// The Keccak-f[1600] permutation in two layouts.
//
// One thread (K5, csrc/keccak.cu, many rows at once): 25 64-bit lanes in
// registers, lane (x, y) at A[x + 5 y].  A round's rho rotations are
// constants, so every rotation is two funnel shifts and chi's b ^ (~c & d)
// one three-input logic op per 32-bit half.  keccak_f1600 unrolls all 24
// rounds.
//
// One warp (K7, csrc/sponge.cu, one sponge): keccak_f1600_warp spreads the
// 25 lanes over the threads of a warp, lane t on thread t as two 32-bit
// halves, and moves lanes between threads with __shfl_sync (WarpKeccak).
#pragma once

#include <cstdint>

namespace tzk {

constexpr int kRate = 136;  // Keccak-256's rate in bytes: 17 lanes

static __constant__ uint64_t kKeccakRC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull, 0x8000000080008000ull,
    0x000000000000808Bull, 0x0000000080000001ull, 0x8000000080008081ull, 0x8000000000008009ull,
    0x000000000000008Aull, 0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull, 0x8000000000008003ull,
    0x8000000000008002ull, 0x8000000000000080ull, 0x000000000000800Aull, 0x800000008000000Aull,
    0x8000000080008081ull, 0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int s) { return (x << s) | (x >> (64 - s)); }

// One round with round constant rc.
__device__ __forceinline__ void keccak_round(uint64_t (&A)[25], uint64_t rc) {
  uint64_t C[5], D[5], B[25];
#pragma unroll
  for (int x = 0; x < 5; ++x) C[x] = A[x] ^ A[x + 5] ^ A[x + 10] ^ A[x + 15] ^ A[x + 20];
#pragma unroll
  for (int x = 0; x < 5; ++x) D[x] = C[(x + 4) % 5] ^ rotl64(C[(x + 1) % 5], 1);
  // theta's D, rho and pi: B[y + 5 ((2x + 3y) % 5)] = rotl(A[x + 5y] ^ D[x], r[x][y])
  B[0] = A[0] ^ D[0];
  B[1] = rotl64(A[6] ^ D[1], 44);
  B[2] = rotl64(A[12] ^ D[2], 43);
  B[3] = rotl64(A[18] ^ D[3], 21);
  B[4] = rotl64(A[24] ^ D[4], 14);
  B[5] = rotl64(A[3] ^ D[3], 28);
  B[6] = rotl64(A[9] ^ D[4], 20);
  B[7] = rotl64(A[10] ^ D[0], 3);
  B[8] = rotl64(A[16] ^ D[1], 45);
  B[9] = rotl64(A[22] ^ D[2], 61);
  B[10] = rotl64(A[1] ^ D[1], 1);
  B[11] = rotl64(A[7] ^ D[2], 6);
  B[12] = rotl64(A[13] ^ D[3], 25);
  B[13] = rotl64(A[19] ^ D[4], 8);
  B[14] = rotl64(A[20] ^ D[0], 18);
  B[15] = rotl64(A[4] ^ D[4], 27);
  B[16] = rotl64(A[5] ^ D[0], 36);
  B[17] = rotl64(A[11] ^ D[1], 10);
  B[18] = rotl64(A[17] ^ D[2], 15);
  B[19] = rotl64(A[23] ^ D[3], 56);
  B[20] = rotl64(A[2] ^ D[2], 62);
  B[21] = rotl64(A[8] ^ D[3], 55);
  B[22] = rotl64(A[14] ^ D[4], 39);
  B[23] = rotl64(A[15] ^ D[0], 41);
  B[24] = rotl64(A[21] ^ D[1], 2);
  // chi
#pragma unroll
  for (int y = 0; y < 25; y += 5) {
#pragma unroll
    for (int x = 0; x < 5; ++x) A[y + x] = B[y + x] ^ (~B[y + (x + 1) % 5] & B[y + (x + 2) % 5]);
  }
  // iota
  A[0] ^= rc;
}

// Keccak-f[1600], the 24 rounds unrolled.
__device__ __forceinline__ void keccak_f1600(uint64_t (&A)[25]) {
#pragma unroll
  for (int r = 0; r < 24; ++r) keccak_round(A, kKeccakRC[r]);
}

// rho's rotation of lane x + 5 y, packed 10 lanes (6 bits each) a word so a
// thread finds its own with shifts and no table lookup
constexpr int kRho[25] = {0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14};
constexpr uint64_t rho_word(int w) {
  uint64_t v = 0;
  for (int i = 0; i < 10 && 10 * w + i < 25; ++i) v |= (uint64_t)kRho[10 * w + i] << (6 * i);
  return v;
}
constexpr uint64_t kRhoWord0 = rho_word(0), kRhoWord1 = rho_word(1), kRhoWord2 = rho_word(2);
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

// pi: lane X + 5 Y of the result comes from lane ((X + 3 Y) % 5) + 5 X
__device__ __forceinline__ int pi_source(int X, int Y) { return (X + 3 * Y) % 5 + 5 * X; }

// One thread's part of keccak_f1600_warp: thread t < 25 holds lane t = x + 5 y,
// threads 25..31 a copy of lane 24 that no thread reads.  Every lane a thread
// reads is below 25.  Made once a kernel.
struct WarpKeccak {
  int column[4];     // theta: the other lanes of this lane's column, (x, y + 1..4)
  int left, right;   // theta: the lanes (x - 1, y) and (x + 1, y), whose column parities make D
  int src[3];        // pi and chi: B[j], B[chi1(j)], B[chi2(j)] are these lanes after rho
  int shift;         // rho: the rotation mod 32 ...
  bool swap;         // ... and whether it is 32 or more (the halves swap first)
  uint32_t iota;     // all ones on thread 0, whose lane takes the round constant

  __device__ __forceinline__ WarpKeccak() {
    const int t = min((int)(threadIdx.x & 31), 24);
    const int x = t % 5, y = t / 5;
#pragma unroll
    for (int k = 0; k < 4; ++k) column[k] = x + 5 * ((y + 1 + k) % 5);
    left = (x + 4) % 5 + 5 * y;
    right = (x + 1) % 5 + 5 * y;
    src[0] = pi_source(x, y);
    src[1] = pi_source((x + 1) % 5, y);
    src[2] = pi_source((x + 2) % 5, y);
    const uint64_t word = t < 10 ? kRhoWord0 : (t < 20 ? kRhoWord1 : kRhoWord2);
    const int r = (int)((word >> (6 * (t % 10))) & 63);
    shift = r & 31;
    swap = r >= 32;
    iota = threadIdx.x == 0 ? 0xFFFFFFFFu : 0u;
  }
};

// Keccak-f[1600] over one warp, every thread calling it together with its own
// lane's halves (lo, hi).  A round: theta's column parity from the column's
// four other lanes, then D from the parities of lanes (x - 1, y) and
// (x + 1, y) (two levels of shuffles), rho by the thread's own rotation, pi
// and chi together (each thread reads the three rotated lanes its chi needs,
// one level), iota on thread 0.
__device__ __forceinline__ void keccak_f1600_warp(uint32_t& lo, uint32_t& hi, const WarpKeccak& k) {
#pragma unroll 1
  for (int r = 0; r < 24; ++r) {
    uint32_t clo = lo, chi = hi;  // this lane's column parity
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      clo ^= __shfl_sync(kFullWarp, lo, k.column[j]);
      chi ^= __shfl_sync(kFullWarp, hi, k.column[j]);
    }
    // the column parities C[x - 1] and C[x + 1]
    const uint32_t llo = __shfl_sync(kFullWarp, clo, k.left), lhi = __shfl_sync(kFullWarp, chi, k.left);
    const uint32_t rlo = __shfl_sync(kFullWarp, clo, k.right), rhi = __shfl_sync(kFullWarp, chi, k.right);
    // theta: A ^= C[x - 1] ^ rotl(C[x + 1], 1)
    lo ^= llo ^ __funnelshift_l(rhi, rlo, 1);
    hi ^= lhi ^ __funnelshift_l(rlo, rhi, 1);
    // rho: the halves swapped for a rotation by 32 or more, then two funnel shifts
    const uint32_t a = k.swap ? hi : lo;  // the low half after the swap
    const uint32_t b = k.swap ? lo : hi;
    const uint32_t plo = __funnelshift_l(b, a, k.shift);
    const uint32_t phi = __funnelshift_l(a, b, k.shift);
    // pi and chi: B[j] ^ (~B[chi1(j)] & B[chi2(j)]); iota
    const uint32_t b0l = __shfl_sync(kFullWarp, plo, k.src[0]), b0h = __shfl_sync(kFullWarp, phi, k.src[0]);
    const uint32_t b1l = __shfl_sync(kFullWarp, plo, k.src[1]), b1h = __shfl_sync(kFullWarp, phi, k.src[1]);
    const uint32_t b2l = __shfl_sync(kFullWarp, plo, k.src[2]), b2h = __shfl_sync(kFullWarp, phi, k.src[2]);
    const uint64_t rc = kKeccakRC[r];
    lo = b0l ^ (~b1l & b2l) ^ ((uint32_t)rc & k.iota);
    hi = b0h ^ (~b1h & b2h) ^ ((uint32_t)(rc >> 32) & k.iota);
  }
}

}  // namespace tzk
