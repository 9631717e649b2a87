// The Keccak-f[1600] permutation shared by K5 (csrc/keccak.cu, many rows at
// once) and K7 (csrc/sponge.cu, one sponge).
//
// 25 64-bit lanes in registers, lane (x, y) at A[x + 5 y].  A round's rho
// rotations are constants, so every rotation is two funnel shifts and chi's
// b ^ (~c & d) one three-input logic op per 32-bit half.  K5 unrolls all 24
// rounds (keccak_f1600); K7, one thread that runs a chain of permutations,
// keeps one round's code and loops over the rounds (keccak_f1600_rolled), so
// the permutation stays in the instruction cache.
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

// Keccak-f[1600], one round's code run 24 times.
__device__ __forceinline__ void keccak_f1600_rolled(uint64_t (&A)[25]) {
#pragma unroll 1
  for (int r = 0; r < 24; ++r) keccak_round(A, kKeccakRC[r]);
}

}  // namespace tzk
