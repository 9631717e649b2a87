// K5 tzk_keccak_rows -- one-block Keccak-256 of many short byte rows, behind
// a plain C interface loaded with ctypes (tpu_zk_torch/_build.py builds this
// file with nvcc for sm_90a).
//
// Replaces tpu_zk/merkle/device_merkle.py:81 _hash_block_T_pallas (body
// _keccak_hash_kernel :41): [N, w <= 135] byte rows -> [N, 32] digests, each
// row one padded 136-byte block (0x01 at byte w, 0x80 at byte 135; one 0x81
// byte when w = 135), one Keccak-f[1600] permutation, the first four lanes
// out.  This is every hash of a Merkle tree over 32-byte field leaves and of
// its 64-byte nodes.
//
// Design.  One thread per row.  The 25 64-bit lanes live in registers (each
// a pair of 32-bit registers), the 24 rounds are unrolled with the rho
// rotations as constants, so every rotation is two funnel shifts and chi's
// b ^ (~c & d) one three-input logic op per half.  A row whose width is a
// multiple of 8 is read as 8-byte words, any other width byte by byte.  The
// TPU kernel kept the batch on the vector lanes and the state in VMEM; here
// nothing but the row and its digest touches device memory.
//
// Bound.  By integer operations: a full round needs 180 32-bit logic and
// shift instructions (theta's column parities 20 and the rotations of its
// parities 10, its application A ^ C[x-1] ^ rot1(C[x+1]) one three-input op
// a half, 50; rho 48 funnel shifts, chi 50, iota 2).  The first round needs
// fewer where the padded block leaves lanes zero and the last computes only
// the digest's four lanes: 4,141 for a 32-byte row and 4,155 for a 64-byte
// one (chip_smoke.py's keccak_ops).  So 2^25 hashes (one 2^24-leaf tree)
// are ~1.4 x 10^11 of them against 64 bytes in and 32 out per hash.
// chip_smoke.py probes the card's rate of such instructions (csrc/probe.cu)
// for the bound it reports.  This kernel computes D apart (10 more a round)
// and every round in full.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace tzk {

constexpr int kKeccakThreads = 128;
constexpr int kRate = 136;

__constant__ uint64_t kKeccakRC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull, 0x8000000080008000ull,
    0x000000000000808Bull, 0x0000000080000001ull, 0x8000000080008081ull, 0x8000000000008009ull,
    0x000000000000008Aull, 0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull, 0x8000000000008003ull,
    0x8000000000008002ull, 0x8000000000000080ull, 0x000000000000800Aull, 0x800000008000000Aull,
    0x8000000080008081ull, 0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int s) { return (x << s) | (x >> (64 - s)); }

// Keccak-f[1600] on 25 lanes, lane (x, y) at A[x + 5 y].
__device__ __forceinline__ void keccak_f1600(uint64_t (&A)[25]) {
#pragma unroll
  for (int r = 0; r < 24; ++r) {
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
    A[0] ^= kKeccakRC[r];
  }
}

__global__ void __launch_bounds__(kKeccakThreads)
    keccak_rows_kernel(const uint8_t* __restrict__ data, uint8_t* __restrict__ out, int64_t n, int w, int words) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t* row = data + i * w;
  uint64_t A[25];
  if (words) {  // w % 8 == 0 and the rows 8-byte aligned
    const unsigned long long* row64 = reinterpret_cast<const unsigned long long*>(row);
#pragma unroll
    for (int k = 0; k < kRate / 8; ++k) A[k] = 8 * k < w ? __ldg(row64 + k) : 0;
  } else {
#pragma unroll
    for (int k = 0; k < kRate / 8; ++k) {
      uint64_t lane = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        if (8 * k + b < w) lane |= (uint64_t)__ldg(row + 8 * k + b) << (8 * b);
      }
      A[k] = lane;
    }
  }
#pragma unroll
  for (int k = kRate / 8; k < 25; ++k) A[k] = 0;
  // padding: 0x01 after the message, 0x80 in the block's last byte
#pragma unroll
  for (int k = 0; k < kRate / 8; ++k) {
    if (k == w / 8) A[k] ^= 0x01ull << (8 * (w % 8));
  }
  A[kRate / 8 - 1] ^= 0x80ull << 56;

  keccak_f1600(A);

  ulonglong2* o = reinterpret_cast<ulonglong2*>(out + i * 32);
  o[0] = make_ulonglong2(A[0], A[1]);
  o[1] = make_ulonglong2(A[2], A[3]);
}

}  // namespace tzk

extern "C" {

// data: [n, w] uint8 rows (0 <= w <= 135); out: [n, 32] uint8, 16-byte aligned.
int tzk_keccak_rows(const void* data, void* out, int64_t n, int w, void* stream) {
  using namespace tzk;
  if (w < 0 || w >= kRate || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int64_t blocks = (n + kKeccakThreads - 1) / kKeccakThreads;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;
  const int words = w % 8 == 0 && reinterpret_cast<uintptr_t>(data) % 8 == 0;
  keccak_rows_kernel<<<(unsigned)blocks, kKeccakThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<uint8_t*>(out), n, w, words);
  return (int)cudaGetLastError();
}

}  // extern "C"
