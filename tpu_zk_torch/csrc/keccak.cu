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
// rotations as constants (csrc/keccak.cuh), so every rotation is two funnel
// shifts and chi's b ^ (~c & d) one three-input logic op per half.  A row whose width is a
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

#include "keccak.cuh"

namespace tzk {

constexpr int kKeccakThreads = 128;

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
