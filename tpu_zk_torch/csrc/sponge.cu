// K7 tzk_sponge_step -- one step of the device Fiat-Shamir sponge, behind a
// plain C interface loaded with ctypes (tpu_zk_torch/_build.py builds this
// file with nvcc for sm_90a).
//
// Replaces the sponge of tpu_zk/transcript/device_fs.py, which runs as plain
// jnp (no Pallas) inside tpu_zk's fused provers: keccak_f1600_device :79,
// DeviceSponge.absorb/squeeze :262/:278, absorb_dyn :314, squeeze_dyn :341
// and digest_to_mont :356.  One sponge lives on the device as state [25]
// 64-bit lanes, buf [136] bytes (the unabsorbed tail; buf[pos:] is zero) and
// pos [1] int32.  A step absorbs k data bytes at pos, running Keccak-f for
// every full block, and, if asked, squeezes with sha3::Keccak256's
// clone-finalize semantics: pad a clone (0x01 at pos and 0x80 at byte 135,
// one 0x81 byte when pos = 135), permute it, write the 32-byte digest,
// absorb the digest into the live sponge, and write the challenge
// digest mod p in Montgomery form as [16] int32 16-bit limbs, digest * R^2
// by field.cuh's mont_mul (valid for any digest < 2^256 = R).  It updates
// state, buf and pos in place on the caller's stream, so the rounds of a
// fused prover chain on the device without the host.
//
// Design.  A sponge is a serial chain of permutations: nothing in it is
// parallel across rows.  One block of 128 threads: the threads stage the
// data and the tail in shared memory and copy bytes into the pending block
// side by side, and thread 0 holds the 25 lanes in registers and runs every
// permutation (one round's code looped 24 times, csrc/keccak.cuh, so that
// the chain stays in the instruction cache).  It allocates nothing.
//
// Bound.  Latency: the permutations of the step run one after another, and
// however the 25 lanes were spread over threads, each Keccak round waits for
// a chain of 6 dependent 32-bit instructions (theta's parity, two three-input
// logic ops; its rotation by one; the lane xor both parities; rho; chi), 144
// a permutation, each at the latency csrc/probe.cu's tzk_latency_probe
// measures; the launch itself comes on top (the probe's empty kernel).  This
// kernel's one thread issues all 4,320 instructions of a permutation in
// turn, so it runs well above that bound.  A round of the fused provers
// absorbs 64 or 96 bytes and squeezes: one or two permutations.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "keccak.cuh"

namespace tzk {

constexpr int kSpongeThreads = 128;
constexpr int kSpongeChunk = 4096;  // data bytes staged in shared memory at a time

struct SpongeParams {
  FieldParams f;
  uint32_t r2[8];  // R^2 mod p, 8 32-bit limbs
};

// Absorbs n bytes of shared memory into the sponge (A, sbuf, pos).  Every
// thread of the block calls it with the same n and pos: the threads copy
// bytes into the pending block side by side, and thread 0, whose A is the
// state, permutes each full block.  sbuf[pos:] is zero on entry and on exit.
__device__ __forceinline__ void absorb_shared(uint64_t (&A)[25], uint8_t* sbuf, int& pos, const uint8_t* src,
                                              int n) {
  int i = 0;
  while (i < n) {
    const int take = min(n - i, kRate - pos);
    for (int j = threadIdx.x; j < take; j += blockDim.x) sbuf[pos + j] = src[i + j];
    __syncthreads();
    pos += take;
    i += take;
    if (pos == kRate) {
      if (threadIdx.x == 0) {
        const uint64_t* lanes = reinterpret_cast<const uint64_t*>(sbuf);
#pragma unroll
        for (int j = 0; j < kRate / 8; ++j) A[j] ^= lanes[j];
        keccak_f1600_rolled(A);
      }
      __syncthreads();
      for (int j = threadIdx.x; j < kRate; j += blockDim.x) sbuf[j] = 0;
      __syncthreads();
      pos = 0;
    }
  }
}

__global__ void __launch_bounds__(kSpongeThreads)
    sponge_step_kernel(uint64_t* __restrict__ state, uint8_t* __restrict__ buf, int32_t* __restrict__ pos_io,
                       const uint8_t* __restrict__ data, int64_t k, uint8_t* __restrict__ digest,
                       uint32_t* __restrict__ challenge, SpongeParams prm) {
  __shared__ uint64_t sbuf64[kRate / 8];
  __shared__ uint64_t sdig64[4];
  __shared__ uint8_t sdata[kSpongeChunk];
  uint8_t* sbuf = reinterpret_cast<uint8_t*>(sbuf64);

  int pos = *pos_io;
  for (int j = threadIdx.x; j < kRate; j += blockDim.x) sbuf[j] = buf[j];
  uint64_t A[25];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 25; ++j) A[j] = state[j];
  }
  __syncthreads();

  for (int64_t off = 0; off < k; off += kSpongeChunk) {
    const int n = k - off < kSpongeChunk ? (int)(k - off) : kSpongeChunk;
    for (int j = threadIdx.x; j < n; j += blockDim.x) sdata[j] = data[off + j];
    __syncthreads();
    absorb_shared(A, sbuf, pos, sdata, n);
    __syncthreads();
  }

  if (digest != nullptr) {
    if (threadIdx.x == 0) {
      // finalize a clone: the tail, 0x01 after it, 0x80 in the block's last byte
      uint64_t C[25];
      const uint64_t* lanes = reinterpret_cast<const uint64_t*>(sbuf);
#pragma unroll
      for (int j = 0; j < 25; ++j) C[j] = A[j];
#pragma unroll
      for (int j = 0; j < kRate / 8; ++j) {
        uint64_t lane = lanes[j];
        if (j == pos / 8) lane ^= 0x01ull << (8 * (pos % 8));
        C[j] ^= lane;
      }
      C[kRate / 8 - 1] ^= 0x80ull << 56;
      keccak_f1600_rolled(C);
#pragma unroll
      for (int j = 0; j < 4; ++j) sdig64[j] = C[j];
      const uint8_t* dig = reinterpret_cast<const uint8_t*>(sdig64);
      for (int b = 0; b < 32; ++b) digest[b] = dig[b];
      if (challenge != nullptr) {
        // the digest as 8 little-endian 32-bit limbs (< 2^256 = R) times R^2: (digest mod p) R
        uint32_t x[8], y[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          x[2 * j] = (uint32_t)C[j];
          x[2 * j + 1] = (uint32_t)(C[j] >> 32);
        }
        mont_mul<8>(y, x, prm.r2, prm.f);
        store_elem<8>(challenge, y);
      }
    }
    __syncthreads();
    absorb_shared(A, sbuf, pos, reinterpret_cast<const uint8_t*>(sdig64), 32);
  }

  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 25; ++j) state[j] = A[j];
    *pos_io = pos;
  }
  for (int j = threadIdx.x; j < kRate; j += blockDim.x) buf[j] = sbuf[j];
}

}  // namespace tzk

extern "C" {

// state: [25] 64-bit lanes (8-byte aligned); buf: [136] uint8 (8-byte
// aligned); pos: [1] int32 in [0, 136); data: [k] uint8, any alignment.
// digest: [32] uint8 or null (no squeeze); challenge: [L] int32 (16-byte
// aligned) or null, only with a digest and only for L = 16, with the
// modulus p32, n0inv = -p^{-1} mod 2^32 and R^2 mod p as 8 32-bit limbs.
int tzk_sponge_step(void* state, void* buf, void* pos, const void* data, int64_t k, void* digest, void* challenge,
                    int L, const uint32_t* p32, uint32_t n0inv, const uint32_t* r2_32, void* stream) {
  using namespace tzk;
  if (k < 0 || (challenge != nullptr && (digest == nullptr || L != 16))) return (int)cudaErrorInvalidValue;
  SpongeParams prm{};
  if (challenge != nullptr) {
    prm.f = make_params(p32, 8, n0inv);
    for (int j = 0; j < 8; ++j) prm.r2[j] = r2_32[j];
  }
  sponge_step_kernel<<<1, kSpongeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint64_t*>(state), static_cast<uint8_t*>(buf), static_cast<int32_t*>(pos),
      static_cast<const uint8_t*>(data), k, static_cast<uint8_t*>(digest), static_cast<uint32_t*>(challenge), prm);
  return (int)cudaGetLastError();
}

}  // extern "C"
