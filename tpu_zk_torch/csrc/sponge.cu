// K7 -- the device Fiat-Shamir sponge, one warp a step, behind a plain C
// interface loaded with ctypes (tpu_zk_torch/_build.py builds this file with
// nvcc for sm_90a).  Two entry points launch the same kernel:
//
// tzk_sponge_step (the byte form): one step of the sponge.  Replaces the
// sponge of tpu_zk/transcript/device_fs.py, which runs as plain jnp (no
// Pallas) inside tpu_zk's fused provers: keccak_f1600_device :79,
// DeviceSponge.absorb/squeeze :262/:278, absorb_dyn :314, squeeze_dyn :341
// and digest_to_mont :356.  One sponge lives on the device as state [25]
// 64-bit lanes, buf [136] bytes (the unabsorbed tail; buf[pos:] is zero) and
// pos [1] int32.  A step absorbs k data bytes at pos, running Keccak-f for
// every full block, and, if asked, squeezes with sha3::Keccak256's
// clone-finalize semantics: pad a clone (0x01 at pos and 0x80 at byte 135,
// one 0x81 byte when pos = 135), permute it, write the 32-byte digest,
// absorb the digest into the live sponge, and write the challenge
// digest mod p in Montgomery form as [16] int32 16-bit limbs, digest * R^2
// by field.cuh's mont_mul (valid for any digest < 2^256 = R).
//
// tzk_sponge_round (the round form): a fused prover round's whole transcript
// step.  It takes the round's w Montgomery elements ([w, 16] 16-bit limbs),
// converts each out of Montgomery form (mont_mul by 1, K1's product, one
// thread an element), writes the plain limbs to the round's slot, packs them
// into 32 w bytes (big-endian elements for the basic round, as
// tpu_zk_torch.transcript.kernels.pack_bytes_be; little-endian for the GKR
// rounds, pack_bytes_le), absorbs them and squeezes with its challenge, as
// the byte form does.  It replaces tpu_zk's from_mont + pack + absorb_dyn +
// squeeze_dyn + digest_to_mont of a fused round (tpu_zk/sumcheck/fused.py),
// one launch where the port ran eight or more.
//
// Both update state, buf and pos in place on the caller's stream, so the
// rounds of a fused prover chain on the device without the host.
//
// Bound.  Latency: the permutations of a step run one after another, and
// however the 25 lanes are spread over threads, each Keccak round waits for
// a chain of 6 dependent 32-bit instructions (theta's parity, two
// three-input logic ops; its rotation by one; the lane xor both parities;
// rho; chi), 144 a permutation, each at the latency csrc/probe.cu's
// tzk_latency_probe measures; the launch itself comes on top (the probe's
// empty kernel).  A round of the fused provers absorbs 64 or 96 bytes and
// squeezes: one or two permutations.
//
// Design.  A sponge is a serial chain of permutations: nothing in it is
// parallel across rows, so a step is one warp, <<<1, 32>>>, and synchronizes
// with __syncwarp only.  Thread t < 25 holds lane t as two 32-bit halves and
// the permutation is spread over the warp (csrc/keccak.cuh
// keccak_f1600_warp): a round is ~34 instructions a thread, where the
// earlier layout's one thread issued all 180 of a round's, and its chain
// waits on three levels of shuffles.  On an H100 80GB HBM3 at 700 W the warp
// took 0.00213 ms a permutation, against 0.00476 for one thread with the
// rounds unrolled, 0.00508 for one thread looping over one round's code
// (the earlier layout) and 0.00234 for the warp with theta in one level of
// shuffles; the bound is 0.00030.  The three shuffle levels a round, not
// the 144 dependent logic ops, set its pace.
// The warp stages the data in shared memory (8-byte words where the data is
// aligned), copies it into the pending block side by side, and each of
// threads 0..16 XORs its own lane of a full block into its state.  The
// squeeze's clone is the same threads' registers; threads 0..3 write the
// digest, and thread 0 computes the challenge from the digest gathered by
// shuffles.  It allocates nothing.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "keccak.cuh"

namespace tzk {

constexpr int kSpongeThreads = 32;  // one warp
constexpr int kSpongeChunk = 4096;  // data bytes staged in shared memory at a time
constexpr int kRoundMaxElems = kSpongeChunk / 32;  // a round's elements, 32 bytes each, fit one chunk

struct SpongeParams {
  FieldParams f;
  uint32_t r2[8];  // R^2 mod p, 8 32-bit limbs
};

// Absorbs n bytes of shared memory into the sponge (lo, hi: this thread's
// lane; tail: the pending block; pos: its fill level).  Every thread of the
// warp calls it with the same n and pos.  tail[pos:] is zero on entry and on
// exit, and src is not read after it returns.
__device__ __forceinline__ void absorb_shared(uint32_t& lo, uint32_t& hi, const WarpKeccak& k, uint64_t* tail,
                                              int& pos, const uint8_t* src, int n) {
  const int t = threadIdx.x;
  uint8_t* tail8 = reinterpret_cast<uint8_t*>(tail);
  int i = 0;
  while (i < n) {
    const int take = min(n - i, kRate - pos);
    for (int j = t; j < take; j += kSpongeThreads) tail8[pos + j] = src[i + j];
    __syncwarp();
    pos += take;
    i += take;
    if (pos == kRate) {
      if (t < kRate / 8) {  // each rate lane into its own thread's state
        const uint64_t w = tail[t];
        lo ^= (uint32_t)w;
        hi ^= (uint32_t)(w >> 32);
        tail[t] = 0;
      }
      __syncwarp();
      keccak_f1600_warp(lo, hi, k);
      pos = 0;
    }
  }
}

// Stages n (<= kSpongeChunk) bytes of device memory in shared memory: 8-byte
// words when src is 8-byte aligned, bytes for the rest.
__device__ __forceinline__ void stage_bytes(uint64_t* dst, const uint8_t* __restrict__ src, int n) {
  const int t = threadIdx.x;
  uint8_t* dst8 = reinterpret_cast<uint8_t*>(dst);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 7) == 0) {
    const unsigned long long* src64 = reinterpret_cast<const unsigned long long*>(src);
    for (int j = t; j < n / 8; j += kSpongeThreads) dst[j] = __ldg(src64 + j);
    done = n & ~7;
  }
  for (int j = done + t; j < n; j += kSpongeThreads) dst8[j] = __ldg(src + j);
}

// Converts a round's w Montgomery elements (16-bit limbs) to plain form into
// slot and packs them into 32 w bytes in shared memory, element e at bytes
// 32 e.., big- or little-endian; one thread an element.
__device__ __forceinline__ void stage_round(uint64_t* dst, const uint32_t* __restrict__ mont, int w, bool big_endian,
                                            uint32_t* __restrict__ slot, const FieldParams& f) {
  const uint32_t one[8] = {1, 0, 0, 0, 0, 0, 0, 0};
  for (int e = threadIdx.x; e < w; e += kSpongeThreads) {
    uint32_t x[8], y[8];
    load_elem<8>(mont + 16 * e, x);
    mont_mul<8>(y, x, one, f);  // from_mont: x * 1 * R^-1, K1's product
    store_elem<8>(slot + 16 * e, y);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dst[4 * e + j] = big_endian
                           ? ((uint64_t)__byte_perm(y[6 - 2 * j], 0, 0x0123) << 32) | __byte_perm(y[7 - 2 * j], 0, 0x0123)
                           : ((uint64_t)y[2 * j + 1] << 32) | y[2 * j];
    }
  }
}

// The step: absorb the data bytes (data, k) or the round's packed elements
// (mont, w), then squeeze if digest is given.  One warp.
__global__ void __launch_bounds__(kSpongeThreads)
    sponge_kernel(uint64_t* __restrict__ state, uint64_t* __restrict__ buf, int32_t* __restrict__ pos_io,
                  const uint8_t* __restrict__ data, int64_t k, const uint32_t* __restrict__ mont, int w,
                  bool big_endian, uint32_t* __restrict__ slot, uint8_t* __restrict__ digest,
                  uint32_t* __restrict__ challenge, SpongeParams prm) {
  __shared__ uint64_t tail[kRate / 8];
  __shared__ uint64_t dig[4];
  __shared__ uint64_t staged[kSpongeChunk / 8];
  const int t = threadIdx.x;
  const WarpKeccak kk;

  int pos = *pos_io;
  if (t < kRate / 8) tail[t] = buf[t];
  const uint64_t lane = state[min(t, 24)];
  uint32_t lo = (uint32_t)lane, hi = (uint32_t)(lane >> 32);

  if (mont != nullptr) {
    stage_round(staged, mont, w, big_endian, slot, prm.f);
    __syncwarp();
    absorb_shared(lo, hi, kk, tail, pos, reinterpret_cast<const uint8_t*>(staged), 32 * w);
  }
  for (int64_t off = 0; off < k; off += kSpongeChunk) {
    const int n = k - off < kSpongeChunk ? (int)(k - off) : kSpongeChunk;
    stage_bytes(staged, data + off, n);
    __syncwarp();
    absorb_shared(lo, hi, kk, tail, pos, reinterpret_cast<const uint8_t*>(staged), n);
    __syncwarp();  // every thread has read the chunk before the next is staged
  }

  if (digest != nullptr) {
    // finalize a clone in the same registers: the tail, 0x01 after it, 0x80 in the block's last byte
    uint32_t clo = lo, chi = hi;
    if (t < kRate / 8) {
      uint64_t padded = tail[t];
      if (t == pos / 8) padded ^= 0x01ull << (8 * (pos % 8));
      if (t == kRate / 8 - 1) padded ^= 0x80ull << 56;
      clo ^= (uint32_t)padded;
      chi ^= (uint32_t)(padded >> 32);
    }
    keccak_f1600_warp(clo, chi, kk);
    if (t < 4) {
      const uint64_t d = ((uint64_t)chi << 32) | clo;
      dig[t] = d;
      if ((reinterpret_cast<uintptr_t>(digest) & 7) == 0) {
        reinterpret_cast<uint64_t*>(digest)[t] = d;
      } else {
        for (int b = 0; b < 8; ++b) digest[8 * t + b] = (uint8_t)(d >> (8 * b));
      }
    }
    // the digest as 8 little-endian 32-bit limbs (< 2^256 = R), on every thread
    uint32_t x[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[2 * j] = __shfl_sync(kFullWarp, clo, j);
      x[2 * j + 1] = __shfl_sync(kFullWarp, chi, j);
    }
    __syncwarp();
    absorb_shared(lo, hi, kk, tail, pos, reinterpret_cast<const uint8_t*>(dig), 32);
    if (challenge != nullptr && t == 0) {  // (digest mod p) R = digest * R^2 * R^-1
      uint32_t y[8];
      mont_mul<8>(y, x, prm.r2, prm.f);
      store_elem<8>(challenge, y);
    }
  }

  if (t < 25) state[t] = ((uint64_t)hi << 32) | lo;
  if (t < kRate / 8) buf[t] = tail[t];
  if (t == 0) *pos_io = pos;
}

static SpongeParams sponge_params(const uint32_t* p32, uint32_t n0inv, const uint32_t* r2_32) {
  SpongeParams prm{};
  prm.f = make_params(p32, 8, n0inv);
  for (int j = 0; j < 8; ++j) prm.r2[j] = r2_32[j];
  return prm;
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
  const SpongeParams prm = challenge != nullptr ? sponge_params(p32, n0inv, r2_32) : SpongeParams{};
  sponge_kernel<<<1, kSpongeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint64_t*>(state), static_cast<uint64_t*>(buf), static_cast<int32_t*>(pos),
      static_cast<const uint8_t*>(data), k, nullptr, 0, false, nullptr, static_cast<uint8_t*>(digest),
      static_cast<uint32_t*>(challenge), prm);
  return (int)cudaGetLastError();
}

// The round form, L = 16 only: state, buf, pos as above; mont: [w, 16] int32
// Montgomery limbs (16-byte aligned), 1 <= w <= 128; big_endian: 1 for
// big-endian elements, 0 for little-endian; slot: [w, 16] int32 (16-byte
// aligned), receives the plain limbs; digest: [32] uint8; challenge: [16]
// int32 (16-byte aligned); the field as for tzk_sponge_step.
int tzk_sponge_round(void* state, void* buf, void* pos, const void* mont, int w, int big_endian, void* slot,
                     void* digest, void* challenge, const uint32_t* p32, uint32_t n0inv, const uint32_t* r2_32,
                     void* stream) {
  using namespace tzk;
  if (w < 1 || w > kRoundMaxElems || mont == nullptr || slot == nullptr || digest == nullptr || challenge == nullptr)
    return (int)cudaErrorInvalidValue;
  sponge_kernel<<<1, kSpongeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint64_t*>(state), static_cast<uint64_t*>(buf), static_cast<int32_t*>(pos), nullptr, 0,
      static_cast<const uint32_t*>(mont), w, big_endian != 0, static_cast<uint32_t*>(slot),
      static_cast<uint8_t*>(digest), static_cast<uint32_t*>(challenge), sponge_params(p32, n0inv, r2_32));
  return (int)cudaGetLastError();
}

}  // extern "C"
