// Prime-field arithmetic over 32-bit limbs for the port's CUDA kernels.
//
// Tensors hold an element as L = 2N int32 words, each a 16-bit limb (the
// layout of tpu_zk_torch.fields.arith).  A thread repacks them into N 32-bit
// limbs on load and back on store.  The Montgomery radix is R = 2^(16L) =
// 2^(32N) in both layouts, so the N 32-bit limbs hold the same Montgomery
// integer and every result is the same canonical integer as the plain
// 16-bit CIOS.  The 32-bit CIOS needs -p^{-1} mod 2^32 (FieldParams.n0inv),
// not the 16-bit layout's -p^{-1} mod 2^16.
//
// Every function assumes canonical inputs (< p) and 2p < 2^(32N), which
// holds for all four fields (BN254 Fq/Fr, BLS12-381 Fr with N = 8;
// BLS12-381 Fq with N = 12).
#pragma once

#include <cstdint>

namespace tzk {

constexpr int kMaxLimbs32 = 12;

struct FieldParams {
  uint32_t p[kMaxLimbs32];  // modulus, little-endian 32-bit limbs
  uint32_t n0inv;           // -p^{-1} mod 2^32
};

// The kernel argument from the wrapper's n 32-bit modulus limbs (host side).
inline FieldParams make_params(const uint32_t* p32, int n, uint32_t n0inv) {
  FieldParams f{};
  for (int j = 0; j < n; ++j) f.p[j] = p32[j];
  f.n0inv = n0inv;
  return f;
}

// 2N 16-bit limbs in int32 words (16-byte aligned) -> N 32-bit limbs.
template <int N>
__device__ __forceinline__ void load_elem(const uint32_t* __restrict__ src, uint32_t (&x)[N]) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int q = 0; q < N / 2; ++q) {
    const uint4 w = __ldg(s + q);
    x[2 * q] = w.x | (w.y << 16);
    x[2 * q + 1] = w.z | (w.w << 16);
  }
}

template <int N>
__device__ __forceinline__ void store_elem(uint32_t* __restrict__ dst, const uint32_t (&x)[N]) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int q = 0; q < N / 2; ++q) {
    d[q] = make_uint4(x[2 * q] & 0xFFFFu, x[2 * q] >> 16, x[2 * q + 1] & 0xFFFFu, x[2 * q + 1] >> 16);
  }
}

// x <- x - p if (hi:x) >= p.  (hi:x) < 2p.
template <int N>
__device__ __forceinline__ void sub_p_if_ge(uint32_t (&x)[N], uint32_t hi, const FieldParams& f) {
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint64_t s = (uint64_t)x[j] - f.p[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool ge = hi != 0 || borrow == 0;
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] = ge ? d[j] : x[j];
}

// out = a + b mod p
template <int N>
__device__ __forceinline__ void mod_add(uint32_t (&out)[N], const uint32_t (&a)[N], const uint32_t (&b)[N],
                                        const FieldParams& f) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint64_t s = (uint64_t)a[j] + b[j] + c;
    out[j] = (uint32_t)s;
    c = s >> 32;
  }
  sub_p_if_ge<N>(out, (uint32_t)c, f);
}

// out = a - b mod p
template <int N>
__device__ __forceinline__ void mod_sub(uint32_t (&out)[N], const uint32_t (&a)[N], const uint32_t (&b)[N],
                                        const FieldParams& f) {
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint64_t s = (uint64_t)a[j] - b[j] - borrow;
    out[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  // a < b: add p back (the carry out of the top limb cancels the borrow)
  const uint32_t mask = 0u - borrow;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint64_t s = (uint64_t)out[j] + (f.p[j] & mask) + c;
    out[j] = (uint32_t)s;
    c = s >> 32;
  }
}

// out = a * b * 2^(-32N) mod p: CIOS over 32-bit limbs.  Each 32x32 -> 64-bit
// product compiles to one mul.wide.u32 (or a mad.lo/mad.hi pair); the sum
// a[i]*b[j] + t[j] + carry never exceeds 2^64 - 1.
template <int N>
__device__ __forceinline__ void mont_mul(uint32_t (&out)[N], const uint32_t (&a)[N], const uint32_t (&b)[N],
                                         const FieldParams& f) {
  uint32_t t[N + 2];
#pragma unroll
  for (int j = 0; j < N + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const uint64_t s = (uint64_t)a[i] * b[j] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);

    const uint32_t m = t[0] * f.n0inv;
    s = (uint64_t)m * f.p[0] + t[0];  // low word is 0 by the choice of m
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      s = (uint64_t)m * f.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  // (t[N]:t) = (a*b + M*p) / R < 2p
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = t[j];
  sub_p_if_ge<N>(out, t[N], f);
}

}  // namespace tzk
