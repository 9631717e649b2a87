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

// The same product as mont_mul, the same integer out: CIOS whose rows split
// by the parity of the limb index.  The products a[j] * b_i of even j fill
// the words j, j + 1 of one accumulator (ev: the words 0..N-1 of the running
// sum T), those of odd j the other (od: the words 1..N), so a row is two carry
// chains of mad.lo.cc / madc.hi.cc, one 32-bit multiply-add each half product,
// with no separate additions.  Dividing T by 2^32 after a row's reduction swaps
// the two roles: od becomes the words 0..N-1, and the old ev, two words out of
// step, is shifted into the next row's odd chain.  The carry flag runs from one
// asm statement to the next, as the chains need.  N even and p < 2^(32N - 1)
// (all four fields): T < 2p 2^32 < 2^(32(N+1)) before each division, so no chain
// carries out of its top word.
namespace eo {

// One PTX instruction an asm statement, so no output can share a register with
// a later input; asm volatile keeps their order, and the carry flag with it.
#define TZK_CC_OP(name, op)                                                          \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b, uint32_t c) {    \
    uint32_t r;                                                                      \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));          \
    return r;                                                                        \
  }
TZK_CC_OP(mad_lo_cc, "mad.lo.cc.u32")
TZK_CC_OP(madc_lo_cc, "madc.lo.cc.u32")
TZK_CC_OP(madc_hi_cc, "madc.hi.cc.u32")
TZK_CC_OP(madc_hi, "madc.hi.u32")
#undef TZK_CC_OP

__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// acc[0..N-1] += a[0] bi + a[2] bi 2^64 + ... (lo, hi of each into two words); the carry out is left in CC
template <int N>
__device__ __forceinline__ void mad_chain(uint32_t (&acc)[N], const uint32_t* a, uint32_t bi) {
  acc[0] = mad_lo_cc(a[0], bi, acc[0]);
  acc[1] = madc_hi_cc(a[0], bi, acc[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    acc[j] = madc_lo_cc(a[j], bi, acc[j]);
    acc[j + 1] = madc_hi_cc(a[j], bi, acc[j + 1]);
  }
}

// T <- T + m p with m = ev[0] n0inv, so that ev[0] becomes 0
template <int N>
__device__ __forceinline__ void redc_row(uint32_t (&ev)[N], uint32_t (&od)[N], const FieldParams& f) {
  const uint32_t m = ev[0] * f.n0inv;
  mad_chain<N>(od, f.p + 1, m);  // words 1..N; no carry out (bound above)
  mad_chain<N>(ev, f.p, m);
  od[N - 1] = addc(od[N - 1], 0);
}

// One row after the first: T <- T / 2^32 + a bi, then its reduction.  On entry x
// holds the words 1..N and y the words 0..N-1 with y[0] = 0; on return x holds
// the words 0..N-1 and y the words 1..N.
template <int N>
__device__ __forceinline__ void row(uint32_t (&x)[N], uint32_t (&y)[N], const uint32_t (&a)[N], uint32_t bi,
                                    const FieldParams& f) {
  x[0] = add_cc(x[0], y[1]);
#pragma unroll
  for (int k = 0; k + 2 < N; k += 2) {  // odd products, with y moved down two words
    y[k] = madc_lo_cc(a[k + 1], bi, y[k + 2]);
    y[k + 1] = madc_hi_cc(a[k + 1], bi, y[k + 3]);
  }
  y[N - 2] = madc_lo_cc(a[N - 1], bi, 0);
  y[N - 1] = madc_hi(a[N - 1], bi, 0);
  mad_chain<N>(x, a, bi);
  y[N - 1] = addc(y[N - 1], 0);
  redc_row<N>(x, y, f);
}

__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

}  // namespace eo

// The same results as mod_add and mod_sub, by carry chains of add.cc / sub.cc
// (one instruction a word where the 64-bit sums above take two or three).
template <int N>
__device__ __forceinline__ void mod_add_cc(uint32_t (&out)[N], const uint32_t (&a)[N], const uint32_t (&b)[N],
                                           const FieldParams& f) {
  uint32_t s[N], d[N];
  s[0] = eo::add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < N; ++j) s[j] = eo::addc_cc(a[j], b[j]);
  const uint32_t top = eo::addc(0, 0);
  d[0] = eo::sub_cc(s[0], f.p[0]);
#pragma unroll
  for (int j = 1; j < N; ++j) d[j] = eo::subc_cc(s[j], f.p[j]);
  const uint32_t below = eo::subc(top, 0);  // all ones where a + b < p
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = below ? s[j] : d[j];
}

template <int N>
__device__ __forceinline__ void mod_sub_cc(uint32_t (&out)[N], const uint32_t (&a)[N], const uint32_t (&b)[N],
                                           const FieldParams& f) {
  uint32_t d[N];
  d[0] = eo::sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < N; ++j) d[j] = eo::subc_cc(a[j], b[j]);
  const uint32_t mask = eo::subc(0, 0);  // all ones where a < b: add p back
  out[0] = eo::add_cc(d[0], f.p[0] & mask);
#pragma unroll
  for (int j = 1; j < N; ++j) out[j] = eo::addc_cc(d[j], f.p[j] & mask);
}

template <int N>
__device__ __forceinline__ void mont_mul_eo(uint32_t (&out)[N], const uint32_t (&a)[N], const uint32_t (&b)[N],
                                            const FieldParams& f) {
  static_assert(N % 2 == 0, "mont_mul_eo needs an even number of limbs");
  uint32_t ev[N], od[N];
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    ev[j] = a[j] * b[0];
    ev[j + 1] = __umulhi(a[j], b[0]);
    od[j] = a[j + 1] * b[0];
    od[j + 1] = __umulhi(a[j + 1], b[0]);
  }
  eo::redc_row<N>(ev, od, f);
#pragma unroll
  for (int i = 1; i < N; i += 2) {
    eo::row<N>(od, ev, a, b[i], f);
    if (i + 1 < N) eo::row<N>(ev, od, a, b[i + 1], f);
  }
  // after an even number of rows ev holds the words 1..N (now 0..N-1) and od
  // the words 0..N-1 with od[0] = 0 (now -1..N-2): add them
  ev[0] = eo::add_cc(ev[0], od[1]);
#pragma unroll
  for (int j = 1; j + 1 < N; ++j) ev[j] = eo::addc_cc(ev[j], od[j + 1]);
  ev[N - 1] = eo::addc_cc(ev[N - 1], 0);
  const uint32_t top = eo::addc(0, 0);
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = ev[j];
  sub_p_if_ge<N>(out, top, f);
}

}  // namespace tzk
