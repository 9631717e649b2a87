// Short-Weierstrass (a = 0) projective point arithmetic for the MSM kernels.
//
// A point is (X : Y : Z), each coordinate N 32-bit limbs in Montgomery form
// (field.cuh).  ec_add is the Renes-Costello-Batina complete addition
// (2015, Algorithm 7): no branch on equal, opposite or identity operands, in
// the operation order of tpu_zk/curves/ec_pallas.py:49-63 (_ec_add_rows) and
// of tpu_zk_torch.curves.ec_device.ec_add, so all three give the same limbs.
#pragma once

#include "field.cuh"

namespace tzk {

template <int N>
struct PointN {
  uint32_t x[N], y[N], z[N];
};

// Raw N-word loads and stores (no 16-bit repacking), 16 bytes at a time.
template <int N>
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ src, uint32_t (&x)[N]) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const uint4 w = s[q];
    x[4 * q] = w.x;
    x[4 * q + 1] = w.y;
    x[4 * q + 2] = w.z;
    x[4 * q + 3] = w.w;
  }
}

template <int N>
__device__ __forceinline__ void store_words(uint32_t* __restrict__ dst, const uint32_t (&x)[N]) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int q = 0; q < N / 4; ++q) d[q] = make_uint4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
}

// A point stored as 3 * N consecutive words (X, Y, Z).
template <int N>
__device__ __forceinline__ void load_point_words(const uint32_t* __restrict__ src, PointN<N>& p) {
  load_words<N>(src, p.x);
  load_words<N>(src + N, p.y);
  load_words<N>(src + 2 * N, p.z);
}

template <int N>
__device__ __forceinline__ void store_point_words(uint32_t* __restrict__ dst, const PointN<N>& p) {
  store_words<N>(dst, p.x);
  store_words<N>(dst + N, p.y);
  store_words<N>(dst + 2 * N, p.z);
}

template <int N>
__device__ __forceinline__ void set_identity(PointN<N>& p, const uint32_t (&one)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    p.x[j] = 0;
    p.y[j] = one[j];
    p.z[j] = 0;
  }
}

// y <- p - y, and 0 stays 0.
template <int N>
__device__ __forceinline__ void neg_y(uint32_t (&y)[N], const FieldParams& f) {
  uint32_t zero[N], out[N];
#pragma unroll
  for (int j = 0; j < N; ++j) zero[j] = 0;
  mod_sub<N>(out, zero, y, f);
#pragma unroll
  for (int j = 0; j < N; ++j) y[j] = out[j];
}

// r = p + q (complete; r may alias p or q).
template <int N>
__device__ __forceinline__ void ec_add(PointN<N>& r, const PointN<N>& p, const PointN<N>& q,
                                       const uint32_t (&b3)[N], const FieldParams& f) {
  uint32_t t0[N], t1[N], t2[N], t3[N], t4[N], t5[N], u[N], v[N];
  mont_mul<N>(t0, p.x, q.x, f);
  mont_mul<N>(t1, p.y, q.y, f);
  mont_mul<N>(t2, p.z, q.z, f);
  mod_add<N>(u, p.x, p.y, f);
  mod_add<N>(v, q.x, q.y, f);
  mont_mul<N>(t3, u, v, f);
  mod_sub<N>(t3, t3, t0, f);
  mod_sub<N>(t3, t3, t1, f);  // X1Y2 + X2Y1
  mod_add<N>(u, p.y, p.z, f);
  mod_add<N>(v, q.y, q.z, f);
  mont_mul<N>(t4, u, v, f);
  mod_sub<N>(t4, t4, t1, f);
  mod_sub<N>(t4, t4, t2, f);  // Y1Z2 + Y2Z1
  mod_add<N>(u, p.x, p.z, f);
  mod_add<N>(v, q.x, q.z, f);
  mont_mul<N>(t5, u, v, f);
  mod_sub<N>(t5, t5, t0, f);
  mod_sub<N>(t5, t5, t2, f);  // X1Z2 + X2Z1
  // p and q are dead from here on: r may be written
  mont_mul<N>(t2, b3, t2, f);  // t2b3
  mont_mul<N>(t5, b3, t5, f);  // y3g
  mod_add<N>(u, t0, t0, f);
  mod_add<N>(t0, u, t0, f);    // three_t0
  mod_add<N>(v, t1, t2, f);    // z3t
  mod_sub<N>(t1, t1, t2, f);   // t1m
  mont_mul<N>(u, t3, t1, f);
  mont_mul<N>(t2, t4, t5, f);
  mod_sub<N>(r.x, u, t2, f);   // X3 = t3 t1m - t4 y3g
  mont_mul<N>(u, t5, t0, f);
  mont_mul<N>(t2, t1, v, f);
  mod_add<N>(r.y, u, t2, f);   // Y3 = y3g three_t0 + t1m z3t
  mont_mul<N>(u, v, t4, f);
  mont_mul<N>(t2, t0, t3, f);
  mod_add<N>(r.z, u, t2, f);   // Z3 = z3t t4 + three_t0 t3
}

}  // namespace tzk
