// Short-Weierstrass (a = 0) projective point arithmetic for the MSM kernels.
//
// A point is (X : Y : Z), each coordinate N 32-bit limbs in Montgomery form
// (field.cuh).  ec_add is the Renes-Costello-Batina complete addition
// (2015, Algorithm 7): no branch on equal, opposite or identity operands, in
// the operation order of tpu_zk/curves/ec_pallas.py:49-63 (_ec_add_rows) and
// of tpu_zk_torch.curves.ec_device.ec_add, so all three give the same limbs.
// Its two products by the curve constant 3b are additions here (mul_b3): the
// same canonical field element, so the limbs stay equal, for 12 Montgomery
// products an add instead of 14.
#pragma once

#include "field.cuh"

namespace tzk {

template <int N>
struct PointN {
  uint32_t x[N], y[N], z[N];
};

// Points in the package's layout: coordinates of 2N int32 16-bit limbs
// (field.cuh's load_elem/store_elem).  load_point reads row ``row`` of three
// coordinate arrays whose rows lie ``stride`` words apart; a stored row is
// X, Y, Z, 3 * 2N limbs.
template <int N>
__device__ __forceinline__ void load_point(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                                           const uint32_t* __restrict__ pz, int64_t row, int64_t stride,
                                           PointN<N>& p) {
  load_elem<N>(px + row * stride, p.x);
  load_elem<N>(py + row * stride, p.y);
  load_elem<N>(pz + row * stride, p.z);
}

template <int N>
__device__ __forceinline__ void store_point_row(uint32_t* __restrict__ dst, const PointN<N>& p) {
  store_elem<N>(dst, p.x);
  store_elem<N>(dst + 2 * N, p.y);
  store_elem<N>(dst + 4 * N, p.z);
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

// out = K x for the curve constant K = 3b: 9 = 8 + 1 (BN254, b = 3) or
// 12 = 8 + 4 (BLS12-381, b = 4), by four modular additions.  out may alias x.
template <int N, int K>
__device__ __forceinline__ void mul_b3(uint32_t (&out)[N], const uint32_t (&x)[N], const FieldParams& f) {
  static_assert(K == 9 || K == 12, "3b is 9 (BN254) or 12 (BLS12-381)");
  uint32_t x2[N], x4[N], x8[N];
  mod_add<N>(x2, x, x, f);
  mod_add<N>(x4, x2, x2, f);
  mod_add<N>(x8, x4, x4, f);
  if constexpr (K == 9) {
    mod_add<N>(out, x8, x, f);
  } else {
    mod_add<N>(out, x8, x4, f);
  }
}

// r = p + q (complete; r may alias p or q or both).  K = 3b (mul_b3).
template <int N, int K>
__device__ __forceinline__ void ec_add(PointN<N>& r, const PointN<N>& p, const PointN<N>& q, const FieldParams& f) {
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
  mul_b3<N, K>(t2, t2, f);  // t2b3
  mul_b3<N, K>(t5, t5, f);  // y3g
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
