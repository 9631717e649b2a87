"""Host-side elliptic-curve arithmetic (exact python ints), generic over the
coordinate field.  Counterpart of :mod:`tpu_zk.curves.host_ec`.

Used as the correctness oracle for the device code and the MSM kernels, for
the tiny G2 side of the trusted setup, for the verifier's G1/G2 points and
for affine conversions.  Points are projective (X : Y : Z) short-Weierstrass
with a = 0; addition is the Renes-Costello-Batina *complete* formula (no
branches on operand equality), the same formula as
:func:`tpu_zk_torch.curves.ec_device.ec_add` and ``csrc/ec.cuh``.
"""

from __future__ import annotations

from .pairing import Fq2
from .params import CURVES


class Fp:
    """Host int mod p with field-element interface."""

    __slots__ = ("p", "v")

    def __init__(self, p, v):
        self.p = p
        self.v = v % p

    def __add__(s, o):
        return Fp(s.p, s.v + o.v)

    def __sub__(s, o):
        return Fp(s.p, s.v - o.v)

    def __neg__(s):
        return Fp(s.p, -s.v)

    def __mul__(s, o):
        return Fp(s.p, s.v * o.v)

    def inverse(s):
        return Fp(s.p, pow(s.v, s.p - 2, s.p))

    def is_zero(s):
        return s.v == 0

    def __eq__(s, o):
        return s.v == o.v

    def __repr__(s):
        return f"Fp({s.v})"


def ec_add(P, Q, b3):
    """Complete projective addition, a = 0 (RCB 2015, Algorithm 7)."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    t0 = X1 * X2
    t1 = Y1 * Y2
    t2 = Z1 * Z2
    t3 = (X1 + Y1) * (X2 + Y2) - t0 - t1
    t4 = (Y1 + Z1) * (Y2 + Z2) - t1 - t2
    t5 = (X1 + Z1) * (X2 + Z2) - t0 - t2
    x3_tmp = t0 + t0 + t0  # 3 X1X2
    t2b3 = b3 * t2
    z3 = t1 + t2b3
    t1m = t1 - t2b3
    y3g = b3 * t5
    X3 = t3 * t1m - t4 * y3g
    Y3 = y3g * x3_tmp + t1m * z3
    Z3 = z3 * t4 + x3_tmp * t3
    return (X3, Y3, Z3)


def ec_double(P, b3):
    """Complete projective doubling, a = 0 (RCB 2015, Algorithm 9): the
    point ec_add(P, P, b3) gives, for 6 products and 2 by b3 instead of 12,
    on the Python ints themselves (the window combine of the MSM is about
    256 doublings)."""
    p = P[0].p
    X, Y, Z = (c.v for c in P)
    t0 = Y * Y % p
    t1 = Y * Z % p
    t2 = b3.v * Z * Z % p
    z8 = 8 * t0
    X3 = t2 * z8 % p
    Z3 = t1 * z8 % p
    t0 = t0 - 3 * t2
    Y3 = X3 + t0 * (t0 + 4 * t2)
    return (Fp(p, 2 * t0 * (X * Y % p)), Fp(p, Y3), Fp(p, Z3))


def ec_neg(P):
    X, Y, Z = P
    return (X, -Y, Z)


def ec_identity(zero, one):
    return (zero, one, zero)


def ec_scalar_mul(P, k: int, b3, zero, one):
    acc = ec_identity(zero, one)
    add = P
    while k:
        if k & 1:
            acc = ec_add(acc, add, b3)
        k >>= 1
        if k:
            add = ec_add(add, add, b3)
    return acc


def ec_is_identity(P) -> bool:
    return P[2].is_zero()


def ec_to_affine(P):
    X, Y, Z = P
    if Z.is_zero():
        return None
    zinv = Z.inverse()
    return (X * zinv, Y * zinv)


def ec_eq(P, Q) -> bool:
    """Projective equality: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    if Z1.is_zero() or Z2.is_zero():
        return Z1.is_zero() and Z2.is_zero()
    return X1 * Z2 == X2 * Z1 and Y1 * Z2 == Y2 * Z1


# --- curve-specific helpers -------------------------------------------------


class HostCurve:
    """G1 (over Fp) and G2 (over Fq2) host arithmetic for a named curve."""

    def __init__(self, curve_name: str):
        c = CURVES[curve_name]
        self.curve = c
        self.p = c["p"]
        self.r = c["r"]
        self.name = curve_name
        self.b3_g1 = Fp(self.p, 3 * c["b"])
        self.zero = Fp(self.p, 0)
        self.one = Fp(self.p, 1)
        # twist coefficient: D-twist b' = b/xi, M-twist b' = b*xi
        xi = Fq2(self.p, *c["xi"])
        b = Fq2(self.p, c["b"], 0)
        self.b_g2 = b * xi.inverse() if c["twist"] == "D" else b * xi
        three = Fq2(self.p, 3, 0)
        self.b3_g2 = self.b_g2 * three
        self.zero2 = Fq2(self.p, 0, 0)
        self.one2 = Fq2(self.p, 1, 0)

    # G1
    def g1_generator(self):
        x, y = self.curve["g1"]
        return (Fp(self.p, x), Fp(self.p, y), self.one)

    def g1_mul(self, P, k: int):
        return ec_scalar_mul(P, k % self.r, self.b3_g1, self.zero, self.one)

    def g1_add(self, P, Q):
        return ec_add(P, Q, self.b3_g1)

    def g1_affine(self, P):
        a = ec_to_affine(P)
        return None if a is None else (a[0].v, a[1].v)

    def g1_is_on_curve(self, P) -> bool:
        X, Y, Z = P
        # Y^2 Z = X^3 + b Z^3
        b = Fp(self.p, self.curve["b"])
        return Y * Y * Z == X * X * X + b * Z * Z * Z

    # G2 (on the twist, coordinates in Fq2)
    def g2_generator(self):
        (x0, x1), (y0, y1) = self.curve["g2"]
        return (Fq2(self.p, x0, x1), Fq2(self.p, y0, y1), self.one2)

    def g2_mul(self, P, k: int):
        return ec_scalar_mul(P, k % self.r, self.b3_g2, self.zero2, self.one2)

    def g2_add(self, P, Q):
        return ec_add(P, Q, self.b3_g2)

    def g2_sub(self, P, Q):
        return ec_add(P, ec_neg(Q), self.b3_g2)

    def g2_affine(self, P):
        a = ec_to_affine(P)
        return None if a is None else ((a[0].c0, a[0].c1), (a[1].c0, a[1].c1))

    def g2_is_on_curve(self, P) -> bool:
        X, Y, Z = P
        return Y * Y * Z == X * X * X + self.b_g2 * Z * Z * Z
