"""Host-side pairings for BN254 and BLS12-381 on Python ints (tower fields +
Miller loop): the oracle that the tests hold the native pairing engine
against.

A copy of :mod:`tpu_zk.curves.pairing`.  KZG verification
(:func:`tpu_zk_torch.kzg.multilinear_kzg.verify`) goes through
:mod:`.pairing_native`, never through this module: here a three-pair product
takes seconds.  :class:`Fq2` also serves :mod:`.host_ec`'s G2 arithmetic.

Construction kept deliberately simple to audit:
  * towers Fq -> Fq2 (i^2 = -1) -> Fq6 (v^3 = xi) -> Fq12 (w^2 = v)
  * G2 points are untwisted into E(Fq12) (D-twist: (x w^2, y w^3);
    M-twist: (x / w^2, y / w^3)), so one affine Miller loop serves both
    curves
  * BN optimal ate appends the two Frobenius line steps; BLS conjugates for
    its negative parameter
  * final exponentiation = easy part + naive (p^4 - p^2 + 1)/r power
"""

from __future__ import annotations

import functools

from .params import CURVES


# --- tower field elements ---------------------------------------------------


class Fq2:
    __slots__ = ("p", "c0", "c1")

    def __init__(self, p, c0, c1):
        self.p = p
        self.c0 = c0 % p
        self.c1 = c1 % p

    def __add__(s, o):
        return Fq2(s.p, s.c0 + o.c0, s.c1 + o.c1)

    def __sub__(s, o):
        return Fq2(s.p, s.c0 - o.c0, s.c1 - o.c1)

    def __neg__(s):
        return Fq2(s.p, -s.c0, -s.c1)

    def __mul__(s, o):
        if isinstance(o, int):
            return Fq2(s.p, s.c0 * o, s.c1 * o)
        a = s.c0 * o.c0
        b = s.c1 * o.c1
        cross = (s.c0 + s.c1) * (o.c0 + o.c1)
        return Fq2(s.p, a - b, cross - a - b)

    def square(s):
        return s * s

    def inverse(s):
        norm = s.c0 * s.c0 + s.c1 * s.c1
        inv = pow(norm, s.p - 2, s.p)
        return Fq2(s.p, s.c0 * inv, -s.c1 * inv)

    def conjugate(s):
        return Fq2(s.p, s.c0, -s.c1)

    def is_zero(s):
        return s.c0 == 0 and s.c1 == 0

    def __eq__(s, o):
        return s.c0 == o.c0 and s.c1 == o.c1

    def __repr__(s):
        return f"Fq2({s.c0}, {s.c1})"


class Fq6:
    __slots__ = ("xi", "c0", "c1", "c2")

    def __init__(self, xi: Fq2, c0: Fq2, c1: Fq2, c2: Fq2):
        self.xi = xi
        self.c0, self.c1, self.c2 = c0, c1, c2

    def __add__(s, o):
        return Fq6(s.xi, s.c0 + o.c0, s.c1 + o.c1, s.c2 + o.c2)

    def __sub__(s, o):
        return Fq6(s.xi, s.c0 - o.c0, s.c1 - o.c1, s.c2 - o.c2)

    def __neg__(s):
        return Fq6(s.xi, -s.c0, -s.c1, -s.c2)

    def __mul__(s, o):
        a0, a1, a2 = s.c0, s.c1, s.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        xi = s.xi
        c0 = a0 * b0 + xi * (a1 * b2 + a2 * b1)
        c1 = a0 * b1 + a1 * b0 + xi * (a2 * b2)
        c2 = a0 * b2 + a1 * b1 + a2 * b0
        return Fq6(xi, c0, c1, c2)

    def mul_by_v(s):
        # (c0 + c1 v + c2 v^2) * v = xi*c2 + c0 v + c1 v^2
        return Fq6(s.xi, s.xi * s.c2, s.c0, s.c1)

    def inverse(s):
        a, b, c = s.c0, s.c1, s.c2
        xi = s.xi
        t0 = a * a - xi * (b * c)
        t1 = xi * (c * c) - a * b
        t2 = b * b - a * c
        denom = a * t0 + xi * (c * t1) + xi * (b * t2)
        dinv = denom.inverse()
        return Fq6(xi, t0 * dinv, t1 * dinv, t2 * dinv)

    def is_zero(s):
        return s.c0.is_zero() and s.c1.is_zero() and s.c2.is_zero()

    def __eq__(s, o):
        return s.c0 == o.c0 and s.c1 == o.c1 and s.c2 == o.c2


class Fq12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    def __add__(s, o):
        return Fq12(s.c0 + o.c0, s.c1 + o.c1)

    def __sub__(s, o):
        return Fq12(s.c0 - o.c0, s.c1 - o.c1)

    def __neg__(s):
        return Fq12(-s.c0, -s.c1)

    def __mul__(s, o):
        a0, a1 = s.c0, s.c1
        b0, b1 = o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        c0 = t0 + t1.mul_by_v()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1
        return Fq12(c0, c1)

    def square(s):
        return s * s

    def inverse(s):
        # (c0 - c1 w) / (c0^2 - v c1^2)
        denom = s.c0 * s.c0 - (s.c1 * s.c1).mul_by_v()
        dinv = denom.inverse()
        return Fq12(s.c0 * dinv, -(s.c1 * dinv))

    def conjugate(s):
        """f^(p^6): w -> -w."""
        return Fq12(s.c0, -s.c1)

    def pow(s, e: int):
        if e < 0:
            return s.inverse().pow(-e)
        result = None
        base = s
        while e:
            if e & 1:
                result = base if result is None else result * base
            e >>= 1
            if e:
                base = base * base
        return result if result is not None else _one_like(s)

    def is_zero(s):
        return s.c0.is_zero() and s.c1.is_zero()

    def __eq__(s, o):
        return s.c0 == o.c0 and s.c1 == o.c1


def _one_like(x: Fq12) -> Fq12:
    return Tower.of(x).one12()


# --- tower factory per curve ------------------------------------------------


class Tower:
    _registry: dict[int, "Tower"] = {}

    def __init__(self, curve: dict):
        self.curve = curve
        self.p = curve["p"]
        self.r = curve["r"]
        self.xi = Fq2(self.p, *curve["xi"])
        Tower._registry[self.p] = self

    @classmethod
    def of(cls, x) -> "Tower":
        if isinstance(x, Fq12):
            return cls._registry[x.c0.c0.p]
        return cls._registry[x.p]

    # constructors
    def fq2(self, c0=0, c1=0) -> Fq2:
        return Fq2(self.p, c0, c1)

    def fq6(self, c0=None, c1=None, c2=None) -> Fq6:
        z = self.fq2()
        return Fq6(self.xi, c0 or z, c1 or z, c2 or z)

    def fq12_scalar(self, v: int) -> Fq12:
        return Fq12(self.fq6(self.fq2(v)), self.fq6())

    def fq12_from_fq2(self, x: Fq2) -> Fq12:
        return Fq12(self.fq6(x), self.fq6())

    def one12(self) -> Fq12:
        return self.fq12_scalar(1)

    def zero12(self) -> Fq12:
        return self.fq12_scalar(0)

    def w(self) -> Fq12:
        return Fq12(self.fq6(), self.fq6(self.fq2(1)))


@functools.lru_cache(maxsize=None)
def tower(curve_name: str) -> Tower:
    return Tower(CURVES[curve_name])


# --- untwist G2 -> E(Fq12) --------------------------------------------------


def untwist(curve_name: str, q_affine) -> tuple[Fq12, Fq12]:
    """Map an affine G2 point ((x0,x1),(y0,y1)) on the twist into E(Fq12)."""
    tw = tower(curve_name)
    (x0, x1), (y0, y1) = q_affine
    x = tw.fq12_from_fq2(tw.fq2(x0, x1))
    y = tw.fq12_from_fq2(tw.fq2(y0, y1))
    w = tw.w()
    w2, w3 = w * w, w * w * w
    if tw.curve["twist"] == "D":
        return x * w2, y * w3
    return x * w2.inverse(), y * w3.inverse()


# --- affine Miller loop over E(Fq12) ----------------------------------------


def _line_and_step(T, Q, P):
    """Evaluate the line through T,Q (or tangent at T if T==Q) at P; return
    (line_value, T+Q)."""
    xT, yT = T
    xQ, yQ = Q
    xP, yP = P
    if xT == xQ and yT == yQ:
        # tangent
        x2 = xT * xT
        m = (x2 + x2 + x2) * (yT + yT).inverse()
    elif xT == xQ:
        # vertical line x - xT
        return xP - xT, None  # T + (-T) = infinity
    else:
        m = (yQ - yT) * (xQ - xT).inverse()
    l = yP - yT - m * (xP - xT)
    x3 = m * m - xT - xQ
    y3 = m * (xT - x3) - yT
    return l, (x3, y3)


def miller_loop(curve_name: str, P, Q) -> Fq12:
    """f_{loop,Q}(P) for affine P, Q in E(Fq12) coordinates."""
    tw = tower(curve_name)
    c = tw.curve
    loop = c["ate_loop"]
    f = tw.one12()
    T = Q
    for bit in bin(loop)[3:]:  # MSB-1 downward
        l, T = _line_and_step(T, T, P)
        f = f * f * l
        if bit == "1":
            l, T = _line_and_step(T, Q, P)
            f = f * l
    if c["ate_is_negative"]:
        f = f.conjugate()  # f^(p^6) == 1/f after the easy part
    if c["bn_final_steps"]:
        # BN optimal ate: two extra line steps with Frobenius images of Q
        pexp = tw.p
        Q1 = (Q[0].pow(pexp), Q[1].pow(pexp))
        Q2 = (Q1[0].pow(pexp), Q1[1].pow(pexp))
        l, T = _line_and_step(T, Q1, P)
        f = f * l
        l, T = _line_and_step(T, (Q2[0], -Q2[1]), P)
        f = f * l
    return f


def final_exponentiation(curve_name: str, f: Fq12) -> Fq12:
    tw = tower(curve_name)
    p, r = tw.p, tw.r
    # easy part: f^((p^6 - 1)(p^2 + 1))
    f = f.conjugate() * f.inverse()  # f^(p^6 - 1)
    f = f.pow(p * p) * f  # f^(p^2 + 1)
    # hard part (naive power; exponent ~ (p^4 - p^2 + 1)/r)
    hard = (p**4 - p**2 + 1) // r
    return f.pow(hard)


def pairing(curve_name: str, p_affine, q_affine) -> Fq12:
    """e(P, Q) for affine G1 P=(x,y) ints and affine G2 Q=((x0,x1),(y0,y1)).

    Either argument may be None (point at infinity) -> returns 1.
    """
    tw = tower(curve_name)
    if p_affine is None or q_affine is None:
        return tw.one12()
    P = (tw.fq12_scalar(p_affine[0]), tw.fq12_scalar(p_affine[1]))
    Q = untwist(curve_name, q_affine)
    f = miller_loop(curve_name, P, Q)
    return final_exponentiation(curve_name, f)


def pairing_product_is_one(curve_name: str, pairs) -> bool:
    """Check prod e(Pi, Qi) == 1 (multi-pairing with shared final exp)."""
    tw = tower(curve_name)
    f = tw.one12()
    for p_affine, q_affine in pairs:
        if p_affine is None or q_affine is None:
            continue
        P = (tw.fq12_scalar(p_affine[0]), tw.fq12_scalar(p_affine[1]))
        Q = untwist(curve_name, q_affine)
        f = f * miller_loop(curve_name, P, Q)
    return final_exponentiation(curve_name, f) == tw.one12()
