"""BN254 (alt_bn128) constants and G1 scalar multiplication with Python ints.

The curve is y^2 = x^3 + 3 over F_q with the generator (1, 2); the scalar
field F_r is the one the proofs are over.  Constants as published for the
curve (EIP-196).
"""

from __future__ import annotations

Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
G1 = (1, 2)
MODULI = {"bn254_fr": R}  # the fields that proofs are over, by the names configurations use


def _double(P):
    x, y, z = P
    if z == 0 or y == 0:
        return (1, 1, 0)
    a = x * x % Q
    b = y * y % Q
    c = b * b % Q
    d = 2 * ((x + b) * (x + b) - a - c) % Q
    e = 3 * a % Q
    x3 = (e * e - 2 * d) % Q
    return x3, (e * (d - x3) - 8 * c) % Q, 2 * y * z % Q


def _add(P, S):
    if P[2] == 0:
        return S
    if S[2] == 0:
        return P
    x1, y1, z1 = P
    x2, y2, z2 = S
    z1z1, z2z2 = z1 * z1 % Q, z2 * z2 % Q
    u1, u2 = x1 * z2z2 % Q, x2 * z1z1 % Q
    s1, s2 = y1 * z2 * z2z2 % Q, y2 * z1 * z1z1 % Q
    if u1 == u2:
        return _double(P) if s1 == s2 else (1, 1, 0)
    h, r = (u2 - u1) % Q, (s2 - s1) % Q
    hh = h * h % Q
    hhh = h * hh % Q
    v = u1 * hh % Q
    x3 = (r * r - hhh - 2 * v) % Q
    return x3, (r * (v - x3) - s1 * hhh) % Q, z1 * z2 * h % Q


def g1_mul(k: int, base=G1):
    """k * base as an affine (x, y) pair, or None for the point at infinity."""
    k %= R
    acc, P = (1, 1, 0), (base[0], base[1], 1)
    while k:
        if k & 1:
            acc = _add(acc, P)
        P = _double(P)
        k >>= 1
    if acc[2] == 0:
        return None
    zinv = pow(acc[2], -1, Q)
    zinv2 = zinv * zinv % Q
    return acc[0] * zinv2 % Q, acc[1] * zinv2 * zinv % Q
