"""ctypes bridge to the native pairing engine (``native/pairing.cpp``).

Counterpart of :mod:`tpu_zk.curves.pairing_native`.  The C++ engine mirrors
:mod:`.pairing`'s tower construction; Python only marshals curve constants
and point coordinates.  The library is built from source by
:func:`tpu_zk_torch._build.pairing_library` at first use; a build that fails
raises (there is no Python pairing to fall back on: :mod:`.pairing` is the
tests' oracle for this module).
"""

from __future__ import annotations

import ctypes
import functools

from .. import _build
from .params import CURVES

NL = 6


class CurveBlob(ctypes.Structure):
    _fields_ = [
        ("p", ctypes.c_uint64 * NL),
        ("r2", ctypes.c_uint64 * NL),
        ("n0inv", ctypes.c_uint64),
        ("xi_c0", ctypes.c_uint64 * NL),
        ("xi_c1", ctypes.c_uint64 * NL),
        ("pm2_len", ctypes.c_int32),
        ("pexp_len", ctypes.c_int32),
        ("p2exp_len", ctypes.c_int32),
        ("hard_len", ctypes.c_int32),
        ("loop_nbits", ctypes.c_int32),
        ("ate_negative", ctypes.c_int32),
        ("bn_final_steps", ctypes.c_int32),
        ("twist_d", ctypes.c_int32),
        ("pm2", ctypes.c_uint8 * 64),
        ("pexp", ctypes.c_uint8 * 64),
        ("p2exp", ctypes.c_uint8 * 128),
        ("hard", ctypes.c_uint8 * 512),
        ("loop_bits", ctypes.c_uint8 * 72),
    ]


def _limbs(v: int):
    return (ctypes.c_uint64 * NL)(*[(v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(NL)])


def _be_bytes(v: int, cap: int):
    raw = v.to_bytes((v.bit_length() + 7) // 8 or 1, "big")
    assert len(raw) <= cap
    buf = (ctypes.c_uint8 * cap)()
    for i, b in enumerate(raw):
        buf[i] = b
    return buf, len(raw)


@functools.cache
def _blob(curve_name: str) -> CurveBlob:
    c = CURVES[curve_name]
    p, r = c["p"], c["r"]
    blob = CurveBlob()
    blob.p = _limbs(p)
    blob.r2 = _limbs(pow(1 << (64 * NL), 2, p))
    blob.n0inv = (-pow(p, -1, 1 << 64)) % (1 << 64)
    blob.xi_c0 = _limbs(c["xi"][0] % p)
    blob.xi_c1 = _limbs(c["xi"][1] % p)
    blob.pm2, blob.pm2_len = _be_bytes(p - 2, 64)
    blob.pexp, blob.pexp_len = _be_bytes(p, 64)
    blob.p2exp, blob.p2exp_len = _be_bytes(p * p, 128)
    blob.hard, blob.hard_len = _be_bytes((p**4 - p**2 + 1) // r, 512)
    bits = bin(c["ate_loop"])[2:]
    blob.loop_nbits = len(bits)
    packed = int(bits, 2) << (8 * ((len(bits) + 7) // 8) - len(bits))
    raw = packed.to_bytes((len(bits) + 7) // 8, "big")
    lb = (ctypes.c_uint8 * 72)()
    for i, b in enumerate(raw):
        lb[i] = b
    blob.loop_bits = lb
    blob.ate_negative = 1 if c["ate_is_negative"] else 0
    blob.bn_final_steps = 1 if c["bn_final_steps"] else 0
    blob.twist_d = 1 if c["twist"] == "D" else 0
    return blob


def pairing_product_is_one(curve_name: str, pairs) -> bool:
    """prod e(Pi, Qi) == 1 over affine (G1, G2) int pairs; a ``None`` on
    either side is the point at infinity and contributes 1."""
    lib = _build.pairing_library()
    n = len(pairs)
    g1 = (ctypes.c_uint64 * (n * 2 * NL))()
    g2 = (ctypes.c_uint64 * (n * 4 * NL))()
    inf = (ctypes.c_uint8 * n)()
    for i, (p_aff, q_aff) in enumerate(pairs):
        if p_aff is None or q_aff is None:
            inf[i] = 1
            continue
        for k, coord in enumerate((p_aff[0], p_aff[1])):
            for j in range(NL):
                g1[i * 2 * NL + k * NL + j] = (coord >> (64 * j)) & 0xFFFFFFFFFFFFFFFF
        (x0, x1), (y0, y1) = q_aff
        for k, coord in enumerate((x0, x1, y0, y1)):
            for j in range(NL):
                g2[i * 4 * NL + k * NL + j] = (coord >> (64 * j)) & 0xFFFFFFFFFFFFFFFF
    blob = _blob(curve_name)
    return bool(lib.pairing_product_is_one(ctypes.byref(blob), g1, g2, inf, n))
