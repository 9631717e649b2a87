"""The one-block Keccak-256 kernel (K5): its wrapper and plain version.

K5 ``keccak_rows``: [N, w <= 135] uint8 byte rows -> [N, 32] uint8 digests,
each row absorbed as one padded block (0x01 at byte w, 0x80 at byte 135; one
0x81 byte when w = 135) and permuted once.  Replaces
``tpu_zk/merkle/device_merkle.py:81 _hash_block_T_pallas`` (its
``_keccak_hash_kernel`` :41), which takes the rows batch-transposed.

It is bound by integer operations: ~4,150 32-bit logic and shift
instructions a hash (180 a full round) against 96 bytes in and out per node
hash.  What
the design does about it is in ``csrc/keccak.cu``: one thread per row, the
state in registers, 24 unrolled rounds.

The plain version runs Keccak-f on each 64-bit lane as (lo, hi) 32-bit
halves held in int64 tensors, every value kept in [0, 2^32): left shifts
are masked and NOT is an XOR with 2^32 - 1 (torch on the CPU has no uint32
or uint64 arithmetic, and its ``>>`` on int64 is arithmetic).  It is the
function of ``tpu_zk/transcript/device_fs.py:188 keccak_f1600_lanes``.

The wrapper runs the plain version when its tensors lie on the CPU, and for
CUDA tensors launches the kernel (built by :mod:`tpu_zk_torch._build` at
first use) or raises.  It keeps a count of its kernel launches in its
``launches`` attribute.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..fields.kernels import _device_index, _launch, _ptr, _raise_on
from ..transcript.keccak import _RC, _ROT, RATE

_M32 = 0xFFFFFFFF
_RC_HALVES = [(int(rc) & _M32, int(rc) >> 32) for rc in _RC]


def _rotl(lo: torch.Tensor, hi: torch.Tensor, s: int):
    """Rotate the 64-bit lanes (lo, hi) left by the constant s."""
    if s >= 32:
        lo, hi, s = hi, lo, s - 32
    if s == 0:
        return lo, hi
    return (((lo << s) & _M32) | (hi >> (32 - s)), ((hi << s) & _M32) | (lo >> (32 - s)))


def keccak_f1600_halves(A: list) -> list:
    """Keccak-f[1600] on 25 lanes, lane x + 5y as a (lo, hi) pair of int64
    tensors holding 32-bit values."""
    for rc_lo, rc_hi in _RC_HALVES:
        C = []
        for x in range(5):
            lo, hi = A[x]
            for y in range(1, 5):
                lo, hi = lo ^ A[x + 5 * y][0], hi ^ A[x + 5 * y][1]
            C.append((lo, hi))
        D = []
        for x in range(5):
            r_lo, r_hi = _rotl(*C[(x + 1) % 5], 1)
            D.append((C[(x - 1) % 5][0] ^ r_lo, C[(x - 1) % 5][1] ^ r_hi))
        B = [None] * 25
        for x in range(5):
            for y in range(5):
                lo, hi = A[x + 5 * y]
                B[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(lo ^ D[x][0], hi ^ D[x][1], _ROT[x][y])
        A = []
        for i in range(25):
            row = 5 * (i // 5)
            b1, b2 = B[row + (i + 1) % 5], B[row + (i + 2) % 5]
            A.append((B[i][0] ^ ((b1[0] ^ _M32) & b2[0]), B[i][1] ^ ((b1[1] ^ _M32) & b2[1])))
        A[0] = (A[0][0] ^ rc_lo, A[0][1] ^ rc_hi)
    return A


def keccak_rows_plain(data: torch.Tensor) -> torch.Tensor:
    """[N, w <= 135] uint8 rows -> [N, 32] uint8 Keccak-256 digests."""
    n, w = data.shape
    buf = torch.zeros((n, RATE), dtype=torch.int64, device=data.device)
    buf[:, :w] = data
    buf[:, w] ^= 0x01
    buf[:, RATE - 1] ^= 0x80
    b = buf.view(n, RATE // 8, 2, 4)
    halves = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)  # [N, 17, 2]
    zero = torch.zeros(n, dtype=torch.int64, device=data.device)
    A = [(halves[:, k, 0], halves[:, k, 1]) if k < RATE // 8 else (zero, zero) for k in range(25)]
    A = keccak_f1600_halves(A)
    words = torch.stack([h for k in range(4) for h in A[k]], dim=1)  # [N, 8] little-endian 32-bit words
    digest = torch.stack([(words >> s) & 0xFF for s in (0, 8, 16, 24)], dim=-1)  # [N, 8, 4]
    return digest.reshape(n, 32).to(torch.uint8)


def keccak_rows(data: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """K5: [N, w <= 135] uint8 rows -> [N, 32] uint8 digests, written into
    ``out`` (a contiguous [N, 32] uint8 tensor, e.g. a slice of a tree's
    level buffer) when one is given."""
    if data.dtype != torch.uint8 or data.dim() != 2 or not data.is_contiguous():
        raise ValueError(f"keccak_rows: expected contiguous [N, w] uint8 rows, got {data.dtype} {tuple(data.shape)}")
    n, w = data.shape
    if w >= RATE:
        raise ValueError(f"keccak_rows: rows of {w} bytes do not fit one {RATE}-byte block with its padding")
    if out is None:
        out = torch.empty((n, 32), dtype=torch.uint8, device=data.device)
    elif out.dtype != torch.uint8 or out.shape != (n, 32) or not out.is_contiguous():
        raise ValueError(f"keccak_rows: out must be a contiguous [{n}, 32] uint8 tensor")
    index = _device_index(data, out)
    if index < 0:
        out.copy_(keccak_rows_plain(data))
        return out
    if n == 0:
        return out
    rc = _launch(
        _build.kernel_library().tzk_keccak_rows, index,
        ctypes.c_void_p(data.data_ptr()), _ptr(out), ctypes.c_int64(n), ctypes.c_int(w))
    _raise_on(rc, "keccak_rows")
    keccak_rows.launches += 1
    return out


keccak_rows.launches = 0
