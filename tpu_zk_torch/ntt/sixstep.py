"""The multi-pass (six-step) NTT plan: every pass one launch of K6.

A transform of N = m_0 * m_1 * ... * m_{R-1} points views its [N, L] table
as [m_0, m_1, ..., m_{R-1}, L] (n_0 the most significant digit of the input
index) and runs one radix-m_i DIF pass per digit (:func:`.kernels.dif_pass`,
K6).  Pass i sees the table as [A_i, m_i, C_i, L] with A_i = m_0 ... m_{i-1}
and C_i = m_{i+1} ... m_{R-1}: its columns are digit n_i with the earlier
passes' bit-reversed outputs k_0r .. k_{i-1}r before it and the remaining
input digits after it.  The pass writes its output digit k_ir back to the
same axis, so no pass moves the table: ``tpu_zk``'s plan transposes it
before and after every pass to bring the digit to its kernel's [L, m, B]
blocks.  Pass i >= 1 first multiplies by the inter-factor twiddles
w^((N / M_{i-1}) * k_{i-1} * (n_i * M_{i+1} + n_rest)) with
M_j = m_j m_{j+1} ... m_{R-1} (``tpu_zk/ntt/sixstep.py:243 _pre_matrix``),
and the inverse's last pass scales by 1/N.  The last pass also stores every
element at its natural-order row, k = k_0 + m_0 k_1 + m_0 m_1 k_2 + ...
(k_j the frequency of digit j): ``tpu_zk`` gathers the bit-reversed digits
into that order after the last pass.

Every split of n_log2 gives the same integers.  The plan takes the fewest
passes of radix at most 2^max_log; the default is the largest radix K6
takes (2^10), and the tests lower it to reach two and three passes at
small sizes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve
from ..fields import arith
from ..fields.arith import field_ctx
from . import kernels
from .kernels import MAX_LOG_M


def _bit_reverse(n_log2: int) -> np.ndarray:
    n = 1 << n_log2
    idx = np.arange(n)
    rev = np.zeros(n, np.int64)
    for b in range(n_log2):
        rev |= ((idx >> b) & 1) << (n_log2 - 1 - b)
    return rev


def _split_logs(k: int, max_log: int = MAX_LOG_M, min_log: int = 1) -> list[int]:
    """Split k into the fewest factors, each in [min_log, max_log], balanced."""
    if k <= max_log:
        return [k]
    r = -(-k // max_log)
    base, extra = divmod(k, r)
    logs = [base + (1 if i < extra else 0) for i in range(r)]
    assert all(min_log <= l <= max_log for l in logs), logs
    return logs


class SixStepPlan:
    """Tables of one (field, N, root, direction) multi-pass transform on one
    device: per pass the stage twiddles [S, m/2, L], the pre-twiddles
    [A, m, C, L] (none for pass 0), and the last pass's output rows."""

    def __init__(self, field_name: str, n_log2: int, root: int, inverse: bool = False,
                 max_log: int = MAX_LOG_M, device=None):
        ctx = field_ctx(field_name)
        self.ctx = ctx
        self.device = resolve(device)
        self.n_log2 = n_log2
        self.N = 1 << n_log2
        p = ctx.p
        w = pow(root, p - 2, p) if inverse else root
        self.logs = _split_logs(n_log2, max_log)
        self.ms = [1 << l for l in self.logs]
        self.revs = [_bit_reverse(l) for l in self.logs]
        self.tws = [self._stage_twiddles(pow(w, self.N // m, p), m) for m in self.ms]
        self.pres = [None] + [self._pre_matrix(w, i) for i in range(1, len(self.ms))]
        self.scale = ctx.scalar(pow(self.N, p - 2, p), device=self.device) if inverse else None
        self.dst = self._natural_rows()

    # -- tables ---------------------------------------------------------------
    def _powers(self, base: int, count: int) -> list[int]:
        vals, acc = [], 1
        for _ in range(count):
            vals.append(acc)
            acc = acc * base % self.ctx.p
        return vals

    def _stage_twiddles(self, w_m: int, m: int) -> torch.Tensor:
        """[S, max(m/2, 1), L]: stage s, slot j = w_m^(j << s) (Montgomery), 0 past m >> (s+1)."""
        S = m.bit_length() - 1
        half = max(m // 2, 1)
        vals = [0] * (S * half)
        for s in range(S):
            H = m >> (s + 1)
            vals[s * half : s * half + H] = self._powers(pow(w_m, 1 << s, self.ctx.p), H)
        return self.ctx.array(vals, device=self.device).reshape(S, half, self.ctx.L)

    def _w_pow(self, w: int, e: torch.Tensor) -> torch.Tensor:
        """w^e (Montgomery) for int64 exponents e [...] < N, through K1:
        w^(e mod 2^10) * (w^(2^10))^(e >> 10) from two small tables."""
        ctx = self.ctx
        lo_bits = min(self.n_log2, 10)
        lo = ctx.array(self._powers(w, 1 << lo_bits), device=self.device)
        hi = ctx.array(self._powers(pow(w, 1 << lo_bits, ctx.p), 1 << (self.n_log2 - lo_bits)), device=self.device)
        return arith.mont_mul(ctx, lo[e & ((1 << lo_bits) - 1)], hi[e >> lo_bits])

    def _pre_matrix(self, w: int, i: int) -> torch.Tensor:
        """Pass-i pre-twiddles in pass-i layout [A_i, m_i, C_i, L]: the
        exponent is (N / M_{i-1}) * k_{i-1} * (n_i * C_i + c) mod N, where
        k_{i-1} is the frequency that slot ``a mod m_{i-1}`` holds."""
        ms, N = self.ms, self.N
        A, m, C = math.prod(ms[:i]), ms[i], math.prod(ms[i + 1 :])
        base_exp = N // math.prod(ms[i - 1 :])
        dev = self.device
        k_prev = torch.from_numpy(self.revs[i - 1]).to(dev)[torch.arange(A, device=dev) % ms[i - 1]]
        inner = torch.arange(m * C, device=dev, dtype=torch.int64)  # n_i * C_i + c
        e = (base_exp * k_prev % N)[:, None] * inner[None, :] % N
        return self._w_pow(w, e.reshape(-1)).reshape(A, m, C, self.ctx.L)

    def _natural_rows(self) -> torch.Tensor:
        """dst[pos]: the natural-order row of what the last pass leaves at
        position pos = sum_j q_j prod(ms[j+1:]), slot q_j holding the
        frequency k_j = rev_j(q_j), namely sum_j k_j prod(ms[:j])."""
        dev = self.device
        pos = torch.arange(self.N, device=dev, dtype=torch.int64)
        dst = torch.zeros_like(pos)
        for j, m in enumerate(self.ms):
            slot = (pos // math.prod(self.ms[j + 1 :])) % m
            dst += torch.from_numpy(self.revs[j]).to(dev)[slot] * math.prod(self.ms[:j])
        return dst

    # -- the transform --------------------------------------------------------
    def __call__(self, table: torch.Tensor) -> torch.Tensor:
        """[N, L] Montgomery -> transformed [N, L] (natural order both ends)."""
        ctx, ms, L = self.ctx, self.ms, self.ctx.L
        if table.shape != (self.N, L):
            raise ValueError(f"SixStepPlan: expected a [{self.N}, {L}] table, got {tuple(table.shape)}")
        x = table.contiguous()
        last = len(ms) - 1
        for i, m in enumerate(ms):
            view = x.view(math.prod(ms[:i]), m, math.prod(ms[i + 1 :]), L)
            tail = (self.scale, self.dst) if i == last else (None, None)
            x = kernels.dif_pass(ctx, view, self.tws[i], self.pres[i], *tail).view(self.N, L)
        return x
