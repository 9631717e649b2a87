"""Radix-2 number-theoretic transform over the scalar fields, bit-identical
to :mod:`tpu_zk.ntt.ntt`.

:class:`NTT` ``forward``/``inverse`` run the multi-pass plan of
:mod:`.sixstep` (one K6 launch per pass) at every size and on either device;
``tpu_zk`` takes that plan only on a TPU from 2^12 up, a threshold that
answered its compile counts.  The stage-at-a-time transform
(:func:`_ntt_device`: a bit-reversal gather, then log2(N) butterfly stages of
K1 and K3 over one twiddle table made by K1 doublings) is kept as the
oracle that ``NTT.forward_stagewise``/``inverse_stagewise`` expose to the
tests and to ``chip_smoke.py``.  Works for any field with enough 2-adicity
(BN254 Fr: 2^28, BLS12-381 Fr: 2^32).
"""

from __future__ import annotations

import functools

import torch

from ..device import resolve
from ..fields import arith
from ..fields.arith import FieldCtx, field_ctx
from .kernels import MAX_LOG_M
from .sixstep import SixStepPlan, _bit_reverse


@functools.lru_cache(maxsize=None)
def find_root_of_unity(field_name: str, order_log2: int) -> int:
    """Smallest-base exact 2^k-th root of unity (host, exact ints)."""
    p = field_ctx(field_name).p
    two_adicity = (p - 1) & -(p - 1)
    assert (1 << order_log2) <= two_adicity, f"{field_name} lacks 2-adicity for 2^{order_log2}"
    for g in range(2, 1000):
        w = pow(g, (p - 1) >> order_log2, p)
        # exact order 2^order_log2 <=> w^(2^(k-1)) != 1
        if order_log2 == 0 or pow(w, 1 << (order_log2 - 1), p) != 1:
            if pow(w, 1 << order_log2, p) == 1:
                return w
    raise RuntimeError("no root found")


def _bit_reverse_indices(n_log2: int, device) -> torch.Tensor:
    return torch.from_numpy(_bit_reverse(n_log2)).to(device)


def _twiddle_table(ctx: FieldCtx, w_mont: torch.Tensor, half_log2: int) -> torch.Tensor:
    """[2^half_log2, L] powers w^0, w^1, ... (Montgomery): log-depth doubling
    through K1."""
    table = ctx.one_mont(w_mont.device)[None, :]
    w_pow = w_mont
    for _ in range(half_log2):
        table = torch.cat([table, arith.mont_mul(ctx, table, w_pow)])
        w_pow = arith.mont_mul(ctx, w_pow, w_pow)
    return table


def _ntt_device(ctx: FieldCtx, table: torch.Tensor, twiddles: torch.Tensor, n_log2: int) -> torch.Tensor:
    """Stage-at-a-time transform: table [N, L] in bit-reversed order ->
    natural-order output.  twiddles: [N/2, L] powers of the N-th root."""
    N, L = 1 << n_log2, ctx.L
    t = table
    for s in range(1, n_log2 + 1):
        m = 1 << s
        tw = twiddles[:: N >> s]  # [m/2, L] = w_m^j
        x = t.reshape(N // m, 2, m // 2, L)
        u = x[:, 0]
        v = arith.mont_mul(ctx, x[:, 1], tw[None])
        t = torch.stack([arith.add(ctx, u, v), arith.sub(ctx, u, v)], dim=1).reshape(N, L)
    return t


class NTT:
    """The size-2^n_log2 transform with root ``root`` (default: the smallest
    exact root of unity of that order).  ``max_log`` is the largest radix
    (log2) of one pass of the plan.  Tables keep their device; the plans
    and twiddles are built on it at first use."""

    def __init__(self, field_name: str, n_log2: int, root: int | None = None, max_log: int = MAX_LOG_M,
                 device=None):
        self.field_name = field_name
        self.ctx = field_ctx(field_name)
        self.n_log2 = n_log2
        self.N = 1 << n_log2
        self.root = root if root is not None else find_root_of_unity(field_name, n_log2)
        assert pow(self.root, self.N, self.ctx.p) == 1
        p = self.ctx.p
        self.root_inv = pow(self.root, p - 2, p)
        self.n_inv = pow(self.N, p - 2, p)
        self.max_log = max_log
        self.device = resolve(device)  # where forward_ints/inverse_ints put their host values
        self._plans: dict = {}
        self._twiddles: dict = {}

    def plan(self, inverse: bool, device) -> SixStepPlan:
        key = (inverse, torch.device(device))
        if key not in self._plans:
            self._plans[key] = SixStepPlan(self.field_name, self.n_log2, self.root, inverse=inverse,
                                           max_log=self.max_log, device=device)
        return self._plans[key]

    def forward(self, table: torch.Tensor) -> torch.Tensor:
        """[N, L] Montgomery coefficients -> evaluations at the root's powers."""
        return self.plan(False, table.device)(table)

    def inverse(self, table: torch.Tensor) -> torch.Tensor:
        return self.plan(True, table.device)(table)

    # the stage-at-a-time oracle
    def _stage_tables(self, inverse: bool, device):
        key = (inverse, torch.device(device))
        if key not in self._twiddles:
            w = self.root_inv if inverse else self.root
            self._twiddles[key] = (_bit_reverse_indices(self.n_log2, device),
                                   _twiddle_table(self.ctx, self.ctx.scalar(w, device=device), max(self.n_log2 - 1, 0)))
        return self._twiddles[key]

    def forward_stagewise(self, table: torch.Tensor) -> torch.Tensor:
        rev, tw = self._stage_tables(False, table.device)
        return _ntt_device(self.ctx, table.index_select(0, rev), tw, self.n_log2)

    def inverse_stagewise(self, table: torch.Tensor) -> torch.Tensor:
        rev, tw = self._stage_tables(True, table.device)
        out = _ntt_device(self.ctx, table.index_select(0, rev), tw, self.n_log2)
        return arith.mont_mul(self.ctx, out, self.ctx.scalar(self.n_inv, device=table.device))

    # host-convenience wrappers
    def forward_ints(self, values: list[int]) -> list[int]:
        return self.ctx.to_ints(self.forward(self.ctx.array(values, device=self.device)))

    def inverse_ints(self, values: list[int]) -> list[int]:
        return self.ctx.to_ints(self.inverse(self.ctx.array(values, device=self.device)))


def polynomial_multiply(field_name: str, a: list[int], b: list[int], device=None) -> list[int]:
    """Coefficient-domain product via the NTT, on ``device`` (the package's
    default, the card, when none is given)."""
    ctx = field_ctx(field_name)
    out_len = len(a) + len(b) - 1
    n_log2 = max(out_len - 1, 1).bit_length()
    ntt = NTT(field_name, n_log2, device=device)
    fa = ntt.forward(ctx.array(list(a) + [0] * (ntt.N - len(a)), device=ntt.device))
    fb = ntt.forward(ctx.array(list(b) + [0] * (ntt.N - len(b)), device=ntt.device))
    return ctx.to_ints(ntt.inverse(arith.mont_mul(ctx, fa, fb)))[:out_len]
