"""Multilinear KZG trusted setup.  Counterpart of :mod:`tpu_zk.kzg.trusted_setup`.

Reference parity: ``multilinear_kzg/src/trusted_setup.rs`` --
``initialize_setup`` :11-22, ``compute_lagrange_basis`` :24-49 (hypercube
index bits MSB-first, bit i selects tau_i vs 1-tau_i),
``compute_g1_powers_of_tau`` :51-62, ``compute_g2_powers_of_tau`` :64-74,
``generate_values_for_tau`` :76-87.

The 2^n Lagrange basis is built by n interleave-and-scale passes on the
device (K1), and the G1 powers come from the windowed fixed-base method
(:mod:`tpu_zk_torch.curves.fixed_base`: one gather and one complete add over
all points per 4-bit window).  G2 powers (n tiny points) stay on the host.
Both the fixed-base pass and the fold chain work through the points in
chunks of ``CHUNK_POINTS``, so that a complete add's stacked operands (about
30 field elements per point) stay a few GiB at 2^24 points.
"""

from __future__ import annotations

import random
import secrets

import torch

from ..curves.ec_device import DeviceCurve, Point, ec_add
from ..curves.fixed_base import digits4, fixed_base_msm, host_window_table
from ..fields import arith

CHUNK_POINTS = 1 << 21


def compute_lagrange_basis_device(fr, taus: list[int], device=None) -> torch.Tensor:
    """[2^n, L] Montgomery tensor of hypercube Lagrange-basis values."""
    basis = fr.array([1], device=device)
    for t in taus:
        t_m = fr.scalar(t, device=basis.device)
        one_minus_t = fr.scalar((1 - t) % fr.p, device=basis.device)
        low = arith.mont_mul(fr, basis, one_minus_t)
        high = arith.mont_mul(fr, basis, t_m)
        basis = torch.stack([low, high], dim=1).reshape(-1, fr.L)
    return basis


def _ec_add_chunked(ctx, b3, P: Point, Q: Point) -> Point:
    """P + Q over [n, L] point arrays, CHUNK_POINTS at a time."""
    n = P[0].shape[0]
    if n <= CHUNK_POINTS:
        return ec_add(ctx, b3, P, Q)
    out = tuple(torch.empty_like(c) for c in P)
    for i in range(0, n, CHUNK_POINTS):
        part = ec_add(ctx, b3, tuple(c[i : i + CHUNK_POINTS] for c in P), tuple(c[i : i + CHUNK_POINTS] for c in Q))
        for o, c in zip(out, part):
            o[i : i + CHUNK_POINTS] = c
    return out


class TrustedSetup:
    def __init__(self, curve: DeviceCurve, g1_powers: Point, g2_powers_host, num_vars: int):
        self.curve = curve
        self.g1_powers_of_tau = g1_powers  # device Point arrays [2^n]
        self.g2_powers_of_tau = g2_powers_host  # host projective G2 points, len n
        self.num_vars = num_vars
        self._folded_g1 = None

    @classmethod
    def initialize_setup(cls, curve_name: str, taus: list[int], device=None) -> "TrustedSetup":
        """The setup for ``len(taus)`` variables, its G1 powers on ``device``
        (default: the package's default device)."""
        if len(taus) == 0:
            raise ValueError("requires at least one variable")
        dc = DeviceCurve(curve_name, device=device)
        fr = dc.fr

        basis = compute_lagrange_basis_device(fr, [t % fr.p for t in taus], device=dc.device)
        plain = arith.from_mont(fr, basis)
        del basis
        # shared base G -> windowed fixed-base method instead of per-point double-and-add
        table = host_window_table(dc, fr.L * 16)
        n = plain.shape[0]
        g1_powers = tuple(torch.empty((n, dc.ctx.L), dtype=torch.int32, device=dc.device) for _ in range(3))
        for i in range(0, n, CHUNK_POINTS):
            part = fixed_base_msm(dc.ctx, dc.b3, table, digits4(plain[i : i + CHUNK_POINTS]))
            for o, c in zip(g1_powers, part):
                o[i : i + CHUNK_POINTS] = c

        g2_gen = dc.host.g2_generator()
        g2_powers = [dc.host.g2_mul(g2_gen, t % fr.p) for t in taus]

        return cls(dc, g1_powers, g2_powers, len(taus))

    def lagrange_basis_ints(self):
        """Host view of the committed G1 powers (affine int pairs)."""
        return self.curve.points_to_host(self.g1_powers_of_tau)

    def folded_g1_bases(self) -> list[Point]:
        """Aggregated bases for ``open_and_prove``'s blown-up quotient MSMs.

        The reference (``multilinear_kzg.rs:181-209``) duplicates quotient i
        to full length 2^n and MSMs against all g1 powers; since
        ``blown[j] = q[j mod len]``, that MSM equals an MSM of the *short*
        quotient against H_i[k] = sum_r g1[r*len_i + k].  The H_i chain is a
        halving cascade of complete adds (N in all), computed once per setup
        and reused by every open.
        """
        if self._folded_g1 is None:
            dc = self.curve
            self._folded_g1 = _fold_chain(dc.ctx, dc.b3, self.g1_powers_of_tau, self.num_vars)
        return self._folded_g1


def _fold_chain(ctx, b3, P: Point, n_steps: int) -> list[Point]:
    out = []
    cur = P
    for _ in range(n_steps):
        half = cur[0].shape[0] // 2
        cur = _ec_add_chunked(ctx, b3, tuple(c[:half] for c in cur), tuple(c[half:] for c in cur))
        out.append(cur)
    return out


def generate_values_for_tau(curve_name: str, number_of_variables: int, seed: int | None = None) -> list[int]:
    """Random taus below the scalar modulus: from the operating system's
    entropy, or reproducibly from ``seed`` (for tests and benchmarks only)."""
    from ..curves.params import CURVES

    r = CURVES[curve_name]["r"]
    if seed is None:
        return [secrets.randbelow(r) for _ in range(number_of_variables)]
    rng = random.Random(seed)
    return [rng.randrange(r) for _ in range(number_of_variables)]
