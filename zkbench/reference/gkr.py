"""The reference's reading of a GKR proof of the tree-sum circuit, plain and
succinct (inputs committed with multilinear KZG).

The circuit has 2^depth inputs and ``depth`` layers of ADD gates; gate g of
layer i (2^i gates, layer 0 the output) adds wires 2g and 2g + 1 of the
layer below.  The protocol is the one of ``gkr/src/gkr_protocol.rs`` and
``gkr/src/succinct_gkr_protocol.rs`` (Keccak-256 Fiat-Shamir, each layer's
sumcheck over its (b, c) variables, variable 0 the most significant index
bit).  A :class:`Statement` holds what the reference works out itself from
the inputs: the circuit output, the inputs' multilinear extension at any
point and, given the setup's taus, the KZG commitment and the quotient
commitments of an opening.  :func:`check` replays the proof's transcript and
counts every element of the proof that disagrees with what the reference
derives:

* the circuit output;
* every layer's claimed sum, and every round polynomial (three canonical
  coefficients whose values at 0 and 1 add up to the running claim);
* every challenge, drawn again from the transcript;
* every layer's closing claim against the wiring's value at (rb, rc),
  worked out in closed form for the tree, times the layer's wb/wc; the last
  layer's wb/wc are the inputs' extension at (rb, rc);
* with a commitment: the commitment, and both openings' evaluations and
  quotient points.

A round polynomial that differs from the honest one changes the claim that
the next round or layer is held to, so it shows in a later check unless a
later element compensates (probability at most 2/p a round).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .bn254 import g1_mul
from .field import Field
from .keccak import Sponge


def be(x: int) -> bytes:
    return x.to_bytes(32, "big")


def le(x: int) -> bytes:
    return x.to_bytes(32, "little")


class Statement:
    """One input table of the circuit (canonical values, ``[16, 2^n]`` on the
    field's device) and, for the succinct protocol, the setup's taus."""

    def __init__(self, F: Field, table: torch.Tensor, taus: list[int] | None = None):
        self.F = F
        self.table = table
        self.n = table.shape[1].bit_length() - 1
        self.output = F.sum(table)
        self.taus = taus
        self._mle: dict[tuple, int] = {}
        self._suffix: list[torch.Tensor] | None = None
        self._points: dict[int, tuple | None] = {}

    def mle(self, point: list[int]) -> int:
        key = tuple(point)
        if key not in self._mle:
            self._mle[key] = self.F.evaluate(self.table, point)
        return self._mle[key]

    def _suffix_tables(self) -> list[torch.Tensor]:
        """S[k]: the table with variables k..n-1 fixed at taus k..n-1 (2^k values)."""
        if self._suffix is None:
            tables = [self.table]
            for k in reversed(range(self.n)):
                tables.append(self.F.fold_last(tables[-1], self.taus[k]))
            self._suffix = tables[::-1]
        return self._suffix

    def _point(self, scalar: int):
        if scalar not in self._points:
            self._points[scalar] = g1_mul(scalar)
        return self._points[scalar]

    def commitment(self):
        """f(tau) G1: the commitment to the table against the Lagrange powers of tau."""
        return self._point(self.F.ints(self._suffix_tables()[0])[0])

    def opening(self, z: list[int]) -> tuple[int, list]:
        """(f(z), the n quotient commitments): quotient i evaluated at taus
        i+1.. is f(z_<i, 1, tau_>i) - f(z_<i, 0, tau_>i)."""
        S = self._suffix_tables()
        points = []
        for i in range(self.n):
            lo, hi = self.F.partial_first(S[i + 1], z[:i])
            points.append(self._point((hi - lo) % self.F.p))
        return self.mle(z), points


@dataclass
class Tally:
    """Elements compared and those that disagree (the first few named)."""

    checked: int = 0
    mismatches: int = 0
    first: list[str] = field(default_factory=list)

    def expect(self, ok: bool, what: str) -> None:
        self.checked += 1
        if not ok:
            self.mismatches += 1
            if len(self.first) < 8:
                self.first.append(what)


def _tri(x: int, y: int, z: int) -> int:
    return x * y * z + (1 - x) * (1 - y) * (1 - z)


def wiring(layer: int, ra: int, alpha: int, beta: int, rb_prev: list[int], rc_prev: list[int],
           rb: list[int], rc: list[int], p: int) -> int:
    """add_i at (rb, rc), weighted by the layer's output claim: eq(ra, 0) for
    layer 0, alpha eq(rb_prev, .) + beta eq(rc_prev, .) below it."""
    tail = (1 - rb[-1]) * rc[-1] % p  # left wire even, right wire odd
    if layer == 0:
        return (1 - ra) * tail % p
    a = b = 1
    for x, y, zb, zc in zip(rb_prev, rc_prev, rb[:-1], rc[:-1]):
        a = a * _tri(x, zb, zc) % p
        b = b * _tri(y, zb, zc) % p
    return (alpha * a + beta * b) * tail % p


def check(st: Statement, proof: dict, depth: int, succinct: bool) -> Tally:
    """Compare a GKR proof (plain ints, see the module's entries) with what the
    reference derives from the statement."""
    p = st.F.p
    t = Tally()
    canonical = lambda v: isinstance(v, int) and 0 <= v < p  # noqa: E731
    chal = lambda: int.from_bytes(tr.challenge(), "little") % p  # noqa: E731

    tr = Sponge()
    out = st.output
    t.expect(proof["output"] == [out], "circuit output")
    tr.update(be(out) + be(0))
    ra = chal()
    claim = out * (1 - ra) % p
    alpha = beta = 0
    rb_prev: list[int] = []
    rc_prev: list[int] = []
    rb: list[int] = []
    rc: list[int] = []
    layers = proof["layers"]
    t.expect(len(layers) == depth and len(proof["wb"]) == len(proof["wc"]) == depth - 1, "proof shape")
    last_claim = claim
    for i, layer in enumerate(layers[:depth]):
        s = i + 1
        last = i == depth - 1
        last_claim = claim
        t.expect(layer["claimed_sum"] == claim, f"layer {i} claimed sum")
        tr.update(be(claim))
        rs = []
        polys = layer["polys"]
        t.expect(len(polys) == 2 * s, f"layer {i} rounds")
        for j, coeffs in enumerate(polys):
            ok = len(coeffs) == 3 and all(canonical(c) for c in coeffs)
            t.expect(ok and (2 * coeffs[0] + coeffs[1] + coeffs[2]) % p == claim, f"layer {i} round {j} poly")
            tr.update(b"".join(le(c % p) for c in coeffs))
            r = chal()
            rs.append(r)
            claim = sum(c * pow(r, k, p) for k, c in enumerate(coeffs)) % p
        t.expect(layer["challenges"] == rs, f"layer {i} challenges")
        rb, rc = rs[:s], rs[s:]
        if last:
            wb, wc = st.mle(rb), st.mle(rc)
        else:
            wb, wc = proof["wb"][i], proof["wc"][i]
            t.expect(canonical(wb) and canonical(wc), f"layer {i} wb/wc")
        add = wiring(i, ra, alpha, beta, rb_prev, rc_prev, rb, rc, p)
        t.expect(claim == add * (wb + wc) % p, f"layer {i} closing claim")
        if not last:
            tr.update(be(wb % p))
            alpha = chal()
            tr.update(be(wc % p))
            beta = chal()
            claim = (alpha * wb + beta * wc) % p
            rb_prev, rc_prev = rb, rc
    t.expect(proof["claimed_sum"] == last_claim, "claimed sum")

    if succinct:
        t.expect(proof["commitment"] == st.commitment(), "input commitment")
        for name, z, opening in zip(("rb", "rc"), (rb, rc), proof["openings"]):
            v, points = st.opening(z)
            t.expect(opening["evaluation"] == v, f"opening at {name}: evaluation")
            t.expect(len(opening["points"]) == len(points), f"opening at {name}: quotients")
            for i, (got, want) in enumerate(zip(opening["points"], points)):
                t.expect(got == want, f"opening at {name}: quotient {i}")
    return t
