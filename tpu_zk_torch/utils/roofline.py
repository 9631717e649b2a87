"""Speed-of-light (roofline) models of the port's kernels on one H100.

Counterpart of :mod:`tpu_zk.utils.roofline`, counted in the port's units,
as ``chip_smoke.py`` counts every kernel's bound: bytes through device
memory (each input read once, each output written once, elements as the
tensors hold them, L int32 words of 16-bit limbs), wide multiply-adds
(32 x 32 + 64 -> 64 bit: a Montgomery product of N = L/2 32-bit limbs is
2 N^2 of them, N^2 for a * b and N^2 for the reduction's m * p) or,
equivalently, twice as many 32-bit multiply-adds (the lo and hi halves),
and 32-bit logic and shift instructions for Keccak (180 a round).  A
kernel's bound is the larger of its bytes over the memory rate and its
operations in the cheaper of the two multiply-add units.  The sponge (K7)
is one serial chain, so its bound is counted in dependent instructions at
the latency of one (:func:`sponge_step_bound_ms`).

The rates: device memory at the H100's published 3.35 TB/s; the others as
``csrc/probe.cu`` measured them on an H100 80GB HBM3 at a 700 W power limit
(``chip_smoke.py`` phase 2, ``PERF.md`` section 6).  ``chip_smoke.py``
probes them again in every run and passes its own to these functions.
"""

from __future__ import annotations

from dataclasses import dataclass

HBM_BYTES_PER_S = 3.35e12  # the H100's published device-memory rate
WIDE_MADS_PER_S = 7.28e12  # probed: wide (32 x 32 + 64 -> 64 bit) multiply-adds
MADS32_PER_S = 1.67e13  # probed: 32-bit multiply-adds
LOGIC_OPS_PER_S = 1.66e13  # probed: 32-bit funnel shifts and logic ops
RATES = (WIDE_MADS_PER_S, MADS32_PER_S)
KECCAK_ROUND_OPS = 180  # 32-bit logic and shift instructions of one full Keccak-f round (csrc/keccak.cu)
PERMUTATION_OPS = 24 * KECCAK_ROUND_OPS
# 32-bit instructions on the longest dependent chain of one round, in 32-bit halves with three-input logic ops:
# theta's column parity of five lanes (two), its rotation by one (a funnel shift), the lane xor both parities
# (one), rho (a funnel shift), chi (one); iota's constant folds into the next round's parity
KECCAK_ROUND_DEPTH = 6
PERMUTATION_DEPTH = 24 * KECCAK_ROUND_DEPTH
# Montgomery products that one complete addition needs: Algorithm 7 has 12 products of two variables; its
# two by the constant b3 = 3b (9 on BN254, 12 on BLS12-381) are four modular additions each in csrc/ec.cuh
EC_ADD_PRODUCTS = 12


def mont_mul_wide_mads(ctx_or_L) -> int:
    """Wide multiply-adds of one CIOS product of N = L/2 32-bit limbs: N^2
    for a * b and N^2 for the reduction's m * p."""
    L = ctx_or_L if isinstance(ctx_or_L, int) else ctx_or_L.L
    return 2 * (L // 2) ** 2


def ops_ms(wide_mads: float, rates: tuple[float, float] = RATES) -> dict:
    """The least milliseconds for the multiply-adds of Montgomery products in
    each unit: as wide multiply-adds at the probed wide rate, and as 32-bit
    ones (two a wide one: the lo and hi halves) at the probed 32-bit rate."""
    return {"wide": wide_mads / rates[0] * 1e3, "32-bit": 2 * wide_mads / rates[1] * 1e3}


def bound_ms(n_bytes: float, wide_mads: float, rates: tuple[float, float] = RATES) -> tuple[float, str]:
    """The least milliseconds the card could take: the larger of the bytes
    over its memory rate and the operations in the cheaper of the two units
    (so that a kernel of 32-bit chains cannot read above its bound)."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, min(ops_ms(wide_mads, rates).values())
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


@dataclass
class KernelModel:
    """The work of one kernel or stage: bytes through device memory, wide
    multiply-adds and 32-bit logic/shift operations."""

    name: str
    bytes_moved: float
    wide_mads: float
    logic_ops: float = 0.0

    def t_memory(self) -> float:
        return self.bytes_moved / HBM_BYTES_PER_S

    def t_compute(self, rates: tuple[float, float] = RATES, logic_rate: float = LOGIC_OPS_PER_S) -> float:
        return min(ops_ms(self.wide_mads, rates).values()) / 1e3 + self.logic_ops / logic_rate

    def t_roofline(self, rates: tuple[float, float] = RATES, logic_rate: float = LOGIC_OPS_PER_S) -> float:
        return max(self.t_memory(), self.t_compute(rates, logic_rate))

    def row(self, measured_s: float, rates: tuple[float, float] = RATES, logic_rate: float = LOGIC_OPS_PER_S) -> dict:
        t_mem, t_ops = self.t_memory(), self.t_compute(rates, logic_rate)
        least = max(t_mem, t_ops)
        return {
            "kernel": self.name, "bytes_moved": self.bytes_moved, "wide_mads": self.wide_mads,
            "logic_ops": self.logic_ops, "t_memory_ms": t_mem * 1e3, "t_compute_ms": t_ops * 1e3,
            "t_roofline_ms": least * 1e3, "t_measured_ms": measured_s * 1e3,
            "pct_of_sol": 100.0 * least / measured_s if measured_s else 0.0,
            "bound": "bytes" if t_mem >= t_ops else "operations",
        }


def sumcheck_round_model(n_log2: int, L: int = 16) -> KernelModel:
    """One basic-sumcheck round at 2^n (K2): read N elements, write N/2, one
    product a pair (lo + r (hi - lo))."""
    N = 1 << n_log2
    return KernelModel(f"sumcheck round 2^{n_log2}", (N + N // 2) * L * 4, N // 2 * mont_mul_wide_mads(L))


def ntt_model(n_log2: int, L: int = 16, radix_log2: int = 8) -> KernelModel:
    """A forward NTT at 2^n in passes of radix 2^radix_log2 (K6): each pass
    reads and writes the table, every pass after the first reads its
    pre-twiddles, the last reads the natural-order index [N] int64; the
    products are the butterflies' except by w^0 (m - 1 of each column's
    m/2 log2 m) and the pre-twiddles (counted as N a pass, ones included)."""
    N = 1 << n_log2
    passes = -(-n_log2 // radix_log2)
    ms = [1 << radix_log2] * (passes - 1) + [1 << (n_log2 - radix_log2 * (passes - 1))]
    products = sum(N // m * (m // 2 * (m.bit_length() - 1) - (m - 1)) for m in ms) + (passes - 1) * N
    n_bytes = sum(2 * N * L * 4 + (N * L * 4 if i else 0) for i in range(passes)) + N * 8
    return KernelModel(f"ntt forward 2^{n_log2}", n_bytes, products * mont_mul_wide_mads(L))


def msm_model(n_log2: int, c: int = 16, L: int = 16, scalar_bits: int = 254) -> KernelModel:
    """A Pippenger MSM at 2^n points with signed c-bit windows (K4a, K4b):
    per window one complete addition a point into its bucket and two a
    bucket for the running sums, each EC_ADD_PRODUCTS Montgomery products;
    points (three coordinates) and scalars read once."""
    N = 1 << n_log2
    windows = scalar_bits // c + 1
    adds = windows * (N + 2 * (1 << (c - 1)))
    return KernelModel(f"msm 2^{n_log2}", N * (3 + 1) * L * 4, adds * EC_ADD_PRODUCTS * mont_mul_wide_mads(L))


def fri_model(n_log2: int, rounds: int, L: int = 16) -> KernelModel:
    """A FRI commit phase from a 2^n codeword: every round hashes its
    codeword into a Merkle tree (leaves of one element, 2 width - 1
    permutations) and folds it to half (one product a pair)."""
    widths = [1 << (n_log2 - r) for r in range(rounds)]
    hashes = sum(2 * w - 1 for w in widths)
    n_bytes = sum(w * L * 4 + w // 2 * L * 4 + (2 * w - 1) * 32 for w in widths)
    return KernelModel(f"fri commit 2^{n_log2}", n_bytes, sum(w // 2 for w in widths) * mont_mul_wide_mads(L),
                       hashes * PERMUTATION_OPS)


def gkr_layer_model(depth: int, L: int = 16) -> KernelModel:
    """The sumcheck rounds of a linear-time GKR prove of a depth-d tree: a
    layer reading a table of S = 2^s entries runs two phases of s rounds
    over a [2, 2, T] working set (T = S, S/2, ..., 2): per round two
    collapse products a pair at each of t = 0, 1, 2 (3 T) and a fold of
    the four tables (2 T products); bytes: the set read once and its
    half written."""
    products = n_bytes = 0
    for s in range(1, depth + 1):
        for _ in range(2):
            for r in range(s):
                T = 1 << (s - r)
                products += 3 * T + 2 * T
                n_bytes += (4 * T + 2 * T) * L * 4
    return KernelModel(f"sparse gkr rounds, depth {depth}", n_bytes, products * mont_mul_wide_mads(L))


def sponge_permutations(pos: int, steps) -> tuple[int, int]:
    """(Keccak-f permutations, final fill level) of the sponge steps
    ``steps`` = [(data bytes, squeeze)] from fill level ``pos``: one a full
    136-byte block, one for each squeeze's clone, then the digest's 32
    bytes absorbed."""
    perms = 0
    for k, squeeze in steps:
        perms += (pos + k) // 136
        pos = (pos + k) % 136
        if squeeze:
            perms += 1 + (pos + 32) // 136
            pos = (pos + 32) % 136
    return perms, pos


def sponge_step_bound_ms(permutations: float, data_bytes: int, dependent_op_s: float, L: int = 16) -> tuple[float, str]:
    """K7's bound for one step.  Its permutations form one chain (each
    block, the squeeze's clone and the digest's block wait for the one
    before), and however many threads share a permutation, each of its
    rounds waits for KECCAK_ROUND_DEPTH dependent instructions: so at least
    PERMUTATION_DEPTH instructions' latency ``dependent_op_s`` (measured by
    csrc/probe.cu's tzk_latency_probe) a permutation.  Its bytes (the data,
    the state, tail and fill level read and written, the digest and the
    challenge written) at the memory rate.  The challenge's product by R^2
    and the launch itself are left out; chip_smoke.py gives the launch
    beside the bound."""
    by_ops = permutations * PERMUTATION_DEPTH * dependent_op_s * 1e3
    by_bytes = (data_bytes + 2 * (200 + 136 + 4) + 32 + 4 * L) / HBM_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def render_markdown(rows: list[dict], card: str = "an H100") -> str:
    """A table of ``KernelModel.row`` results."""
    out = [
        f"# Speed-of-light table ({card})",
        "",
        "Roofline = max(memory floor, operation floor); memory at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, multiply-adds and logic ops at the probed rates.",
        "",
        "| kernel | bound | bytes | wide multiply-adds | logic ops | roofline (ms) | measured (ms) | % of bound |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        out.append(
            f"| {r['kernel']} | {r['bound']} | {r['bytes_moved'] / 1e6:.1f} MB | {r['wide_mads'] / 1e9:.3f} G "
            f"| {r['logic_ops'] / 1e9:.3f} G | {r['t_roofline_ms']:.4f} | {r['t_measured_ms']:.4f} "
            f"| {r['pct_of_sol']:.1f}% |"
        )
    out.append("")
    return "\n".join(out)
