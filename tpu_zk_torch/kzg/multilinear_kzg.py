"""Multilinear KZG: commit (MSM), open/prove (quotient chain + MSMs),
pairing verification.  Counterpart of :mod:`tpu_zk.kzg.multilinear_kzg`.

Reference parity: ``multilinear_kzg/src/multilinear_kzg.rs`` --
commit_to_polynomial :25-45 (MSM against the G1 Lagrange powers),
open_and_prove :50-126 (per variable: quotient = top-minus-bottom half :165-179,
blow-up duplication :181-209, MSM proof :100-107, fold remainder :113-119),
verify :131-158 (pairing product check
``e(C - v g1, g2) == sum_i e(Q_i, tau_i g2 - x_i g2)``).

Quotients and folds are table operations on the polynomial's device (K3,
K2); each proof point is one device MSM (:func:`msm_pippenger`: K4 from 2048
points up); only the O(n)-pairing verify runs on the host, through the
native pairing engine.  ``tpu_zk`` pads the tail MSMs to a grid of shapes to
bound its compile count; nothing is compiled per shape here, so every MSM
runs at its own size.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves.host_ec import Fp, ec_neg
from ..curves.msm_pippenger import msm_pippenger
from ..curves.pairing_native import pairing_product_is_one
from ..fields import arith
from ..poly.multilinear import MultilinearPolynomial, fold
from .trusted_setup import TrustedSetup


@dataclass
class MultilinearKZGProof:
    evaluation: int  # v
    proofs: list  # affine G1 int pairs (or None), one per variable


def commit_to_polynomial(polynomial: MultilinearPolynomial, trusted_setup: TrustedSetup):
    """-> affine G1 point (host int pair)."""
    dc = trusted_setup.curve
    fr = dc.fr
    if polynomial.table.shape[0] != trusted_setup.g1_powers_of_tau[0].shape[0]:
        raise ValueError("Polynomial evaluation must match g1 length")
    plain = arith.from_mont(fr, polynomial.table)
    point = msm_pippenger(dc.ctx, dc.b3, (trusted_setup.g1_powers_of_tau, plain))
    return dc.point_to_host(point)


def open_and_prove(polynomial: MultilinearPolynomial, trusted_setup: TrustedSetup,
                   opening_values: list[int]) -> MultilinearKZGProof:
    dc = trusted_setup.curve
    fr = dc.fr
    n = polynomial.number_of_variables
    if n != len(opening_values):
        raise ValueError("number of polynomial variables must match length of opening values")
    if len(opening_values) != len(trusted_setup.g2_powers_of_tau):
        raise ValueError("Opening values must match number of variables from trusted setup")
    device = polynomial.table.device

    evaluation_v = polynomial.evaluate(opening_values)

    # f - v
    sub_table = arith.sub(fr, polynomial.table, fr.scalar(evaluation_v, device=device))

    # The reference blows each quotient up to full length and MSMs against
    # all g1 powers (multilinear_kzg.rs:100-107,181-209); MSM i here runs the
    # *short* quotient against the precomputed folded bases H_i -- the same
    # group element (sum regrouped by associativity), at 1/n the points.
    folded_bases = trusted_setup.folded_g1_bases()
    proofs = []
    for i, opening in enumerate(opening_values):
        half = sub_table.shape[0] // 2
        quotient = arith.sub(fr, sub_table[half:], sub_table[:half])
        scalars = arith.from_mont(fr, quotient)
        del quotient
        proof_point = msm_pippenger(dc.ctx, dc.b3, (folded_bases[i], scalars))
        proofs.append(dc.point_to_host(proof_point))
        # remainder: fold the first variable at the opening value
        sub_table = fold(fr, sub_table, 0, fr.scalar(opening, device=device))

    return MultilinearKZGProof(evaluation=evaluation_v, proofs=proofs)


def pairing_pairs(trusted_setup: TrustedSetup, commitment, opening_values: list[int], proof: MultilinearKZGProof):
    """The (G1, G2) affine pairs whose pairing product is one iff the proof
    holds: e(C - v g1, -g2) * prod_i e(Q_i, tau_i g2 - x_i g2)."""
    hc = trusted_setup.curve.host
    g1_gen = hc.g1_generator()
    c_proj = (Fp(hc.p, commitment[0]), Fp(hc.p, commitment[1]), hc.one)
    c_minus_v = hc.g1_add(c_proj, ec_neg(hc.g1_mul(g1_gen, proof.evaluation)))
    g2_gen = hc.g2_generator()

    pairs = [(hc.g1_affine(c_minus_v), hc.g2_affine(ec_neg(g2_gen)))]
    for i, tau_g2 in enumerate(trusted_setup.g2_powers_of_tau):
        x_g2 = hc.g2_mul(g2_gen, opening_values[i])
        pairs.append((proof.proofs[i], hc.g2_affine(hc.g2_sub(tau_g2, x_g2))))
    return pairs


def verify(trusted_setup: TrustedSetup, commitment, opening_values: list[int], proof: MultilinearKZGProof) -> bool:
    if len(opening_values) != len(proof.proofs):
        raise ValueError("Number of opening values must match number of proofs")
    if len(proof.proofs) != trusted_setup.num_vars:
        return False
    pairs = pairing_pairs(trusted_setup, commitment, opening_values, proof)
    return pairing_product_is_one(trusted_setup.curve.name, pairs)
