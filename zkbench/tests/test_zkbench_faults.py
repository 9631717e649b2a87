"""A run with the timed path broken underneath comes out not correct: the
harness runs as on the card (minus its look for a card), at small sizes on
the CPU, with one fault planted in the program for the run."""

import time

import pytest
import torch

from zkbench import harness

from .conftest import SMALL

GKR_CELLS = ("succinct_gkr.bn254_d24", "gkr.bn254_d24_public")


def _run(cell):
    return harness.run_cell(cell, 2**31 + 11, 0.5, False, "cpu", time.perf_counter(), config=SMALL[cell])


@pytest.mark.parametrize("cell", GKR_CELLS)
def test_a_round_polynomial_altered_where_it_is_produced(cell, on_cpu, monkeypatch):
    from tpu_zk_torch.sumcheck import gkr_sumcheck

    real = gkr_sumcheck.prove_and_fold

    def altered(*args, **kw):
        proof, folded = real(*args, **kw)
        u = proof.round_univariate_polynomials[-1]
        u.coefficients[1] = (u.coefficients[1] + 1) % u.ctx.p
        return proof, folded

    monkeypatch.setattr(gkr_sumcheck, "prove_and_fold", altered)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", GKR_CELLS)
def test_half_of_the_inputs_left_out(cell, on_cpu, monkeypatch):
    from tpu_zk_torch.circuit.layered import Circuit

    real = Circuit.evaluate

    def half(self, values, *args, **kw):
        values = values.clone()
        values[values.shape[0] // 2:] = 0
        return real(self, values, *args, **kw)

    monkeypatch.setattr(Circuit, "evaluate", half)
    assert not _run(cell)["correct"]


def test_a_fri_value_altered_where_it_is_produced(on_cpu, monkeypatch):
    from tpu_zk_torch.fri import fri

    real = fri._hand_back

    def altered(*args, **kw):
        roots, final = real(*args, **kw)
        return roots, [(final[0] + 1) % fri.field_ctx("bn254_fr").p] + final[1:]

    monkeypatch.setattr(fri, "_hand_back", altered)
    assert not _run("fri.bn254_2p18")["correct"]


def test_half_of_the_codeword_left_out(on_cpu, monkeypatch):
    from tpu_zk_torch.fri import fri

    real = fri.prove

    def half(config, codeword, *args, **kw):
        codeword = codeword.clone()
        codeword[codeword.shape[0] // 2:] = torch.zeros_like(codeword[0])
        return real(config, codeword, *args, **kw)

    monkeypatch.setattr(fri, "prove", half)
    assert not _run("fri.bn254_2p18")["correct"]
