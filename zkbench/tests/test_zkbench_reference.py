"""The reference against the program's plain path (its CPU versions) at small
sizes, and its parts against known values."""

import random
import time

import pytest
import torch

from zkbench import harness
from zkbench.reference import bn254, fri, keccak
from zkbench.reference.field import Field

from .conftest import SMALL

R = bn254.R


def test_keccak_known_answers():
    assert keccak.keccak256(b"").hex() == "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    assert keccak.keccak256(b"abc").hex() == "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"
    msgs = [bytes(random.Random(i).randbytes(n)) for i, n in enumerate((32, 64, 64, 32))]
    for m in msgs:
        lanes = [torch.tensor([int.from_bytes(m[8 * j:8 * j + 8], "little")]).to(torch.int64)
                 if int.from_bytes(m[8 * j:8 * j + 8], "little") < 1 << 63
                 else torch.tensor([int.from_bytes(m[8 * j:8 * j + 8], "little") - (1 << 64)])
                 for j in range(len(m) // 8)]
        assert keccak.lanes_to_bytes(keccak.hash_blocks(lanes, len(m)))[0] == keccak.keccak256(m)


def test_field_against_python_ints():
    F = Field(R, "cpu")
    rng = random.Random(1)
    xs = [rng.randrange(R) for _ in range(64)] + [0, 1, R - 1]
    ys = [rng.randrange(R) for _ in range(64)] + [R - 1, R - 1, R - 1]
    a, b = F.table(xs), F.table(ys)
    assert F.ints(F.add(a, b)) == [(x + y) % R for x, y in zip(xs, ys)]
    assert F.ints(F.sub(a, b)) == [(x - y) % R for x, y in zip(xs, ys)]
    rinv = pow(1 << 256, -1, R)
    assert F.ints(F.mont(a, b)) == [x * y * rinv % R for x, y in zip(xs, ys)]
    assert F.ints(F.mul(a, 12345)) == [x * 12345 % R for x in xs]
    assert F.sum(a) == sum(xs) % R
    point = [rng.randrange(R) for _ in range(6)]
    t = F.table(xs[:64])
    want = xs[:64]
    for r in point:
        want = [(lo + r * (hi - lo)) % R for lo, hi in zip(want[:len(want) // 2], want[len(want) // 2:])]
    assert F.evaluate(t, point) == want[0]


def test_field_matches_the_programs_montgomery_form():
    from tpu_zk_torch.fields import arith
    from tpu_zk_torch.fields.arith import field_ctx

    ctx = field_ctx("bn254_fr")
    from zkbench.inputs import uniform_rows

    rows = uniform_rows(R, 32, 7, 0, "cpu")
    F = Field(R, "cpu")
    assert F.ints(F.from_montgomery(F.from_rows(rows))) == ctx.to_ints(rows)
    assert ctx.to_ints(arith.from_mont(ctx, rows), mont=False) == ctx.to_ints(rows)


def test_curve_and_root_of_unity_match_the_program():
    from tpu_zk_torch.curves.host_ec import HostCurve
    from tpu_zk_torch.ntt.ntt import find_root_of_unity

    hc = HostCurve("bn254")
    for k in (1, 2, 12345, R - 1):
        assert bn254.g1_mul(k) == hc.g1_affine(hc.g1_mul(hc.g1_generator(), k))
    assert bn254.g1_mul(0) is None and bn254.g1_mul(R) is None
    for k in (4, 10, 24):
        assert fri.root_of_unity(R, k) == find_root_of_unity("bn254_fr", k)


def test_ntt_matches_the_programs(on_cpu):
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.ntt.ntt import NTT

    ctx = field_ctx("bn254_fr")
    F = Field(R, "cpu")
    values = [random.Random(3).randrange(R) for _ in range(64)]
    want = NTT("bn254_fr", 6, device="cpu").forward_ints(values)
    assert F.ints(fri.ntt(F, F.table(values), fri.root_of_unity(R, 6))) == want
    assert ctx.p == R


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_at_a_small_size_is_correct(cell, trace, on_cpu):
    result = harness.run_cell(cell, 2**31 + 99, 0.5, bool(trace), "cpu", time.perf_counter(), config=SMALL[cell])
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "compared" and result["compared"]["mismatched_elements"]["value"] == 0
    names = {m["name"] for m in harness.metrics_for(harness.load_benchmark(), cell, bool(trace))}
    assert set(result["metrics"]) <= names
    if not trace:
        assert {"proofs_per_s", "setup_s"} <= set(result["metrics"])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_another_statement_is_caught(cell, on_cpu):
    """The judge of statement 1 rejects a proof of statement 0."""
    _, _, traffic = harness.cell_parts(harness.load_benchmark(), cell)
    entry = harness.entry_class(traffic)(SMALL[cell], traffic, 5, "cpu")
    plain = entry.plain(entry.prove(entry.inputs(0)))
    assert entry.reference(0)(plain).mismatches == 0
    assert entry.reference(1)(plain).mismatches > 0
