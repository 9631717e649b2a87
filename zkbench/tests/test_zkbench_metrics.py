"""The metric arithmetic: idle share over overlapping intervals, the field
kernels' bytes model, the 95th percentile and the idle gaps' attribution."""

import contextlib

import pytest
import torch

from zkbench import harness
from zkbench import trace as tracing


def test_union_of_overlapping_intervals():
    ops = [("a", 0, 10), ("b", 5, 20), ("c", 30, 40), ("d", 35, 38), ("e", 40, 45)]
    assert tracing.merged(ops) == [(0, 20), (30, 45)]
    run = harness.Run(window_s=50e-9, device_ops=ops)
    assert run.busy_s == pytest.approx(35e-9)
    assert harness.reader("device_idle_pct").read(run) == pytest.approx(30.0)
    assert harness.reader("device_idle_pct").read(harness.Run(window_s=1.0, device_ops=[])) is None


def test_device_time_by_kernel_name():
    ops = [("void mont_mul_kernel<8>(...)", 0, 2_000_000), ("void fold_kernel<8>(...)", 3_000_000, 4_000_000),
           ("void msm_units_kernel(...)", 5_000_000, 9_000_000)]
    run = harness.Run(attempted=2, device_ops=ops)
    assert run.device_s("mont_mul_kernel", "fold_kernel") == pytest.approx(3e-3)
    assert harness.reader("msm_device_ms_per_proof").read(run) == pytest.approx(2.0)
    assert harness.reader("ntt_merkle_device_ms_per_proof").read(run) is None


def test_field_kernel_bytes_model():
    roof = harness.reader("field_kernels_roofline")
    a, b = torch.zeros((1 << 10, 16), dtype=torch.int32), torch.zeros(16, dtype=torch.int32)
    assert roof.launch_bytes((a, b), torch.empty_like(a)) == 2 * (1 << 10) * 64 + 64  # K1 with a broadcast b
    assert roof.launch_bytes((a, a, "add"), torch.empty_like(a)) == 3 * (1 << 10) * 64  # K3
    flat = torch.zeros((1, 8, 16), dtype=torch.int32)
    folded, sums = torch.zeros((1, 4, 16), dtype=torch.int32), torch.zeros((1, 1, 18), dtype=torch.int32)
    assert roof.launch_bytes((flat, b, 4), (folded, sums)) == (8 * 16 + 16 + 4 * 16 + 18) * 4  # K2
    run = harness.Run(device_ops=[("mont_mul_kernel", 0, 1_000_000)], notes={"field_kernel_bytes": 1.675e9})
    assert roof.read(run) == pytest.approx(50.0)


def test_field_kernel_wrappers_are_counted_and_put_back(on_cpu):
    from tpu_zk_torch.fields import kernels
    from tpu_zk_torch.fields.arith import field_ctx

    roof = harness.reader("field_kernels_roofline")
    saved = (kernels.mont_mul, kernels.mont_mul.launches)
    notes = {}
    with roof.during(notes):
        assert kernels.mont_mul is not saved[0]
        kernels.mont_mul.launches += 3  # what the wrapper's body does on a launch
        ctx = field_ctx("bn254_fr")
        x = torch.zeros((4, 16), dtype=torch.int32)
        kernels.mont_mul(ctx, x, x)  # on the CPU: the plain version, no launch, no bytes
    assert kernels.mont_mul is saved[0] and kernels.mont_mul.launches == saved[1] + 3
    kernels.mont_mul.launches = saved[1]
    assert notes["field_kernel_bytes"] == 0


def test_launch_counters_over_a_window():
    lp = harness.reader("launches_per_proof")
    notes = {}
    from tpu_zk_torch.transcript import kernels

    with lp.during(notes):
        kernels.sponge_step.launches += 20
    kernels.sponge_step.launches -= 20
    assert lp.read(harness.Run(attempted=4, notes=notes)) == 5.0


def test_p95_over_a_known_list():
    p95 = harness.reader("prove_p95_ms")
    values = [i / 1000 for i in range(1, 101)]  # 1 .. 100 ms
    assert p95.p95(values) == pytest.approx(0.09505)
    assert p95.read(harness.Run(latencies_s=values)) == pytest.approx(95.05)
    assert harness.reader("proofs_per_s").read(harness.Run(attempted=10, raised=2, window_s=4.0)) == 2.0


def test_idle_gaps_named_by_the_innermost_host_op():
    intervals = [(0, 10), (20, 30), (60, 70)]
    host = [("zkbench.proof", 0, 100), ("aten::item", 12, 18), ("aten::copy_", 40, 55)]
    gaps = dict(tracing.idle_by_host(intervals, host))
    assert gaps == {"aten::item": pytest.approx(10e-9), "aten::copy_": pytest.approx(30e-9)}
    gaps = dict(tracing.idle_by_host([(0, 10), (50, 60)], [("aten::item", 12, 18)]))
    assert gaps == {"host, outside any op": pytest.approx(40e-9)}


def test_profiler_events_are_read():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("zkbench.proof"):
            torch.ones(8).sum()
    device, host = tracing.events(prof)
    assert device == [] and any(name == "zkbench.proof" for name, _, _ in host)
    assert all(start <= end for _, start, end in host)


def test_reader_hooks_nest(on_cpu):
    notes = {}
    with contextlib.ExitStack() as stack:
        for name in ("field_kernels_roofline", "launches_per_proof"):
            stack.enter_context(harness.reader(name).during(notes))
    assert notes == {"field_kernel_bytes": 0, "launches": 0}
