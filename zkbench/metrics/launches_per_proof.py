"""Kernel launches a proof over the traced window: the sum of every kernel
wrapper's ``launches`` counter (exact), K1-K7."""

import contextlib
import importlib

WRAPPERS = {
    "tpu_zk_torch.fields.kernels": ("mont_mul", "addsub", "fold"),
    "tpu_zk_torch.curves.kernels": ("msm_buckets", "msm_bucket_reduce"),
    "tpu_zk_torch.ntt.kernels": ("dif_pass",),
    "tpu_zk_torch.merkle.kernels": ("keccak_rows",),
    "tpu_zk_torch.transcript.kernels": ("sponge_step", "sponge_round"),
}


def total() -> int:
    return sum(getattr(importlib.import_module(m), name).launches for m, names in WRAPPERS.items() for name in names)


@contextlib.contextmanager
def during(notes):
    start = total()
    try:
        yield
    finally:
        notes["launches"] = total() - start


def read(run):
    return run.notes["launches"] / run.proofs if run.proofs and "launches" in run.notes else None
