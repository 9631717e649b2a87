"""The field kernels' share of their memory roofline over the traced window:
the bytes every launch of K1 (``tzk_mont_mul``, CUDA name
``mont_mul_kernel``), K2 (``tzk_fold``, ``fold_kernel``) and K3
(``tzk_addsub``, ``addsub_kernel``) needs at the H100's published 3.35 TB/s,
over those kernels' device time.

A launch needs each input byte read once and each output byte written once,
as the tensors that its wrapper receives and returns hold them (int32 limbs):
the bytes model of ``tpu_zk_torch/utils/roofline.py``, copied.  The wrappers
are wrapped for the traced window only, and put back after it; a launch is
counted where the wrapper's ``launches`` counter moved.
"""

import contextlib

HBM_BYTES_PER_S = 3.35e12  # the H100's published device-memory rate
KERNELS = ("mont_mul_kernel", "fold_kernel", "addsub_kernel")
WRAPPERS = ("mont_mul", "addsub", "fold")


def launch_bytes(args, out) -> int:
    """Bytes of the tensor operands (after ctx) and of the outputs."""
    outs = out if isinstance(out, tuple) else (out,)
    return sum(t.numel() * t.element_size() for t in (*args, *outs) if hasattr(t, "numel"))


@contextlib.contextmanager
def during(notes):
    from tpu_zk_torch.fields import kernels

    notes["field_kernel_bytes"] = 0
    saved = {name: getattr(kernels, name) for name in WRAPPERS}

    def counted(fn):
        def wrapper(ctx, *args, **kw):
            before = wrapper.launches
            out = fn(ctx, *args, **kw)
            if wrapper.launches != before:  # the wrapper's body counts its launch on the module's attribute
                notes["field_kernel_bytes"] += launch_bytes(args, out)
            return out

        wrapper.launches = fn.launches
        return wrapper

    try:
        for name, fn in saved.items():
            setattr(kernels, name, counted(fn))
        yield
    finally:
        for name, fn in saved.items():
            fn.launches = getattr(kernels, name).launches
            setattr(kernels, name, fn)


def read(run):
    s = run.device_s(*KERNELS)
    n_bytes = run.notes.get("field_kernel_bytes", 0)
    return 100.0 * n_bytes / HBM_BYTES_PER_S / s if s and n_bytes else None
