"""Device milliseconds a proof of the MSM kernels: K4a (``tzk_msm_buckets``,
CUDA name ``msm_units_kernel``) and K4b (``tzk_msm_bucket_reduce``,
``msm_reduce_kernel``), over the traced window."""

KERNELS = ("msm_units_kernel", "msm_reduce_kernel")


def read(run):
    s = run.device_s(*KERNELS)
    return 1e3 * s / run.proofs if s is not None and run.proofs else None
