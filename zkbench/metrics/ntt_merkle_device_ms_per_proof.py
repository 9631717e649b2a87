"""Device milliseconds a proof of the NTT and Merkle kernels: K6
(``tzk_ntt_pass``, CUDA name ``ntt_pass_kernel``) and K5
(``tzk_keccak_rows``, ``keccak_rows_kernel``), over the traced window."""

KERNELS = ("ntt_pass_kernel", "keccak_rows_kernel")


def read(run):
    s = run.device_s(*KERNELS)
    return 1e3 * s / run.proofs if s is not None and run.proofs else None
