"""The NTT kernels' share of their roofline in the traced window: the
bytes the proofs' transforms need (counts/stark.py) over HBM bandwidth
(counts/peaks.py), over the device time of the NTT family of kernels."""

from prove_bench.counts import peaks, stark

KERNELS = ("dft_kernel", "lde_kernel")


def read(ctx):
    device_s = ctx.kernel_seconds(KERNELS)
    s = ctx.work
    if not device_s or not ctx.proofs or s is None:
        return None
    bound_s = len(ctx.proofs) * stark.ntt_bytes(s) / peaks.HBM_BYTES_PER_S
    return 100.0 * bound_s / device_s
