"""The Poseidon kernels' share of their roofline in the traced window:
the least time the permutations the proofs need could take at the
integer peak (counts/stark.py, counts/peaks.py), over the device time of
the Poseidon family of kernels."""

from prove_bench.counts import peaks, stark

KERNELS = ("poseidon_kernel", "hash_rows_kernel", "hash_rows_group_kernel",
           "hash_cols_kernel", "hash_cols_group_kernel")


def read(ctx):
    device_s = ctx.kernel_seconds(KERNELS)
    s = ctx.work
    if not device_s or not ctx.proofs or s is None:
        return None
    perms = sum(stark.permutations(s) + stark.grind_permutations(f["pow_witness"])
                for f in ctx.proofs)
    bound_s = perms * peaks.poseidon_muls() / peaks.INT32_MUL_PER_S
    return 100.0 * bound_s / device_s
