"""plonky2_tpu_torch: the PyTorch/CUDA port of plonky2_tpu.

Same layout and module names as the JAX package; field elements are u64 bit
patterns in torch.int64 tensors.  The hot kernels (Poseidon, the coset LDEs,
the batched NTT) are hand-written CUDA in csrc/, built with nvcc at first
use; on CPU tensors the plain torch versions beside them run instead.  Entry
points (the STARK and multi-table STARK proves, the plonk circuit build, the
zkEVM's prove_program / prove_transfer) run on CUDA unless the caller passes
device="cpu".
"""
