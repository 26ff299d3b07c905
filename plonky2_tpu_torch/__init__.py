"""plonky2_tpu_torch: the PyTorch/CUDA port of plonky2_tpu.

Same layout and module names as the JAX package; field elements are u64 bit
patterns in torch.int64 tensors.  The hot kernels (Poseidon, coset LDE) are
hand-written CUDA in csrc/, built with nvcc at first use; on CPU tensors the
plain torch versions beside them run instead.  Entry points run on CUDA
unless the caller passes device="cpu".
"""
