from .aggregator import KERNEL, Kernel, build_kernel
from .assembler import assemble

__all__ = ["KERNEL", "Kernel", "build_kernel", "assemble"]
