"""zkEVM application layer (twin of reference evm/ crate).

STARK tables proved jointly via cross-table lookups (stark/ctl.py +
stark/multi.py):

- `CpuStark` — full EVM-style machine: opcode-bit decode, kernel mode,
  syscall/exception traps, gas, memory channels and ALU buses (cpu.py;
  reference evm/src/cpu/), with the kernel assembled from asm routines
  (kernel/)
- `MemoryStark` — access-log consistency (memory.py)
- `ArithmeticStark` — 256-bit add/mul/sub/div/mod/modular/byte over
  16-bit limbs (arithmetic.py)
- `LogicStark` — bitwise AND/OR/XOR (logic.py)
- `KeccakStark` — keccak-f[1600] rounds (keccak.py)
- `KeccakSpongeStark` — keccak-256 absorption (keccak_sponge.py)

`generation.py` simulates programs and assembles the joint proof
(reference evm/src/generation/ + all_stark.rs + prover.rs).
"""

from .arithmetic import ArithmeticStark, Operation
from .cpu import CpuStark
from .generation import (Simulator, Traces, all_cross_table_lookups,
                         generate_traces, prove_program,
                         verify_program_proof)
from .kernel import KERNEL, Kernel, assemble, build_kernel
from .transfer import (BlockMetadata, GenerationInputs, PublicValues,
                       Transfer, TrieRoots, apply_transfer, prove_transfer,
                       public_values, simulate_transfer,
                       verify_transfer_proof)
from .program import ProgramStark
from .keccak import KeccakStark
from .keccak_sponge import KeccakSpongeOp, KeccakSpongeStark
from .logic import LogicStark
from .lookup import eval_lookups, permuted_cols
from .memory import MemoryOp, MemoryStark
