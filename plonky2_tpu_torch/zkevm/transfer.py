"""Transaction-level generation inputs and public values (twin of
reference evm/src/generation/mod.rs:39 GenerationInputs and
evm/src/proof.rs:51 PublicValues/TrieRoots/BlockMetadata), plus the
host twin of the kernel's transfer semantics (kernel/asm/txn.asm) and
the end-to-end prove/verify wrappers mirroring
evm/tests/simple_transfer.rs:29.

The kernel checks the claimed before/after trie roots in SEG_GLOBAL
(txn.asm check_root) and those global slots are part of the bootstrap
image, which the verifier recomputes from PublicValues and pins via the
program-ROM commitment (generation.verify_program_proof) — so the trie
roots and txn fields are sound public inputs of the proof.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..stark.config import StarkConfig
from . import mpt, rlp
from .kernel.aggregator import (GLOBAL_BLOCK_BASE_FEE,
                                GLOBAL_BLOCK_BENEFICIARY,
                                GLOBAL_BLOCK_CHAIN_ID,
                                GLOBAL_BLOCK_DIFFICULTY,
                                GLOBAL_BLOCK_GASLIMIT, GLOBAL_BLOCK_NUMBER,
                                GLOBAL_BLOCK_TIMESTAMP,
                                GLOBAL_RECEIPT_ROOT_AFTER,
                                GLOBAL_RECEIPT_ROOT_BEFORE,
                                GLOBAL_STATE_ROOT_AFTER,
                                GLOBAL_STATE_ROOT_BEFORE,
                                GLOBAL_TXN_COUNT, GLOBAL_TXN_DATA_BASE,
                                GLOBAL_TXN_DATA_LEN, GLOBAL_TXN_GASPRICE,
                                GLOBAL_TXN_NONCE, GLOBAL_TXN_ROOT_AFTER,
                                GLOBAL_TXN_ROOT_BEFORE, GLOBAL_TXN_SENDER,
                                GLOBAL_TXN_SIG_R, GLOBAL_TXN_SIG_S,
                                GLOBAL_TXN_SIG_V, GLOBAL_TXN_TO,
                                GLOBAL_TXN_VALUE, build_kernel)

TXN_GAS = 21_000


def intrinsic_gas(data: bytes = b"") -> int:
    """21000 + 4 per zero byte + 16 per nonzero calldata byte
    (gas.asm compute_intrinsic_gas, EIP-2028)."""
    return TXN_GAS + sum(4 if b == 0 else 16 for b in data)

# the kernel main for transfer blocks (txn.asm txn_main)
TXN_MAIN_SOURCE = "global main:\n    %jump(txn_main)\n"


@dataclass(frozen=True)
class BlockMetadata:
    """(proof.rs:59 BlockMetadata)"""

    beneficiary: bytes = b"\x00" * 20
    timestamp: int = 0
    number: int = 0
    difficulty: int = 0
    gaslimit: int = 0xFFFFFFFF
    chain_id: int = 1
    base_fee: int = 0


@dataclass(frozen=True)
class Transfer:
    """The reduced signed-txn payload (sender is a public input; see
    module docstring).  `data` is the call payload (calldata) — public
    via the SEG_GLOBAL image words and part of the txn RLP."""

    sender: bytes
    to: bytes
    value: int
    nonce: int = 0
    gas_price: int = 0
    data: bytes = b""
    # (v, r, s) legacy-txn signature over keccak(self.rlp()); None keeps
    # the unsigned reduction (SIG_R = 0 skips the in-kernel check)
    sig: tuple | None = None

    def rlp(self) -> bytes:
        """The txn-trie entry the kernel builds (txn.asm
        build_txn_value): rlp([nonce, gas_price, 21000, to, value,
        data]) (legacy-txn reduction)."""
        return rlp.encode([self.nonce, self.gas_price, TXN_GAS, self.to,
                           self.value, self.data])

    def sighash(self) -> int:
        from ..hash.keccak import keccak256
        return int.from_bytes(keccak256(self.rlp()), "big")

    def intrinsic_gas(self) -> int:
        return intrinsic_gas(self.data)

    def receipt_rlp(self, status: int = 1, gas_used: int = None,
                    logs: list = ()) -> bytes:
        """The legacy receipt payload rlp([status, cum_gas, bloom,
        logs]) (txn.asm build_receipt_value; reference receipt
        encoding).  `logs` is a list of (address20, [topic_ints],
        data_bytes)."""
        if gas_used is None:
            gas_used = self.intrinsic_gas()
        return receipt_payload(status, gas_used, list(logs))


@dataclass
class GenerationInputs:
    """(generation/mod.rs:39); txn=None is an empty block
    (evm/tests/empty_txn_list.rs): nothing executes and the after-roots
    must equal the before-roots.

    contract_code maps code_hash (32 bytes) -> word-machine code (a
    list of (opcode, immediate) pairs) — the reference's
    `contract_code: HashMap<H256, Vec<u8>>`.  When the txn recipient's
    account carries code, the kernel loads it from the prover-input
    stream and verifies its keccak against the account's code_hash
    (kernel/asm/contract.asm load_contract_code)."""

    txn: Transfer | None
    tries: mpt.TrieInputs = field(default_factory=mpt.TrieInputs)
    block_metadata: BlockMetadata = field(default_factory=BlockMetadata)
    contract_code: dict = field(default_factory=dict)
    # code hashes loaded by INNER message calls (sys_call), in dynamic
    # call order — each CALL to a code-bearing account consumes one more
    # code stream from the prover inputs (contract.asm
    # load_contract_code; the reference keys these loads through its
    # ProverInputFn oracle instead, generation/prover_input.rs)
    inner_code_loads: list = field(default_factory=list)
    # further PROVER_INPUT words consumed after the code loads, in
    # order — e.g. the [y, r_inv, z_inv] hints of each in-contract
    # ecrecover precompile call (precompiles.asm;
    # field/secp256k1.py ecrecover_kernel_hints)
    extra_prover_inputs: list = field(default_factory=list)


@dataclass(frozen=True)
class TrieRoots:
    state: bytes
    transactions: bytes
    receipts: bytes


@dataclass(frozen=True)
class PublicValues:
    """(proof.rs:51)"""

    trie_roots_before: TrieRoots
    trie_roots_after: TrieRoots
    block_metadata: BlockMetadata
    txn: Transfer | None


def logs_bloom(logs: list) -> bytes:
    """The 2048-bit receipt bloom (logs.asm build_log_bloom twin):
    3 bits per value (log address + each topic), from the keccak
    digest's byte pairs (0,1),(2,3),(4,5) mod 2048."""
    from ..hash.keccak import keccak256
    bloom = bytearray(256)
    for address, topics, _data in logs:
        for value in [address] + [int(t).to_bytes(32, "big")
                                  for t in topics]:
            h = keccak256(value)
            for k in range(3):
                m = ((h[2 * k] << 8) | h[2 * k + 1]) & 0x7FF
                bloom[255 - (m >> 3)] |= 1 << (m & 7)
    return bytes(bloom)


def receipt_payload(status: int, cum_gas: int, logs: list) -> bytes:
    """rlp([status, cum_gas, bloom, [[addr, [topics], data]..]])."""
    items = [[address, [int(t).to_bytes(32, "big") for t in topics], data]
             for address, topics, data in logs]
    return rlp.encode([status, cum_gas, logs_bloom(logs), items])


def code_serialization(code: list) -> bytes:
    """The hashed byte form of word-machine code: 33 bytes per
    instruction — opcode byte + immediate as 32 big-endian bytes
    (contract.asm module note)."""
    return b"".join(bytes([op]) + (imm & ((1 << 256) - 1)).to_bytes(32, "big")
                    for op, imm in code)


def code_hash(code: list) -> bytes:
    from ..hash.keccak import keccak256
    return keccak256(code_serialization(code))


def code_prover_inputs(code: list) -> list:
    """The prover-input words load_contract_code consumes: count, then
    (opcode, immediate) per instruction."""
    return [len(code)] + [x for op, imm in code for x in (op, imm)]


def _contract_inputs(inputs: GenerationInputs) -> list:
    """Prover inputs for the recipient's code plus every inner CALL's
    code load, in consumption order."""
    txn = inputs.txn
    if txn is None:
        return []
    out = []
    acct = _get_account(inputs.tries.state_trie, txn.to)
    if acct is not None and acct.code_hash != mpt.EMPTY_CODE_HASH:
        out += code_prover_inputs(inputs.contract_code[acct.code_hash])
    for chash in inputs.inner_code_loads:
        out += code_prover_inputs(inputs.contract_code[chash])
    return out + list(inputs.extra_prover_inputs)


def sign_transfer(txn: Transfer, priv: int, k: int = None) -> Transfer:
    """Attach a legacy signature; the sender is DERIVED from priv (any
    mismatching `sender` field would make the block unprovable)."""
    import dataclasses
    from ..field import secp256k1 as secp
    if k is None:  # deterministic nonce from the payload (tests only)
        k = (txn.sighash() * 0x1337 + 1) % secp.SECP256K1_SCALAR.order
    pub = secp.ec_mul((secp.GX, secp.GY), priv)
    sender = secp.pubkey_to_address(pub)
    txn = dataclasses.replace(txn, sender=sender)
    v, r, s = secp.ecdsa_sign(txn.sighash(), priv, k)
    return dataclasses.replace(txn, sig=(v, r, s))


def _sig_inputs(inputs: GenerationInputs) -> list:
    """PROVER_INPUT hints for verify_txn_signature (consumed between the
    trie-load inputs and the contract-code inputs — curve.asm)."""
    txn = inputs.txn
    if txn is None or txn.sig is None:
        return []
    from ..field.secp256k1 import ecrecover_kernel_hints
    v, r, s = txn.sig
    return ecrecover_kernel_hints(txn.sighash(), v, r, s)


def _get_account(state, address: bytes) -> mpt.Account | None:
    raw = mpt.trie_get(state, mpt.state_key(address))
    return mpt.Account.decode(raw) if raw is not None else None


def _set_account(state, address: bytes, acct: mpt.Account):
    return mpt.trie_insert(state, mpt.state_key(address), acct.encode())


def apply_transfer(inputs: GenerationInputs) -> mpt.TrieInputs:
    """Host twin of txn.asm execute_transfer: the after-tries.  Raises
    on the same conditions the kernel panics on (missing sender, nonce
    mismatch, insufficient balance)."""
    txn, md = inputs.txn, inputs.block_metadata
    if txn is None:   # empty block: identity on every trie
        return inputs.tries
    if txn.sig is not None:
        # host twin of verify_txn_signature: the kernel panics on a
        # forged signature, so the block would be unprovable
        from ..field import secp256k1 as secp
        v, r, s = txn.sig
        q = secp.ecdsa_recover(txn.sighash(), v, r, s)
        assert q is not None and secp.pubkey_to_address(q) == txn.sender, \
            "transaction signature does not recover the claimed sender"
    state = inputs.tries.state_trie
    sender = _get_account(state, txn.sender)
    assert sender is not None, "sender account missing"
    assert sender.nonce == txn.nonce, "nonce mismatch"
    fee = txn.gas_price * txn.intrinsic_gas()
    cost = txn.value + fee
    assert sender.balance >= cost, "insufficient balance"
    state = _set_account(state, txn.sender, mpt.Account(
        sender.nonce + 1, sender.balance - cost, sender.storage_root,
        sender.code_hash))

    def credit(state, address, amount):
        acct = _get_account(state, address) or mpt.Account()
        return _set_account(state, address, mpt.Account(
            acct.nonce, acct.balance + amount, acct.storage_root,
            acct.code_hash))

    state = credit(state, txn.to, txn.value)
    state = credit(state, md.beneficiary, fee)

    key0 = mpt.bytes_to_nibbles(rlp.encode(0))
    txn_trie = mpt.trie_insert(inputs.tries.transactions_trie, key0,
                               txn.rlp())
    receipts = mpt.trie_insert(inputs.tries.receipts_trie, key0,
                               txn.receipt_rlp())
    return mpt.TrieInputs(state, txn_trie, receipts,
                          inputs.tries.storage_tries)


def public_values(inputs: GenerationInputs) -> PublicValues:
    """The proof's public values.  For plain transfers the after-roots
    come from the pure-host twin (apply_transfer); for contract blocks
    (inputs.contract_code nonempty) the kernel itself is the semantics,
    so a fast untraced DRY-RUN simulation computes them: check_root
    publishes the computed roots into the after slots instead of
    checking (mpt.asm cr_store), and this function reads them back from
    the simulator's memory.  The real proof then runs with DRY_RUN = 0
    and the published roots as its claimed (checked) public inputs."""
    before = TrieRoots(
        mpt.trie_hash(inputs.tries.state_trie),
        mpt.trie_hash(inputs.tries.transactions_trie),
        mpt.trie_hash(inputs.tries.receipts_trie))
    if not inputs.contract_code:
        after_t = apply_transfer(inputs)
        after = TrieRoots(
            mpt.trie_hash(after_t.state_trie),
            mpt.trie_hash(after_t.transactions_trie),
            mpt.trie_hash(after_t.receipts_trie))
        return PublicValues(before, after, inputs.block_metadata,
                            inputs.txn)

    from ..field import gl64  # noqa: F401  (import parity; not used)
    from .cpu import SEG_GLOBAL
    from .generation import Simulator
    from .kernel.aggregator import GLOBAL_DRY_RUN
    provisional = PublicValues(before, before, inputs.block_metadata,
                               inputs.txn)
    gv = global_values_for(provisional)
    gv[GLOBAL_DRY_RUN] = 1
    sim = Simulator(
        kernel=txn_kernel(), global_values=gv,
        prover_inputs=(mpt.state_prover_inputs(inputs.tries)
                       + _sig_inputs(inputs)
                       + _contract_inputs(inputs)),
        max_cycles=4_000_000, trace=False)
    sim.run()
    assert sim.exc_status == 0, "dry run faulted"

    def root(slot):
        return int(sim.memory[(0, SEG_GLOBAL, slot)]).to_bytes(32, "big")

    after = TrieRoots(root(GLOBAL_STATE_ROOT_AFTER),
                      root(GLOBAL_TXN_ROOT_AFTER),
                      root(GLOBAL_RECEIPT_ROOT_AFTER))
    return PublicValues(before, after, inputs.block_metadata, inputs.txn)


def _be(b: bytes) -> int:
    return int.from_bytes(b, "big")


def global_values_for(pv: PublicValues) -> dict:
    """The SEG_GLOBAL image slots for a transfer block — everything the
    kernel's check_root / execute_transfer reads, derived purely from
    PublicValues (so the verifier can rebuild the image)."""
    md = pv.block_metadata
    txn = pv.txn or Transfer(sender=b"\x00" * 20, to=b"\x00" * 20, value=0)
    return {
        GLOBAL_TXN_COUNT: 0 if pv.txn is None else 1,
        GLOBAL_BLOCK_BENEFICIARY: _be(md.beneficiary),
        GLOBAL_BLOCK_TIMESTAMP: md.timestamp,
        GLOBAL_BLOCK_NUMBER: md.number,
        GLOBAL_BLOCK_DIFFICULTY: md.difficulty,
        GLOBAL_BLOCK_GASLIMIT: md.gaslimit,
        GLOBAL_BLOCK_CHAIN_ID: md.chain_id,
        GLOBAL_BLOCK_BASE_FEE: md.base_fee,
        GLOBAL_STATE_ROOT_BEFORE: _be(pv.trie_roots_before.state),
        GLOBAL_TXN_ROOT_BEFORE: _be(pv.trie_roots_before.transactions),
        GLOBAL_RECEIPT_ROOT_BEFORE: _be(pv.trie_roots_before.receipts),
        GLOBAL_STATE_ROOT_AFTER: _be(pv.trie_roots_after.state),
        GLOBAL_TXN_ROOT_AFTER: _be(pv.trie_roots_after.transactions),
        GLOBAL_RECEIPT_ROOT_AFTER: _be(pv.trie_roots_after.receipts),
        GLOBAL_TXN_SENDER: _be(txn.sender),
        GLOBAL_TXN_TO: _be(txn.to),
        GLOBAL_TXN_VALUE: txn.value,
        GLOBAL_TXN_NONCE: txn.nonce,
        GLOBAL_TXN_GASPRICE: txn.gas_price,
        GLOBAL_TXN_SIG_V: txn.sig[0] if txn.sig else 0,
        GLOBAL_TXN_SIG_R: txn.sig[1] if txn.sig else 0,
        GLOBAL_TXN_SIG_S: txn.sig[2] if txn.sig else 0,
        GLOBAL_TXN_DATA_LEN: len(txn.data),
        # calldata words, 32 bytes each, big-endian, zero-padded right
        **{GLOBAL_TXN_DATA_BASE + j:
           _be(txn.data[32 * j:32 * j + 32].ljust(32, b"\x00"))
           for j in range(-(-len(txn.data) // 32))},
    }


_TXN_KERNEL = None


def txn_kernel():
    """The transfer-block kernel (cached: assembly is deterministic)."""
    global _TXN_KERNEL
    if _TXN_KERNEL is None:
        _TXN_KERNEL = build_kernel(main_source=TXN_MAIN_SOURCE)
    return _TXN_KERNEL


def simulate_transfer(inputs: GenerationInputs, trace: bool = True,
                      max_cycles: int = 4_000_000):
    """Run the transfer block in the simulator/interpreter; returns the
    Simulator after a clean HALT (panics spin -> RuntimeError)."""
    from .generation import Simulator
    pv = public_values(inputs)
    sim = Simulator(
        kernel=txn_kernel(), global_values=global_values_for(pv),
        prover_inputs=(mpt.state_prover_inputs(inputs.tries)
                       + _sig_inputs(inputs)
                       + _contract_inputs(inputs)),
        max_cycles=max_cycles, trace=trace)
    sim.run()
    assert sim.exc_status == 0
    return sim, pv


def prove_transfer(inputs: GenerationInputs, config: StarkConfig = None,
                   arith_limb_bits: int = 16, timing=None, device=None):
    """simple_transfer.rs:29 equivalent: prove one transfer block
    through the full multi-table pipeline on ``device`` (None means
    CUDA); returns (proof, starks, ctls, public_values).  ``timing`` (a
    TimingTree) gets prove_program's scopes."""
    from .generation import prove_program
    pv = public_values(inputs)
    proof, starks, ctls, sim = prove_program(
        kernel=txn_kernel(), global_values=global_values_for(pv),
        prover_inputs=(mpt.state_prover_inputs(inputs.tries)
                       + _sig_inputs(inputs)
                       + _contract_inputs(inputs)),
        config=config, arith_limb_bits=arith_limb_bits, timing=timing,
        device=device)
    return proof, starks, ctls, pv


def verify_transfer_proof(starks, ctls, proof, pv: PublicValues,
                          config: StarkConfig = None, device=None) -> None:
    """Verify the multi-proof AND that its ROM commitment (recomputed on
    ``device``; None means CUDA) matches the image rebuilt from these
    PublicValues, binding the trie roots and txn fields to the proof."""
    from .generation import verify_program_proof
    verify_program_proof(starks, ctls, proof, config=config,
                         kernel=txn_kernel(),
                         global_values=global_values_for(pv), device=device)
