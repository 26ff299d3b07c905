"""Ethereum hexary Merkle-Patricia trie, host side (twin of reference
evm/src/generation/mpt.rs + the eth_trie_utils crate's
HashedPartialTrie, re-implemented from the yellow-paper spec).

Node kinds and type codes follow the reference kernel exactly
(cpu/kernel/constants/trie_type.rs:8): EMPTY=0, HASH=1, BRANCH=2,
EXTENSION=3, LEAF=4.  `Hash` nodes stand in for unexplored parts of a
*partial* trie; traversing into one is an error.

Keys are nibble tuples (ints 0..15).  Node references follow the spec's
inline rule: a child whose RLP encoding is shorter than 32 bytes is
embedded directly, otherwise it is referenced by its keccak256 digest;
the root is always hashed.

`prover_inputs` serializes a trie in the exact format the kernel's
mpt_load consumes (mpt.rs:75 mpt_prover_inputs): depth-first
(type, payload...) with (count, packed) nibble keys.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..hash.keccak import keccak256
from . import rlp

EMPTY, HASH, BRANCH, EXTENSION, LEAF = range(5)

# keccak(rlp(b'')) — the canonical empty-trie root
EMPTY_TRIE_ROOT = keccak256(rlp.encode(b""))
EMPTY_CODE_HASH = keccak256(b"")


# ---------------------------------------------------------------- nodes

@dataclass(frozen=True)
class Empty:
    pass


@dataclass(frozen=True)
class Hash:
    digest: bytes  # 32 bytes


@dataclass(frozen=True)
class Branch:
    children: tuple  # 16 nodes
    value: bytes = b""


@dataclass(frozen=True)
class Extension:
    nibbles: tuple
    child: object


@dataclass(frozen=True)
class Leaf:
    nibbles: tuple
    value: bytes


def type_of(node) -> int:
    return {Empty: EMPTY, Hash: HASH, Branch: BRANCH,
            Extension: EXTENSION, Leaf: LEAF}[type(node)]


def empty_branch() -> Branch:
    return Branch(tuple(Empty() for _ in range(16)))


# ------------------------------------------------------------- nibbles

def bytes_to_nibbles(b: bytes) -> tuple:
    out = []
    for byte in b:
        out += [byte >> 4, byte & 0xF]
    return tuple(out)


def pack_nibbles(nibbles: tuple) -> int:
    """Big-endian packed value (eth_trie_utils Nibbles.packed)."""
    v = 0
    for n in nibbles:
        v = (v << 4) | n
    return v


def unpack_nibbles(packed: int, count: int) -> tuple:
    return tuple((packed >> (4 * (count - 1 - i))) & 0xF
                 for i in range(count))


def hex_prefix(nibbles: tuple, is_leaf: bool) -> bytes:
    """Yellow-paper appendix C HP encoding."""
    flag = 2 * int(is_leaf) + (len(nibbles) & 1)
    if len(nibbles) & 1:
        first = bytes([(flag << 4) | nibbles[0]])
        rest = nibbles[1:]
    else:
        first = bytes([flag << 4])
        rest = nibbles
    return first + bytes((rest[i] << 4) | rest[i + 1]
                         for i in range(0, len(rest), 2))


# ------------------------------------------------------------- hashing

def node_rlp(node):
    """The RLP *structure* (bytes or list) of a node (spec c(J, i))."""
    t = type(node)
    if t is Empty:
        return b""
    if t is Hash:
        return node.digest
    if t is Leaf:
        return [hex_prefix(node.nibbles, True), node.value]
    if t is Extension:
        return [hex_prefix(node.nibbles, False), node_ref(node.child)]
    assert t is Branch
    return [node_ref(c) for c in node.children] + [node.value]


def node_ref(node):
    """Child reference: inline structure if its encoding is < 32 bytes,
    else the keccak digest (spec n(J, i))."""
    if isinstance(node, Empty):
        return b""
    if isinstance(node, Hash):
        return node.digest
    structure = node_rlp(node)
    encoded = rlp.encode(structure)
    return structure if len(encoded) < 32 else keccak256(encoded)


def trie_hash(node) -> bytes:
    """Root hash: always keccak of the root's RLP (spec TRIE(J))."""
    if isinstance(node, Hash):
        return node.digest
    return keccak256(rlp.encode(node_rlp(node)))


# ------------------------------------------------------------ get / set

def trie_get(node, key: tuple):
    """Value at `key`, or None.  Traversing a Hash node is an error
    (the partial trie must cover all accessed paths)."""
    t = type(node)
    if t is Empty:
        return None
    if t is Hash:
        raise LookupError("key path leaves the partial trie")
    if t is Leaf:
        return node.value if node.nibbles == key else None
    if t is Extension:
        n = len(node.nibbles)
        if key[:n] != node.nibbles:
            return None
        return trie_get(node.child, key[n:])
    if not key:
        return node.value or None
    return trie_get(node.children[key[0]], key[1:])


def _common_prefix(a: tuple, b: tuple) -> int:
    i = 0
    while i < len(a) and i < len(b) and a[i] == b[i]:
        i += 1
    return i


def trie_insert(node, key: tuple, value: bytes):
    """Insert/update (standard MPT insertion with node splitting)."""
    t = type(node)
    if t is Empty:
        return Leaf(key, value)
    if t is Hash:
        raise LookupError("insert path leaves the partial trie")
    if t is Branch:
        if not key:
            return Branch(node.children, value)
        ch = list(node.children)
        ch[key[0]] = trie_insert(ch[key[0]], key[1:], value)
        return Branch(tuple(ch), node.value)
    existing = node.nibbles
    cp = _common_prefix(existing, key)
    if t is Leaf and cp == len(existing) == len(key):
        return Leaf(key, value)
    if t is Extension and cp == len(existing):
        return Extension(existing, trie_insert(node.child, key[cp:], value))
    # split at cp: build a branch over the diverging nibbles
    children, bvalue = list(empty_branch().children), b""
    rest_old, rest_new = existing[cp:], key[cp:]
    if t is Leaf:
        if rest_old:
            children[rest_old[0]] = Leaf(rest_old[1:], node.value)
        else:  # old leaf key is a strict prefix of the new key
            bvalue = node.value
    else:  # Extension with cp < len(existing), so rest_old is non-empty
        children[rest_old[0]] = (Extension(rest_old[1:], node.child)
                                 if len(rest_old) > 1 else node.child)
    if rest_new:
        children[rest_new[0]] = Leaf(rest_new[1:], value)
    else:  # new key is a strict prefix of the old (they are not equal)
        bvalue = value
    out = Branch(tuple(children), bvalue)
    return Extension(key[:cp], out) if cp else out


def trie_delete(node, key: tuple):
    """Delete `key` (standard MPT deletion with branch collapse and
    extension merging; twin of reference
    evm/src/cpu/kernel/asm/mpt/delete/delete.asm semantics).  A missing
    key returns the trie unchanged."""
    t = type(node)
    if t is Empty:
        return node
    if t is Hash:
        raise LookupError("delete path leaves the partial trie")
    if t is Leaf:
        return Empty() if node.nibbles == key else node
    if t is Extension:
        n = len(node.nibbles)
        if key[:n] != node.nibbles:
            return node
        return _merge_extension(node.nibbles,
                                trie_delete(node.child, key[n:]))
    if not key:
        return _collapse_branch(Branch(node.children, b""))
    ch = list(node.children)
    ch[key[0]] = trie_delete(ch[key[0]], key[1:])
    return _collapse_branch(Branch(tuple(ch), node.value))


def _merge_extension(nibbles: tuple, child):
    """Extension over a possibly-collapsed child (delete/extension.asm)."""
    t = type(child)
    if t is Empty:
        return Empty()
    if t is Leaf:
        return Leaf(nibbles + child.nibbles, child.value)
    if t is Extension:
        return Extension(nibbles + child.nibbles, child.child)
    return Extension(nibbles, child)


def _collapse_branch(b: Branch):
    """A branch left with one child and no value collapses into that
    child prefixed by its nibble (delete/branch.asm)."""
    nonempty = [(i, c) for i, c in enumerate(b.children)
                if not isinstance(c, Empty)]
    if len(nonempty) >= 2 or (b.value and nonempty):
        return b
    if not nonempty:
        return Leaf((), b.value) if b.value else Empty()
    i, c = nonempty[0]
    t = type(c)
    if t is Leaf:
        return Leaf((i,) + c.nibbles, c.value)
    if t is Extension:
        return Extension((i,) + c.nibbles, c.child)
    if t is Hash:
        raise LookupError("collapsing past a hash node needs its contents")
    return Extension((i,), c)


# ------------------------------------------------------------- accounts

@dataclass(frozen=True)
class Account:
    """(mpt.rs:15 AccountRlp)"""

    nonce: int = 0
    balance: int = 0
    storage_root: bytes = EMPTY_TRIE_ROOT
    code_hash: bytes = EMPTY_CODE_HASH

    def encode(self) -> bytes:
        return rlp.encode([self.nonce, self.balance, self.storage_root,
                           self.code_hash])

    @classmethod
    def decode(cls, data: bytes) -> "Account":
        nonce, balance, sr, ch = rlp.decode_list(data)
        assert len(sr) == 32 and len(ch) == 32
        return cls(rlp.decode_int(nonce), rlp.decode_int(balance), sr, ch)


def state_key(address: bytes) -> tuple:
    """keccak(address) as 64 nibbles (the state-trie key)."""
    assert len(address) == 20
    return bytes_to_nibbles(keccak256(address))


# ------------------------------------------------- prover-input format

@dataclass
class TrieInputs:
    """(generation/mod.rs:59)"""

    state_trie: object = field(default_factory=Empty)
    transactions_trie: object = field(default_factory=Empty)
    receipts_trie: object = field(default_factory=Empty)
    storage_tries: list = field(default_factory=list)  # [(state_key, trie)]


def prover_inputs(node, parse_value) -> list:
    """Depth-first serialization the kernel's mpt_load consumes
    (mpt.rs:75 mpt_prover_inputs); `parse_value(bytes) -> [words]`."""
    out = [type_of(node)]
    t = type(node)
    if t is Empty:
        pass
    elif t is Hash:
        out.append(int.from_bytes(node.digest, "big"))
    elif t is Branch:
        if node.value:
            out.append(1)
            out += parse_value(node.value)
        else:
            out.append(0)
        for child in node.children:
            out += prover_inputs(child, parse_value)
    elif t is Extension:
        out += [len(node.nibbles), pack_nibbles(node.nibbles)]
        out += prover_inputs(node.child, parse_value)
    else:
        out += [len(node.nibbles), pack_nibbles(node.nibbles)]
        out += parse_value(node.value)
    return out


def state_prover_inputs(trie_inputs: TrieInputs) -> list:
    """State trie with each account's storage trie spliced in at the
    leaf (mpt.rs:115 mpt_prover_inputs_state_trie); then the txn and
    receipt tries (values as raw RLP byte-strings: [len, bytes...])."""
    storage_by_key = {tuple(k): t for k, t in trie_inputs.storage_tries}

    def walk_state(node, prefix):
        out = [type_of(node)]
        t = type(node)
        if t is Empty:
            pass
        elif t is Hash:
            out.append(int.from_bytes(node.digest, "big"))
        elif t is Branch:
            assert not node.value, "state trie has no branch values"
            out.append(0)
            for i, child in enumerate(node.children):
                out += walk_state(child, prefix + (i,))
        elif t is Extension:
            out += [len(node.nibbles), pack_nibbles(node.nibbles)]
            out += walk_state(node.child, prefix + node.nibbles)
        else:
            acct = Account.decode(node.value)
            key = prefix + node.nibbles
            storage = storage_by_key.get(key, Hash(acct.storage_root))
            assert trie_hash(storage) == acct.storage_root, \
                "storage trie does not match account storage_root"
            out += [len(node.nibbles), pack_nibbles(node.nibbles),
                    acct.nonce, acct.balance]
            out += prover_inputs(storage, _parse_storage_value)
            out.append(int.from_bytes(acct.code_hash, "big"))
        return out

    inputs = walk_state(trie_inputs.state_trie, ())
    inputs += prover_inputs(trie_inputs.transactions_trie, _parse_raw_bytes)
    inputs += prover_inputs(trie_inputs.receipts_trie, _parse_raw_bytes)
    return inputs


def _parse_storage_value(value_rlp: bytes) -> list:
    return [rlp.decode_int(rlp.decode(value_rlp))]


def _parse_raw_bytes(value: bytes) -> list:
    return [len(value)] + list(value)
