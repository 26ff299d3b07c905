// MPT key manipulation + in-machine trie read/insert (twin of
// reference cpu/kernel/asm/mpt/{read.asm,insert/*.asm}, re-targeted at
// the word machine's node layout — see mpt.asm header).
//
// Keys are (count, packed) nibble strings: count nibbles, big-endian
// packed into one word (count <= 64).  Child pointer 0 acts as an
// EMPTY node: TRIE[0] is reserved by load_all_tries and never written,
// so reading its type yields @MPT_EMPTY.
// Stack comments list the TOP first.

// key_head(count, packed, retdest) -> (first, count-1, rest); count >= 1
global key_head:
    // stack: count, packed, retdest
    PUSH 1
    DUP2
    SUB                          // [cm1, count, packed]
    SWAP1
    POP                          // [cm1, packed]
    DUP1
    PUSH 4
    MUL                          // [s = 4*cm1, cm1, packed]
    DUP1                         // [s, s, cm1, packed]
    DUP4                         // [packed, s, s, cm1, packed]
    SWAP1                        // [s, packed, s, cm1, packed]
    SHR                          // [first, s, cm1, packed]
    %stack (first, s, cm1, packed) -> (s, 1, 1, packed, first, cm1)
    SHL                          // [1<<s, 1, packed, first, cm1]
    SUB                          // [mask, packed, first, cm1]
    AND                          // [rest, first, cm1, retdest]
    %stack (rest, first, cm1, retdest) -> (retdest, first, cm1, rest)
    JUMP

// key_suffix(count, packed, cp, retdest) -> (count-cp, suffix)
global key_suffix:
    // stack: count, packed, cp, retdest
    %stack (count, packed, cp) -> (count, cp, packed)
    SUB                          // [sc = count-cp, packed]
    DUP1
    PUSH 4
    MUL                          // [s, sc, packed]
    %stack (s, sc, packed) -> (s, 1, 1, packed, sc)
    SHL                          // [1<<s, 1, packed, sc]
    SUB                          // [mask, packed, sc]
    AND                          // [suffix, sc, retdest]
    %stack (suffix, sc, retdest) -> (retdest, sc, suffix)
    JUMP

// key_prefix(count, packed, cp, retdest) -> prefix (top cp nibbles)
global key_prefix:
    // stack: count, packed, cp, retdest
    %stack (count, packed, cp) -> (count, cp, packed)
    SUB                          // [count-cp, packed]
    PUSH 4
    MUL                          // [s, packed]
    SHR                          // [prefix, retdest]
    SWAP1
    JUMP

// key_common_prefix(c1, p1, c2, p2, retdest) -> cp
global key_common_prefix:
    PUSH 0                       // cp
kcp_loop:
    // stack: cp, c1, p1, c2, p2, retdest
    DUP2
    DUP2
    EQ                           // cp == c1 ?
    %jumpi(kcp_done)
    DUP4
    DUP2
    EQ                           // cp == c2 ?
    %jumpi(kcp_done)
    // nib1 = (p1 >> 4*(c1-1-cp)) & 0xF
    %stack (cp, c1, p1, c2, p2) -> (1, cp, c1, p1, cp, c1, p1, c2, p2)
    ADD                          // [cp+1, c1, p1, ...]
    SWAP1                        // [c1, cp+1, p1, ...]
    SUB                          // [c1-cp-1, p1, cp, c1, p1, c2, p2]
    PUSH 4
    MUL                          // [s1, p1, ...]
    SHR                          // [v1, cp, c1, p1, c2, p2]
    PUSH 0xf
    AND                          // [nib1, cp, c1, p1, c2, p2]
    // nib2 = (p2 >> 4*(c2-1-cp)) & 0xF
    %stack (nib1, cp, c1, p1, c2, p2) -> (1, cp, c2, p2, nib1, cp, c1, p1, c2, p2)
    ADD
    SWAP1
    SUB                          // [c2-cp-1, p2, nib1, ...]
    PUSH 4
    MUL
    SHR                          // [v2, nib1, cp, c1, p1, c2, p2]
    PUSH 0xf
    AND                          // [nib2, nib1, cp, ...]
    EQ
    ISZERO
    %jumpi(kcp_done)
    PUSH 1
    ADD                          // cp += 1
    %jump(kcp_loop)
kcp_done:
    %stack (cp, c1, p1, c2, p2, retdest) -> (retdest, cp)
    JUMP

// make_node4(type, count, packed, x, retdest) -> ptr: a fresh 4-cell
// node [type, count, packed, x] (LEAF: x = value_ptr; EXT: x = child).
global make_node4:
    PUSH 4
    %trie_alloc                  // [ptr, type, count, packed, x]
    %stack (ptr, type) -> (ptr, type, ptr)
    %trie_write                  // [ptr, count, packed, x]
    %stack (ptr, count) -> (ptr, 1, count, ptr)
    ADD
    %trie_write                  // [ptr, packed, x]
    %stack (ptr, packed) -> (ptr, 2, packed, ptr)
    ADD
    %trie_write                  // [ptr, x]
    %stack (ptr, x) -> (ptr, 3, x, ptr)
    ADD
    %trie_write                  // [ptr, retdest]
    SWAP1
    JUMP

// ------------------------------------------------------------- read

// mpt_read(ptr, count, packed, retdest) -> vptr (0 if absent; HASH
// nodes panic — the partial trie must cover all accessed paths)
global mpt_read:
    DUP1
    %trie_read                   // [type, ptr, count, packed, retdest]
    DUP1
    PUSH @MPT_EMPTY
    EQ
    %jumpi(mr_empty)
    DUP1
    PUSH @MPT_BRANCH
    EQ
    %jumpi(mr_branch)
    DUP1
    PUSH @MPT_EXTENSION
    EQ
    %jumpi(mr_ext)
    DUP1
    PUSH @MPT_LEAF
    EQ
    %jumpi(mr_leaf)
    %jump(panic)

mr_empty:
    // stack: type, ptr, count, packed, retdest
    %stack (type, ptr, count, packed, retdest) -> (retdest, 0)
    JUMP

mr_leaf:
    // stack: type, ptr, count, packed, retdest
    POP
    DUP1
    PUSH 1
    ADD
    %trie_read                   // [ecount, ptr, count, packed]
    DUP2
    PUSH 2
    ADD
    %trie_read                   // [epacked, ecount, ptr, count, packed]
    %stack (epacked, ecount, ptr, count, packed) -> (ecount, count, epacked, packed, ptr)
    EQ                           // [ceq, epacked, packed, ptr]
    %stack (ceq, epacked, packed) -> (epacked, packed, ceq)
    EQ                           // [peq, ceq, ptr]
    MUL                          // [match, ptr, retdest]
    %jumpi(mr_leaf_hit)
    %stack (ptr, retdest) -> (retdest, 0)
    JUMP
mr_leaf_hit:
    // stack: ptr, retdest
    PUSH 3
    ADD
    %trie_read                   // [vptr, retdest]
    SWAP1
    JUMP

mr_branch:
    // stack: type, ptr, count, packed, retdest
    POP
    DUP2
    ISZERO
    %jumpi(mr_branch_value)
    %stack (ptr, count, packed) -> (count, packed, mr_br_head, ptr)
    %jump(key_head)
mr_br_head:
    // stack: first, cm1, rest, ptr, retdest
    %stack (first, cm1, rest, ptr) -> (ptr, 1, first, cm1, rest)
    ADD
    ADD                          // [ptr+1+first, cm1, rest]
    %trie_read                   // [child, cm1, rest, retdest]
    %jump(mpt_read)              // tail call
mr_branch_value:
    // stack: ptr, count, packed, retdest
    %stack (ptr, count, packed) -> (ptr, 17)
    ADD
    %trie_read                   // [vptr, retdest]
    SWAP1
    JUMP

mr_ext:
    // stack: type, ptr, count, packed, retdest
    POP
    DUP1
    PUSH 1
    ADD
    %trie_read                   // [ecount, ptr, count, packed]
    DUP2
    PUSH 2
    ADD
    %trie_read                   // [epacked, ecount, ptr, count, packed]
    %stack (epacked, ecount, ptr, count, packed) -> (ecount, epacked, count, packed, mr_ext_cp, ecount, ptr, count, packed)
    %jump(key_common_prefix)
mr_ext_cp:
    // stack: cp, ecount, ptr, count, packed, retdest
    DUP2
    EQ                           // cp == ecount ?
    ISZERO
    %jumpi(mr_ext_miss)
    %stack (ecount, ptr, count, packed) -> (count, packed, ecount, mr_ext_sfx, ptr)
    %jump(key_suffix)
mr_ext_sfx:
    // stack: sc, sp, ptr, retdest
    %stack (sc, sp, ptr) -> (ptr, 3, sc, sp)
    ADD
    %trie_read                   // [child, sc, sp, retdest]
    %jump(mpt_read)              // tail call
mr_ext_miss:
    %stack (ecount, ptr, count, packed, retdest) -> (retdest, 0)
    JUMP

// ------------------------------------------------------------- insert

// mpt_insert(ptr, count, packed, vptr, retdest) -> newptr.  Mutates
// nodes in place where possible (the machine owns SEG_TRIE; the
// before-root was already checked, so mutation is sound) and allocates
// fresh nodes on splits (host twin: mpt.py trie_insert).
global mpt_insert:
    DUP1
    %trie_read                   // [type, ptr, count, packed, vptr, retdest]
    DUP1
    PUSH @MPT_EMPTY
    EQ
    %jumpi(mi_empty)
    DUP1
    PUSH @MPT_BRANCH
    EQ
    %jumpi(mi_branch)
    DUP1
    PUSH @MPT_EXTENSION
    EQ
    %jumpi(mi_ext)
    DUP1
    PUSH @MPT_LEAF
    EQ
    %jumpi(mi_leaf)
    %jump(panic)

mi_empty:
    // stack: type, ptr, count, packed, vptr, retdest
    %stack (type, ptr, count, packed, vptr) -> (@MPT_LEAF, count, packed, vptr)
    %jump(make_node4)            // tail: fresh leaf

mi_branch:
    // stack: type, ptr, count, packed, vptr, retdest
    POP
    DUP2
    ISZERO
    %jumpi(mi_branch_value)
    %stack (ptr, count, packed) -> (count, packed, mi_br_head, ptr)
    %jump(key_head)
mi_br_head:
    // stack: first, cm1, rest, ptr, vptr, retdest
    %stack (first, cm1, rest, ptr, vptr) -> (ptr, 1, first, cm1, rest, vptr, first, ptr)
    ADD
    ADD                          // [ptr+1+first, cm1, rest, vptr, first, ptr]
    %trie_read                   // [child, cm1, rest, vptr, first, ptr]
    %stack (child, cm1, rest, vptr) -> (child, cm1, rest, vptr, mi_br_ret)
    %jump(mpt_insert)
mi_br_ret:
    // stack: newchild, first, ptr, retdest
    %stack (newchild, first, ptr) -> (ptr, 1, first, newchild, ptr)
    ADD
    ADD
    %trie_write                  // [ptr, retdest]
    SWAP1
    JUMP
mi_branch_value:
    // stack: ptr, count, packed, vptr, retdest
    %stack (ptr, count, packed, vptr) -> (ptr, 17, vptr, ptr)
    ADD
    %trie_write                  // [ptr, retdest]
    SWAP1
    JUMP

mi_leaf:
    // stack: type, ptr, count, packed, vptr, retdest
    POP
    DUP1
    PUSH 1
    ADD
    %trie_read                   // [ecount, ptr, count, packed, vptr]
    DUP2
    PUSH 2
    ADD
    %trie_read                   // [epacked, ecount, ptr, count, packed, vptr]
    %stack (epacked, ecount, ptr, count, packed, vptr) -> (ecount, count, epacked, packed, epacked, ecount, ptr, count, packed, vptr)
    EQ                           // [ceq, epacked, packed, epacked, ...]
    %stack (ceq, epacked, packed) -> (epacked, packed, ceq)
    EQ                           // [peq, ceq, epacked, ecount, ptr, count, packed, vptr]
    MUL                          // [match, epacked, ecount, ptr, count, packed, vptr]
    %jumpi(mi_leaf_replace)
    // split: cp = common_prefix(existing, new)
    %stack (epacked, ecount, ptr, count, packed, vptr) -> (ecount, epacked, count, packed, mi_leaf_cp, ecount, epacked, ptr, count, packed, vptr)
    %jump(key_common_prefix)
mi_leaf_cp:
    // stack: cp, ecount, epacked, ptr, count, packed, vptr, retdest
    %stack (cp, ecount, epacked, ptr, count, packed, vptr) -> (ptr, 3, cp, ecount, epacked, count, packed, vptr)
    ADD
    %trie_read                   // [ovptr, cp, ecount, epacked, count, packed, vptr]
    PUSH 18
    %trie_alloc                  // [branch, ovptr, cp, ecount, epacked, count, packed, vptr]
    DUP1
    PUSH @MPT_BRANCH
    SWAP1
    %trie_write                  // fresh cells are 0: children/value empty
    // rest_old = key_suffix(ecount, epacked, cp)
    %stack (branch, ovptr, cp, ecount, epacked, count, packed, vptr) -> (ecount, epacked, cp, mi_leaf_ro, branch, ovptr, cp, count, packed, vptr)
    %jump(key_suffix)
mi_leaf_ro:
    // stack: roc, rop, branch, ovptr, cp, count, packed, vptr, retdest
    DUP1
    ISZERO
    %jumpi(mi_leaf_ro_empty)
    %stack (roc, rop) -> (roc, rop, mi_leaf_ro_head)
    %jump(key_head)
mi_leaf_ro_head:
    // stack: rof, roc1, ror, branch, ovptr, cp, count, packed, vptr
    %stack (rof, roc1, ror, branch, ovptr) -> (@MPT_LEAF, roc1, ror, ovptr, mi_leaf_ro_made, rof, branch)
    %jump(make_node4)
mi_leaf_ro_made:
    // stack: leafp, rof, branch, cp, count, packed, vptr, retdest
    %stack (leafp, rof, branch) -> (branch, 1, rof, leafp, branch)
    ADD
    ADD
    %trie_write                  // [branch, cp, count, packed, vptr]
    %jump(mi_attach_new)
mi_leaf_ro_empty:
    // stack: roc(0), rop, branch, ovptr, cp, count, packed, vptr
    %stack (roc, rop, branch, ovptr) -> (branch, 17, ovptr, branch)
    ADD
    %trie_write                  // branch.value = old leaf value
    %jump(mi_attach_new)
mi_leaf_replace:
    // stack: epacked, ecount, ptr, count, packed, vptr, retdest
    %stack (epacked, ecount, ptr, count, packed, vptr) -> (ptr, 3, vptr, ptr)
    ADD
    %trie_write                  // [ptr, retdest]
    SWAP1
    JUMP

// mi_attach_new(branch, cp, count, packed, vptr, retdest) -> newptr:
// attach the new key's post-cp remainder to the branch, then wrap the
// branch in an extension over the cp common nibbles if cp > 0.
mi_attach_new:
    // stack: branch, cp, count, packed, vptr, retdest
    %stack (branch, cp, count, packed, vptr) -> (count, packed, cp, mi_an_sfx, branch, cp, count, packed, vptr)
    %jump(key_suffix)
mi_an_sfx:
    // stack: rnc, rnp, branch, cp, count, packed, vptr, retdest
    DUP1
    ISZERO
    %jumpi(mi_an_empty)
    %stack (rnc, rnp) -> (rnc, rnp, mi_an_head)
    %jump(key_head)
mi_an_head:
    // stack: rnf, rnc1, rnr, branch, cp, count, packed, vptr
    %stack (rnf, rnc1, rnr, branch, cp, count, packed, vptr) -> (@MPT_LEAF, rnc1, rnr, vptr, mi_an_made, rnf, branch, cp, count, packed)
    %jump(make_node4)
mi_an_made:
    // stack: leafp, rnf, branch, cp, count, packed, retdest
    %stack (leafp, rnf, branch) -> (branch, 1, rnf, leafp, branch)
    ADD
    ADD
    %trie_write                  // [branch, cp, count, packed]
    %jump(mi_an_wrap)
mi_an_empty:
    // stack: rnc(0), rnp, branch, cp, count, packed, vptr, retdest
    %stack (rnc, rnp, branch, cp, count, packed, vptr) -> (branch, 17, vptr, branch, cp, count, packed)
    ADD
    %trie_write                  // branch.value = new value
mi_an_wrap:
    // stack: branch, cp, count, packed, retdest
    DUP2
    ISZERO
    %jumpi(mi_an_nowrap)
    %stack (branch, cp, count, packed) -> (count, packed, cp, mi_an_pfx, branch, cp)
    %jump(key_prefix)
mi_an_pfx:
    // stack: prefix, branch, cp, retdest
    %stack (prefix, branch, cp) -> (@MPT_EXTENSION, cp, prefix, branch)
    %jump(make_node4)            // tail: the extension is the new root
mi_an_nowrap:
    // stack: branch, cp, count, packed, retdest
    %stack (branch, cp, count, packed, retdest) -> (retdest, branch)
    JUMP

mi_ext:
    // stack: type, ptr, count, packed, vptr, retdest
    POP
    DUP1
    PUSH 1
    ADD
    %trie_read                   // [ecount, ptr, count, packed, vptr]
    DUP2
    PUSH 2
    ADD
    %trie_read                   // [epacked, ecount, ptr, count, packed, vptr]
    %stack (epacked, ecount, ptr, count, packed, vptr) -> (ecount, epacked, count, packed, mi_ext_cp, ecount, epacked, ptr, count, packed, vptr)
    %jump(key_common_prefix)
mi_ext_cp:
    // stack: cp, ecount, epacked, ptr, count, packed, vptr, retdest
    DUP2
    DUP2
    EQ                           // cp == ecount ?
    ISZERO
    %jumpi(mi_ext_split)
    // whole extension matched: recurse into the child with the suffix
    %stack (cp, ecount, epacked, ptr, count, packed, vptr) -> (count, packed, ecount, mi_ext_sfx, ptr, vptr)
    %jump(key_suffix)
mi_ext_sfx:
    // stack: sc, sp, ptr, vptr, retdest
    %stack (sc, sp, ptr, vptr) -> (ptr, 3, sc, sp, vptr, ptr)
    ADD
    %trie_read                   // [child, sc, sp, vptr, ptr]
    %stack (child, sc, sp, vptr) -> (child, sc, sp, vptr, mi_ext_ret)
    %jump(mpt_insert)
mi_ext_ret:
    // stack: newchild, ptr, retdest
    %stack (newchild, ptr) -> (ptr, 3, newchild, ptr)
    ADD
    %trie_write                  // [ptr, retdest]
    SWAP1
    JUMP
mi_ext_split:
    // stack: cp, ecount, epacked, ptr, count, packed, vptr, retdest
    %stack (cp, ecount, epacked, ptr, count, packed, vptr) -> (ptr, 3, cp, ecount, epacked, count, packed, vptr)
    ADD
    %trie_read                   // [child, cp, ecount, epacked, count, packed, vptr]
    PUSH 18
    %trie_alloc                  // [branch, child, cp, ecount, epacked, count, packed, vptr]
    DUP1
    PUSH @MPT_BRANCH
    SWAP1
    %trie_write
    // rest_old = key_suffix(ecount, epacked, cp); roc >= 1 since cp < ecount
    %stack (branch, child, cp, ecount, epacked, count, packed, vptr) -> (ecount, epacked, cp, mi_ext_ro, branch, child, cp, count, packed, vptr)
    %jump(key_suffix)
mi_ext_ro:
    // stack: roc, rop, branch, child, cp, count, packed, vptr, retdest
    %stack (roc, rop) -> (roc, rop, mi_ext_ro_head)
    %jump(key_head)
mi_ext_ro_head:
    // stack: rof, roc1, ror, branch, child, cp, count, packed, vptr
    DUP2
    ISZERO
    %jumpi(mi_ext_ro_direct)
    // remainder keeps nibbles: shorter extension over the old child
    %stack (rof, roc1, ror, branch, child) -> (@MPT_EXTENSION, roc1, ror, child, mi_ext_ro_made, rof, branch)
    %jump(make_node4)
mi_ext_ro_made:
    // stack: extp, rof, branch, cp, count, packed, vptr, retdest
    %stack (extp, rof, branch) -> (branch, 1, rof, extp, branch)
    ADD
    ADD
    %trie_write                  // [branch, cp, count, packed, vptr]
    %jump(mi_attach_new)
mi_ext_ro_direct:
    // stack: rof, roc1(0), ror, branch, child, cp, count, packed, vptr
    %stack (rof, roc1, ror, branch, child) -> (branch, 1, rof, child, branch)
    ADD
    ADD
    %trie_write                  // [branch, cp, count, packed, vptr]
    %jump(mi_attach_new)

// ------------------------------------------------------------- delete

// mpt_delete(ptr, count, packed, retdest) -> newptr (host twin:
// mpt.py trie_delete; reference cpu/kernel/asm/mpt/delete/delete.asm):
// standard MPT deletion with branch collapse and extension merging.
// A missing key returns the trie unchanged; traversing (or collapsing
// past) a HASH node panics — the partial trie must cover the path and
// the collapse sibling, exactly the reference's requirement.
global mpt_delete:
    DUP1
    %trie_read                   // [type, ptr, count, packed, retdest]
    DUP1
    PUSH @MPT_EMPTY
    EQ
    %jumpi(md_unchanged)
    DUP1
    PUSH @MPT_LEAF
    EQ
    %jumpi(md_leaf)
    DUP1
    PUSH @MPT_EXTENSION
    EQ
    %jumpi(md_ext)
    DUP1
    PUSH @MPT_BRANCH
    EQ
    %jumpi(md_branch)
    %jump(panic)

md_unchanged:
    // stack: type, ptr, count, packed, retdest
    %stack (type, ptr, count, packed, retdest) -> (retdest, ptr)
    JUMP

md_leaf:
    // stack: type, ptr, count, packed, retdest
    POP
    DUP1
    PUSH 1
    ADD
    %trie_read                   // [ecount, ptr, count, packed]
    DUP2
    PUSH 2
    ADD
    %trie_read                   // [epacked, ecount, ptr, count, packed]
    %stack (epacked, ecount, ptr, count, packed) -> (ecount, count, epacked, packed, ptr)
    EQ
    %stack (ceq, epacked, packed) -> (epacked, packed, ceq)
    EQ
    MUL                          // [match, ptr, retdest]
    ISZERO
    %jumpi(md_leaf_miss)
    %stack (ptr, retdest) -> (retdest, 0)
    JUMP
md_leaf_miss:
    SWAP1
    JUMP

md_ext:
    // stack: type, ptr, count, packed, retdest
    POP
    DUP1
    PUSH 1
    ADD
    %trie_read                   // [ecount, ptr, count, packed]
    DUP2
    PUSH 2
    ADD
    %trie_read                   // [epacked, ecount, ptr, count, packed]
    %stack (epacked, ecount, ptr, count, packed) -> (ecount, epacked, count, packed, md_ext_cp, epacked, ecount, ptr, count, packed)
    %jump(key_common_prefix)
md_ext_cp:
    // stack: cp, epacked, ecount, ptr, count, packed, retdest
    DUP3
    EQ                           // cp == ecount ?
    ISZERO
    %jumpi(md_ext_miss)
    %stack (epacked, ecount, ptr, count, packed) -> (count, packed, ecount, md_ext_sfx, epacked, ecount, ptr)
    %jump(key_suffix)
md_ext_sfx:
    // stack: sc, sp, epacked, ecount, ptr, retdest
    DUP5
    PUSH 3
    ADD
    %trie_read                   // [child, sc, sp, epacked, ecount, ptr]
    %stack (child, sc, sp, epacked, ecount, ptr) -> (child, sc, sp, md_ext_del, ecount, epacked)
    %jump(mpt_delete)
md_ext_del:
    // stack: newchild, ecount, epacked, retdest
    %stack (newchild, ecount, epacked) -> (ecount, epacked, newchild, md_ext_done)
    %jump(merge_extension)
md_ext_done:
    SWAP1
    JUMP
md_ext_miss:
    %stack (epacked, ecount, ptr, count, packed, retdest) -> (retdest, ptr)
    JUMP

md_branch:
    // stack: type, ptr, count, packed, retdest
    POP
    DUP2
    ISZERO
    %jumpi(md_br_value)
    %stack (ptr, count, packed) -> (count, packed, md_br_head, ptr)
    %jump(key_head)
md_br_head:
    // stack: first, cm1, rest, ptr, retdest
    DUP4
    PUSH 1
    ADD
    DUP2
    ADD                          // [slot = ptr+1+first, first, cm1, rest, ptr]
    DUP1
    %trie_read                   // [child, slot, first, cm1, rest, ptr]
    %stack (child, slot, first, cm1, rest, ptr) -> (child, cm1, rest, md_br_del, slot, ptr)
    %jump(mpt_delete)
md_br_del:
    // stack: newchild, slot, ptr, retdest — mutate the child cell in
    // place (same ownership argument as mpt_insert)
    SWAP1
    %trie_write                  // [ptr, retdest]
    %stack (ptr) -> (ptr, md_br_done)
    %jump(collapse_branch)
md_br_done:
    SWAP1
    JUMP
md_br_value:
    // delete the branch's own value (unreachable for the fixed
    // 64-nibble state/storage keys; host-twin parity)
    // stack: ptr, count, packed, retdest
    %stack (ptr, count, packed) -> (ptr, 17, 0, ptr)
    ADD
    %trie_write                  // TRIE[ptr+17] = 0
    %stack (ptr) -> (ptr, md_br_done)
    %jump(collapse_branch)

// merge_extension(ecount, epacked, child, retdest) -> ptr: an
// extension key over a possibly-collapsed child (mpt.py
// _merge_extension).  LEAF/EXT children merge keys; BRANCH keeps an
// extension node; EMPTY erases; HASH panics (blind merge).
global merge_extension:
    // stack: ecount, epacked, child, retdest
    DUP3
    %trie_read                   // [ctype, ecount, epacked, child]
    DUP1
    PUSH @MPT_EMPTY
    EQ
    %jumpi(me_empty)
    DUP1
    PUSH @MPT_LEAF
    EQ
    %jumpi(me_concat)
    DUP1
    PUSH @MPT_EXTENSION
    EQ
    %jumpi(me_concat)
    DUP1
    PUSH @MPT_BRANCH
    EQ
    ISZERO
    %jumpi(panic)                // HASH: collapse sibling not present
    %stack (ctype, ecount, epacked, child) -> (@MPT_EXTENSION, ecount, epacked, child, me_done)
    %jump(make_node4)
me_concat:
    // stack: ctype, ecount, epacked, child — same type, key = e ++ c
    DUP4
    PUSH 1
    ADD
    %trie_read                   // [ccount, ctype, ecount, epacked, child]
    DUP5
    PUSH 2
    ADD
    %trie_read                   // [cpacked, ccount, ctype, ecount, epacked, child]
    DUP6
    PUSH 3
    ADD
    %trie_read                   // [ctail, cpacked, ccount, ctype, ecount, epacked, child]
    %stack (ctail, cpacked, ccount, ctype, ecount, epacked, child) -> (ccount, 4, epacked, cpacked, ctype, ecount, ccount, ctail)
    MUL                          // [4*ccount, epacked, cpacked, ...]
    SHL                          // [epacked << 4*ccount, cpacked, ...]
    ADD                          // [newpacked, ctype, ecount, ccount, ctail]
    %stack (newpacked, ctype, ecount, ccount, ctail) -> (ecount, ccount, ctype, newpacked, ctail)
    ADD                          // [newcount, ctype, newpacked, ctail]
    %stack (newcount, ctype, newpacked, ctail) -> (ctype, newcount, newpacked, ctail, me_done)
    %jump(make_node4)
me_done:
    SWAP1
    JUMP
me_empty:
    %stack (ctype, ecount, epacked, child, retdest) -> (retdest, 0)
    JUMP

// collapse_branch(ptr, retdest) -> newptr: a branch left with one
// child and no value collapses into that child prefixed by its nibble
// (mpt.py _collapse_branch; reference delete/branch.asm)
global collapse_branch:
    // stack: ptr, retdest
    PUSH 0                       // n
    PUSH 0                       // last_i
    PUSH 0                       // i
cb_loop:
    // stack: i, last_i, n, ptr, retdest
    DUP1
    PUSH 16
    EQ
    %jumpi(cb_scan_done)
    DUP4
    PUSH 1
    ADD
    DUP2
    ADD                          // [ptr+1+i, i, last_i, n, ptr]
    %trie_read                   // [child, i, last_i, n, ptr]
    %trie_read                   // [ctype, ...] (child 0 reads EMPTY)
    PUSH @MPT_EMPTY
    EQ
    %jumpi(cb_skip)
    %stack (i, last_i, n) -> (n, 1, i, i)
    ADD                          // [n+1, i, i]
    %stack (np, li, i) -> (i, li, np)
cb_skip:
    PUSH 1
    ADD
    %jump(cb_loop)
cb_scan_done:
    // stack: 16, last_i, n, ptr, retdest
    POP
    DUP3
    PUSH 17
    ADD
    %trie_read                   // [value, last_i, n, ptr, retdest]
    DUP3
    PUSH 1
    LT                           // [1 < n, value, last_i, n, ptr]
    %jumpi(cb_unchanged)
    DUP3
    ISZERO
    %jumpi(cb_no_children)
    DUP1
    %jumpi(cb_unchanged)         // one child + a value: stays a branch
    POP                          // [last_i, n, ptr]
    DUP3
    PUSH 1
    ADD
    DUP2
    ADD
    %trie_read                   // [child, last_i, n, ptr]
    %stack (child, last_i, n, ptr) -> (1, last_i, child, cb_done)
    %jump(merge_extension)
cb_no_children:
    // stack: value, last_i, n, ptr, retdest
    DUP1
    %jumpi(cb_value_leaf)
    %stack (value, last_i, n, ptr, retdest) -> (retdest, 0)
    JUMP
cb_value_leaf:
    %stack (value, last_i, n, ptr) -> (@MPT_LEAF, 0, 0, value, cb_done)
    %jump(make_node4)
cb_unchanged:
    %stack (value, last_i, n, ptr, retdest) -> (retdest, ptr)
    JUMP
cb_done:
    SWAP1
    JUMP
