"""RLP encoding/decoding (twin of reference evm/src/generation/rlp.rs
plus the `rlp` crate's core rules, re-implemented from the Ethereum
yellow-paper spec).

Items are `bytes` or (recursively) lists of items.  Integers are
encoded big-endian with no leading zeros (the convention the reference
relies on via `rlp::encode(&U256)`), so `encode_int(0) == b''` wrapped
as a single empty string.
"""

from __future__ import annotations


def encode_int(v: int) -> bytes:
    """Minimal big-endian byte string (U256 RLP convention)."""
    assert v >= 0
    return v.to_bytes((v.bit_length() + 7) // 8, "big") if v else b""


def decode_int(b: bytes) -> int:
    assert len(b) == 0 or b[0] != 0, "RLP integer has leading zero"
    return int.from_bytes(b, "big")


def _length_prefix(length: int, short_offset: int, long_offset: int) -> bytes:
    if length < 56:
        return bytes([short_offset + length])
    ll = encode_int(length)
    return bytes([long_offset + len(ll)]) + ll


def encode(item) -> bytes:
    """RLP-encode bytes | int | list (ints via encode_int)."""
    if isinstance(item, int):
        item = encode_int(item)
    if isinstance(item, (bytes, bytearray)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _length_prefix(len(item), 0x80, 0xB7) + item
    assert isinstance(item, (list, tuple)), f"cannot RLP-encode {item!r}"
    payload = b"".join(encode(x) for x in item)
    return _length_prefix(len(payload), 0xC0, 0xF7) + payload


def _decode_at(data: bytes, pos: int) -> tuple:
    """(item, next_pos)."""
    b0 = data[pos]
    if b0 < 0x80:
        return bytes([b0]), pos + 1
    if b0 < 0xB8:                                  # short string
        n = b0 - 0x80
        s = data[pos + 1:pos + 1 + n]
        assert len(s) == n, "truncated RLP string"
        assert n != 1 or s[0] >= 0x80, "non-canonical single byte"
        return s, pos + 1 + n
    if b0 < 0xC0:                                  # long string
        ln = b0 - 0xB7
        n = decode_int(data[pos + 1:pos + 1 + ln])
        assert n >= 56, "non-canonical long string"
        s = data[pos + 1 + ln:pos + 1 + ln + n]
        assert len(s) == n, "truncated RLP string"
        return s, pos + 1 + ln + n
    if b0 < 0xF8:                                  # short list
        n = b0 - 0xC0
        end = pos + 1 + n
    else:                                          # long list
        ln = b0 - 0xF7
        n = decode_int(data[pos + 1:pos + 1 + ln])
        assert n >= 56, "non-canonical long list"
        pos += ln
        end = pos + 1 + n
    assert end <= len(data), "truncated RLP list"
    items, p = [], pos + 1
    while p < end:
        item, p = _decode_at(data, p)
        items.append(item)
    assert p == end, "RLP list payload overrun"
    return items, end


def decode(data: bytes):
    item, end = _decode_at(bytes(data), 0)
    assert end == len(data), "trailing bytes after RLP item"
    return item


def decode_list(data: bytes) -> list:
    item = decode(data)
    assert isinstance(item, list), "expected an RLP list"
    return item
