"""Native (C++) host code, loaded through ctypes.

The keccak configs (``hasher="keccak"``) hash every Merkle level on the host,
as the reference does (plonky2/src/plonk/config.rs:72: the keccak config
exists for cheap non-recursive proofs).  ``keccak.cpp`` gives that hashing
the native speed the reference gets from rustc.  It is compiled with g++ at
first use into ``plonky2_tpu_torch/_build/native/`` (never next to the
source), keyed by a hash of the source.  If no compiler is available the
callers fall back to the numpy twins in ``hash/keccak.py``, which give the
same bytes; ``backend()`` says which one hashes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "keccak.cpp"
_BUILD = Path(__file__).resolve().parent.parent / "_build" / "native"

_lock = threading.Lock()
_lib = None
_tried = False


def _lib_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD / f"libkeccak-{digest}.so"


def _build(target: Path) -> bool:
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o",
                        str(tmp)], check=True, capture_output=True,
                       timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, target)
    return True


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        target = _lib_path()
        if not target.exists() and not _build(target):
            return None
        try:
            lib = ctypes.CDLL(str(target))
        except OSError:
            return None
        lib.keccak256_rows.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                       ctypes.c_size_t, ctypes.c_void_p]
        lib.keccak256_rows.restype = None
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def backend() -> str:
    """Which code hashes keccak rows: "native" (keccak.cpp) or "numpy"."""
    return "native" if available() else "numpy"


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("native keccak library is not available")
    return lib


def keccak256_rows(rows: np.ndarray) -> np.ndarray:
    """keccak-256 of each row of an (n, L) uint8 matrix -> (n, 32) uint8."""
    lib = _require()
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    n, length = rows.shape
    if length == 0:
        rows = np.zeros((n, 1), dtype=np.uint8)  # valid pointer, len stays 0
    out = np.empty((n, 32), dtype=np.uint8)
    lib.keccak256_rows(rows.ctypes.data, n, length, out.ctypes.data)
    return out
