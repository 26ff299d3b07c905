"""Build and bind the hand-written CUDA kernels in ``plonky2_tpu_torch/csrc``.

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``.  The
build happens at first use, into ``plonky2_tpu_torch/_build/<hash>/``, keyed
by a hash of every source (``.cu`` and ``.cuh``), so a checkout builds its
own kernels; all sources compile in parallel, one ``nvcc`` each.

A ``CudaKernel`` is one C entry point.  Every C entry point launches on the
stream it is given (PyTorch's current stream), allocates nothing, writes
the number of kernel launches it issued to its ``launches`` argument, and
returns ``cudaGetLastError()``; the call raises if that is not 0.  Each
``CudaKernel`` counts its calls in ``calls`` and the kernel launches they
issued in ``launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
build_log: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    # CUDA_HOME, else the toolkit's default install prefix
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every csrc/*.cu (in parallel) unless already built; return
    {source name: path of its .so}."""
    with _lock:
        out_dir = BUILD_ROOT / _sources_hash()
        out_dir.mkdir(parents=True, exist_ok=True)
        sources = sorted(CSRC.glob("*.cu"))
        targets = {s.name: out_dir / (s.stem + ".so") for s in sources}
        todo = [s for s in sources if not targets[s.name].exists()]
        procs = []
        for s in todo:
            tmp = out_dir / f"{s.stem}.{os.getpid()}.tmp.so"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(s)]
            procs.append((s, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for s, tmp, p in procs:
            log, _ = p.communicate()
            build_log[s.name] = log
            if p.returncode != 0:
                failed.append(f"{s.name}:\n{log}")
            else:
                os.replace(tmp, targets[s.name])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return targets


def _library(source: str) -> ctypes.CDLL:
    lib = _libs.get(source)
    if lib is None:
        path = build_all()[source]
        lib = _libs[source] = ctypes.CDLL(str(path))
    return lib


class CudaKernel:
    """One C entry point of a csrc/*.cu library, with a launch counter."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.calls = 0
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(_library(self.source), self.symbol)
            # + launches (out), stream
            fn.argtypes = self.argtypes + [ctypes.POINTER(ctypes.c_int),
                                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream().cuda_stream
        launched = ctypes.c_int(0)
        err = self._fn(*args, ctypes.byref(launched), stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol} failed: CUDA error {err}")
        self.calls += 1
        self.launches += launched.value

    def reset(self) -> None:
        self.calls = self.launches = 0


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


def check_cuda_tensor(x: torch.Tensor, name: str) -> None:
    """Raise unless x is a contiguous int64 CUDA tensor."""
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.int64:
        raise ValueError(f"{name}: expected int64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
