"""Meshes of ranks, the package's collectives, and the sharded primitives.

One process (rank) drives one device; a ``Mesh`` is the ranks of one
``torch.distributed`` process group, seen from one of them.  The reference's
only parallel substrate is rayon (maybe_rayon/src/lib.rs); here the
equivalents are:
  * data parallelism over polynomial columns: each rank holds a block of
    the (num_polys, n) batch, and NTT butterflies act along the unsharded
    row axis with no communication;
  * "sequence" parallelism over trace rows: a four-step NTT factorisation
    N = N1 * N2 with local NTTs, a twiddle scale and one all_to_all mesh
    transpose (the transpose the reference prototypes in
    projects/cache-friendly-fft/transpose.py).

A sharded value is the calling rank's local block, never a global array;
each function says which block a rank holds.

Every collective of ``plonky2_tpu_torch.parallel`` is a helper of this
module (``distributed.py`` brings the process group up).  Under NCCL a
collective runs in place on the card; under gloo a CUDA tensor is copied to
the host for the collective and back, explicitly, here, so the compute
never leaves the device.  A mesh of one rank needs no process group: every
helper is then the identity.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.distributed as dist

from ..field import gl64, ntt
from ..field.goldilocks import GF
from ..hash.hashing import hash_or_noop_cols
from ..utils.bits import log2_strict
from ..utils.cuda import resolve_device


class Mesh:
    """A 1-D mesh: the ranks of one process group, each driving one device.

    group: the process group (None: the default, whole-world group);
    ranks: the global ranks of its members, in mesh order; rank: the
    calling process's position in the mesh (-1 if it is not a member);
    device: the calling rank's device, always with its index.
    """

    def __init__(self, group=None, ranks=None, device=None, parent=None):
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.group = group
        self.parent = parent
        if dist.is_available() and dist.is_initialized():
            world = dist.get_world_size()
            self.ranks = list(range(world)) if ranks is None else list(ranks)
            me = dist.get_rank()
            self.rank = self.ranks.index(me) if me in self.ranks else -1
            self.backend = dist.get_backend()
        else:
            self.ranks = [0]
            self.rank = 0
            self.backend = None
        self.size = len(self.ranks)

    @property
    def is_member(self) -> bool:
        return self.rank >= 0

    @property
    def key(self) -> tuple:
        """Identifies the mesh from this rank (cache key)."""
        return (tuple(self.ranks), self.rank, str(self.device))

    def __repr__(self) -> str:
        return (f"Mesh(ranks={self.ranks}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")


def make_mesh(device=None) -> Mesh:
    """A mesh over every rank of the world (one rank, no process group,
    when none was brought up).  device: this rank's device; None means its
    CUDA device."""
    return Mesh(device=device)


def split_mesh(mesh: Mesh, num_groups: int) -> list:
    """Split the mesh's ranks into num_groups equal, contiguous sub-meshes
    (one process group each; every rank of the mesh must call this)."""
    per = mesh.size // num_groups
    if per < 1:
        raise ValueError("more groups than ranks")
    out = []
    for g in range(num_groups):
        ranks = mesh.ranks[g * per:(g + 1) * per]
        group = dist.new_group(ranks) if mesh.backend is not None else None
        out.append(Mesh(group, ranks, mesh.device, parent=mesh))
    return out


# -- collectives --------------------------------------------------------------
#
# Under gloo a CUDA tensor goes through a host copy: gloo's CUDA support is
# partial, and this keeps every rank's math on its own device.

def _via_host(mesh: Mesh, x: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and x.is_cuda


def _global(mesh: Mesh, mesh_rank: int) -> int:
    return mesh.ranks[mesh_rank]


def bytes_moved() -> int:
    """Bytes this rank has handed to other ranks in collectives since the
    last reset, each destination counted (the payload, not the wire
    traffic of a particular algorithm)."""
    return _traffic["bytes"]


def reset_bytes_moved() -> None:
    _traffic["bytes"] = 0


_traffic = {"bytes": 0}


def _count(x: torch.Tensor, destinations: float) -> None:
    """Add x's bytes once per rank it is sent to."""
    _traffic["bytes"] += int(x.numel() * x.element_size() * destinations)


def all_to_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The tiled all_to_all of a (k, M) block: split axis 1 into mesh.size
    equal parts, send part j to mesh rank j, and concatenate what arrives
    along axis 0 in rank order -> (k * size, M / size)."""
    nd = mesh.size
    if nd == 1:
        return x
    k, m = x.shape
    if m % nd:
        raise ValueError(f"all_to_all: {m} columns do not split {nd} ways")
    # all_to_all_single splits dim 0: bring the column blocks in front
    send = x.reshape(k, nd, m // nd).permute(1, 0, 2).contiguous()
    _count(send, (nd - 1) / nd)     # all but its own part
    if _via_host(mesh, send):
        host = send.cpu()
        recv = torch.empty_like(host)
        dist.all_to_all_single(recv, host, group=mesh.group)
        recv = recv.to(x.device)
    else:
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=mesh.group)
    return recv.reshape(nd * k, m // nd)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: int = 0) -> torch.Tensor:
    """Every rank's block, concatenated along axis in rank order (the
    tiled all_gather); blocks must have equal shapes."""
    nd = mesh.size
    if nd == 1:
        return x
    x = x.contiguous()
    _count(x, nd - 1)
    src = x.cpu() if _via_host(mesh, x) else x
    parts = [torch.empty_like(src) for _ in range(nd)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts, dim=axis).to(x.device)


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Integer sum over the mesh (not a field sum)."""
    return _all_reduce(x, mesh, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Elementwise maximum over the mesh."""
    return _all_reduce(x, mesh, dist.ReduceOp.MAX)


def _all_reduce(x: torch.Tensor, mesh: Mesh, op) -> torch.Tensor:
    if mesh.size == 1:
        return x
    buf = x.cpu().clone() if _via_host(mesh, x) else x.clone()
    _count(buf, mesh.size - 1)
    dist.all_reduce(buf, op=op, group=mesh.group)
    return buf.to(x.device)


def broadcast(x: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """Mesh rank src's x on every rank (x gives the shape elsewhere)."""
    if mesh.size == 1:
        return x
    buf = x.contiguous()
    buf = buf.cpu() if _via_host(mesh, buf) else buf.clone()
    if mesh.rank == src:
        _count(buf, mesh.size - 1)
    dist.broadcast(buf, src=_global(mesh, src), group=mesh.group)
    return buf.to(x.device)


def broadcast_bytes(data: bytes | None, mesh: Mesh, src: int = 0) -> bytes:
    """Mesh rank src's byte string on every rank."""
    if mesh.size == 1:
        return data
    dev = torch.device("cpu") if mesh.backend == "gloo" else mesh.device
    n = torch.tensor([len(data) if mesh.rank == src else 0], device=dev)
    n = int(broadcast(n, mesh, src)[0])
    buf = torch.zeros(n, dtype=torch.uint8, device=dev)
    if mesh.rank == src:
        buf = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
    return broadcast(buf, mesh, src).cpu().numpy().tobytes()


def roll_left(x: torch.Tensor, k: int, mesh: Mesh) -> torch.Tensor:
    """The global roll(-k) along the last axis of an axis-sharded block:
    each rank's first k entries move to the end of its left neighbour's
    block (the ring ppermute, here an all_gather of the small halos)."""
    if k > x.shape[-1]:
        raise ValueError("roll_left: halo longer than the local block")
    if mesh.size == 1:
        return torch.roll(x, -k, dims=-1)
    halos = all_gather(x[..., :k].unsqueeze(0), mesh)
    recv = halos[(mesh.rank + 1) % mesh.size]
    return torch.cat([x[..., k:], recv], dim=-1)


def send(tensors: list, mesh: Mesh, dst: int) -> list:
    """Start sending tensors to mesh rank dst; returns the pending works
    (wait on each before the next send of the same buffers)."""
    works = []
    for t in tensors:
        t = t.contiguous()
        t = t.cpu() if _via_host(mesh, t) else t
        _count(t, 1)
        works.append((dist.isend(t, dst=_global(mesh, dst)), t))
    return works


def recv(shapes: list, mesh: Mesh, src: int) -> list:
    """Receive int64 tensors of the given shapes from mesh rank src onto
    this rank's device."""
    out = []
    via_host = mesh.backend == "gloo" and mesh.device.type == "cuda"
    for shape in shapes:
        buf = torch.empty(shape, dtype=torch.int64,
                          device="cpu" if via_host else mesh.device)
        dist.recv(buf, src=_global(mesh, src))
        out.append(buf.to(mesh.device))
    return out


# -- sharded primitives -------------------------------------------------------

def shard_polys(polys: GF, mesh: Mesh) -> GF:
    """The rank's block of a (num_polys, n) batch, on its device: rows
    [rank * b, (rank + 1) * b) of the batch zero-padded to size * b rows,
    b = ceil(num_polys / size)."""
    k = polys.shape[0]
    b = -(-k // mesh.size)
    lo = mesh.rank * b
    blk = polys.v[lo:min(lo + b, k)].to(mesh.device)
    if blk.shape[0] < b:
        pad = torch.zeros((b - blk.shape[0],) + tuple(polys.shape[1:]),
                          dtype=torch.int64, device=mesh.device)
        blk = torch.cat([blk, pad], dim=0)
    return GF(blk)


def dp_lde_and_leaf_hash(polys: GF, rate_bits: int, shift: int, mesh: Mesh,
                         num_polys: int | None = None) -> GF:
    """Data-parallel LDE + per-shard Merkle leaf hashing.

    polys: the rank's block of the batch (shard_polys).  Each rank LDEs its
    polynomials locally; leaf hashing needs whole leaves, so one all_to_all
    re-shards by LDE point (per-rank memory stays full/size), and the
    sponge hashes the columns of that block where they lie.  The zero pad
    rows of the batch (those at and above num_polys) are dropped before
    hashing.  Returns the rank's block of the leaf digests: rows
    [rank * N / size, (rank + 1) * N / size) of the (N, 4) digests of the
    natural-order LDE rows, N = n << rate_bits.
    """
    values = ntt.lde(polys, rate_bits, shift=shift)       # (b, N) local
    rows = all_to_all(values.v, mesh)                      # (b * size, N/size)
    if num_polys is not None:
        rows = rows[:num_polys]
    return hash_or_noop_cols(GF(rows), leaf_order=False)


@lru_cache(maxsize=8)
def _four_step_twiddles(log_n: int, size: int, rank: int) -> np.ndarray:
    """Rows [rank * b1, (rank + 1) * b1) of tw[j1, k2] = w^(j1 k2), by
    log2(n2) doubling passes along k2."""
    log_n1 = log_n // 2
    n1, n2 = 1 << log_n1, 1 << (log_n - log_n1)
    b1 = n1 // size
    w = gl64.primitive_root_of_unity(log_n)
    col = gl64.powers(w, n1)[rank * b1:(rank + 1) * b1]   # w^j1
    tw = np.ones((b1, n2), dtype=np.uint64)
    m = 1
    while m < n2:
        tw[:, m:2 * m] = gl64.mul(tw[:, :m], col[:, None])
        col = gl64.mul(col, col)
        m *= 2
    return tw


def four_step_ntt(x: GF, mesh: Mesh) -> GF:
    """Distributed NTT of a length-N vector.

    Bailey four-step with N = N1 * N2, input viewed as A[j1, j2] =
    x[j1 + N1 * j2]; rank r takes rows j1 of its block:
      1. length-N2 NTTs along j2 (local rows),
      2. twiddle scale by w^(j1 * k2),
      3. all_to_all transpose so j1 becomes local,
      4. length-N1 NTTs along j1.
    x: the whole vector (every rank passes the same).  Returns the rank's
    block of C, the (N1, N2) matrix with X[k2 + N2 * k1] = C[k1, k2] for
    the natural-order NTT X: columns k2 in [rank * N2 / size,
    (rank + 1) * N2 / size), shape (N1, N2 / size).  Concatenating every
    rank's block along axis 1 and flattening gives X.
    """
    n = x.shape[-1]
    log_n = log2_strict(n)
    nd = mesh.size
    log_n1 = log_n // 2
    n1, n2 = 1 << log_n1, 1 << (log_n - log_n1)
    if n1 % nd or n2 % nd:
        raise ValueError(f"four_step_ntt: {n1} x {n2} does not split {nd} ways")
    b1 = n1 // nd
    rows = slice(mesh.rank * b1, (mesh.rank + 1) * b1)
    a = GF(x.v.to(mesh.device).reshape(n2, n1)[:, rows].transpose(0, 1)
           .contiguous())                                   # (b1, n2)
    tw = GF.from_u64(_four_step_twiddles(log_n, nd, mesh.rank), mesh.device)
    b = ntt.ntt(a) * tw
    c = all_to_all(b.v, mesh)                               # (n1, n2/nd)
    c = ntt.ntt(GF(c.transpose(0, 1).contiguous()))         # along j1
    return GF(c.v.transpose(0, 1).contiguous())
