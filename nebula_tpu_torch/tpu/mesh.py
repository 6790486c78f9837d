"""A 1-D mesh of shard devices and the collectives of the replicated-
frontier mesh and the frontier-sharded one — the port's counterpart of
the reference's ``jax.sharding.Mesh`` with its ``"parts"`` axis and of
what its ``shard_map`` bodies exchange (``nebula_tpu/tpu/ell.py:1789``'s
re-replication, ``kernels.py:384``'s ``psum``, ``ell.py:2003``'s
``all_to_all``).

One process drives every shard, as the reference's single controller
drives its mesh: there is no ``torch.distributed``.  A shard is an
index into ``PartsMesh.devices``; several shards may sit on one device
(k shards on one card, or on the CPU, play the part of the test
suite's virtual devices).  Each shard keeps its own buffers, and
whatever moves between shards moves into the receiving shard's
buffer — a peer copy between two cards, a device copy when both
shards share one — so shards on one card move the same bytes a mesh of
cards would.  The hop's row replication sends a source shard's owned
rows to every shard on its card in one launch (``ell_ops.copy_rows``);
everything else moves by ``Tensor.copy_``.  Combining what arrived
(the OR of ``psum_or``) is one kernel launch a shard
(``ell_ops.or_many``).  A copy between two cards runs on the current
streams of both (``Tensor.copy_``'s own ordering); only one card has
been run.
"""
from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple

import torch


def on(device: torch.device):
    """A context in which a kernel launch lands on ``device``: its card
    made current (a launch goes to the current card), or nothing for the
    CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class PartsMesh:
    """k shard devices in shard order; repeats allowed."""

    __slots__ = ("devices",)

    def __init__(self, devices: Sequence):
        devs = tuple(torch.device("cuda", 0) if torch.device(d) ==
                     torch.device("cuda") else torch.device(d)
                     for d in devices)
        if len(devs) < 2:
            raise ValueError(f"a mesh needs at least 2 shards, got "
                             f"{len(devs)}")
        kinds = {d.type for d in devs}
        if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
            raise ValueError(f"mesh devices must all be CUDA cards or all "
                             f"the CPU: {devs}")
        self.devices = devs

    @property
    def k(self) -> int:
        return len(self.devices)

    def __eq__(self, other) -> bool:
        return isinstance(other, PartsMesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return f"PartsMesh({[str(d) for d in self.devices]})"

    def replicas(self, t: torch.Tensor) -> List[torch.Tensor]:
        """One fresh copy of ``t`` on every shard (a replicated input)."""
        out = []
        for d in self.devices:
            r = torch.empty(t.shape, dtype=t.dtype, device=d)
            r.copy_(t)
            out.append(r)
        return out


def replicate_rows(bufs: Sequence[torch.Tensor],
                   blocks: Sequence[Sequence[Tuple[int, int]]],
                   copy) -> int:
    """Every shard receives every other shard's owned rows: shard s owns
    the row ranges ``blocks[s]`` (half-open, along dim 0) of its buffer
    ``bufs[s]``, and each of them is copied into the same rows of every
    other shard's buffer.  The receivers on the source's own device take
    them through one ``copy(bufs[t], receivers, blocks[t])``
    (``ell_ops.copy_rows``, M3: one launch a source shard, or its plain
    version); a receiver on another card takes them by ``copy_`` per
    range (a peer copy; no such machine has been measured).  Returns the
    bytes copied."""
    moved = 0
    for t, rows in enumerate(blocks):
        rows = [(lo, hi) for lo, hi in rows if hi > lo]
        if not rows:
            continue
        src = bufs[t]
        near = [b for s, b in enumerate(bufs)
                if s != t and b.device == src.device]
        if near:
            copy(src, near, rows)
        for s, dst in enumerate(bufs):
            if s != t and dst.device != src.device:
                for lo, hi in rows:
                    dst[lo:hi].copy_(src[lo:hi])
        nbytes = sum(hi - lo for lo, hi in rows) * src[0].numel() \
            * src.element_size()
        moved += nbytes * (len(bufs) - 1)
    return moved


def psum_or(partials: Sequence[torch.Tensor], outs: Sequence[torch.Tensor],
            recv: Sequence[torch.Tensor], or_many) -> None:
    """``outs[s]`` = the OR of every shard's ``partials``: shard s
    copies its own partial into ``outs[s]``, receives each other
    shard's, in shard order, into a row of its receive slab ``recv[s]``
    ([k - 1, *shape], on its device), then ORs the whole slab in with
    one ``or_many(recv[s], outs[s])``: k combine launches, and the same
    k(k - 1) copies a mesh of cards would move.  ``partials`` and
    ``outs`` are per shard, all of one shape; ``partials`` are only
    read."""
    k = len(partials)
    for s, out in enumerate(outs):
        out.copy_(partials[s])
        slab = recv[s]
        if slab.shape[0] != k - 1:
            raise ValueError(f"shard {s}: a receive slab of "
                             f"{slab.shape[0]} rows for {k} shards")
        rows = iter(slab.unbind(0))
        for t, p in enumerate(partials):
            if t != s:
                next(rows).copy_(p)
        or_many(slab, out)


def all_to_all(send: Sequence[torch.Tensor],
               recv: Sequence[torch.Tensor]) -> Tuple[int, int]:
    """``jax.lax.all_to_all(x, axis, 0, 0, tiled=False)``: shard s's
    buffer ``send[s]`` holds one block per destination along dim 0,
    and block d lands in shard d's buffer ``recv[d]`` at block s — one
    ``copy_`` per (source, destination) pair, the local one included.
    Returns (the copies made, the bytes copied between shards)."""
    k = len(send)
    if len(recv) != k:
        raise ValueError(f"{k} send buffers, {len(recv)} receive buffers")
    for s in range(k):
        for b in (send[s], recv[s]):
            if b.shape[0] != k or b.shape != send[0].shape \
                    or b.dtype != send[0].dtype:
                raise ValueError(f"shard {s}: buffers must all be "
                                 f"{tuple(send[0].shape)} "
                                 f"{send[0].dtype} with {k} blocks")
    copies = moved = 0
    for s in range(k):
        for d in range(k):
            blk = send[s][d]
            recv[d][s].copy_(blk)
            copies += 1
            if s != d:
                moved += blk.numel() * blk.element_size()
    return copies, moved
