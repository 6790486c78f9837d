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
suite's virtual devices).  The shards that share a device form one
card group (``PartsMesh.groups``): their working buffers are one
``[members, ...]`` slab, and each stage of a mesh program is one
launch a kernel over every member of a group (``ell_ops.mesh_hop``,
``mesh_route``, ``mesh_dedup``, ...).  Each shard keeps its own row of
those slabs, and whatever moves between shards moves into the
receiving shard's row — written there by the launch when both shards
share a card, copied by ``Tensor.copy_`` (a peer copy) when they do
not — so shards on one card move the same bytes a mesh of cards would.
A copy between two cards runs on the current streams of both
(``Tensor.copy_``'s own ordering); only one card has been run.
"""
from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple

import torch

MAX_CARD_SHARDS = 16   # csrc kCardShards: the members one launch covers


def on(device: torch.device):
    """A context in which a kernel launch lands on ``device``: its card
    made current (a launch goes to the current card), or nothing for the
    CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def card_groups(devices: Sequence[torch.device]
                ) -> Tuple[Tuple[torch.device, Tuple[int, ...]], ...]:
    """The shards grouped by device, in order of each device's first
    shard: ((device, its shards in shard order), ...)."""
    groups: dict = {}
    for s, d in enumerate(devices):
        groups.setdefault(d, []).append(s)
    return tuple((d, tuple(m)) for d, m in groups.items())


class PartsMesh:
    """k shard devices in shard order; repeats allowed.  ``groups`` are
    the card groups (``card_groups``); a device holds at most
    MAX_CARD_SHARDS shards."""

    __slots__ = ("devices", "groups")

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
        self.groups = card_groups(devs)
        for d, members in self.groups:
            if len(members) > MAX_CARD_SHARDS:
                raise ValueError(f"{len(members)} shards on {d}: a device "
                                 f"takes at most {MAX_CARD_SHARDS}")

    @property
    def k(self) -> int:
        return len(self.devices)

    def __eq__(self, other) -> bool:
        return isinstance(other, PartsMesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return f"PartsMesh({[str(d) for d in self.devices]})"

    def slabs(self, shape: Tuple[int, ...], dtype: torch.dtype,
              zero: bool = False) -> List[torch.Tensor]:
        """One ``[members, *shape]`` slab a card group (zeroed: one
        memset a group)."""
        make = torch.zeros if zero else torch.empty
        return [make((len(m), *shape), dtype=dtype, device=d)
                for d, m in self.groups]

    def rows(self, slabs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each shard's row of the group slabs, in shard order."""
        out = [None] * self.k
        for (_d, members), slab in zip(self.groups, slabs):
            for i, s in enumerate(members):
                out[s] = slab[i]
        return out

    def split(self, t: torch.Tensor) -> List[torch.Tensor]:
        """A [k, ...] tensor's rows as the group slabs, each a copy on
        its group's device."""
        return [t[list(members)].to(d) for d, members in self.groups]

    def stacked(self, slabs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The group slabs' rows as one [k, ...] tensor in shard order,
        on the first group's device (one group: its slab)."""
        if len(slabs) == 1:
            return slabs[0]
        dev = slabs[0].device
        return torch.stack([r.to(dev) for r in self.rows(slabs)])

    def replicas(self, t: torch.Tensor) -> List[torch.Tensor]:
        """``t`` copied into every row of a fresh slab a card group (a
        replicated input): one copy launch a group, moving the bytes as
        the widest words that divide them (a broadcast copy of single
        bytes runs several times slower on the card)."""
        out = self.slabs(tuple(t.shape), t.dtype)
        nbytes = t.numel() * t.element_size()
        word = next(w for w in (torch.int64, torch.int32, torch.int16,
                                torch.uint8)
                    if nbytes % w.itemsize == 0)
        src = t.contiguous().reshape(1, -1).view(torch.uint8).view(word)
        for slab in out:
            slab.view(slab.shape[0], -1).view(torch.uint8).view(word) \
                .copy_(src.expand(slab.shape[0], -1))
        return out


def replicate_rows(bufs: Sequence[torch.Tensor],
                   blocks: Sequence[Sequence[Tuple[int, int]]], near,
                   groups) -> int:
    """Every shard receives every other shard's owned rows: shard s owns
    the row ranges ``blocks[s]`` (half-open, along dim 0) of its buffer
    ``bufs[s]``, and each of them goes into the same rows of every
    other shard's buffer.  The members of one card group take them from
    each other through one ``near(members)`` a group that has two or
    more members (``ell_ops.mesh_hop``'s copy stage: one launch for
    every source on the card); a receiver on another card takes them by
    ``copy_`` per range (a peer copy; no such machine has been
    measured).  Returns the bytes copied."""
    card = {s: g for g, (_d, members) in enumerate(groups) for s in members}
    for _d, members in groups:
        if len(members) > 1 and any(hi > lo for s in members
                                    for lo, hi in blocks[s]):
            near(members)
    moved = 0
    for t, rows in enumerate(blocks):
        rows = [(lo, hi) for lo, hi in rows if hi > lo]
        src = bufs[t]
        for s, dst in enumerate(bufs):
            if s != t and card[s] != card[t]:
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


def all_to_all(send: Sequence[torch.Tensor], recv: Sequence[torch.Tensor],
               groups) -> Tuple[int, int]:
    """The cross-card part of ``jax.lax.all_to_all(x, axis, 0, 0,
    tiled=False)``: shard s's buffer ``send[s]`` holds one block per
    destination along dim 0, and block d lands in shard d's buffer
    ``recv[d]`` at block s — one ``copy_`` for each (source,
    destination) pair on different cards of ``groups``.  Between the
    members of one card the router (``ell_ops.mesh_route``) wrote each
    block straight into ``recv[d][s]``, so nothing moves here.  Returns
    (the copies made, the bytes they copied)."""
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
    card = {s: g for g, (_d, members) in enumerate(groups) for s in members}
    copies = moved = 0
    for s in range(k):
        for d in range(k):
            if card[s] != card[d]:
                blk = send[s][d]
                recv[d][s].copy_(blk)
                copies += 1
                moved += blk.numel() * blk.element_size()
    return copies, moved
