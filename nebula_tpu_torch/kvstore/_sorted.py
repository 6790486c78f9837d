"""The sorted key table under ``MemEngine`` — the port's own stand-in
for the ``sortedcontainers.SortedDict`` the reference's engine uses
(``nebula_tpu/kvstore/_sorted.py``), so the port needs no package
beyond torch and numpy.

A dict holds the values; the key order lives in two sorted lists: a
large ``base`` and a small ``recent`` that takes single inserts.  When
``recent`` outgrows about 4 * sqrt(len(base)) keys (at least 1024),
the two merge into a new ``base``.  A deleted key stays in its list,
marked dead, until the next merge drops it; a dead key written again
is live in the same list place.  Neither list is ever changed in
place (a merge and an insert each build a new list), so a scan walks
the lists it started on while writers go on.

Costs: a single insert copies ``recent`` (O(sqrt n)); a merge is one
sort of two sorted runs (linear in practice); a bulk ``update`` of
many new keys merges at once; a scan of k keys is O(log n + k).
"""
from __future__ import annotations

import bisect
import heapq
import math
from typing import Iterable, Iterator, List, Optional, Tuple


def _walk(keys: List[bytes], lo: int, hi: Optional[bytes],
          hi_inclusive: bool) -> Iterator[bytes]:
    """``keys[lo:]`` up to ``hi``, lazily, with no slice copy."""
    for i in range(lo, len(keys)):
        k = keys[i]
        if hi is not None and (k > hi or (k == hi and not hi_inclusive)):
            return
        yield k


class SortedDict(dict):
    """A dict whose live keys ``irange`` walks in sorted order."""

    def __init__(self):
        super().__init__()
        self._base: List[bytes] = []
        self._recent: List[bytes] = []
        self._dead: set = set()

    # ---------------------------------------------------- mutation
    def _recent_cap(self) -> int:
        return max(1024, 4 * int(math.isqrt(len(self._base))))

    def _merge(self, extra: Iterable[bytes] = ()) -> None:
        keys = sorted([*self._base, *self._recent, *extra])
        if self._dead:
            keys = [k for k in keys if dict.__contains__(self, k)]
            self._dead = set()
        self._base, self._recent = keys, []

    def _note_new(self, key: bytes) -> bool:
        """Place a key that is not live; True when it needs a list slot
        (a dead key revives where it lies)."""
        if key in self._dead:
            self._dead.discard(key)
            return False
        return True

    def __setitem__(self, key: bytes, value: bytes) -> None:
        slot = not dict.__contains__(self, key) and self._note_new(key)
        dict.__setitem__(self, key, value)
        if slot:
            recent = list(self._recent)
            bisect.insort(recent, key)
            self._recent = recent
            if len(recent) > self._recent_cap():
                self._merge()

    def update(self, kvs: Iterable[Tuple[bytes, bytes]]) -> None:
        kvs = list(kvs)
        new = [k for k in dict.fromkeys(k for k, _v in kvs)
               if not dict.__contains__(self, k) and self._note_new(k)]
        for k, v in kvs:
            dict.__setitem__(self, k, v)
        if len(new) + len(self._recent) > self._recent_cap():
            self._merge(new)
        elif new:
            recent = list(self._recent)
            for k in new:
                bisect.insort(recent, k)
            self._recent = recent

    def pop(self, key: bytes, *default):
        if dict.__contains__(self, key):
            self._dead.add(key)
        return dict.pop(self, key, *default)

    def __delitem__(self, key: bytes) -> None:
        dict.__delitem__(self, key)
        self._dead.add(key)

    # ---------------------------------------------------- ordered reads
    def irange(self, minimum: Optional[bytes] = None,
               maximum: Optional[bytes] = None,
               inclusive: Tuple[bool, bool] = (True, True)
               ) -> Iterator[bytes]:
        """Live keys in [minimum, maximum] in order, each bound inclusive
        as ``inclusive`` says (``None``: unbounded)."""
        runs = []
        for keys in (self._base, self._recent):
            if minimum is None:
                lo = 0
            elif inclusive[0]:
                lo = bisect.bisect_left(keys, minimum)
            else:
                lo = bisect.bisect_right(keys, minimum)
            runs.append(_walk(keys, lo, maximum, inclusive[1]))
        for k in heapq.merge(*runs):
            if dict.__contains__(self, k):
                yield k
