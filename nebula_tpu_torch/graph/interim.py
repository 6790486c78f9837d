"""Result columns — the subset of ``nebula_tpu/graph/interim.py:20-74``
(``ConstCol``, ``DictCol``, ``_col_tolist``) that YIELD materialization
builds, and ``default_col_name`` (``graph/executors/traverse.py:81``),
the column name of a YIELD without an alias."""
from __future__ import annotations

from typing import List

Value = object


class ConstCol:
    """A column whose every row holds the same value (string literals
    in a YIELD) — O(1) storage and wire bytes regardless of row count."""

    __slots__ = ("val", "n")

    def __init__(self, val: Value, n: int):
        self.val = val
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, s):
        if isinstance(s, slice):
            lo, hi, _ = s.indices(self.n)
            return ConstCol(self.val, max(hi - lo, 0))
        return self.val

    def tolist(self) -> List[Value]:
        return [self.val] * self.n


class DictCol:
    """Dictionary-encoded string column: int codes + a small value
    dictionary (the mirror's string columns are stored exactly this
    way, tpu/csr.py) — rows materialize only at the edge."""

    __slots__ = ("codes", "dictionary")

    def __init__(self, codes, dictionary):
        self.codes = codes            # numpy int array
        self.dictionary = dictionary  # list[str], code -> value

    def __len__(self) -> int:
        return len(self.codes)

    def __getitem__(self, s):
        if isinstance(s, slice):
            return DictCol(self.codes[s], self.dictionary)
        return self.dictionary[int(self.codes[s])]

    def tolist(self) -> List[Value]:
        d = self.dictionary
        return [d[c] for c in self.codes.tolist()]


def _col_tolist(c) -> List[Value]:
    """One column -> plain python list (numpy arrays, ConstCol, DictCol
    and plain lists all answer .tolist() or are lists already)."""
    if isinstance(c, list):
        return c
    return c.tolist()


def default_col_name(expr) -> str:
    """The column name of an un-aliased YIELD expression."""
    return str(expr)
