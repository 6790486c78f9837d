"""Result columns — the subset of ``nebula_tpu/graph/interim.py:20-169``
(``ConstCol``, ``DictCol``, ``_col_tolist``, ``ColumnarRows``) that YIELD
materialization builds, and ``default_col_name``
(``graph/executors/traverse.py:81``), the column name of a YIELD without
an alias."""
from __future__ import annotations

from typing import List, Optional

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


class ColumnarRows:
    """Lazy list-of-rows facade over per-column value containers
    (numpy arrays, ConstCol / DictCol, plain lists): what a signature
    group's vectorized YIELD returns per query.  The columns stay flat
    until someone reads rows, so a group's assembly builds no per-row
    Python lists; reading (iteration, indexing, slicing, ``+``, ``==``)
    materializes the rows once and drops the columns."""

    __slots__ = ("_cols", "_n", "_rows")

    def __init__(self, cols: List[object], n: int):
        self._cols = cols
        self._n = n
        self._rows: Optional[List[List[Value]]] = None

    def _mat(self) -> List[List[Value]]:
        if self._rows is None:
            cols = [_col_tolist(c) for c in self._cols]
            if len(cols) == 1:
                self._rows = [[v] for v in cols[0]]
            else:
                self._rows = [list(t) for t in zip(*cols)]
            self._cols = None       # columns die once rows exist
        return self._rows

    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0

    def __iter__(self):
        return iter(self._mat())

    def __getitem__(self, i):
        return self._mat()[i]

    def __add__(self, other):
        return self._mat() + list(other)

    def __radd__(self, other):
        return list(other) + self._mat()

    def __eq__(self, other):
        if isinstance(other, ColumnarRows):
            other = other._mat()
        return self._mat() == other

    def __repr__(self) -> str:
        return f"ColumnarRows({self._n} rows)"


def default_col_name(expr) -> str:
    """The column name of an un-aliased YIELD expression."""
    return str(expr)
