"""Process-wide flag registry — a copy of ``nebula_tpu/common/flags.py``.

Only define/get/set/info and the flags this slice reads are carried,
with the reference's names and defaults, so a flag set on one package
means the same on the other.  The reference's config-mode metadata
(metad's mutable/immutable registration), watchers and conf-file
loading are not: nothing in the port uses them yet.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional


class FlagInfo:
    __slots__ = ("name", "default", "value", "help")

    def __init__(self, name: str, default: Any, help_: str):
        self.name = name
        self.default = default
        self.value = default
        self.help = help_


class FlagsRegistry:
    def __init__(self):
        self._flags: Dict[str, FlagInfo] = {}
        self._lock = threading.Lock()

    def define(self, name: str, default: Any, help_: str = "") -> None:
        with self._lock:
            if name not in self._flags:
                self._flags[name] = FlagInfo(name, default, help_)

    def get(self, name: str, default: Any = None) -> Any:
        # lock-free read: one attribute load cannot tear
        f = self._flags.get(name)
        return f.value if f is not None else default

    def set(self, name: str, value: Any) -> bool:
        with self._lock:
            f = self._flags.get(name)
            if f is None:
                return False
            # coerce to the default's type when possible
            if f.default is not None \
                    and not isinstance(value, type(f.default)):
                try:
                    if isinstance(f.default, bool):
                        value = str(value).lower() in ("1", "true", "yes")
                    else:
                        value = type(f.default)(value)
                except (TypeError, ValueError):
                    return False
            f.value = value
        return True

    def info(self, name: str) -> Optional[FlagInfo]:
        return self._flags.get(name)


flags = FlagsRegistry()

# the slice's flags (nebula_tpu/tpu/runtime.py:230, :269, :275)
flags.define(
    "go_batch_widths", "128,1024",
    "pinned lane widths (comma list, ascending): a continuous session "
    "anchors on the smallest rung covering its arrival backlog")
flags.define(
    "tpu_ell_cap", 512,
    "ELL slot-table width cap (ell.EllIndex.build): vertices above it "
    "spill into hub extra rows")
flags.define(
    "tpu_ell_growth_slack", 8,
    "spare all-sentinel rows provisioned per ELL build in the widest "
    "bucket (ell.EllIndex.build growth_slack); unclaimed spares merge "
    "nowhere")
