"""Stage-folder path algebra.

The on-disk dataflow is a chain of stage folders sharing the layout
``<ROOT>/<stage>/<set>/<class>/<video>/...``. ``ChaPath`` swaps the split, the stage
folder, or prepends a filename prefix without string surgery at call sites.
Reimplements the v2 helper `new_feature_test.py:24-53` of the reference.
A copy of the JAX package's ``utils/chapath.py``: the port imports nothing
from it.
"""

from __future__ import annotations

from pathlib import Path


class ChaPath:
    def __init__(self, path: Path | str) -> None:
        self.path = Path(path)

    def change_split(self, new_split: str) -> "ChaPath":
        """.../<stage>/<split>/xxx/file -> swap <split> (4th-from-last part)."""
        parts = list(self.path.parts)
        parts[-3] = new_split
        return ChaPath(Path(*parts))

    def change_base(self, new_base: str) -> "ChaPath":
        """.../<stage>/<split>/xxx/file -> swap <stage> folder."""
        parts = list(self.path.parts)
        parts[-4] = new_base
        return ChaPath(Path(*parts))

    def prepend(self, prefix: str) -> "ChaPath":
        """Prefix the file name: U_00001.jpg, F0_00001.jpg, ..."""
        return ChaPath(self.path.parent / (prefix + self.path.name))

    def __fspath__(self) -> str:
        return str(self.path)

    def __str__(self) -> str:
        return str(self.path)

    def __eq__(self, other) -> bool:
        return Path(self.path) == Path(getattr(other, "path", other))

    def __hash__(self) -> int:
        return hash(self.path)
