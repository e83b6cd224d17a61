"""ChaLearn IsoGD label I/O (the port's own copy of the JAX package's
``utils/labels.py``).

``1_Sample/<set>.txt`` holds lines ``"M K L"``: the RGB video's relative
path, the depth video's relative path and the class label (1..249), as
the reference's utils/chalearn.py:7-35 reads them.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

LabelEntry = Tuple[str, str, int]
SETS = ("train", "test", "valid")


def parse_label_lines(lines: List[str]) -> List[LabelEntry]:
    labels = [line.split(" ") for line in lines if line.strip()]
    return [(m, k, int(l)) for (m, k, l) in labels]


def _label_file(cfg, name_of_set: str) -> Path:
    if name_of_set not in SETS:
        raise ValueError(f"name_of_set must be one of {SETS}, got {name_of_set!r}")
    return Path(cfg.CHALEARN.ROOT, cfg.CHALEARN.SAMPLE, name_of_set + ".txt")


def get_labels(cfg, name_of_set: str) -> List[LabelEntry]:
    """Label list of one split, ``name_of_set`` in {'train', 'test', 'valid'}."""
    with _label_file(cfg, name_of_set).open("r") as f:
        return parse_label_lines(f.readlines())


def write_labels(cfg, name_of_set: str, labels: List[LabelEntry]) -> Path:
    txt = _label_file(cfg, name_of_set)
    txt.parent.mkdir(parents=True, exist_ok=True)
    with txt.open("w") as f:
        f.writelines(f"{m} {k} {l}\n" for (m, k, l) in labels)
    return txt


class Labels:
    """A label reader bound to a config (the reference's utils/chalearn.py:19-35)."""

    def __init__(self, cfg) -> None:
        self.cfg = cfg
        self.sample_root = Path(cfg.CHALEARN.ROOT, cfg.CHALEARN.SAMPLE)

    def from_set(self, name_of_set: str) -> List[LabelEntry]:
        return get_labels(self.cfg, name_of_set)
