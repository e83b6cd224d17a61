"""Structured metrics logging (the port's own copy of the JAX package's
``utils/logging.py``): each event is printed readably and, with a path,
appended as one JSON line to ``<ROOT>/<MODEL.LOGS>/metrics/<model-name>.jsonl``.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, log_path: Optional[Path] = None, stream=None) -> None:
        self.log_path = Path(log_path) if log_path else None
        self.stream = stream if stream is not None else sys.stdout
        if self.log_path:
            self.log_path.parent.mkdir(parents=True, exist_ok=True)

    @classmethod
    def for_model(cls, cfg) -> "MetricsLogger":
        path = Path(cfg.CHALEARN.ROOT, cfg.MODEL.LOGS, "metrics", cfg.MODEL.NAME + ".jsonl")
        return cls(path)

    def log(self, event: str, **scalars: Any) -> Dict[str, Any]:
        record = {"ts": time.time(), "event": event, **scalars}
        pretty = " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in scalars.items())
        print(f"[{event}] {pretty}", file=self.stream)
        if self.log_path:
            with self.log_path.open("a") as f:
                f.write(json.dumps(record) + "\n")
        return record
