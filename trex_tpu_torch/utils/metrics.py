"""Structured metrics: JSON-lines step logging (counterpart of
``trex_tpu/utils/metrics.py``), to stderr and/or a file."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Any


class MetricsLogger:
    """Append JSON lines of step metrics; values with ``.item()`` (tensors,
    numpy scalars) are written as floats."""

    def __init__(self, path: str | None = None, echo: bool = True) -> None:
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._file: IO[str] | None = open(path, "a") if path else None
        self._echo = echo
        self._t0 = time.time()

    def log(self, step: int, **metrics: Any) -> None:
        record = {"step": step, "t": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            record[k] = float(v) if hasattr(v, "item") else v
        line = json.dumps(record)
        if self._echo:
            print(line, file=sys.stderr)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
