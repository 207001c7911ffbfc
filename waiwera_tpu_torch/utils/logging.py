"""Structured YAML logging (counterpart of waiwera_tpu/utils/logging.py).

Counterpart of logfile.F90: each message is one flow-style YAML list
line `[level, source, event, {key: value, ...}]`, optionally echoed to
stdout and/or written to a .yaml log file. Input-default logging (the
fson_mpi getter behaviour) uses the same channel.
"""

from __future__ import annotations

import sys
from typing import Optional

LEVELS = {"debug": 0, "info": 1, "warn": 2, "err": 3}


def _fmt(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return f"{v:.6g}"
    if isinstance(v, str):
        return v
    return str(v)


class Logger:
    def __init__(
        self,
        filename: Optional[str] = None,
        echo: bool = False,
        level: str = "info",
    ):
        self.filename = filename
        self.echo = echo
        self.level = LEVELS.get(level, 1)
        self._fh = open(filename, "w") if filename else None

    def write(self, level: str, source: str, event: str, **data):
        if LEVELS.get(level, 1) < self.level:
            return
        parts = ", ".join(f"{k}: {_fmt(v)}" for k, v in data.items())
        line = f"- [{level}, {source}, {event}, {{{parts}}}]"
        if self._fh:
            self._fh.write(line + "\n")
        if self.echo:
            print(line, file=sys.stdout)

    def flush(self):
        if self._fh:
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
