"""Config dict with default-value tracking (counterpart of
waiwera_tpu/utils/config.py).

Counterpart of the fson_mpi getters (fson_mpi.F90:18-56): every typed
read takes a default, and when the default is used the read is logged
— so a run's YAML log records exactly which inputs were assumed rather
than specified. Here the same behaviour is retrofitted transparently:
TrackedConfig wraps the parsed JSON, records every .get() that fell
back to its default, and the CLI/Timestepper flush the records as
`[info, input, default, {path, value}]` log lines.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple


class DefaultSink:
    """Collects (json.path, default value) records; duplicates (same
    path) are logged once."""

    def __init__(self):
        self.records: List[Tuple[str, Any]] = []
        self._seen = set()

    def add(self, path: str, value):
        if path in self._seen:
            return
        self._seen.add(path)
        self.records.append((path, value))

    def log_to(self, logger):
        for path, value in self.records:
            logger.write(
                "info", "input", "default",
                path=path, value=_render(value),
            )


def _render(v):
    if v is None:
        return "null"
    if isinstance(v, (dict, list)) and not v:
        return "{}" if isinstance(v, dict) else "[]"
    return v


class TrackedConfig(dict):
    """dict that records default-using .get() calls.

    Nested dicts/lists returned from reads are wrapped with the
    extended JSON path so deep reads track too. Call sites keep using
    plain dict idioms (`cfg.get("output", {})`), matching the
    reference's fson_get_mpi(default) pattern without touching them.
    """

    def __init__(self, data: dict, path: str = "", sink: Optional[DefaultSink] = None):
        super().__init__(data)
        self._path = path
        self._sink = sink if sink is not None else DefaultSink()

    @property
    def defaults(self) -> DefaultSink:
        return self._sink

    def _wrap(self, key, value):
        path = f"{self._path}.{key}" if self._path else str(key)
        if isinstance(value, TrackedConfig):
            return value
        if isinstance(value, dict):
            return TrackedConfig(value, path, self._sink)
        if isinstance(value, list):
            return [
                TrackedConfig(v, f"{path}[{i}]", self._sink)
                if isinstance(v, dict)
                else v
                for i, v in enumerate(value)
            ]
        return value

    def __getitem__(self, key):
        return self._wrap(key, super().__getitem__(key))

    def get(self, key, default=None):
        if key in self:
            v = super().__getitem__(key)
            # JSON null counts as absent (the reference's getters fall
            # back to the default for missing *or* null)
            if v is None and default is not None:
                self._note(key, default)
                return self._wrap(key, default)
            return self._wrap(key, v)
        self._note(key, default)
        return self._wrap(key, default)

    def _note(self, key, default):
        path = f"{self._path}.{key}" if self._path else str(key)
        self._sink.add(path, default)
