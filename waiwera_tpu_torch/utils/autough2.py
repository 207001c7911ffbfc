"""AUTOUGH2 / TOUGH2 listing-file reader (counterpart of
waiwera_tpu/utils/autough2.py).

A minimal parser for the benchmark reference results of the reference
repository (test/benchmark/*/run/*.listing): the ELEMENT TABLE (or
GENERATION TABLE) time series, the role CREDO's T2ModelResult plays in
the reference's benchmark harness.
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np

_TIME_RE = re.compile(
    r"OUTPUT AFTER\s+\d+\s+TIME STEPS\s+([0-9.eE+\-]+)\s+SECONDS"
)


def _header_names(header: str, col_spans):
    """Assign header tokens to fixed-width data columns by character
    position (multi-word names like 'Gas saturatio' are single-spaced
    in NCG listings, so splitting on runs of spaces is not enough)."""
    tokens = [
        (m.group(0), 0.5 * (m.start() + m.end()))
        for m in re.finditer(r"\S+", header)
    ]
    # drop the leading ELEMEN[T] / SOURCE / INDEX labels
    while tokens and tokens[0][0].upper() in (
        "ELEMEN", "ELEMENT", "SOURCE", "INDEX"
    ):
        tokens.pop(0)
    centers = [0.5 * (s + e) for s, e in col_spans]
    names = [[] for _ in col_spans]
    for word, c in tokens:
        k = min(range(len(centers)), key=lambda i: abs(centers[i] - c))
        names[k].append(word)
    return [" ".join(ws) for ws in names]


def _row_values(row: str):
    """(values, spans) of the real-valued tokens at the right of a data
    row: the INDEX integer and the digits of an element name have no
    '.' and stop the scan (element names may contain spaces)."""
    vals = []
    spans = []
    for m in reversed(list(re.finditer(r"\S+", row))):
        tok = m.group(0)
        if "." not in tok:
            break
        try:
            # Fortran drops the 'E' of 3-digit exponents (8.22033-106)
            v = float(re.sub(r"(\d)([+-]\d{3})$", r"\1E\2", tok))
        except ValueError:
            break
        vals.append(v)
        spans.append((m.start(), m.end()))
    return vals[::-1], spans[::-1]


def read_listing(filename: str, table: str = "element"):
    """Parse a listing file.

    Returns (times [nt], tables: {column_name: [nt, n_elements]}), the
    column names as in the file header (e.g. 'Pressure', 'Temperature',
    'Vapour saturation'). table='generation' parses the per-source
    GENERATION TABLE blocks instead (columns like 'Generation rate',
    'Enthalpy')."""
    marker = "GENERATION TABLE" if table == "generation" else "ELEMENT TABLE"
    with open(filename, errors="replace") as f:
        lines = f.readlines()

    times: List[float] = []
    data: Dict[str, List[List[float]]] = {}
    i = 0
    n = len(lines)
    while i < n:
        if marker not in lines[i]:
            i += 1
            continue
        # the time, from the OUTPUT AFTER line just before the table
        t = None
        for j in range(i, max(0, i - 10), -1):
            m = _TIME_RE.search(lines[j])
            if m:
                t = float(m.group(1))
                break
        # header: the next non-blank line
        j = i + 1
        while j < n and not lines[j].strip():
            j += 1
        header = lines[j]
        if not header.strip().upper().startswith("ELEMEN"):
            raise ValueError(f"{filename}:{j + 1}: no ELEMENT header after "
                             f"{marker}")
        if table == "generation" and "SOURCE" not in header.upper():
            i = j
            continue
        j += 1
        rows = []
        col_spans = []
        while j < n:
            s = lines[j].strip()
            if not s:
                j += 1
                continue
            if s.startswith("EEEE") or s.startswith("@") or "TABLE" in s:
                break
            vals, spans = _row_values(lines[j])
            if vals:
                rows.append(vals)
                if len(spans) > len(col_spans):
                    col_spans = spans
            j += 1
        if rows and t is not None:
            ncol = len(col_spans)
            times.append(t)
            for k, name in enumerate(_header_names(header, col_spans)):
                data.setdefault(name, []).append(
                    [r[k] for r in rows if len(r) == ncol]
                )
        i = j

    tables = {k: np.asarray(v, dtype=np.float64) for k, v in data.items()}
    return np.asarray(times), tables
