"""Profiler spans at the port's layer boundaries.

A span is a torch.profiler record_function range: a name, a start and an
end on the profiler's clock, the one its CUDA activity records use, and
as parent the span that encloses it on the host thread. Spans are
entered only while a profiler is active: with none, a span site costs
one check of the profiler's flag. The profiler's trace is where they go
(torch.profiler's exports, the CLI's --profile); nothing here keeps or
writes them.

The spans, by layer (PERF.md §3):

- ``timestepper.try`` (one try: the step function, the tracer solve and
  the residual report; its args name the step, the try and dt) and
  ``timestepper.output`` (one output record): sim/timestepper.py;
- ``newton.solve``: the host's Newton loop, solver/newton.py;
- ``program.launch:<piece>`` (a piece's graph replay or eager call),
  ``program.read:<piece>`` (the host read of the flags of the piece
  launched last), ``program.stage`` and ``program.hand_out`` (a graph
  program's copies in and out of a try) and ``program.capture:<piece>``
  (a piece's capture, warm-up included): solver/program.py.

No span sits inside a piece's body: the body runs at capture only, and a
replayed graph would not record it.
"""

from __future__ import annotations

import contextlib

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def profiling() -> bool:
    """Whether a profiler is recording on this thread."""
    return _profiler_enabled()


def span(name: str, args=None):
    """The span `name` while a profiler is active, otherwise a context
    that does nothing. args: None, or a callable of no arguments giving
    the span's argument string, called only when the span is recorded."""
    if not _profiler_enabled():
        return _OFF
    return record_function(name, None if args is None else args())
