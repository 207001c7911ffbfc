"""Capture and replay of a timestep try: the port's counterpart of the
JAX package's jax.jit around the try (waiwera_tpu/sim/simulation.py) and
its lax.while_loops of Newton and BiCGStab (solver/newton.py,
solver/krylov.py).

A try is cut into pieces, each a pure function of tensors that reads
nothing on the host: the Newton start (coefficients, residual, flags),
the Jacobian with the operator and the preconditioner, the Krylov start
with its first chunk, the further Krylov chunks and rounds, and the
Newton update. The host runs the loops between them and reads their
flags once per piece.
A Program runs each piece

- eagerly (the CPU, and every configuration a graph does not cover),
- or, on a CUDA device, as a CUDA graph captured at the piece's first
  call and replayed at every later one.

Graph mode rules, each checked where it can be:

- Every tensor a piece takes is the program's own: a staged input
  (Program.stage copies a try's inputs into buffers kept across tries)
  or an output of an earlier piece. A tensor argument of another
  address raises. A piece's other arguments (numbers, strings, None,
  functions) are constants of its graph and must repeat at every call:
  a Python number that changed (a try's dt, say) would otherwise be
  replayed at its first value.
- A loop piece (Program.loop) returns a new state, which its graph
  copies into the state it was given, so that the next replay reads it.
- The pieces of a program share one memory pool. Values that outlive a
  try leave it through Program.hand_out, which copies them out of the
  pool: the next try's replays overwrite the pool.
- Kernel launch counts (ops.dia.LaunchCount) count Python calls of the
  wrappers, which happen at capture, not at replay. A capture's launches
  are taken out of the counts and its graph's launches are added at
  every replay. The warm-up run before a capture (on a side stream, for
  the lazy initialisations a capture may not make) is taken out too.
- A failed capture or replay raises, naming the piece. Nothing falls back
  to eager execution.

Under a profiler a Program records the spans program.launch:<piece>
(each replay or eager call of a piece), program.read:<piece> (the host
read of the flags of the piece launched last), program.stage,
program.hand_out and program.capture:<piece> (utils/spans.py).
"""

from __future__ import annotations

import gc
import time
from typing import Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

from waiwera_tpu_torch.ops.dia import LaunchCount
from waiwera_tpu_torch.utils.spans import profiling, span


def _is_tensor(a) -> bool:
    return isinstance(a, torch.Tensor)


def _same_constant(a, b) -> bool:
    if a is b:
        return True
    try:
        return bool(a == b) and type(a) is type(b)
    except Exception:  # noqa: BLE001 (objects without a plain ==)
        return False


def distinct(tree):
    """`tree` with every tensor leaf that shares storage with an earlier
    leaf copied: the state a loop piece writes back into must not alias
    itself (r, r0 and p of a BiCGStab round start are one tensor)."""
    seen = set()

    def own(a):
        if not _is_tensor(a):
            return a
        if a.data_ptr() in seen:
            return a.clone()
        seen.add(a.data_ptr())
        return a

    return pytree.tree_map(own, tree)


class _Spans(NamedTuple):
    """The span names of one piece."""

    launch: str
    read: str
    capture: str


class _Piece(NamedTuple):
    graph: object
    spec: object
    leaves: list  # the arguments' leaves at capture
    out: object
    launches: list  # per-replay launches, one per LaunchCount.all entry


class CudaGraphs:
    """Captures and replays pieces as torch.cuda.CUDAGraphs sharing one
    memory pool."""

    def __init__(self, device, pool=None):
        self.device = torch.device(device)
        self.pool = pool

    def warm(self, fn: Callable[[], object]):
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            fn()
        stream.wait_stream(side)

    def capture(self, fn: Callable[[], object], mutated):
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        # no cyclic garbage collection inside a capture: an earlier
        # System's graphs (held in a reference cycle through its pieces'
        # closures) freed there would make a CUDA call the capture
        # forbids. torch.cuda.graph collects before it begins.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(self.device), \
                    torch.cuda.graph(graph, pool=self.pool):
                out = fn()
        finally:
            if collecting:
                gc.enable()
        return graph, out

    def replay(self, graph):
        graph.replay()


class Program:
    """Runs the pieces of a try eagerly (graphs=None) or through a graph
    backend (CudaGraphs, or a stand-in with the same three methods)."""

    def __init__(self, graphs=None):
        self.graphs = graphs
        self.mode = "eager" if graphs is None else "graph"
        self._pieces: dict = {}
        self._stages: dict = {}
        self._owned: set = set()
        self.captures = 0
        self.capture_seconds = 0.0
        self.replays = 0
        self.host_syncs = 0
        self._spans: dict = {}
        self._last = ""  # the piece launched last, whose flags read reads

    def _span_names(self, name: str) -> _Spans:
        names = self._spans.get(name)
        if names is None:
            names = self._spans[name] = _Spans(
                f"program.launch:{name}", f"program.read:{name}",
                f"program.capture:{name}")
        return names

    # -- the host side --------------------------------------------------

    def read(self, flags: torch.Tensor) -> list:
        """A piece's flags as Python numbers: one host sync."""
        self.host_syncs += 1
        if not profiling():
            return flags.tolist()
        with span(self._span_names(self._last).read):
            return flags.tolist()

    def stage(self, name: str, tree):
        """A try's inputs: eagerly the inputs themselves; in graph mode
        their copies in buffers that this program keeps across tries (the
        same buffers at every call of `name`)."""
        if self.graphs is None:
            return tree
        with span("program.stage"):
            return self._stage(name, tree)

    def _stage(self, name: str, tree):
        leaves, spec = pytree.tree_flatten(tree)
        kept = self._stages.get(name)
        if kept is None:
            bufs = [torch.empty(a.shape, dtype=a.dtype, device=a.device)
                    if _is_tensor(a) else a for a in leaves]
            self._own(bufs)
            kept = self._stages[name] = (spec, bufs)
        spec0, bufs = kept
        if spec != spec0:
            raise ValueError(f"graph program: stage {name!r} changed "
                             "structure between tries")
        for i, (buf, a) in enumerate(zip(bufs, leaves)):
            if _is_tensor(buf) != _is_tensor(a) or (
                    _is_tensor(a) and (a.shape != buf.shape
                                       or a.dtype != buf.dtype)):
                raise ValueError(f"graph program: stage {name!r} input "
                                 f"{i} changed type, shape or dtype")
            if _is_tensor(a):
                buf.copy_(a)
            elif not _same_constant(a, buf):
                raise ValueError(f"graph program: stage {name!r} input {i} "
                                 f"is the constant {a!r}, captured as "
                                 f"{buf!r}")
        return pytree.tree_unflatten(bufs, spec)

    def hand_out(self, tree):
        """Values that leave a try: copies out of the graph pool in graph
        mode (the next try's replays overwrite the pool)."""
        if self.graphs is None:
            return tree
        with span("program.hand_out"):
            return pytree.tree_map(
                lambda a: a.clone() if _is_tensor(a) else a, tree)

    # -- pieces ---------------------------------------------------------

    def _launch(self, name, fn, *args):
        """fn(*args), the launch of the piece `name` (a replay, or the
        eager piece itself)."""
        self._last = name
        if not profiling():
            return fn(*args)
        with span(self._span_names(name).launch):
            return fn(*args)

    def run(self, name: str, fn: Callable, *args):
        """fn(*args) as the piece `name` (fn is used at the piece's
        capture only)."""
        if self.graphs is None:
            return self._launch(name, fn, *args)
        return self._call(name, lambda: fn(*args), lambda: fn(*args), args,
                          None)

    def loop(self, name: str, fn: Callable, state, *args):
        """(state, out) = fn(state, *args) as the piece `name`; in graph
        mode the new state is copied into `state`, which is returned."""
        if self.graphs is None:
            return self._launch(name, fn, state, *args)

        def body():
            new, out = fn(state, *args)
            for s, n in zip(pytree.tree_leaves(state),
                            pytree.tree_leaves(new)):
                if _is_tensor(s) and n is not s:
                    s.copy_(n)
            return state, out

        return self._call(name, lambda: fn(state, *args), body,
                          (state,) + args, pytree.tree_leaves(state))

    def _own(self, leaves):
        for a in leaves:
            if _is_tensor(a):
                self._owned.add(a.data_ptr())

    def _call(self, name, warm, body, args, mutated):
        leaves, spec = pytree.tree_flatten(args)
        piece = self._pieces.get(name)
        if piece is None:
            piece = self._capture(name, warm, body, leaves, spec, mutated)
        else:
            self._check(name, piece, leaves, spec)
        try:
            self._launch(name, self.graphs.replay, piece.graph)
        except Exception as e:
            raise RuntimeError(f"graph program: replay of piece {name!r} "
                               f"failed: {e}") from e
        for count, n in zip(LaunchCount.all, piece.launches):
            count.count += n
        self.replays += 1
        return piece.out

    def _capture(self, name, warm, body, leaves, spec, mutated) -> _Piece:
        for i, a in enumerate(leaves):
            if _is_tensor(a) and a.data_ptr() not in self._owned:
                raise ValueError(
                    f"graph program: argument {i} of piece {name!r} is "
                    "neither a staged input nor a piece's output")
        t0 = time.perf_counter()
        counts = [c.count for c in LaunchCount.all]
        try:
            with span(self._span_names(name).capture):
                self.graphs.warm(warm)
                warmed = [c.count for c in LaunchCount.all]
                graph, out = self.graphs.capture(body, mutated)
        except Exception as e:
            raise RuntimeError(f"graph program: capture of piece {name!r} "
                               f"failed: {e}") from e
        launches = [c.count - w for c, w in zip(LaunchCount.all, warmed)]
        for c, n in zip(LaunchCount.all, counts):
            c.count = n
        self._own(pytree.tree_leaves(out))
        piece = _Piece(graph, spec, leaves, out, launches)
        self._pieces[name] = piece
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return piece

    @staticmethod
    def _check(name, piece, leaves, spec):
        if spec != piece.spec:
            raise ValueError(f"graph program: piece {name!r} called with "
                             "arguments of another structure")
        for i, (a, b) in enumerate(zip(leaves, piece.leaves)):
            if _is_tensor(a) or _is_tensor(b):
                if not (_is_tensor(a) and _is_tensor(b)
                        and a.data_ptr() == b.data_ptr()
                        and a.shape == b.shape and a.dtype == b.dtype):
                    raise ValueError(
                        f"graph program: tensor argument {i} of piece "
                        f"{name!r} is not the one it was captured with")
            elif not _same_constant(a, b):
                raise ValueError(
                    f"graph program: argument {i} of piece {name!r} is the "
                    f"constant {a!r}, captured as {b!r}")
