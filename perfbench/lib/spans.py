"""The port's spans (waiwera_tpu_torch/utils/spans.py) read from a
torch.profiler trace: the device time of each piece of the step program,
and the device's idle time split by the host layer the host was in.

Per piece. A device op (kernel, copy or set, the ops trace.summarise
counts) is tied to the host event that launched it, then to the
innermost ``program.launch:<piece>`` span that encloses that event on its
thread:

1. ``linked``: the op's linked correlation id names the innermost op or
   span on the host at its launch (for a graph replay, the launch span
   itself, as nothing else encloses cudaGraphLaunch);
2. ``runtime``: else its own correlation id names the runtime call that
   launched it (cudaLaunchKernel, cudaGraphLaunch, a copy);
3. ``time``: else the last launch span that began before it.

An op whose host event lies outside every launch span (a try's staged
copies, the output's) belongs to no piece. A piece's device seconds are
the union of its ops' intervals clipped to the window, its launches the
count of its launch spans that begin in the window.

Idle. Every nanosecond of trace.gaps over the same device intervals as
trace.summarise is charged to the host layer whose span covers it:
``read`` (a ``program.read:`` span), ``launch`` (a ``program.launch:``
span), ``host_loop`` (a ``timestepper.try`` span, in neither) or
``other``. The four parts sum to the window's idle time, the one that
device_idle_share reads.
"""

from __future__ import annotations

import numpy as np

from perfbench.lib import trace as trace_mod

LAUNCH = "program.launch:"
READ = "program.read:"
TRY = "timestepper.try"
RULES = ("linked", "runtime", "time")


def _merged(intervals) -> np.ndarray:
    """The union of [start, end) intervals as sorted disjoint ones."""
    a = np.asarray(intervals, dtype=np.int64).reshape(-1, 2)
    if len(a) == 0:
        return a
    a = a[np.argsort(a[:, 0], kind="stable")]
    reach = np.maximum.accumulate(a[:, 1])
    new = np.concatenate(([True], a[1:, 0] > reach[:-1]))
    first = np.nonzero(new)[0]
    last = np.concatenate((first[1:], [len(a)])) - 1
    return np.stack([a[first, 0], reach[last]], axis=1)


def _overlap_ns(gaps: np.ndarray, cover: np.ndarray) -> int:
    """Total length of gaps (sorted disjoint) inside the union of
    cover."""
    m = _merged(cover)
    if len(gaps) == 0 or len(m) == 0:
        return 0
    lengths = m[:, 1] - m[:, 0]
    before = np.concatenate(([0], np.cumsum(lengths)))

    def covered(t):  # length of the union before t
        i = np.searchsorted(m[:, 0], t, side="right") - 1
        inside = np.where(i >= 0, np.clip(t - m[np.maximum(i, 0), 0], 0,
                                          lengths[np.maximum(i, 0)]), 0)
        return np.where(i >= 0, before[np.maximum(i, 0)], 0) + inside

    return int((covered(gaps[:, 1]) - covered(gaps[:, 0])).sum())


def is_runtime(e) -> bool:
    """Whether a host event is a CUDA runtime or driver call (by its
    activity type where torch gives one, else by its name)."""
    kind = getattr(e, "activity_type", None)
    if kind is None:
        return e.name().startswith("cu")
    kind = kind()
    return "runtime" in kind or "driver" in kind


def _enclosing(spans, thread, t):
    """Index of the launch span of `spans` (by thread: sorted starts,
    ends, indices) that encloses time t on `thread`, or -1."""
    on = spans.get(thread)
    if on is None:
        return -1
    starts, ends, idx = on
    i = np.searchsorted(starts, t, side="right") - 1
    return int(idx[i]) if i >= 0 and ends[i] >= t else -1


def _longest(gaps, read, launch, r_iv, l_iv, t_iv, top):
    """[[layer, seconds]] of the `top` longest gaps, each named by the
    host layer over its midpoint: read:<piece>, launch:<piece>,
    host_loop or other."""
    out = []
    for a, b in sorted(gaps.tolist(), key=lambda g: g[0] - g[1])[:top]:
        mid = (a + b) // 2
        name = "other"
        for part, spans, ivs in (("read", read, r_iv),
                                 ("launch", launch, l_iv)):
            hit = np.nonzero((ivs[:, 0] <= mid) & (ivs[:, 1] >= mid))[0]
            if len(hit):
                name = f"{part}:{spans[hit[0]][2 if part == 'read' else 3]}"
                break
        else:
            if np.any((t_iv[:, 0] <= mid) & (t_iv[:, 1] >= mid)):
                name = "host_loop"
        out.append([name, (b - a) * 1e-9])
    return out


def split(kineto_events, device_type, window=None, top: int = 10) -> dict:
    """Device seconds and launches by piece, idle seconds by host layer
    (and, within read and launch, by piece) and the `top` longest idle
    gaps named by their host layer, over the window: (lo, hi) in ns,
    else trace.WINDOW_SPAN, else the trace's extent."""
    dev, launch, read, tries = [], [], [], []
    by_corr, by_runtime = {}, {}
    lo = hi = None
    first = last = None
    for e in kineto_events:
        s = e.start_ns()
        end = s + e.duration_ns()
        first = s if first is None else min(first, s)
        last = end if last is None else max(last, end)
        if e.device_type() == device_type:
            if e.is_user_annotation() or "Sync" in e.name():
                continue
            dev.append((s, end, e.linked_correlation_id(),
                        e.correlation_id()))
            continue
        name = e.name()
        thread = e.device_resource_id()
        if is_runtime(e):
            by_runtime[e.correlation_id()] = (s, thread)
            continue
        by_corr[e.correlation_id()] = (s, thread)
        if not e.is_user_annotation():
            continue
        if name == trace_mod.WINDOW_SPAN:
            lo, hi = s, end
        elif name.startswith(LAUNCH):
            launch.append((s, end, thread, name[len(LAUNCH):],
                           e.correlation_id()))
        elif name.startswith(READ):
            read.append((s, end, name[len(READ):]))
        elif name == TRY:
            tries.append((s, end))
    if window is not None:
        lo, hi = window
    elif lo is None:
        lo, hi = (first or 0), (last or 0)

    # the launch spans by thread, for the enclosing-span lookups
    launch.sort()
    piece_of = [x[3] for x in launch]
    launch_start = np.asarray([x[0] for x in launch], np.int64)
    spans_by_thread = {}
    for thread in {x[2] for x in launch}:
        idx = np.asarray([i for i, x in enumerate(launch) if x[2] == thread])
        spans_by_thread[thread] = (launch_start[idx],
                                   np.asarray([launch[i][1] for i in idx]),
                                   idx)
    span_of_corr = {x[4]: i for i, x in enumerate(launch)}

    # each device op's launch span: -1 for none
    owner = np.full(len(dev), -1, np.int64)
    rule_n = dict.fromkeys(RULES, 0)
    early = 0
    for k, (s, _, linked, corr) in enumerate(dev):
        host = by_corr.get(linked) if linked else None
        rule = "linked"
        if host is None:
            host = by_runtime.get(corr)
            rule = "runtime"
        if host is not None:
            i = span_of_corr.get(linked, -1) if rule == "linked" else -1
            if i < 0:
                i = _enclosing(spans_by_thread, host[1], host[0])
        else:
            rule = "time"
            i = int(np.searchsorted(launch_start, s, side="right")) - 1
        if i >= 0:
            owner[k] = i
            rule_n[rule] += 1
            early += int(s < launch[i][0])

    ds = np.clip(np.asarray([d[0] for d in dev], np.int64), lo, hi)
    de = np.clip(np.asarray([d[1] for d in dev], np.int64), lo, hi)
    live = de > ds
    iv = np.stack([ds[live], de[live]], axis=1)
    own = owner[live]

    pieces = {}
    for name in sorted(set(piece_of)):
        mine = np.asarray([p == name for p in piece_of], bool)
        ops = iv[mine[own] & (own >= 0)] if len(own) else iv[:0]
        n = int(np.sum(mine & (launch_start >= lo) & (launch_start < hi)))
        pieces[name] = {"device_s": trace_mod.union_seconds(ops),
                        "launches": n}

    gaps = np.asarray(trace_mod.gaps(iv, lo, hi), np.int64).reshape(-1, 2)
    clip = lambda spans: np.clip(np.asarray(  # noqa: E731
        [(s, e) for s, e, *_ in spans], np.int64).reshape(-1, 2), lo, hi)
    r_iv, l_iv, t_iv = clip(read), clip(launch), clip(tries)
    total = int((gaps[:, 1] - gaps[:, 0]).sum())
    in_r = _overlap_ns(gaps, r_iv)
    in_rl = _overlap_ns(gaps, np.concatenate([r_iv, l_iv]))
    in_rlt = _overlap_ns(gaps, np.concatenate([r_iv, l_iv, t_iv]))
    idle = {"read": in_r * 1e-9, "launch": (in_rl - in_r) * 1e-9,
            "host_loop": (in_rlt - in_rl) * 1e-9,
            "other": (total - in_rlt) * 1e-9}
    idle_by_piece = {}
    for part, spans, ivs in (("read", read, r_iv), ("launch", launch, l_iv)):
        names = np.asarray([x[2 if part == "read" else 3] for x in spans],
                           object)
        idle_by_piece[part] = {
            str(p): _overlap_ns(gaps, ivs[names == p]) * 1e-9
            for p in sorted(set(names.tolist()))}
    return {
        "window_s": (hi - lo) * 1e-9,
        "busy_s": trace_mod.union_seconds(iv),
        "longest_gaps": _longest(gaps, read, launch, r_iv, l_iv, t_iv, top),
        "pieces": pieces,
        "unattributed_s": trace_mod.union_seconds(iv[own < 0]),
        "ops": {"total": int(live.sum()), **rule_n},
        "early_ops": early,
        "idle_s": idle,
        "idle_by_piece_s": idle_by_piece,
    }


def piece_ms(result: dict, piece: str):
    """Device ms of one launch of `piece` over the window, or None."""
    p = result.get("pieces", {}).get(piece)
    if not p or p["launches"] <= 0 or p["device_s"] <= 0:
        return None
    return 1e3 * p["device_s"] / p["launches"]


def idle_share(result: dict, part: str):
    """Per cent of the window idle in the host layer `part`, or None."""
    if result.get("window_s", 0) <= 0 or part not in result.get("idle_s", {}):
        return None
    return 100.0 * result["idle_s"][part] / result["window_s"]


def per_layer(result: dict) -> dict:
    """The per-layer numbers of one split: each piece's device ms a
    launch, and each host layer's share of the window idle (None where
    the trace holds no such piece or window)."""
    return {
        "jacobian_ms": piece_ms(result, "newton.jacobian"),
        "update_ms": piece_ms(result, "newton.update"),
        "krylov_chunk_ms": piece_ms(result, "newton.krylov.chunk"),
        "read_idle_share": idle_share(result, "read"),
        "launch_idle_share": idle_share(result, "launch"),
        "host_loop_idle_share": idle_share(result, "host_loop"),
    }
