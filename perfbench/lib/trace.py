"""Reduction of a torch.profiler trace of the measured window to the
numbers the benchmark reports: device busy time (the union of the
intervals of every kernel, copy and set on the card), the window's
length on the same clock, device time and count by kernel name, and
the longest idle gaps named by what the host was doing then."""

from __future__ import annotations

import numpy as np

WINDOW_SPAN = "perfbench.window"


def _sorted(intervals):
    a = np.asarray(intervals, dtype=np.int64).reshape(-1, 2)
    return a[np.argsort(a[:, 0], kind="stable")]


def union_seconds(intervals) -> float:
    """Total length, in seconds, of the union of [start, end) intervals
    given in nanoseconds."""
    a = _sorted(intervals)
    if len(a) == 0:
        return 0.0
    reach = np.maximum.accumulate(a[:, 1])
    prev = np.concatenate(([a[0, 0]], reach[:-1]))
    # each interval adds what it reaches beyond every earlier one
    added = np.maximum(reach - np.maximum(a[:, 0], prev), 0)
    added[0] = a[0, 1] - a[0, 0]
    return float(added.sum()) * 1e-9


def gaps(intervals, lo: int, hi: int):
    """[(start, end)] of the idle stretches of [lo, hi) between the
    union of the intervals (nanoseconds)."""
    a = _sorted(intervals)
    if len(a) == 0:
        return [(lo, hi)] if hi > lo else []
    reach = np.maximum.accumulate(a[:, 1])
    starts = np.concatenate(([lo], reach))
    ends = np.concatenate((a[:, 0], [hi]))
    # a gap opens where the next interval starts past everything before
    prior = np.maximum.accumulate(starts)
    keep = ends > prior
    return [(int(s), int(min(e, hi))) for s, e in
            zip(prior[keep], ends[keep]) if min(e, hi) > s]


def summarise(kineto_events, device_type, top: int = 10) -> dict:
    """busy_s, window_s, kernel_s and kernel_n (by name), and the
    breakdown (device_ops, idle_gaps) of one traced window."""
    lo = hi = None
    dev_s, dev_e, dev_name = [], [], []
    host_s, host_e, host_ev = [], [], []
    for e in kineto_events:
        s = e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == device_type:
            name = e.name()
            if e.is_user_annotation() or "Sync" in name:
                continue
            dev_s.append(s)
            dev_e.append(end)
            dev_name.append(name)
        elif e.is_user_annotation() and e.name() == WINDOW_SPAN:
            lo, hi = s, end
        else:
            host_s.append(s)
            host_e.append(end)
            host_ev.append(e)
    if lo is None:
        raise RuntimeError(f"no {WINDOW_SPAN} span in the trace")
    ds = np.clip(np.asarray(dev_s, np.int64), lo, hi)
    de = np.clip(np.asarray(dev_e, np.int64), lo, hi)
    live = de > ds
    kernel_s, kernel_n = {}, {}
    for name, d in zip(np.asarray(dev_name, object)[live],
                       (de - ds)[live]):
        kernel_s[name] = kernel_s.get(name, 0.0) + float(d) * 1e-9
        kernel_n[name] = kernel_n.get(name, 0) + 1
    iv = np.stack([ds[live], de[live]], axis=1)
    idle = sorted(gaps(iv, lo, hi), key=lambda g: g[0] - g[1])[:top]
    hs = np.asarray(host_s, np.int64)
    he = np.asarray(host_e, np.int64)
    named = []
    for a, b in idle:
        mid = (a + b) // 2
        cover = np.nonzero((hs <= mid) & (he >= mid))[0]
        name = ("host outside any traced call" if len(cover) == 0
                else host_ev[cover[np.argmax(hs[cover])]].name())
        named.append([name[:160], (b - a) * 1e-9])
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:top]
    return {
        "busy_s": union_seconds(iv),
        "window_s": (hi - lo) * 1e-9,
        "kernel_s": kernel_s,
        "kernel_n": kernel_n,
        "breakdown": {"device_ops": [[k[:160], v] for k, v in ops],
                      "idle_gaps": named},
    }
