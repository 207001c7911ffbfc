"""device_idle_share: per cent of the traced window in which no kernel,
copy or set ran on the card: 1 - union of the device intervals over
the window (torch.profiler)."""


def read(run):
    tr = run["trace"]
    if tr is None or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
