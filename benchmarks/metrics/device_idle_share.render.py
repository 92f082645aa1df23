"""The share of the traced passes' window in which the device ran
nothing, in percent: one minus the union of its kernel, copy and set
intervals over the window (averaged over the ranks in a sharded cell)."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "render" or tr is None or not tr.device_ops:
        return None
    busy = rec.get("busy_s", tr.busy_s())
    window = rec.get("window_s_traced", tr.window_s)
    return 100.0 * (1.0 - busy / window)
