"""The 95th percentile (nearest rank) of the wall time of every pass in
the window, in milliseconds: the progressive preview's latency. Read per
layer: a pass is bound by the host's Python and launches, and the host's
speed drifts between processes by more than a bound could hold."""

from benchlib import stats


def read(rec):
    if rec.get("kind") != "render":
        return None
    return stats.percentile(rec["pass_s"], 95) * 1e3
