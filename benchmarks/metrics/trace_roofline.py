"""The trace kernels' share of their bytes-only bound, in percent: the
least time the device's memory rate allows for work that no tree or
kernel changes (each launch's live rays in at 32 B, every lane out at
17 B, the scene's triangles once at 36 B; benchlib/stats.py) over the
kernels' device time in the profile (by kernel name). The bound counts no
operations, so the share is an upper bound's share, read beside the
card's power limit."""

from benchlib import stats

KERNELS = ("trace_wide_kernel", "trace_bvh2_kernel")


def read(rec):
    tr = rec.get("trace")
    if tr is None or not rec.get("launch_lanes"):
        return None
    t = sum(tr.device_time(k) for k in KERNELS)
    if t <= 0.0:
        return None
    return 100.0 * stats.trace_bound_s(rec["launch_lanes"],
                                       rec["n_triangles"]) / t
