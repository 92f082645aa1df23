"""Device kernels the profiler records over the traced passes, per
million camera samples: what the host launches to render a sample."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "render" or tr is None:
        return None
    n = len(tr.kernels())
    if n == 0:
        return None
    return n / (rec["traced_passes"] * rec["samples_per_pass"] / 1e6)
