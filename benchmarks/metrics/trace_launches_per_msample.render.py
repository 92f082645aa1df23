"""The program's trace kernel launches (ops.trace.launches) over the
traced passes, per million camera samples."""


def read(rec):
    if rec.get("kind") != "render" or "trace_launches" not in rec:
        return None
    if rec["trace_launches"] == 0:
        return None
    return rec["trace_launches"] / (rec["traced_passes"]
                                    * rec["samples_per_pass"] / 1e6)
