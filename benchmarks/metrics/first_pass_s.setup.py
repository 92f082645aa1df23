"""Host seconds of the first render pass the process ran (the program's
`setup.first_pass` span): the first launches of every kernel, the trace
library's load at the first trace, the allocator's growth and, sharded,
the first collective. No synchronize is added, so device work still
queued when the pass returns is not in it."""

from benchlib import stages


def read(rec):
    if rec.get("kind") != "render":
        return None
    return stages.setup_seconds("setup.first_pass") or None
