"""The share of the traced passes' device idle time, in percent, during
which the host's innermost program span is the film's splat
(`render.splat`, its hashes left out), after benchlib/stages.py."""

from benchlib import stages


def read(rec):
    return stages.idle_share(rec, "splat")
