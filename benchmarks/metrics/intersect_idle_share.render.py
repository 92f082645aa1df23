"""The share of the traced passes' device idle time, in percent, during
which the host's innermost program span is a scene query
(`scene.intersect`, `scene.occluded`: the trace launch and the fragment
around it), after benchlib/stages.py."""

from benchlib import stages


def read(rec):
    return stages.idle_share(rec, "intersect")
