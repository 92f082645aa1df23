"""The share of the traced passes' device idle time, in percent, during
which the host's innermost program span is shading (`render.camera`,
`pt.bounce`: camera rays, materials, lights and the bounce's arithmetic,
its hashes and scene queries left out), after benchlib/stages.py."""

from benchlib import stages


def read(rec):
    return stages.idle_share(rec, "shade")
