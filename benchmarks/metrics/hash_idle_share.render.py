"""The share of the traced passes' device idle time, in percent, during
which the host's innermost program span is the sample hash (`rng.hash`),
after benchlib/stages.py: how much of the waiting device the hash's
Python causes."""

from benchlib import stages


def read(rec):
    return stages.idle_share(rec, "hash")
