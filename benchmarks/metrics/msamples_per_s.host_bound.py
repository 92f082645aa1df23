"""msamples_per_s on one card, read per layer: there the pass is bound by
the host's Python and launches, and the host's speed drifts between
processes by more than a bound could hold."""

from benchlib import spec


def read(rec):
    return spec.reader("msamples_per_s")(rec)
