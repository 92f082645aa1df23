"""Photons a light walk of SPPM (counter `sppm.photons` over counter
`sppm.photon_walks`, one a `walk_light_paths` call), over every iteration
the process ran: the width of the photon pass's wavefront. Nothing where
the program counts no walk."""

from benchlib import stages


def read(rec):
    tel = stages.telemetry()
    if rec.get("kind") != "render" or tel is None:
        return None
    walks = tel.counters.get("sppm.photon_walks", 0)
    if walks == 0 or "sppm.photons" not in tel.counters:
        return None
    return tel.counters["sppm.photons"] / walks
