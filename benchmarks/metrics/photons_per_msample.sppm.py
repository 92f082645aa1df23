"""Photons traced (counter `sppm.photons`) a million camera samples
(counter `render.samples`), over every iteration the process ran. Nothing
where the program counts no photon."""

from benchlib import stages


def read(rec):
    tel = stages.telemetry()
    if rec.get("kind") != "render" or tel is None:
        return None
    samples = tel.counters.get("render.samples", 0)
    if samples == 0 or "sppm.photons" not in tel.counters:
        return None
    return tel.counters["sppm.photons"] / (samples / 1e6)
