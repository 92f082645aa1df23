"""Turns of SPPM's drain an iteration (counter `sppm.drain_turns`, the
fullest grid cell's entries summed over each iteration's photon chunks),
over every iteration the process ran (counter `render.samples` over the
samples an iteration). Each turn is about ten launches over the visible
points. Nothing where the program counts no turn."""

from benchlib import stages


def read(rec):
    tel = stages.telemetry()
    if rec.get("kind") != "render" or tel is None:
        return None
    samples = tel.counters.get("render.samples", 0)
    if samples == 0 or "sppm.drain_turns" not in tel.counters:
        return None
    return tel.counters["sppm.drain_turns"] / (
        samples / rec["samples_per_pass"])
