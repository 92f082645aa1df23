"""Calls of the program's sample hash (counter `rng.hash_calls`) a million
camera samples splatted (counter `render.samples`), over every pass the
process ran: each call is some 77 small int64 kernels over a wavefront."""

from benchlib import stages


def read(rec):
    tel = stages.telemetry()
    if rec.get("kind") != "render" or tel is None:
        return None
    samples = tel.counters.get("render.samples", 0)
    if samples == 0:
        return None
    return tel.counters.get("rng.hash_calls", 0) / (samples / 1e6)
