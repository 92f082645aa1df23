"""(Visible point, photon entry) pairs that passed SPPM's drain tests an
iteration (counter `sppm.drain_pairs`, the pair total of each drain in
pair form, taken from the drain's one read), over every iteration the
process ran (counter `render.samples` over the samples an iteration): the
pairs the BSDF is evaluated on. Nothing where the program counts no
pairs: a program without the pair form, or a run on the CPU."""

from benchlib import stages


def read(rec):
    tel = stages.telemetry()
    if rec.get("kind") != "render" or tel is None:
        return None
    samples = tel.counters.get("render.samples", 0)
    if samples == 0 or "sppm.drain_pairs" not in tel.counters:
        return None
    return tel.counters["sppm.drain_pairs"] / (
        samples / rec["samples_per_pass"])
