"""The share of the traced iterations' device idle time, in percent,
during which the host's innermost program span is SPPM's photon stage
(telemetry.STAGES), after benchlib/stages.py. Nothing where the program
has no such stage."""

from benchlib import stages


def read(rec):
    if rec.get("kind") != "render":
        return None
    split = stages.idle_by_stage(rec)
    return None if split is None else split.get("photon")
