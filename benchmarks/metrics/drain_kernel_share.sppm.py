"""The share of SPPM's drains (counter `sppm.drain_reads`, one a drain)
that ran through the drain's kernels (counter `sppm.drain_launches`, one a
drain's count pass launched from csrc/sppm_drain.cu), in %, over every
iteration the process ran. Nothing where the program counts no launch: a
program without the kernels, or a run on the CPU, which takes the loop."""

from benchlib import stages


def read(rec):
    tel = stages.telemetry()
    if rec.get("kind") != "render" or tel is None:
        return None
    reads = tel.counters.get("sppm.drain_reads", 0)
    if reads == 0 or "sppm.drain_launches" not in tel.counters:
        return None
    return 100.0 * tel.counters["sppm.drain_launches"] / reads
