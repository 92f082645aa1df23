"""The share of the program's sample-hash calls (counter `rng.hash_calls`)
that launched the hash kernel (counter `rng.hash_launches`), in %, over
every pass the process ran, as hash_calls_per_msample.render counts them.
Nothing where the program counts no launch: a program without the kernel,
or a run on the CPU, which takes the int64 form."""

from benchlib import stages


def read(rec):
    tel = stages.telemetry()
    if rec.get("kind") != "render" or tel is None:
        return None
    calls = tel.counters.get("rng.hash_calls", 0)
    if calls == 0 or "rng.hash_launches" not in tel.counters:
        return None
    return 100.0 * tel.counters["rng.hash_launches"] / calls
