"""The sharded window's rate over the card count times rank 0's own
unsharded rate, measured in the same run while the other ranks wait at a
barrier, in percent."""


def read(rec):
    one = rec.get("unsharded_msamples_per_s")
    if not one:
        return None
    n = len(rec["pass_s"]) * rec["samples_per_pass"]
    return 100.0 * (n / rec["window_s"] / 1e6) / (rec["world"] * one)
