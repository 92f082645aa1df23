"""The cards' busy milliseconds a million camera samples, over the
device-timed passes that follow the window in every run: the union of
each card's kernel, copy and set intervals (NCCL's waiting collectives
left out), summed over the cards. What the samples cost the device; the
hosts' speed does not enter it."""


def read(rec):
    if rec.get("kind") != "render" or not rec.get("device_busy_s"):
        return None
    return rec["device_busy_s"] * 1e3 / (
        rec["device_passes"] * rec["samples_per_pass"] / 1e6)
