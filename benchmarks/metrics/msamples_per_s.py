"""Camera samples splatted into the film over the window, across all
cards, in millions a second of the window's whole length."""


def read(rec):
    if rec.get("kind") != "render":
        return None
    n = len(rec["pass_s"]) * rec["samples_per_pass"]
    return n / rec["window_s"] / 1e6
