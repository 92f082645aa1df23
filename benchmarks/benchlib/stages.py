"""The program's own spans and counters (goblin_tpu_torch.telemetry), read
beside a traced run's device trace.

The program records its spans on the host's wall clock, in nanoseconds;
`Trace` times its events in seconds from the profile's start. Each harness
`pass` range encloses exactly one program `render.pass`, the last ones the
process recorded, so the offset between the clocks is the smallest
(program `render.pass` start - harness `pass` start) over the traced
passes. Only the spans inside the traced window after that shift are
read.

A stage's idle share is the part of the window's device idle time during
which the host's innermost program span belongs to that stage (the
program's `telemetry.STAGES`); `rest` is the idle time under no stage: in
a pass outside every stage, or outside the program's spans. The shares
and `rest` sum to 100%. In a sharded cell the trace and the spans are rank
0's.

Where the program has no telemetry, or recorded no spans, every function
here returns None.
"""

from __future__ import annotations

import bisect

from . import stats


def telemetry():
    """The program's telemetry module, or None where it has none."""
    try:
        from goblin_tpu_torch import telemetry as tel
    except ImportError:
        return None
    return tel


def offsets_ns(rec):
    """(program render.pass start - harness pass start) in ns for each
    traced pass, or None."""
    tel, tr = telemetry(), rec.get("trace")
    if tel is None or tr is None:
        return None
    passes = sorted(a for a, _, n in tr.spans if n == "pass")
    prog = [r for r in tel.spans() if r[0] == "render.pass"]
    if not passes or len(prog) < len(passes):
        return None
    prog = prog[-len(passes):]
    return [r[1] - round(a * 1e9) for r, a in zip(prog, passes)]


def aligned(rec):
    """The program's span records inside the traced window, shifted onto
    the trace's clock (still in ns), or None."""
    off = offsets_ns(rec)
    if off is None:
        return None
    shift = min(off)
    tr = rec["trace"]
    lo, hi = round(tr.lo * 1e9), round(tr.hi * 1e9)
    out = []
    for name, a, b, parent in telemetry().spans():
        a, b = a - shift, b - shift
        if lo <= a and b <= hi:
            out.append((name, a, b, parent))
    return out


def overlap(pieces, gaps):
    """Seconds of each piece's overlap with the gaps: pieces and gaps are
    sorted, disjoint (start, end, ...) intervals -> one number a piece."""
    starts = [g[0] for g in gaps]
    out = []
    for p in pieces:
        a, b = p[0], p[1]
        i = max(0, bisect.bisect_right(starts, a) - 1)
        s = 0.0
        while i < len(gaps) and gaps[i][0] < b:
            s += max(0.0, min(b, gaps[i][1]) - max(a, gaps[i][0]))
            i += 1
        out.append(s)
    return out


def idle_by_stage(rec):
    """{stage: % of the traced window's device idle time}, each stage of
    telemetry.STAGES and `rest`, summing to 100; None without spans or
    idle time. Kept in rec, as each stage's reader asks."""
    if "idle_by_stage" in rec:
        return rec["idle_by_stage"]
    spans = aligned(rec)
    out = None
    if spans:
        tel, tr = telemetry(), rec["trace"]
        gaps = stats.gaps([(a, b) for a, b, _ in tr.device_ops],
                          tr.lo, tr.hi)
        idle = sum(b - a for a, b in gaps)
        if idle > 0.0:
            pieces = [(a * 1e-9, b * 1e-9, n)
                      for a, b, n in tel.innermost(spans)]
            out = dict.fromkeys(sorted(set(tel.STAGES.values())), 0.0)
            for p, s in zip(pieces, overlap(pieces, gaps)):
                stage = tel.STAGES.get(p[2])
                if stage is not None:
                    out[stage] += s
            out = {k: 100.0 * v / idle for k, v in out.items()}
            out["rest"] = 100.0 - sum(out.values())
    rec["idle_by_stage"] = out
    return out


def idle_share(rec, stage):
    if rec.get("kind") != "render":
        return None
    split = idle_by_stage(rec)
    return None if split is None else split[stage]


def setup_seconds(name):
    """Seconds of the program's set-up spans of that name, summed; 0 where
    it has telemetry and recorded none, None where it has none."""
    tel = telemetry()
    if tel is None:
        return None
    return sum(b - a for n, a, b, _ in tel.setup_spans() if n == name) * 1e-9
