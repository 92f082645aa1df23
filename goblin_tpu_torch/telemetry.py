"""The renderer's own spans and counters, kept in memory.

A span is a record (name, start_ns, end_ns, parent): the host's wall clock
(``time.time_ns()``) when the block began and ended, and the name of the
recorded span open around it (None at the top). The torch profiler stamps
its host events on the same clock, so a span lines up with a profile's
device trace once one constant offset is taken out.

- Hot spans (``span``) mark a render pass and its stages. They record only
  while a torch profiler records, or between ``start()`` and ``stop()``;
  otherwise ``span`` returns one shared no-op context, with no allocation
  and no clock read. At most ``CAP`` of them are kept, the oldest dropped.
- Cold spans (``cold``, ``once``) mark a process's set-up: a trace
  library's first load and the first render pass. They always record, and
  are few.
- Counters (``count``) always count.

No span is a profiler range: the profiler gives its ranges device-side
mirror events, which a device trace would count as device work. The
records are one thread's: the renderer's passes run on one.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time

from torch.autograd import profiler as _profiler

# hot spans kept; a pass of the path tracer records about 133
CAP = 200_000

# the stage each hot span's self time belongs to; render.pass has none
STAGES = {
    "render.camera": "shade",
    "pt.bounce": "shade",
    "scene.intersect": "intersect",
    "scene.occluded": "intersect",
    "rng.hash": "hash",
    "render.splat": "splat",
    "sppm.ray": "shade",
    "sppm.photon": "photon",
    "sppm.grid": "grid",
    "sppm.drain": "drain",
    "sppm.update": "splat",
}

# name -> count since the process began (or the caller's last clear)
counters: dict[str, int] = {}

_on = False
_hot: collections.deque = collections.deque(maxlen=CAP)
_cold: list = []
_open: list[str] = []  # names of the recorded spans open, innermost last
_seen: set[str] = set()  # once() names already recorded
_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "out", "t0")

    def __init__(self, name, out):
        self.name = name
        self.out = out

    def __enter__(self):
        _open.append(self.name)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        _open.pop()
        self.out.append((self.name, self.t0, t1,
                         _open[-1] if _open else None))
        return False


def span(name: str):
    """A hot span around a stage of a pass: recorded while a profiler
    records or between start() and stop(), else a no-op."""
    if _on or _profiler._is_profiler_enabled:
        return _Span(name, _hot)
    return _NULL


def spanned(name: str):
    """Decorator: each call of the function in a hot span."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def cold(name: str):
    """A set-up span, always recorded."""
    return _Span(name, _cold)


def once(name: str):
    """A set-up span recorded the first time the process enters it, a no-op
    after."""
    if name in _seen:
        return _NULL
    _seen.add(name)
    return _Span(name, _cold)


def count(name: str, n: int = 1) -> None:
    counters[name] = counters.get(name, 0) + n


def start() -> None:
    """Record hot spans without a profiler, until stop()."""
    global _on
    _on = True


def stop() -> None:
    global _on
    _on = False


def spans() -> list:
    """The hot span records, oldest first."""
    return list(_hot)


def setup_spans() -> list:
    """The cold span records, oldest first."""
    return list(_cold)


def clear() -> None:
    """Forget the hot span records."""
    _hot.clear()


def innermost(records) -> list:
    """The time the records cover, cut into disjoint (start_ns, end_ns,
    name) pieces, each named by the innermost span open over it, in time
    order. A span's self time is the sum of its pieces: its length less
    what its children cover. The records must nest, as one thread's do."""
    out = []
    stack = []  # (end_ns, name) of the spans open at cur
    cur = 0
    for name, a, b, _ in sorted(records, key=lambda r: (r[1], -r[2])):
        while stack and stack[-1][0] <= a:
            end, outer = stack.pop()
            if end > cur:
                out.append((cur, end, outer))
                cur = end
        if stack and a > cur:
            out.append((cur, a, stack[-1][1]))
        cur = a
        stack.append((b, name))
    while stack:
        end, outer = stack.pop()
        if end > cur:
            out.append((cur, end, outer))
            cur = end
    return out


def self_times(records) -> dict:
    """name -> self time in ns, summed over the records of that name."""
    out: dict[str, int] = {}
    for a, b, name in innermost(records):
        out[name] = out.get(name, 0) + b - a
    return out
