"""A run of a cell: the refusals, the entry, the metrics and the result
line."""

from __future__ import annotations

import json
import os
import sys

from . import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "goblin_tpu")


class Refused(Exception):
    """The run cannot give a result (no card, too few cards, a forbidden
    module loaded)."""


def set_cache_dirs(root):
    """Every build and kernel cache at a fixed place inside the checkout.
    The program's own kernels build into goblin_tpu_torch/_build."""
    base = os.path.join(root, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def forbidden_loaded():
    """Forbidden top-level module names in sys.modules, compared whole:
    goblin_tpu_torch is not goblin_tpu."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def run(args, t_start, device="cuda", film=None):
    """Run the cell -> the result dict (None on a rank other than 0).
    device "cpu" and film (x_res, y_res) are the tests' small runs."""
    import torch

    cell = spec.Cell(args.workload)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise Refused("CUDA is not available")
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"{cell.name} needs {cell.chips} cards, "
                          f"{torch.cuda.device_count()} found")
    rec = cell.entry().run(cell, args, device, t_start, film=film)
    if rec is None:
        return None
    bad = forbidden_loaded()
    if bad:
        raise Refused(f"modules loaded in the result's process: {bad}")
    metrics = {}
    for m in cell.metrics(bool(args.trace)):
        v = spec.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips if cuda else 1,
           "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    out = {"correct": bool(rec["correct"]),
           "attempted": int(rec["attempted"]), "failed": int(rec["failed"]),
           "metrics": metrics, "device": dev}
    if args.trace:
        tr = rec["trace"]
        dev["busy_s"] = float(rec.get("busy_s", tr.busy_s()))
        dev["window_s"] = float(rec.get("window_s_traced", tr.window_s))
        out["breakdown"] = tr.breakdown()
    out["check"] = rec["check"]
    out["_log"] = rec.get("log", {})
    return out


def emit(result):
    """The run's log and compared numbers on standard error (the numbers
    last), the result line last on standard output."""
    log = result.pop("_log", {})
    print("benchmark: " + json.dumps(log), file=sys.stderr)
    for name, row in result["check"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
