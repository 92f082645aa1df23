"""What decides `correct` in a render cell: the film the window's passes
left, at pixels drawn from the seed, against the plain reference's film at
the same pixels over the same passes.

The pixels are `blocks` squares of `block` x `block` pixels placed by the
seed (neighbouring pixels share most of the samples their filter reads, so
squares cost the reference less than scattered pixels). The numbers
compared, over the checked pixels that either film lit:

- colour_err_median: the median of each pixel's relative colour error
  (its largest channel's difference over its largest reference channel);
- colour_bad_share: the share of them whose relative error is over
  BAD_REL, which a fault confined to part of the frame moves where the
  median does not;
- weight_err_max: the largest relative error of the filter weights, which
  depend on the sample positions alone;
- lit_share: the share of checked pixels that either film lit, which has
  to reach a floor (a check that reads only black pixels decides nothing).
"""

from __future__ import annotations

import numpy as np
import torch

BAD_REL = 1e-3


def pixels(seed, x_res, y_res, blocks, block):
    """Flat ids of the checked pixels, drawn from the seed."""
    rng = np.random.default_rng(int(seed))
    out = []
    for _ in range(blocks):
        x0 = int(rng.integers(0, x_res - block + 1))
        y0 = int(rng.integers(0, y_res - block + 1))
        for y in range(y0, y0 + block):
            out.extend(y * x_res + x for x in range(x0, x0 + block))
    return np.unique(np.asarray(out, np.int64))


def compare(color, weight, ref_color, ref_weight):
    """The numbers compared, from the program's (or the control's) film
    and the reference's at the checked pixels: (K, 3) and (K,) each."""
    color = torch.as_tensor(color, dtype=torch.float64).cpu()
    ref_color = torch.as_tensor(ref_color, dtype=torch.float64).cpu()
    weight = torch.as_tensor(weight, dtype=torch.float64).cpu()
    ref_weight = torch.as_tensor(ref_weight, dtype=torch.float64).cpu()
    finite = torch.isfinite(color).all(-1) & torch.isfinite(weight)
    mag = ref_color.abs().amax(-1)
    lit = (mag > 0.0) | (color.abs().amax(-1) > 0.0) | ~finite
    err = torch.where(finite, (color - ref_color).abs().amax(-1)
                      / torch.clamp(mag, min=1e-30), float("inf"))
    err = torch.clamp(err, max=1e30)[lit]
    w_err = torch.where(torch.isfinite(weight),
                        (weight - ref_weight).abs()
                        / torch.clamp(ref_weight.abs(), min=1e-30), 1e30)
    n_lit = int(lit.sum())
    return {
        "colour_err_median": float(err.median()) if n_lit else 1e30,
        "colour_bad_share": float((err > BAD_REL).double().mean())
        if n_lit else 1.0,
        "weight_err_max": float(w_err.max()),
        "lit_share": n_lit / max(1, lit.numel()),
    }


def judge(numbers, limits):
    """-> (correct, {name: {value, limit}}): every number at or under its
    limit, and lit_share at or over its floor."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers[name]
        passed = v >= limit if name == "lit_share" else v <= limit
        ok = ok and passed and np.isfinite(v)
        out[name] = {"value": v, "limit": limit}
    return ok, out
