"""Sampling helpers the path-tracing slice uses (port of part of
goblin_tpu/core/sampling.py)."""

from __future__ import annotations

import torch


def power_heuristic(n_a, pdf_a, n_b, pdf_b):
    """Veach power heuristic (beta=2) MIS weight for strategy A."""
    a = n_a * pdf_a
    b = n_b * pdf_b
    return a * a / torch.clamp(a * a + b * b, min=1e-30)
