"""Image error metrics + reference-render workflow helpers.

Port of merian_quake_tpu/utils/metrics.py (a copy: the port imports
nothing of the JAX package). Equivalent of the reference's offline
analysis scripts (scripts/error_plot.py: RMSE/MAE convergence vs a
reference; scripts/combine_images.py: averaging runs into a reference;
scripts/expose.py: exposure-matched comparison). Every function takes
numpy arrays or tensors; a tensor is moved to the host once, at the call.
"""
from __future__ import annotations

import numpy as np
import torch


def _host(x, dtype=None) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def rmse(img, ref) -> float:
    return float(np.sqrt(np.mean((_host(img) - _host(ref)) ** 2)))


def mae(img, ref) -> float:
    return float(np.mean(np.abs(_host(img) - _host(ref))))


def relmse(img, ref, eps: float = 1e-2) -> float:
    """Relative MSE — the paper's headline metric (error_plot.py:27-60)."""
    img = _host(img, np.float64)
    ref = _host(ref, np.float64)
    return float(np.mean((img - ref) ** 2 / (ref**2 + eps)))


def relmse_trimmed(img, ref, eps: float = 1e-2, trim: float = 1e-3) -> float:
    """relMSE with the top ``trim`` fraction of per-value errors
    discarded. Path-tracing estimators are heavy-tailed (a handful of
    low-pdf fireflies can dominate the plain mean at modest budgets); the
    trimmed statistic tracks the bulk convergence the plain metric
    drowns out."""
    img = _host(img, np.float64)
    ref = _host(ref, np.float64)
    e = ((img - ref) ** 2 / (ref**2 + eps)).ravel()
    k = max(int(e.size * (1.0 - trim)), 1)
    return float(np.mean(np.partition(e, k - 1)[:k]))


def combine_images(images) -> np.ndarray:
    """Average independent runs into a reference (combine_images.py)."""
    return np.mean([_host(i, np.float64) for i in images], axis=0)


def exposure_match(img, ref) -> np.ndarray:
    """Scale img so its mean luminance matches ref (expose.py)."""
    img = _host(img, np.float64)
    ref = _host(ref, np.float64)
    s = ref.mean() / max(img.mean(), 1e-12)
    return img * s


def convergence_series(estimates, ref, metric=relmse):
    """Per-iteration error curve for log-log convergence plots."""
    ref = _host(ref)
    return [metric(e, ref) for e in estimates]
