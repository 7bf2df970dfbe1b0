"""Robust M-estimators (Tukey / Cauchy / Huber / LeastSquares), vectorized.

Capability parity with the reference's cg::{Tukey,Cauchy,Huber,LeastSquares}
(ref: include/Tools.h:88-256), but operating on *masked fixed-capacity
arrays* instead of std::vector — the static-shape idiom. ``find_sigma_squared``
reproduces the reference's MAD-style formula exactly:

    sigma = 1.4826 * (1 + 5/(2n - 6)) * sqrt(median(err^2)) * c
    (c = 4.6851 Tukey/Cauchy, 1.345 Huber; ref include/Tools.h:152-158)

where the median over n valid entries is sorted[n // 2] — the same
element the C++ picks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array

TUKEY = 0
CAUCHY = 1
HUBER = 2
LSQ = 3

_NAMES = {"tukey": TUKEY, "cauchy": CAUCHY, "huber": HUBER,
          "leastsquares": LSQ, "lsq": LSQ}

_SIGMA_SCALE = {TUKEY: 4.6851, CAUCHY: 4.6851, HUBER: 1.345, LSQ: 1.0}


def estimator_id(name: str) -> int:
    return _NAMES[name.lower()]


def masked_median(values: Array, mask: Array) -> Array:
    """sorted(valid)[n_valid // 2] — matches std::sort + [size/2] in the
    reference. Invalid entries are pushed to +inf before sorting."""
    big = jnp.asarray(jnp.finfo(values.dtype).max, values.dtype)
    v = jnp.where(mask, values, big)
    v = jnp.sort(v)
    n = jnp.sum(mask.astype(jnp.int32))
    idx = jnp.clip(n // 2, 0, values.shape[-1] - 1)
    return v[idx]


def masked_median_approx(values: Array, mask: Array) -> Array:
    """Median-of-medians approximation: rows of ~sqrt(N), exact masked
    median per row, then the masked median of row-medians. ~2 small sorts
    instead of one full-length sort (the robust-sigma loops run it every
    GN iteration). Bias is
    well within the M-estimator's tolerance."""
    n = values.shape[-1]
    rows = 1
    while rows * rows < n:
        rows *= 2
    cols = -(-n // rows)
    pad = rows * cols - n
    big = jnp.asarray(jnp.finfo(values.dtype).max, values.dtype)
    v = jnp.where(mask, values, big)
    v = jnp.concatenate([v, jnp.full((pad,), big, values.dtype)])
    m = jnp.concatenate([mask, jnp.zeros((pad,), bool)])
    v2 = jnp.sort(v.reshape(rows, cols), axis=-1)
    cnt = jnp.sum(m.reshape(rows, cols).astype(jnp.int32), axis=-1)
    idx = jnp.clip(cnt // 2, 0, cols - 1)
    row_med = jnp.take_along_axis(v2, idx[:, None], axis=-1)[:, 0]
    row_ok = cnt > 0
    return masked_median(row_med, row_ok)


def find_sigma_squared(err_sq: Array, mask: Array, kind: int = TUKEY,
                       min_sigma: float = 0.0,
                       approx: bool = False) -> Array:
    """Robust sigma^2 from masked squared errors.

    ``kind`` must be a Python int (static under jit). ``min_sigma`` applies
    the reference BA's floor (ref: src/Bundle.cc:234 min sigma 0.4px).
    ``approx`` uses the median-of-medians (for per-iteration use in hot
    GN loops).
    """
    n = jnp.maximum(jnp.sum(mask.astype(jnp.float32)), 1.0)
    # Approximation only pays off (and stays accurate) on big arrays.
    use_approx = approx and err_sq.shape[-1] >= 512
    median_fn = masked_median_approx if use_approx else masked_median
    median_sq = median_fn(err_sq, mask)
    if kind == LSQ:
        total = jnp.sum(jnp.where(mask, err_sq, 0.0))
        return total / n
    denom = jnp.maximum(2.0 * n - 6.0, 1.0)
    sigma = 1.4826 * (1.0 + 5.0 / denom) * jnp.sqrt(jnp.maximum(median_sq, 0.0))
    sigma = _SIGMA_SCALE[kind] * sigma
    sigma = jnp.maximum(sigma, min_sigma)
    return sigma * sigma


def weight(err_sq: Array, sigma_sq: Array, kind: int = TUKEY) -> Array:
    """Per-residual IRLS weight (ref: include/Tools.h Weight impls)."""
    s = jnp.maximum(sigma_sq, 1e-12)
    if kind == TUKEY:
        w = 1.0 - err_sq / s
        return jnp.where(err_sq > s, 0.0, w * w)
    if kind == CAUCHY:
        return 1.0 / (1.0 + err_sq / s)
    if kind == HUBER:
        return jnp.where(err_sq < s, 1.0,
                         jnp.sqrt(s / jnp.maximum(err_sq, 1e-12)))
    return jnp.ones_like(err_sq)


def sqrt_weight(err_sq: Array, sigma_sq: Array, kind: int = TUKEY) -> Array:
    s = jnp.maximum(sigma_sq, 1e-12)
    if kind == TUKEY:
        return jnp.where(err_sq > s, 0.0, 1.0 - err_sq / s)
    return jnp.sqrt(weight(err_sq, sigma_sq, kind))


def objective(err_sq: Array, sigma_sq: Array, kind: int = TUKEY) -> Array:
    """Robust objective score (ref: include/Tools.h ObjectiveScore impls).
    NB Tukey is scaled as in the reference (no sigma^2/6 factor)."""
    s = jnp.maximum(sigma_sq, 1e-12)
    if kind == TUKEY:
        d = 1.0 - err_sq / s
        return jnp.where(err_sq > s, 1.0, 1.0 - d * d * d)
    if kind == CAUCHY:
        return jnp.log1p(err_sq / s)
    if kind == HUBER:
        sig = jnp.sqrt(s)
        err = jnp.sqrt(jnp.maximum(err_sq, 0.0))
        return jnp.where(err_sq < s, 0.5 * err_sq, sig * (err - 0.5 * sig))
    return err_sq
