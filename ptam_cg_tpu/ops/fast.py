"""FAST-10 corner detection as dense, vectorized array ops.

Replaces libCVD's fast_corner_detect_10 / fast_nonmax used by the reference
(ref: src/KeyFrame.cc:35-53). Instead of producing variable-length corner
lists on the host, we compute:

- a dense corner mask (H, W) bool — used directly by the patch-search ops
  (the dense-mask equivalent of the reference's row-LUT corner scan,
  ref: src/PatchFinder.cc:187-202);
- a dense score map for non-max suppression (the standard FAST "V" measure:
  the largest threshold margin over any passing arc);
- fixed-capacity (N, 2) corner lists + validity masks via top-k, for the
  epipolar-search and candidate-selection paths.

The segment test: a pixel is a corner if >= 10 contiguous pixels on the
16-pixel Bresenham circle are all brighter than center + t or all darker
than center - t.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

Array = jax.Array

ARC = 10  # FAST-10

# Standard FAST circle offsets (x, y), clockwise from 12 o'clock.
CIRCLE: Tuple[Tuple[int, int], ...] = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)


def _shift(im: Array, dx: int, dy: int) -> Array:
    """im shifted so out[y, x] = im[y + dy, x + dx], zero padded."""
    H, W = im.shape[-2], im.shape[-1]
    pad = 3
    p = jnp.pad(im, [(0, 0)] * (im.ndim - 2) + [(pad, pad), (pad, pad)])
    return jax.lax.dynamic_slice_in_dim(
        jax.lax.dynamic_slice_in_dim(p, pad + dy, H, axis=-2),
        pad + dx, W, axis=-1)


def fast_score_map(im: Array, threshold: float) -> tuple:
    """Compute (is_corner (H,W) bool, score (H,W) float32).

    Score is the FAST "V" measure: max over passing 10-arcs of the minimum
    margin |ring - center| - t within the arc; 0 for non-corners.
    """
    im = im.astype(jnp.float32)
    center = im
    ring = jnp.stack([_shift(im, dx, dy) for dx, dy in CIRCLE], axis=0)
    ring = jnp.concatenate([ring, ring[: ARC - 1]], axis=0)  # wrap (25,H,W)

    bright_margin = ring - (center + threshold)[None]
    dark_margin = (center - threshold)[None] - ring

    def arc_scores(margin):
        # For each of the 16 start positions: min margin over the 10-window.
        # Sliding window min via stacked minimum (10 ops, fused by XLA).
        windows = []
        for s in range(16):
            m = margin[s]
            for k in range(1, ARC):
                m = jnp.minimum(m, margin[s + k])
            windows.append(m)
        return jnp.max(jnp.stack(windows, axis=0), axis=0)  # (H, W)

    sb = arc_scores(bright_margin)
    sd = arc_scores(dark_margin)
    score = jnp.maximum(sb, sd)
    is_corner = score > 0.0
    # Exclude the 3-px border (ring reads zero padding there).
    H, W = im.shape[-2], im.shape[-1]
    inner = jnp.zeros((H, W), bool).at[3:-3, 3:-3].set(True)
    is_corner = is_corner & inner
    return is_corner, jnp.where(is_corner, score + threshold, 0.0)


def nonmax_3x3(score: Array) -> Array:
    """3x3 non-max suppression mask: True where score is a strict-ish local
    max (ties broken toward earlier row-major position, matching typical
    scan-order suppression)."""
    H, W = score.shape[-2], score.shape[-1]
    neg = -jnp.inf
    p = jnp.pad(score, [(1, 1), (1, 1)], constant_values=neg)
    best = score > 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            nb = p[1 + dy: 1 + dy + H, 1 + dx: 1 + dx + W]
            if (dy, dx) < (0, 0) or (dy == 0 and dx < 0):
                best = best & (score >= nb)  # earlier neighbor: allow tie
            else:
                best = best & (score > nb)
    return best


class Corners(NamedTuple):
    """Fixed-capacity corner list."""

    xy: Array      # (N, 2) int32, (x, y)
    score: Array   # (N,) float32
    valid: Array   # (N,) bool
    count: Array   # () int32


def corners_from_mask(mask: Array, score: Array, max_n: int,
                      tile: int = 1) -> Corners:
    """Top-``max_n`` corners by score from a dense mask (capacity overflow
    keeps the strongest — the static-shape replacement for the reference's
    unbounded std::vector<ImageRef>).

    ``tile`` > 1 enables tiled selection: only the best corner per
    (tile x tile) block competes, which shrinks the top_k sort by tile^2
    and spreads corners spatially.
    """
    H, W = mask.shape
    key = jnp.where(mask, score, -jnp.inf)
    if tile > 1 and H % tile == 0 and W % tile == 0:
        Ht, Wt = H // tile, W // tile
        blocks = key.reshape(Ht, tile, Wt, tile).transpose(0, 2, 1, 3)
        blocks = blocks.reshape(Ht, Wt, tile * tile)
        within = jnp.argmax(blocks, axis=-1)                 # (Ht, Wt)
        key = jnp.max(blocks, axis=-1)
        k = min(max_n, Ht * Wt)
        vals, idx = jax.lax.top_k(key.reshape(-1), k)
        ty = idx // Wt
        tx = idx % Wt
        w = jnp.take(within.reshape(-1), idx)
        ys = ty * tile + w // tile
        xs = tx * tile + w % tile
    else:
        k = min(max_n, H * W)
        vals, idx = jax.lax.top_k(key.reshape(-1), k)
        ys = idx // W
        xs = idx % W
    if k < max_n:   # pad capacity for small levels
        vals = jnp.concatenate([vals, jnp.full(max_n - k, -jnp.inf)])
        xs = jnp.concatenate([xs, jnp.zeros(max_n - k, xs.dtype)])
        ys = jnp.concatenate([ys, jnp.zeros(max_n - k, ys.dtype)])
    valid = vals > -jnp.inf
    xy = jnp.stack([xs, ys], axis=-1).astype(jnp.int32)
    xy = jnp.where(valid[:, None], xy, -1)
    return Corners(xy=xy, score=jnp.where(valid, vals, 0.0), valid=valid,
                   count=jnp.sum(valid.astype(jnp.int32)))


def detect(im: Array, threshold: float, max_corners: int,
           nonmax: bool = True) -> tuple:
    """Full detection: (corner_mask, score_map, Corners).

    With ``nonmax`` the mask/list are suppressed (MakeKeyFrame_Rest path,
    ref: src/KeyFrame.cc:64-66); without, raw corners (MakeKeyFrame_Lite
    path used by the coarse patch search, ref: src/KeyFrame.cc:35-42).
    """
    is_corner, score = fast_score_map(im, threshold)
    if nonmax:
        keep = nonmax_3x3(score) & is_corner
    else:
        keep = is_corner
    corners = corners_from_mask(keep, score, max_corners)
    return keep, score, corners
