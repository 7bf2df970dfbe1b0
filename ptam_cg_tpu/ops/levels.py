"""Pyramid-level coordinate transforms and the packed pyramid atlas.

Level transforms replicate the reference exactly
(ref: include/KeyFrame.h:85-124): pixel centers shift by half a pixel per
level, so LevelZeroPos(p, l) = (p + 0.5) * 2^l - 0.5.

The *atlas* is the static-shape representation of a 4-level pyramid: all
levels packed into ONE static-shape (1.5*H, W) image so that per-point
dynamic slices can address any level with a single offset — no ragged
tuples inside jitted code, one contiguous device buffer per keyframe.

Layout for a (H, W) level-0 image::

    +----------------------+  row 0
    |       level 0        |
    |      (H x W)         |
    +-----------+----+--+--+  row H
    | level 1   | L2 |L3|  |
    | (H/2xW/2) |    |  |  |
    +-----------+----+--+--+  row H + H/2

Level 1 at (H, 0); level 2 at (H, W/2); level 3 at (H, 3W/4).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ptam_cg_tpu.config import LEVELS
from ptam_cg_tpu.ops import image as imops

Array = jax.Array


def level_scale(level) -> Array:
    """2^level, works on traced int arrays."""
    return jnp.left_shift(1, level).astype(jnp.float32)


def _broadcast_scale(p: Array, level) -> Array:
    """2^level broadcast against p: a (N,) level array pairs with (N, 2)
    coordinate arrays by gaining a trailing axis."""
    s = jnp.asarray(level_scale(level))
    if s.ndim == jnp.ndim(p) - 1:
        s = s[..., None]
    return s


def level_zero_pos(p: Array, level) -> Array:
    """Level-l coords -> level-0 coords (ref: include/KeyFrame.h:90-93)."""
    return (p + 0.5) * _broadcast_scale(p, level) - 0.5


def level_n_pos(p: Array, level) -> Array:
    """Level-0 coords -> level-l coords (ref: include/KeyFrame.h:112-115)."""
    return (p + 0.5) / _broadcast_scale(p, level) - 0.5


def atlas_shape(h: int, w: int) -> Tuple[int, int]:
    assert h % 8 == 0 and w % 8 == 0, "image dims must be divisible by 8"
    return (h + h // 2, w)


def level_offsets(h: int, w: int) -> Tuple[Tuple[int, int], ...]:
    """(row, col) of each level's top-left pixel in the atlas."""
    return ((0, 0), (h, 0), (h, w // 2), (h, w // 2 + w // 4))


def level_sizes(h: int, w: int) -> Tuple[Tuple[int, int], ...]:
    return tuple((h >> l, w >> l) for l in range(LEVELS))


def pack_atlas(pyramid: Tuple[Array, ...]) -> Array:
    """Pack a 4-level pyramid (tuple of (H/2^l, W/2^l)) into the atlas."""
    h, w = pyramid[0].shape
    A = jnp.zeros(atlas_shape(h, w), pyramid[0].dtype)
    for (r, c), lev in zip(level_offsets(h, w), pyramid):
        A = jax.lax.dynamic_update_slice(A, lev, (r, c))
    return A


def build_atlas(im: Array) -> Array:
    """Level-0 image -> packed pyramid atlas (MakeKeyFrame_Lite's pyramid,
    ref: src/KeyFrame.cc:23-33)."""
    return pack_atlas(imops.build_pyramid(im, LEVELS))


def unpack_level(atlas: Array, level: int, h: int, w: int) -> Array:
    """Static-level extraction (host/test convenience)."""
    r, c = level_offsets(h, w)[level]
    return atlas[r: r + (h >> level), c: c + (w >> level)]


def atlas_pos(p_level_xy: Array, level, h: int, w: int) -> Array:
    """(x, y) in level-l coords -> (x, y) in atlas coords, traced level.

    Adds the packed level's (col, row) offset.
    """
    offs = jnp.asarray([[c, r] for (r, c) in level_offsets(h, w)],
                       jnp.float32)
    return p_level_xy + offs[level]


def level_bounds(level, h: int, w: int):
    """(x0, y0, x1, y1) atlas-coordinate bounds of a (traced) level —
    used to keep dynamic slices from crossing level boundaries."""
    offs = jnp.asarray([[c, r] for (r, c) in level_offsets(h, w)],
                       jnp.float32)
    sizes = jnp.asarray([[wl, hl] for (hl, wl) in level_sizes(h, w)],
                        jnp.float32)
    tl = offs[level]
    br = offs[level] + sizes[level]
    return tl[..., 0], tl[..., 1], br[..., 0], br[..., 1]
