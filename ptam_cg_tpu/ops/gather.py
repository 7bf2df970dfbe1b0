"""Per-point rectangular window gathers from a packed pyramid atlas.

The patch search, sub-pixel refinement and epipolar search all cut one
D x D window per point out of an (Ha, W) atlas. ``gather_windows`` is the
production formulation: take the D rows each window spans (as 128-wide
bands where the atlas width allows), then select the D columns with a
batched one-hot dot. ``gather_windows_vmap`` is the plain vmapped
``dynamic_slice`` reference it is tested against.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

Array = jax.Array


@functools.partial(jax.jit, static_argnames=("D",))
def gather_windows_rowtake(atlas: Array, origin_yx: Array, D: int) -> Array:
    """Window gather: take row segments, then select the D-column window
    with a batched one-hot dot.

    When the atlas width is a multiple of 128 and D <= 128, rows are
    taken as PAIRS of 128-wide bands from a (Ha*Wa/128, 128) view —
    2.5x less gather traffic than full 640-wide rows at 640x480."""
    N = origin_yx.shape[0]
    Ha, Wa = atlas.shape
    oy = jnp.clip(origin_yx[:, 0], 0, Ha - D)
    ox = jnp.clip(origin_yx[:, 1], 0, Wa - D)
    ii = jnp.arange(D, dtype=jnp.int32)

    band = 128
    nb = Wa // band
    if Wa % band == 0 and D <= band and nb >= 2:
        b0 = jnp.minimum(ox // band, nb - 2)        # window spans <= 2 bands
        lx = ox - b0 * band                         # in [0, 2*band - D]
        banded = atlas.reshape(Ha * nb, band)
        rb = (oy[:, None] + ii[None, :]) * nb + b0[:, None]   # (N, D)
        seg_idx = jnp.stack([rb, rb + 1], axis=-1).reshape(-1)
        rows = jnp.take(banded, seg_idx, axis=0).reshape(N, D, 2 * band)
        C = 2 * band
    else:
        lx = ox
        rows_idx = (oy[:, None] + ii[None, :]).reshape(-1)
        rows = jnp.take(atlas, rows_idx, axis=0).reshape(N, D, Wa)
        C = Wa

    csel = (lx[:, None, None] + ii[None, None, :]
            == jnp.arange(C, dtype=jnp.int32)[None, :, None])
    # A bfloat16 atlas (FrontendConfig.atlas_bf16) halves the row-take
    # traffic and runs this dot at bf16 rate; accumulation and output
    # are always float32 so downstream ZMSSD/subpix math keeps full
    # precision. Explicit DEFAULT precision: the selector is one-hot, so
    # the only rounding is of the image values themselves (none for
    # uint8-valued pixels; at most TF32's on the GPU) — and the dot must
    # stay fast under the callers' pinned-f32 contexts (tracker/mapmaker
    # programs).
    return jnp.einsum("ndc,ncj->ndj", rows, csel.astype(atlas.dtype),
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.DEFAULT
                      ).astype(jnp.float32)


def gather_windows_vmap(atlas: Array, origin_yx: Array, D: int) -> Array:
    """vmapped-dynamic-slice window extraction — the plain reference
    formulation ``gather_windows_rowtake`` is tested against."""
    def one(o):
        return jax.lax.dynamic_slice(atlas, (o[0], o[1]), (D, D))

    return jax.vmap(one)(origin_yx)


def gather_windows(atlas: Array, origin_yx: Array, D: int) -> Array:
    """Per-point window extraction (production path): the row-take +
    one-hot column dot. Whether XLA's native gather beats it on the GPU
    is ROADMAP C7."""
    return gather_windows_rowtake(atlas, origin_yx, D)
