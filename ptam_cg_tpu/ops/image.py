"""Dense image kernels: pyramid, blur, gradients, Shi-Tomasi score maps.

Dense replacements for libCVD's halfSample/convolveGaussian and the
reference's per-point Shi-Tomasi loop (ref: src/ImageProcess.cc:20-47,
src/KeyFrame.cc:23-53). Everything here is *dense*: instead of scoring
individual corner points we produce whole score maps, and
downstream code gathers/top-ks from them. Images are float32 (...,H,W)
with intensity in [0, 255] to keep the reference's tunable thresholds
meaningful.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

Array = jax.Array


def half_sample(im: Array) -> Array:
    """2x2 box-filter downsample (libCVD halfSample parity).

    Averages each 2x2 block; odd trailing row/col dropped like CVD.
    """
    H, W = im.shape[-2], im.shape[-1]
    H2, W2 = H // 2, W // 2
    im = im[..., : H2 * 2, : W2 * 2]
    r = im.reshape(*im.shape[:-2], H2, 2, W2, 2)
    return r.mean(axis=(-3, -1))


def build_pyramid(im: Array, levels: int = 4) -> tuple:
    """4-level half-sampled pyramid (ref: src/KeyFrame.cc:23-33)."""
    out = [im]
    for _ in range(levels - 1):
        out.append(half_sample(out[-1]))
    return tuple(out)


@functools.lru_cache(maxsize=32)
def _gauss_kernel(sigma: float) -> tuple:
    radius = max(1, int(math.ceil(2.5 * sigma)))
    xs = [math.exp(-0.5 * (i / sigma) ** 2) for i in range(-radius, radius + 1)]
    s = sum(xs)
    return tuple(x / s for x in xs)


def gaussian_blur(im: Array, sigma: float) -> Array:
    """Separable Gaussian blur (CVD convolveGaussian parity in spirit).

    ``sigma`` is a static Python float. Uses edge-replicate padding.
    """
    if sigma <= 0:
        return im
    k = jnp.asarray(_gauss_kernel(float(sigma)), im.dtype)
    r = (k.shape[0] - 1) // 2
    # Rows.
    x = jnp.pad(im, [(0, 0)] * (im.ndim - 2) + [(r, r), (0, 0)], mode="edge")
    x = jnp.moveaxis(x, -2, -1)
    x = _conv1d_last(x, k)
    x = jnp.moveaxis(x, -1, -2)
    # Cols.
    x = jnp.pad(x, [(0, 0)] * (im.ndim - 2) + [(0, 0), (r, r)], mode="edge")
    return _conv1d_last(x, k)


def _conv1d_last(x: Array, k: Array) -> Array:
    """Correlate the last axis with kernel k (valid mode), via stacked
    shifts — XLA fuses this into one elementwise kernel."""
    n = k.shape[0]
    L = x.shape[-1] - n + 1
    acc = jnp.zeros((*x.shape[:-1], L), x.dtype)
    for i in range(n):
        acc = acc + k[i] * jax.lax.dynamic_slice_in_dim(x, i, L, axis=-1)
    return acc


def central_gradients(im: Array) -> tuple:
    """(gx, gy) with central differences, zero on 1-px border.

    NB like the reference's MakeJacs the 0.5 factor is OMITTED
    (ref: src/ImageProcess.cc:170-191).
    """
    gx = jnp.zeros_like(im)
    gy = jnp.zeros_like(im)
    gx = gx.at[..., 1:-1].set(im[..., 2:] - im[..., :-2])
    gy = gy.at[..., 1:-1, :].set(im[..., 2:, :] - im[..., :-2, :])
    return gx, gy


def box_sum(im: Array, radius: int) -> Array:
    """Sum over (2r+1)^2 box via two separable passes (zero padding)."""
    n = 2 * radius + 1
    x = jnp.pad(im, [(0, 0)] * (im.ndim - 2) + [(radius, radius), (0, 0)])
    x = jnp.moveaxis(x, -2, -1)
    x = _running_sum_last(x, n)
    x = jnp.moveaxis(x, -1, -2)
    x = jnp.pad(x, [(0, 0)] * (im.ndim - 2) + [(0, 0), (radius, radius)])
    return _running_sum_last(x, n)


def _running_sum_last(x: Array, n: int) -> Array:
    c = jnp.cumsum(x, axis=-1)
    zero = jnp.zeros_like(c[..., :1])
    c = jnp.concatenate([zero, c], axis=-1)
    return c[..., n:] - c[..., :-n]


def shi_tomasi_score_map(im: Array, half_box: int = 3) -> Array:
    """Dense min-eigenvalue (Shi-Tomasi) score map.

    Exact semantics of ShiTomasiScoreAtPoint (ref: src/ImageProcess.cc:20-47)
    at every pixel at once: central-diff gradients (no 0.5), box-summed
    second-moment matrix over (2*half_box+1)^2, normalized by 2*N, smaller
    eigenvalue returned. Border pixels (where the C++ would read out of
    bounds) are zeroed.
    """
    gx, gy = central_gradients(im)
    dxx = box_sum(gx * gx, half_box)
    dyy = box_sum(gy * gy, half_box)
    dxy = box_sum(gx * gy, half_box)
    n_pixels = float((2 * half_box + 1) ** 2)
    dxx, dyy, dxy = (d / (2.0 * n_pixels) for d in (dxx, dyy, dxy))
    disc = (dxx + dyy) ** 2 - 4.0 * (dxx * dyy - dxy * dxy)
    score = 0.5 * (dxx + dyy - jnp.sqrt(jnp.maximum(disc, 0.0)))
    # Zero the invalid border: gradient needs 1, box needs half_box more.
    b = half_box + 1
    mask = jnp.zeros_like(score, dtype=bool)
    mask = mask.at[..., b:-b, b:-b].set(True)
    return jnp.where(mask, score, 0.0)


def zero_mean(im: Array) -> Array:
    return im - jnp.mean(im, axis=(-2, -1), keepdims=True)


def bilinear_sample(im: Array, xy: Array, pad_value: float = 0.0):
    """Bilinear interpolation of im (H, W) at points xy (..., 2) in
    (x, y) pixel coords. Returns (values, valid) where valid marks samples
    whose 2x2 support lies fully inside the image."""
    H, W = im.shape[-2], im.shape[-1]
    x, y = xy[..., 0], xy[..., 1]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx, fy = x - x0, y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    valid = (x0i >= 0) & (y0i >= 0) & (x0i + 1 <= W - 1) & (y0i + 1 <= H - 1)
    x0c = jnp.clip(x0i, 0, W - 2)
    y0c = jnp.clip(y0i, 0, H - 2)
    v00 = im[y0c, x0c]
    v01 = im[y0c, x0c + 1]
    v10 = im[y0c + 1, x0c]
    v11 = im[y0c + 1, x0c + 1]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    vals = top * (1 - fy) + bot * fy
    return jnp.where(valid, vals, pad_value), valid


def affine_warp_sample(im: Array, center: Array, A: Array, offsets: Array,
                       pad_value: float = 0.0):
    """Sample im at center + A @ offset for a grid of offsets.

    The batched replacement for CVD::transform-based template warping
    (ref: src/PatchFinder.cc:98-127). ``offsets`` is (P, 2) patch coords
    relative to patch center; ``A`` (2, 2); ``center`` (2,) in (x, y).
    Returns (values (P,), valid (P,)).
    """
    pts = center + offsets @ A.T
    return bilinear_sample(im, pts, pad_value)


def patch_offsets(size: int) -> Array:
    """(size*size, 2) offsets relative to the patch center, matching the
    reference's irCenter = size/2 integer convention (ref:
    src/PatchFinder.cc:104-110 loops x,y in [0,size) minus center)."""
    c = size // 2
    ys, xs = jnp.mgrid[0:size, 0:size]
    return jnp.stack([(xs - c).ravel(), (ys - c).ravel()],
                     axis=-1).astype(jnp.float32)


def extract_patch(im: Array, center_xy: Array, size: int,
                  pad_value: float = 0.0):
    """Integer-centered size x size patch around center (x, y).

    Equivalent of GetImageROI (ref: src/ImageProcess.cc:11-18): top-left
    = center - size//2. Returns (patch (size,size), valid scalar).
    """
    H, W = im.shape[-2], im.shape[-1]
    cx = center_xy[0].astype(jnp.int32)
    cy = center_xy[1].astype(jnp.int32)
    x0 = cx - size // 2
    y0 = cy - size // 2
    valid = (x0 >= 0) & (y0 >= 0) & (x0 + size <= W) & (y0 + size <= H)
    x0c = jnp.clip(x0, 0, W - size)
    y0c = jnp.clip(y0, 0, H - size)
    patch = jax.lax.dynamic_slice(im, (y0c, x0c), (size, size))
    return jnp.where(valid, patch, pad_value), valid
