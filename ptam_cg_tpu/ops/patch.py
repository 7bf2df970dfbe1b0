"""Batched patch search: the engine's hottest path.

Batched re-architecture of PatchFinder (ref: src/PatchFinder.cc). The
reference searches each map point serially: warp an 8x8 template, scan FAST
corners within a radius via a row LUT, score ZMSSD per corner
(SSE-optimized upstream), then iterate inverse-composition sub-pixel
alignment. Here all N points run at once:

1. ``search_level_and_warp`` — vectorized warp matrix + level choice
   (ref: CalcSearchLevelAndWarpMatrix, src/PatchFinder.cc:52-84).
2. ``make_warped_templates`` — bilinear-gather template warps, all points
   in one shot (ref: MakeTemplateCoarseCont, src/PatchFinder.cc:98-127).
3. ``ssd_search`` — *dense windowed* ZMSSD: a static window around each
   predicted position, 8x8 sliding sums via integral images, the cross
   term as P*P shifted multiply-adds, candidates masked by the
   dense FAST-corner mask (the dense-mask equivalent of the corner row
   LUT, ref: FindPatchCoarse src/PatchFinder.cc:160-211).
4. ``subpix_refine`` — batched inverse-composition iterations with the
   3-DoF (x, y, mean-diff) Hessian (ref: MakeSubPixTemplate /
   IterateSubPix, src/PatchFinder.cc:219-318).

All positions here are *atlas* coordinates (see ops/levels.py) unless
noted; conversion to/from level-0 happens at the call site.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ptam_cg_tpu.config import LEVELS, PATCH_SIZE

Array = jax.Array


# ---------------------------------------------------------------------------
# 1. Warp matrix & search level
# ---------------------------------------------------------------------------

class WarpResult(NamedTuple):
    warp_inv: Array   # (N, 2, 2) level-0 pixels per source pixel
    level: Array      # (N,) int32 chosen search level
    good: Array       # (N,) bool — det in [0.25, 3] at chosen level


def search_level_and_warp(p_cam: Array, R_cw: Array, pixel_right_w: Array,
                          pixel_down_w: Array, cam_derivs: Array) -> WarpResult:
    """Vectorized CalcSearchLevelAndWarpMatrix
    (ref: src/PatchFinder.cc:52-84).

    p_cam: (N, 3) point in current camera frame; R_cw: (3, 3) current
    rotation; pixel_right_w/pixel_down_w: (N, 3) world-frame one-pixel
    steps of the source patch (ref: MapPoint::RefreshPixelVectors,
    src/Map.cc:40-65); cam_derivs: (N, 2, 2) projection derivatives.
    """
    z = p_cam[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)

    def col(motion_w):
        m = motion_w @ R_cw.T                     # rotate into camera frame
        v = (m[..., :2] - p_cam[..., :2] * (m[..., 2] * inv_z)[..., None])
        v = v * inv_z[..., None]
        return jnp.einsum("...ij,...j->...i", cam_derivs, v)

    c0 = col(pixel_right_w)
    c1 = col(pixel_down_w)
    warp_inv = jnp.stack([c0, c1], axis=-1)       # columns like the ref
    det = c0[..., 0] * c1[..., 1] - c0[..., 1] * c1[..., 0]
    # level = number of quarterings needed to bring det <= 3, capped.
    scaled = det[..., None] * (0.25 ** jnp.arange(LEVELS, dtype=jnp.float32))
    level = jnp.minimum(jnp.sum((scaled > 3.0).astype(jnp.int32), axis=-1),
                        LEVELS - 1)
    det_at = jnp.take_along_axis(scaled, level[..., None],
                                 axis=-1)[..., 0]
    good = (det_at <= 3.0) & (det_at >= 0.25)
    return WarpResult(warp_inv=warp_inv, level=level, good=good)


def inv3x3(m: Array) -> Array:
    """Batched closed-form (adjugate) 3x3 inverse — avoids the LU
    custom-call for the tiny systems in subpix/BA."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    adj = jnp.stack([
        jnp.stack([A, -(b * i - c * h), b * f - c * e], -1),
        jnp.stack([B, a * i - c * g, -(a * f - c * d)], -1),
        jnp.stack([C, -(a * h - b * g), a * e - b * d], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def inv2x2(m: Array) -> Array:
    """Batched 2x2 inverse (ref: cg::Tools::M2Inverse, include/Tools.h:54-66)."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    return (jnp.stack([
        jnp.stack([d, -b], axis=-1),
        jnp.stack([-c, a], axis=-1)], axis=-2) * inv_det[..., None, None])


# ---------------------------------------------------------------------------
# 2. Warped template generation
# ---------------------------------------------------------------------------

def _patch_grid(patch_size: int) -> Array:
    """(P*P, 2) (x, y) offsets from the integer patch center (P//2, P//2)."""
    c = patch_size // 2
    ys, xs = jnp.mgrid[0:patch_size, 0:patch_size]
    return jnp.stack([(xs - c).ravel(), (ys - c).ravel()],
                     axis=-1).astype(jnp.float32)


def make_warped_templates_flat(kf_atlases: Array, kf_idx: Array,
                               src_center: Array, m2: Array,
                               src_bounds: Array,
                               patch_size: int = PATCH_SIZE) -> tuple:
    """Warp templates via flat-index bilinear gathers (fallback/reference
    formulation: four per-sample corner takes). See
    ``make_warped_templates`` for the production path.
    """
    offsets = _patch_grid(patch_size)               # (P*P, 2)
    pts = src_center[:, None, :] + jnp.einsum(
        "nij,pj->npi", m2, offsets)                 # (N, P*P, 2)

    K, Ha, Wa = kf_atlases.shape
    flat = kf_atlases.reshape(-1)
    x = pts[..., 0]
    y = pts[..., 1]
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    x0c = jnp.clip(x0, 0, Wa - 2)
    y0c = jnp.clip(y0, 0, Ha - 2)
    base = kf_idx[:, None] * (Ha * Wa) + y0c * Wa + x0c
    v00 = jnp.take(flat, base)
    v01 = jnp.take(flat, base + 1)
    v10 = jnp.take(flat, base + Wa)
    v11 = jnp.take(flat, base + Wa + 1)
    vals = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)   # (N, P*P)
    vals = vals.astype(jnp.float32)   # bf16 atlases convert on output
    inside = ((pts[..., 0] >= src_bounds[:, None, 0]) &
              (pts[..., 1] >= src_bounds[:, None, 1]) &
              (pts[..., 0] <= src_bounds[:, None, 2] - 1.0) &
              (pts[..., 1] <= src_bounds[:, None, 3] - 1.0))
    good = jnp.all(inside, axis=-1)
    return vals.reshape(-1, patch_size, patch_size), good


def make_warped_templates(kf_atlases: Array, kf_idx: Array,
                          src_center: Array, m2: Array,
                          src_bounds: Array,
                          patch_size: int = PATCH_SIZE,
                          window: int = 28) -> tuple:
    """Warp templates for all points at once.

    kf_atlases: (K, Ha, Wa) keyframe pyramid atlases; kf_idx: (N,) source
    KF per point; src_center: (N, 2) source patch center in atlas coords;
    m2: (N, 2, 2) source pixels per template pixel (= inv(warp_inv) *
    2^level, ref: src/PatchFinder.cc:104); src_bounds: (N, 4) atlas-coord
    (x0, y0, x1, y1) of the source *level* rect, to detect out-of-level
    samples (the ref's nOutside check).

    Strategy: gather ONE (window, window) neighborhood per point
    around the source center (vectorized row gather + column dot), then
    evaluate all P*P bilinear samples INSIDE the window with separable
    one-hot interpolation dots — no per-sample gathers.
    Warps whose samples leave the window (per-axis extent >
    (window/2 − 2)/(patch/2), i.e. extreme anisotropy the det∈[0.25,3]
    gate admits but the reference would also warp poorly) are flagged
    not-good, like the reference's nOutside check
    (ref: MakeTemplateCoarseCont, src/PatchFinder.cc:98-127).

    Returns (templates (N, P, P), good (N,)).
    """
    from ptam_cg_tpu.ops.gather import gather_windows

    offsets = _patch_grid(patch_size)               # (P*P, 2)
    pts = src_center[:, None, :] + jnp.einsum(
        "nij,pj->npi", m2, offsets)                 # (N, P*P, 2) x,y

    K, Ha, Wa = kf_atlases.shape
    S = min(window, Ha, Wa)
    flat_rows = kf_atlases.reshape(K * Ha, Wa)
    c = jnp.round(src_center).astype(jnp.int32)     # (N, 2) x,y
    ox = jnp.clip(c[:, 0] - S // 2, 0, Wa - S)
    oy_lvl = jnp.clip(c[:, 1] - S // 2, 0, Ha - S)
    oy = kf_idx * Ha + oy_lvl
    win = gather_windows(flat_rows, jnp.stack([oy, ox], -1), S)

    lx = pts[..., 0] - ox[:, None].astype(jnp.float32)
    ly = pts[..., 1] - oy_lvl[:, None].astype(jnp.float32)
    x0 = jnp.floor(lx).astype(jnp.int32)
    y0 = jnp.floor(ly).astype(jnp.int32)
    fx = lx - x0
    fy = ly - y0
    in_win = (x0 >= 0) & (y0 >= 0) & (x0 <= S - 2) & (y0 <= S - 2)
    x0c = jnp.clip(x0, 0, S - 2)
    y0c = jnp.clip(y0, 0, S - 2)

    ii = jnp.arange(S, dtype=jnp.int32)
    wy = ((ii == y0c[..., None]).astype(win.dtype) * (1 - fy)[..., None]
          + (ii == y0c[..., None] + 1).astype(win.dtype) * fy[..., None])
    # Explicit DEFAULT precision: image values x two-hot bilinear
    # weights, whose reduced-precision rounding (TF32 on the GPU) stays
    # inside the ZMSSD margins; this dot opts out of the tracker's
    # pinned-f32 program on purpose.
    t1 = jnp.einsum("nps,nsc->npc", wy, win,
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.DEFAULT)  # (N, P*P, S)
    wx = ((ii == x0c[..., None]).astype(win.dtype) * (1 - fx)[..., None]
          + (ii == x0c[..., None] + 1).astype(win.dtype) * fx[..., None])
    vals = jnp.sum(wx * t1, axis=-1)                 # (N, P*P)

    inside = ((pts[..., 0] >= src_bounds[:, None, 0]) &
              (pts[..., 1] >= src_bounds[:, None, 1]) &
              (pts[..., 0] <= src_bounds[:, None, 2] - 1.0) &
              (pts[..., 1] <= src_bounds[:, None, 3] - 1.0))
    good = jnp.all(inside & in_win, axis=-1)
    return vals.reshape(-1, patch_size, patch_size), good


# ---------------------------------------------------------------------------
# 3. Dense windowed ZMSSD / SSD search
# ---------------------------------------------------------------------------

class SearchResult(NamedTuple):
    pos: Array      # (N, 2) float atlas coords of best integer candidate
    ssd: Array      # (N,) best score
    found: Array    # (N,) bool


def _integral_window_sums(win: Array, patch_size: int) -> Array:
    """8x8 (patch_size^2) block sums at every top-left of win (N, D, D)
    -> (N, D-P+1, D-P+1) via 2-D integral images."""
    ii = jnp.cumsum(jnp.cumsum(win, axis=-1), axis=-2)
    ii = jnp.pad(ii, [(0, 0), (1, 0), (1, 0)])
    P = patch_size
    return (ii[:, P:, P:] - ii[:, P:, :-P] - ii[:, :-P, P:]
            + ii[:, :-P, :-P])


def ssd_search(atlas: Array, corner_mask: Array, templates: Array,
               centers: Array, radius: Array, bounds: Array, *,
               r_win: int, max_ssd: float, zero_mean: bool = True,
               require_corner: bool = True,
               patch_size: int = PATCH_SIZE,
               return_windows: bool = False,
               bf16_cross: bool = False):
    """Batched windowed (ZM)SSD search.

    atlas: (Ha, Wa) current-frame pyramid atlas; corner_mask: (Ha, Wa)
    bool FAST-corner mask; templates: (N, P, P); centers: (N, 2) predicted
    positions (atlas float coords); radius: (N,) search radius in level
    pixels (value-level — the static window is r_win); bounds: (N, 4)
    (x0, y0, x1, y1) level rect per point.

    ZMSSD formula matches ImageProcess::ZMSSDAtPoint exactly
    (ref: src/ImageProcess.cc:130-163).

    INVARIANT: the examined window is ``r_win``-bounded regardless of the
    value-level ``radius`` — a radius > r_win would be silently truncated.
    Callers must guarantee radius <= r_win (the tracker validates its
    config via ``models.tracker.validate_config``).
    """
    N = templates.shape[0]
    P = patch_size
    ph = P // 2
    D = 2 * r_win + P                 # window side
    M = 2 * r_win + 1                 # candidate-map side
    Ha, Wa = atlas.shape

    from ptam_cg_tpu.ops.gather import gather_windows

    base = jnp.round(centers).astype(jnp.int32)           # (N, 2) x,y
    origin_x = jnp.clip(base[:, 0] - r_win - ph, 0, Wa - D)
    origin_y = jnp.clip(base[:, 1] - r_win - ph, 0, Ha - D)

    win = gather_windows(atlas, jnp.stack([origin_y, origin_x], -1), D)
    cmask = gather_windows(
        corner_mask.astype(jnp.float32),
        jnp.stack([origin_y + ph, origin_x + ph], -1), M) > 0.5

    # Sliding sums of image and image^2 (integral images).
    SA_t = jnp.sum(templates, axis=(-2, -1))               # template sum
    SSQ_t = jnp.sum(templates * templates, axis=(-2, -1))
    S_img = _integral_window_sums(win, P)                  # (N, M, M)
    SSQ_img = _integral_window_sums(win * win, P)

    # Cross term: per-point correlation as P*P shifted multiply-adds
    # (a grouped conv with N groups is the alternative formulation).
    # bf16_cross: image values are uint8-in-spec (integers <= 255, exact
    # in bf16's 8-bit mantissa), so the products are computed in bf16 —
    # halved element width — and only ACCUMULATED in f32. Worst-case
    # product rounding is ~0.4%, well inside the ZMSSD decision margins
    # (same in-spec argument as the one-hot gather dots; CLAUDE.md).
    if bf16_cross:
        t16 = templates.astype(jnp.bfloat16)
        w16 = win.astype(jnp.bfloat16)
        cross = jnp.zeros((N, M, M), jnp.float32)
        for dy in range(P):
            for dx in range(P):
                cross = cross + (t16[:, dy, dx][:, None, None]
                                 * w16[:, dy: dy + M, dx: dx + M]
                                 ).astype(jnp.float32)
    else:
        cross = jnp.zeros((N, M, M), win.dtype)
        for dy in range(P):
            for dx in range(P):
                cross = cross + (templates[:, dy, dx][:, None, None]
                                 * win[:, dy: dy + M, dx: dx + M])

    npix = float(P * P)
    if zero_mean:
        ssd = ((2.0 * SA_t[:, None, None] * S_img
                - SA_t[:, None, None] ** 2 - S_img * S_img) / npix
               + SSQ_img + SSQ_t[:, None, None] - 2.0 * cross)
    else:
        ssd = SSQ_img + SSQ_t[:, None, None] - 2.0 * cross

    # Candidate positions: patch centers in atlas coords.
    gx = jax.lax.broadcasted_iota(jnp.int32, (M, M), 1)
    gy = jax.lax.broadcasted_iota(jnp.int32, (M, M), 0)
    pos_x = origin_x[:, None, None] + gx + ph              # (N, M, M)
    pos_y = origin_y[:, None, None] + gy + ph

    dx = pos_x.astype(jnp.float32) - centers[:, 0, None, None]
    dy = pos_y.astype(jnp.float32) - centers[:, 1, None, None]
    in_radius = dx * dx + dy * dy <= (radius ** 2)[:, None, None]
    # Patch (+1 border for subpix) must stay inside the level rect.
    b = ph + 1
    in_level = ((pos_x.astype(jnp.float32) - b >= bounds[:, None, None, 0]) &
                (pos_y.astype(jnp.float32) - b >= bounds[:, None, None, 1]) &
                (pos_x.astype(jnp.float32) + b <= bounds[:, None, None, 2]) &
                (pos_y.astype(jnp.float32) + b <= bounds[:, None, None, 3]))
    ok = in_radius & in_level
    if require_corner:
        ok = ok & cmask

    big = jnp.float32(3.4e38)
    ssd = jnp.where(ok, ssd, big)
    flat = ssd.reshape(N, -1)
    best = jnp.argmin(flat, axis=-1)
    best_ssd = jnp.take_along_axis(flat, best[:, None], axis=-1)[:, 0]
    bx = jnp.take_along_axis(pos_x.reshape(N, -1), best[:, None],
                             axis=-1)[:, 0]
    by = jnp.take_along_axis(pos_y.reshape(N, -1), best[:, None],
                             axis=-1)[:, 0]
    found = best_ssd < max_ssd
    pos = jnp.stack([bx, by], axis=-1).astype(jnp.float32)
    result = SearchResult(pos=pos, ssd=best_ssd, found=found)
    if return_windows:
        origin = jnp.stack([origin_x, origin_y], -1).astype(jnp.float32)
        return result, win, origin
    return result


# ---------------------------------------------------------------------------
# 4. Inverse-composition sub-pixel refinement
# ---------------------------------------------------------------------------

class SubPixResult(NamedTuple):
    pos: Array        # (N, 2) refined atlas coords
    converged: Array  # (N,) bool


MARGIN = 3      # subpix excursion allowance in the local window (px)


def subpix_refine(atlas: Array, templates: Array, pos0: Array,
                  bounds: Array, *, max_its: int = 10,
                  conv_limit: float = 0.03,
                  patch_size: int = PATCH_SIZE,
                  windows: Array | None = None,
                  win_origin: Array | None = None) -> SubPixResult:
    """Batched inverse-composition alignment
    (ref: MakeSubPixTemplate + IterateSubPix, src/PatchFinder.cc:219-318).

    3 DoF per point: (x, y, mean difference). Jacobians/Hessian come from
    the *template* (inverse composition), so they're computed once.

    Gather strategy: each point's neighborhood is sliced from the atlas
    ONCE into a local window; every iteration then uses the reference's
    shared-mixing-fraction trick (all patch pixels share one bilinear
    fraction, ref: src/PatchFinder.cc:283-296) so resampling is four
    shifted static slices of the window — no per-pixel gathers. The
    window margin bounds the total excursion (the reference likewise
    declares sub-pix "should never travel more than a pixel",
    src/PatchFinder.cc:249-252).
    """
    N = templates.shape[0]
    P = patch_size
    ph = P // 2

    # Template gradients on the interior (P-2)x(P-2), WITH the 0.5 factor
    # (ref: src/PatchFinder.cc:226-229).
    gx = 0.5 * (templates[:, 1:-1, 2:] - templates[:, 1:-1, :-2])
    gy = 0.5 * (templates[:, 2:, 1:-1] - templates[:, :-2, 1:-1])
    ones = jnp.ones_like(gx)
    J = jnp.stack([gx, gy, ones], axis=-1).reshape(N, -1, 3)  # (N, Q, 3)
    H = jnp.einsum("nqi,nqj->nij", J, J)
    Hinv = inv3x3(H + 1e-9 * jnp.eye(3))

    t_interior = templates[:, 1:-1, 1:-1]                     # (N, P-2, P-2)

    Ha, Wa = atlas.shape
    if windows is not None:
        # Reuse caller-provided windows (e.g. the ZMSSD search windows —
        # the best candidate always lies inside them).
        win = windows
        D = win.shape[-1]
        origin = jnp.asarray(win_origin, jnp.float32)
    else:
        D = P + 2 * MARGIN + 1  # local window side (+1 for bilinear)
        # One window per point around the rounded start position.
        c0 = jnp.round(pos0).astype(jnp.int32)                # (N, 2) x,y
        org_x = jnp.clip(c0[:, 0] - ph - MARGIN, 0, Wa - D)
        org_y = jnp.clip(c0[:, 1] - ph - MARGIN, 0, Ha - D)
        from ptam_cg_tpu.ops.gather import gather_windows
        win = gather_windows(atlas, jnp.stack([org_y, org_x], -1), D)
        origin = jnp.stack([org_x, org_y], -1).astype(jnp.float32)

    Q = P - 2

    def body(_, state):
        pos, mean_diff, conv, failed = state
        in_im = ((pos[:, 0] - ph - 1 >= bounds[:, 0]) &
                 (pos[:, 1] - ph - 1 >= bounds[:, 1]) &
                 (pos[:, 0] + ph + 1 <= bounds[:, 2]) &
                 (pos[:, 1] + ph + 1 <= bounds[:, 3]))
        # Patch top-left in window coords; interior starts at +1.
        base = pos - ph - origin                              # (N, 2)
        ib = jnp.floor(base).astype(jnp.int32)
        frac = base - ib
        in_win = ((ib[:, 0] >= 0) & (ib[:, 1] >= 0)
                  & (ib[:, 0] + P + 1 <= D) & (ib[:, 1] + P + 1 <= D))
        failed = failed | ~in_im | ~in_win
        ibc_x = jnp.clip(ib[:, 0], 0, D - P - 1)
        ibc_y = jnp.clip(ib[:, 1], 0, D - P - 1)

        # Per-point integer re-basing WITHOUT dynamic slicing (a
        # vmapped dynamic_slice can lower to a serial loop of slices).
        # The integer base is bounded by the window, so select it with a
        # SEPARABLE one-hot blend over static shifts, rows then
        # columns.
        n_off = D - P
        Sq = Q + 1
        oy_oh = jax.nn.one_hot(ibc_y, n_off, dtype=win.dtype)  # (N, n_off)
        ox_oh = jax.nn.one_hot(ibc_x, n_off, dtype=win.dtype)
        rows = jnp.zeros((N, Sq + 1, D), win.dtype)
        for oy in range(n_off):
            rows = rows + oy_oh[:, oy][:, None, None] * jax.lax.slice(
                win, (0, oy + 1, 0), (N, oy + 1 + Sq + 1, D))
        S1 = jnp.zeros((N, Sq + 1, Sq + 1), win.dtype)
        for ox in range(n_off):
            S1 = S1 + ox_oh[:, ox][:, None, None] * jax.lax.slice(
                rows, (0, 0, ox + 1), (N, Sq + 1, ox + 1 + Sq + 1))
        fx = frac[:, 0][:, None, None]
        fy = frac[:, 1][:, None, None]
        # Shared-fraction bilinear of the (P-2)x(P-2) interior: S1 holds
        # win[ib + 1 + (0..Q, 0..Q)] so interior sample (i, j) blends
        # S1[i, j], S1[i, j+1], S1[i+1, j], S1[i+1, j+1].
        cur = ((1 - fx) * (1 - fy) * S1[:, :Q, :Q]
               + fx * (1 - fy) * S1[:, :Q, 1:Q + 1]
               + (1 - fx) * fy * S1[:, 1:Q + 1, :Q]
               + fx * fy * S1[:, 1:Q + 1, 1:Q + 1])           # (N, Q, Q)
        diff = (cur - t_interior + mean_diff[:, None, None]) \
            .reshape(N, -1)
        accum = jnp.einsum("nq,nqi->ni", diff, J)             # (N, 3)
        upd = jnp.einsum("nij,nj->ni", Hinv, accum)
        active = ~(conv | failed)
        pos = jnp.where(active[:, None], pos - upd[:, :2], pos)
        mean_diff = jnp.where(active, mean_diff - upd[:, 2], mean_diff)
        step_sq = jnp.sum(upd[:, :2] ** 2, axis=-1)
        conv = conv | (active & (step_sq < conv_limit * conv_limit))
        return pos, mean_diff, conv, failed

    # while_loop with an all-settled early exit (EXACT parity with the
    # fixed fori_loop: settled points take no further updates, so the
    # skipped iterations are no-ops). Typical frames settle in 2-4
    # iterations of the 8 allowed.
    def loop_cond(state):
        it, _, _, conv, failed = state
        return (it < max_its) & ~jnp.all(conv | failed)

    def loop_body(state):
        it, pos, mean_diff, conv, failed = state
        pos, mean_diff, conv, failed = body(
            it, (pos, mean_diff, conv, failed))
        return it + 1, pos, mean_diff, conv, failed

    init = (jnp.int32(0), pos0, jnp.zeros(N, jnp.float32),
            jnp.zeros(N, bool), jnp.zeros(N, bool))
    _, pos, _, conv, failed = jax.lax.while_loop(loop_cond, loop_body,
                                                 init)
    return SubPixResult(pos=pos, converged=conv & ~failed)
