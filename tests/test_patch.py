"""Patch search tests (ref parity: src/PatchFinder.cc)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptam_cg_tpu.ops import patch as patchops


def rng(seed=0):
    return np.random.default_rng(seed)


def test_search_level_selection():
    """det quartering logic (ref: src/PatchFinder.cc:67-84)."""
    # Identity-ish warp at various scales via pixel vectors along axes.
    cam_derivs = jnp.broadcast_to(jnp.eye(2) * 100.0, (4, 2, 2))
    p_cam = jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (4, 1))
    R = jnp.eye(3)
    # scale s => warp = diag(100 s), det = (100 s)^2.
    scales = jnp.array([0.01, 0.02, 0.04, 0.08])  # det = 1, 4, 16, 64
    right = jnp.stack([jnp.array([s, 0, 0]) for s in scales])
    down = jnp.stack([jnp.array([0, s, 0]) for s in scales])
    res = patchops.search_level_and_warp(p_cam, R, right, down, cam_derivs)
    np.testing.assert_array_equal(np.asarray(res.level), [0, 1, 2, 3])
    assert np.all(np.asarray(res.good))


def test_search_level_rejects_degenerate():
    cam_derivs = jnp.broadcast_to(jnp.eye(2) * 100.0, (2, 2, 2))
    p_cam = jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (2, 1))
    R = jnp.eye(3)
    # tiny det (too far) and huge det (too close).
    right = jnp.stack([jnp.array([1e-4, 0, 0]), jnp.array([1.0, 0, 0])])
    down = jnp.stack([jnp.array([0, 1e-4, 0]), jnp.array([0, 1.0, 0])])
    res = patchops.search_level_and_warp(p_cam, R, right, down, cam_derivs)
    assert not np.any(np.asarray(res.good))


def test_inv2x2():
    m = jnp.array([[[2.0, 1.0], [1.0, 3.0]]])
    inv = patchops.inv2x2(m)
    np.testing.assert_allclose(inv[0] @ m[0], np.eye(2), atol=1e-6)


def test_identity_warp_template_matches_source():
    im = rng(1).uniform(0, 255, (32, 32)).astype(np.float32)
    atlases = jnp.asarray(im)[None]
    center = jnp.array([[16.0, 16.0]])
    m2 = jnp.eye(2)[None]
    bounds = jnp.array([[0.0, 0.0, 32.0, 32.0]])
    tmpl, good = patchops.make_warped_templates(
        atlases, jnp.array([0]), center, m2, bounds)
    assert bool(good[0])
    # Template pixel (y,x) samples source at center + (x-4, y-4).
    np.testing.assert_allclose(np.asarray(tmpl[0]), im[12:20, 12:20],
                               atol=1e-4)


def test_scaled_warp_template():
    """2x zoom warp: template covers a 16x16 source area."""
    im = np.zeros((64, 64), np.float32)
    im[::2, :] += 100.0  # horizontal stripes period 2
    atlases = jnp.asarray(im)[None]
    m2 = (jnp.eye(2) * 2.0)[None]
    tmpl, good = patchops.make_warped_templates(
        atlases, jnp.array([0]), jnp.array([[32.0, 32.0]]), m2,
        jnp.array([[0.0, 0.0, 64.0, 64.0]]))
    assert bool(good[0])
    # Sampling every 2nd row of period-2 stripes -> constant template.
    t = np.asarray(tmpl[0])
    assert t.std() < 1e-3


def test_warp_out_of_bounds_flagged():
    atlases = jnp.zeros((1, 32, 32))
    tmpl, good = patchops.make_warped_templates(
        atlases, jnp.array([0]), jnp.array([[2.0, 2.0]]), jnp.eye(2)[None],
        jnp.array([[0.0, 0.0, 32.0, 32.0]]))
    assert not bool(good[0])


def _plant_patch(im, patch, cx, cy):
    P = patch.shape[0]
    im[cy - P // 2: cy + (P + 1) // 2, cx - P // 2: cx + (P + 1) // 2] = patch


def test_ssd_search_finds_planted_patch():
    H = W = 96
    im = rng(2).uniform(0, 50, (H, W)).astype(np.float32)
    patch = rng(3).uniform(100, 255, (8, 8)).astype(np.float32)
    _plant_patch(im, patch, 40, 56)   # x=40, y=56
    cmask = np.zeros((H, W), bool)
    cmask[56, 40] = True              # corner at the planted location
    cmask[30, 30] = True              # decoy corner
    res = patchops.ssd_search(
        jnp.asarray(im), jnp.asarray(cmask), jnp.asarray(patch)[None],
        centers=jnp.array([[37.0, 52.0]]), radius=jnp.array([10.0]),
        bounds=jnp.array([[0.0, 0.0, float(W), float(H)]]),
        r_win=10, max_ssd=8 * 8 * 500.0)
    assert bool(res.found[0])
    np.testing.assert_array_equal(np.asarray(res.pos[0]), [40.0, 56.0])


def test_ssd_search_bf16_cross_parity():
    """bf16 cross-term products must pick the same best candidates as
    f32 on uint8-in-spec imagery (the flag's soundness argument)."""
    H = W = 96
    im = np.round(rng(7).uniform(0, 255, (H, W))).astype(np.float32)
    patch = np.round(rng(8).uniform(0, 255, (8, 8))).astype(np.float32)
    _plant_patch(im, patch, 40, 56)
    cmask = np.ones((H, W), bool)
    args = (jnp.asarray(im), jnp.asarray(cmask), jnp.asarray(patch)[None])
    kw = dict(centers=jnp.array([[37.0, 52.0]]),
              radius=jnp.array([10.0]),
              bounds=jnp.array([[0.0, 0.0, float(W), float(H)]]),
              r_win=10, max_ssd=8 * 8 * 500.0)
    r32 = patchops.ssd_search(*args, **kw)
    r16 = patchops.ssd_search(*args, bf16_cross=True, **kw)
    np.testing.assert_array_equal(np.asarray(r32.pos), np.asarray(r16.pos))
    assert bool(r16.found[0])
    # SSD drift = bf16 product rounding (~0.2% relative, products up to
    # 255^2, 64 accumulations, doubled in the -2*cross term): a few
    # thousand absolute against the 32000 acceptance threshold. The
    # argmin (position) must be exact; the score tolerance is the
    # honest bf16 bound.
    assert abs(float(r32.ssd[0]) - float(r16.ssd[0])) < 4000


def test_ssd_search_zero_mean_invariance():
    """ZMSSD must match a patch under a constant intensity offset."""
    H = W = 64
    im = rng(4).uniform(0, 40, (H, W)).astype(np.float32)
    patch = rng(5).uniform(60, 200, (8, 8)).astype(np.float32)
    _plant_patch(im, np.clip(patch + 40.0, 0, 255), 32, 32)
    cmask = np.zeros((H, W), bool)
    cmask[32, 32] = True
    res = patchops.ssd_search(
        jnp.asarray(im), jnp.asarray(cmask), jnp.asarray(patch)[None],
        centers=jnp.array([[30.0, 30.0]]), radius=jnp.array([8.0]),
        bounds=jnp.array([[0.0, 0.0, float(W), float(H)]]),
        r_win=8, max_ssd=8 * 8 * 500.0, zero_mean=True)
    assert bool(res.found[0])
    np.testing.assert_array_equal(np.asarray(res.pos[0]), [32.0, 32.0])
    # Plain SSD on the same inputs should NOT accept (offset too big).
    res2 = patchops.ssd_search(
        jnp.asarray(im), jnp.asarray(cmask), jnp.asarray(patch)[None],
        centers=jnp.array([[30.0, 30.0]]), radius=jnp.array([8.0]),
        bounds=jnp.array([[0.0, 0.0, float(W), float(H)]]),
        r_win=8, max_ssd=8 * 8 * 500.0, zero_mean=False)
    assert float(res2.ssd[0]) > float(res.ssd[0])


def test_ssd_search_respects_radius_and_corners():
    H = W = 64
    im = np.zeros((H, W), np.float32)
    patch = rng(6).uniform(100, 255, (8, 8)).astype(np.float32)
    _plant_patch(im, patch, 48, 16)
    cmask = np.zeros((H, W), bool)
    cmask[16, 48] = True
    # Predicted center far away: radius excludes the true position.
    res = patchops.ssd_search(
        jnp.asarray(im), jnp.asarray(cmask), jnp.asarray(patch)[None],
        centers=jnp.array([[20.0, 48.0]]), radius=jnp.array([5.0]),
        bounds=jnp.array([[0.0, 0.0, float(W), float(H)]]),
        r_win=8, max_ssd=8 * 8 * 500.0)
    assert not bool(res.found[0])


def test_ssd_search_zmssd_matches_reference_formula():
    """Check the returned score against ZMSSDAtPoint's closed form
    (ref: src/ImageProcess.cc:130-163)."""
    H = W = 48
    im = rng(7).uniform(0, 255, (H, W)).astype(np.float32)
    patch = rng(8).uniform(0, 255, (8, 8)).astype(np.float32)
    cmask = np.zeros((H, W), bool)
    cmask[24, 24] = True
    res = patchops.ssd_search(
        jnp.asarray(im), jnp.asarray(cmask), jnp.asarray(patch)[None],
        centers=jnp.array([[24.0, 24.0]]), radius=jnp.array([2.0]),
        bounds=jnp.array([[0.0, 0.0, float(W), float(H)]]),
        r_win=4, max_ssd=1e12)
    # Reference formula at (24, 24): patch base = pos - 4.
    roi = im[20:28, 20:28].astype(np.float64)
    T = patch.astype(np.float64)
    SA, SB = T.sum(), roi.sum()
    N = 64.0
    expected = ((2 * SA * SB - SA * SA - SB * SB) / N
                + (roi * roi).sum() + (T * T).sum() - 2 * (roi * T).sum())
    np.testing.assert_allclose(float(res.ssd[0]), expected, rtol=1e-3)


def test_subpix_refine_converges_to_subpixel_truth():
    """Plant a smooth patch at a known subpixel offset; IC must find it."""
    H = W = 64
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    true_dx, true_dy = 0.3, -0.2

    def render(dx, dy):
        return (np.sin((xx - dx) * 0.7) * np.cos((yy - dy) * 0.55)
                * 100 + 128).astype(np.float32)

    img = render(true_dx, true_dy)
    tmpl_img = render(0.0, 0.0)
    tmpl = tmpl_img[28:36, 28:36]  # patch center (32, 32)
    res = patchops.subpix_refine(
        jnp.asarray(img), jnp.asarray(tmpl)[None],
        pos0=jnp.array([[32.0, 32.0]]),
        bounds=jnp.array([[0.0, 0.0, float(W), float(H)]]),
        max_its=10)
    assert bool(res.converged[0])
    got = np.asarray(res.pos[0])
    np.testing.assert_allclose(got, [32.0 + true_dx, 32.0 + true_dy],
                               atol=0.05)


def test_subpix_jit_compiles():
    im = jnp.asarray(rng(9).uniform(0, 255, (64, 64)).astype(np.float32))
    tmpl = im[28:36, 28:36][None]
    fn = jax.jit(lambda a, t, p: patchops.subpix_refine(
        a, t, p, jnp.array([[0.0, 0.0, 64.0, 64.0]])))
    res = fn(im, tmpl, jnp.array([[32.0, 32.0]]))
    assert res.pos.shape == (1, 2)


@pytest.mark.parametrize("D", [8, 12, 16])
@pytest.mark.parametrize("width", [256, 200], ids=["banded", "rows"])
def test_gather_windows_rowtake_matches_vmap(D, width):
    """The production window gather (row take + one-hot column dot) is
    exact against the vmapped dynamic_slice reference, on an atlas
    width that takes the 128-wide band path (a multiple of 128) and one
    that takes whole rows; origins past the far edge clip the same way."""
    from ptam_cg_tpu.ops import gather
    Ha = 72
    atlas = jnp.asarray(rng(11).uniform(0, 255, (Ha, width))
                        .astype(np.float32))
    origins = np.stack([rng(12).integers(0, Ha - D + 3, 40),
                        rng(13).integers(0, width - D + 3, 40)], -1)
    # Windows straddling a band boundary, and the far corner.
    origins[:3] = [[5, 128 - D // 2], [0, 127], [Ha - D, width - D]]
    origins = jnp.asarray(origins.astype(np.int32))
    ref = gather.gather_windows_vmap(atlas, origins, D)
    got = gather.gather_windows_rowtake(atlas, origins, D)
    assert got.shape == (40, D, D) and got.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_ssd_search_window_size_invariance():
    """A smaller static window that still covers the radius disc (+1 px
    subpix margin) returns IDENTICAL results — the basis for the
    tracker's fine-stage FINE_R_WIN=11 vs coarse R_WIN=16 split: the
    examined candidate set is radius-bounded, the window is just the
    gathered superset."""
    H = W = 128
    g = rng(7)
    im = g.uniform(0, 255, (H, W)).astype(np.float32)
    cmask = g.uniform(size=(H, W)) < 0.15
    N = 24
    templates = g.uniform(0, 255, (N, 8, 8)).astype(np.float32)
    centers = g.uniform(24, 104, (N, 2)).astype(np.float32)
    radius = g.uniform(3.0, 10.0, N).astype(np.float32)
    bounds = np.tile(np.array([[0.0, 0.0, float(W), float(H)]],
                              np.float32), (N, 1))
    outs = []
    for r_win in (11, 16):
        res = patchops.ssd_search(
            jnp.asarray(im), jnp.asarray(cmask), jnp.asarray(templates),
            jnp.asarray(centers), jnp.asarray(radius),
            jnp.asarray(bounds), r_win=r_win, max_ssd=8 * 8 * 500.0)
        outs.append(res)
    np.testing.assert_array_equal(np.asarray(outs[0].found),
                                  np.asarray(outs[1].found))
    np.testing.assert_array_equal(np.asarray(outs[0].pos),
                                  np.asarray(outs[1].pos))
    # SSD values agree to float noise only: the integral-image cumsums
    # run over different window extents, so the summation order differs.
    np.testing.assert_allclose(np.asarray(outs[0].ssd),
                               np.asarray(outs[1].ssd), rtol=1e-4)


def test_subpix_window_reuse_near_radius():
    """Subpix-reuse behavior for matches AT the search radius (ADVICE r3):
    the reused search window bounds subpix excursion, so the margin at an
    at-radius candidate is ~1 px for r_win=11 vs ~5 px for r_win=16. The
    reference's own subpix contract is <= 1 px of travel
    (src/PatchFinder.cc:249-252), so for in-spec matches (true position
    within ~0.5 px of the found candidate) the small window must converge
    to the same answer as the big one; for deliberately out-of-spec
    matches the small window must DROP the point (converged=False), never
    return an out-of-window position."""
    H = W = 160
    g = rng(21)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)

    def render(dx, dy):
        return (np.sin((xx - dx) * 0.61) * np.cos((yy - dy) * 0.47)
                * 90.0 + 128.0).astype(np.float32)

    radius = 10.0
    # True features sit at EXACTLY the search radius from the predicted
    # centers, plus a subpixel offset: 0.4 px (in-spec) / 2.5 px (out-of-
    # spec travel for the r_win=11 window, fine for 16).
    centers = np.array([[60.0, 60.0], [100.0, 60.0],
                        [60.0, 100.0], [100.0, 100.0]], np.float32)
    sub = np.array([0.4, 0.4, 2.5, 2.5], np.float32)
    dirs = np.array([[1.0, 0.0], [0.0, 1.0],
                     [1.0, 0.0], [0.0, 1.0]], np.float32)
    # Integer candidate exactly AT the radius edge (inside the disc);
    # the true feature lies `sub` px beyond it, so subpix must travel
    # outward by `sub` from the found candidate.
    cand_pos = centers + dirs * radius
    true_pos = cand_pos + dirs * sub[:, None]
    N = centers.shape[0]
    img = render(0.0, 0.0)
    templates = np.stack([
        # Template = image patch at the true (subpixel) position, sampled
        # by re-rendering the analytic image shifted so the patch grid
        # lands on the candidate's integer grid.
        # render(-d) shifts content so template pixel x matches img at
        # x + d: the true match sits OUTWARD of the candidate.
        render(cand_pos[i, 0] - true_pos[i, 0],
               cand_pos[i, 1] - true_pos[i, 1])
        [int(cand_pos[i, 1]) - 4:int(cand_pos[i, 1]) + 4,
         int(cand_pos[i, 0]) - 4:int(cand_pos[i, 0]) + 4]
        for i in range(N)])
    cmask = np.zeros((H, W), bool)
    for i in range(N):
        cmask[int(cand_pos[i, 1]), int(cand_pos[i, 0])] = True
    bounds = np.tile(np.array([[0.0, 0.0, float(W), float(H)]],
                              np.float32), (N, 1))
    out = {}
    for r_win in (11, 16):
        # max_ssd is disabled: a 2.5-px-off template would fail the
        # ZMSSD gate on this high-contrast image, but the subject under
        # test is the subpix window margin, not the gate.
        res, win, origin = patchops.ssd_search(
            jnp.asarray(img), jnp.asarray(cmask), jnp.asarray(templates),
            jnp.asarray(centers), jnp.full((N,), radius, jnp.float32),
            jnp.asarray(bounds), r_win=r_win, max_ssd=1e9,
            return_windows=True)
        assert bool(np.all(np.asarray(res.found))), r_win
        ref = patchops.subpix_refine(
            jnp.asarray(img), jnp.asarray(templates), res.pos,
            jnp.asarray(bounds), max_its=8, windows=win, win_origin=origin)
        out[r_win] = (np.asarray(res.pos), np.asarray(ref.pos),
                      np.asarray(ref.converged))
    # In-spec points (0.4 px subpixel travel): both windows converge and
    # agree with the true position.
    for r_win in (11, 16):
        _, pos, conv = out[r_win]
        assert conv[0] and conv[1], (r_win, conv)
        np.testing.assert_allclose(pos[:2], true_pos[:2], atol=0.2,
                                   err_msg=str(r_win))
    # Out-of-spec points (2.5 px travel needed): the r_win=16 window has
    # margin and may converge; the r_win=11 window must either converge
    # to the true position or report converged=False — silent wrong
    # output is the only failure mode this guards against.
    _, pos11, conv11 = out[11]
    for i in (2, 3):
        if conv11[i]:
            np.testing.assert_allclose(pos11[i], true_pos[i], atol=0.3)
