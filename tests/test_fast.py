"""FAST-10 detector tests: exact parity with a brute-force reference
implementation of the segment test (the algorithm libCVD implements,
ref usage: src/KeyFrame.cc:35-42)."""

import jax.numpy as jnp
import numpy as np
import pytest

from ptam_cg_tpu.ops import fast as fastops

CIRCLE = fastops.CIRCLE


def brute_force_fast10(im, t):
    """Reference segment test: >=10 contiguous circle pixels all brighter
    than c+t or all darker than c-t."""
    H, W = im.shape
    out = np.zeros((H, W), bool)
    for y in range(3, H - 3):
        for x in range(3, W - 3):
            c = im[y, x]
            ring = np.array([im[y + dy, x + dx] for dx, dy in CIRCLE])
            for cmp_vals in (ring > c + t, ring < c - t):
                ext = np.concatenate([cmp_vals, cmp_vals[:9]])
                run = 0
                for v in ext:
                    run = run + 1 if v else 0
                    if run >= 10:
                        out[y, x] = True
                        break
                if out[y, x]:
                    break
    return out


def test_fast_matches_brute_force_random():
    im = np.random.default_rng(0).uniform(0, 255, (32, 32)).astype(np.float32)
    got, _ = fastops.fast_score_map(jnp.asarray(im), 20.0)
    expected = brute_force_fast10(im, 20.0)
    np.testing.assert_array_equal(np.asarray(got), expected)


def test_fast_detects_square_corner():
    im = np.zeros((24, 24), np.float32)
    im[8:16, 8:16] = 200.0
    got, score = fastops.fast_score_map(jnp.asarray(im), 20.0)
    got = np.asarray(got)
    expected = brute_force_fast10(im, 20.0)
    np.testing.assert_array_equal(got, expected)
    assert got.sum() > 0              # square corners found
    assert not got[4, 4]              # flat region empty
    assert not got[12, 12]            # inside the square: flat


def test_fast_no_corners_on_flat():
    im = jnp.full((16, 16), 100.0)
    got, score = fastops.fast_score_map(im, 10.0)
    assert not bool(jnp.any(got))
    np.testing.assert_allclose(score, 0.0)


def test_nonmax_reduces_and_keeps_peak():
    im = np.zeros((24, 24), np.float32)
    im[8:16, 8:16] = 200.0
    mask, score = fastops.fast_score_map(jnp.asarray(im), 20.0)
    keep = fastops.nonmax_3x3(score) & mask
    assert int(jnp.sum(keep)) <= int(jnp.sum(mask))
    assert int(jnp.sum(keep)) > 0


def test_corners_from_mask_topk():
    mask = np.zeros((16, 16), bool)
    score = np.zeros((16, 16), np.float32)
    pts = [(3, 4, 10.0), (8, 9, 30.0), (12, 2, 20.0)]
    for y, x, s in pts:
        mask[y, x] = True
        score[y, x] = s
    c = fastops.corners_from_mask(jnp.asarray(mask), jnp.asarray(score), 2)
    assert int(c.count) == 2
    # Strongest two kept: (9,8) then (2,12) in (x,y).
    np.testing.assert_array_equal(np.asarray(c.xy[0]), [9, 8])
    np.testing.assert_array_equal(np.asarray(c.xy[1]), [2, 12])


def test_corners_capacity_padding():
    mask = np.zeros((8, 8), bool)
    mask[4, 4] = True
    score = np.full((8, 8), 5.0, np.float32)
    c = fastops.corners_from_mask(jnp.asarray(mask), jnp.asarray(score), 4)
    assert int(c.count) == 1
    assert list(np.asarray(c.valid)) == [True, False, False, False]
    np.testing.assert_array_equal(np.asarray(c.xy[1]), [-1, -1])


def test_detect_full_pipeline():
    im = np.random.default_rng(1).uniform(0, 255, (48, 64)).astype(np.float32)
    mask, score, corners = fastops.detect(jnp.asarray(im), 15.0, 128)
    n = int(corners.count)
    assert 0 < n <= 128
    # All reported corners are on mask positions.
    m = np.asarray(mask)
    for i in range(n):
        x, y = np.asarray(corners.xy[i])
        assert m[y, x]


def shi_tomasi_reference(im, half_box, x, y):
    """Transcription of ShiTomasiScoreAtPoint (ref:
    src/ImageProcess.cc:20-47): central differences without the 0.5,
    second moments over the (2*half_box+1)^2 box, each divided by
    2 * nPixels, smaller eigenvalue of the 2x2 matrix — in float64."""
    dxx = dyy = dxy = 0.0
    for yy in range(y - half_box, y + half_box + 1):
        for xx in range(x - half_box, x + half_box + 1):
            dx = float(im[yy, xx + 1]) - float(im[yy, xx - 1])
            dy = float(im[yy + 1, xx]) - float(im[yy - 1, xx])
            dxx += dx * dx
            dyy += dy * dy
            dxy += dx * dy
    n_pixels = (2 * half_box + 1) ** 2
    dxx /= 2.0 * n_pixels
    dyy /= 2.0 * n_pixels
    dxy /= 2.0 * n_pixels
    return 0.5 * (dxx + dyy - np.sqrt((dxx + dyy) * (dxx + dyy)
                                      - 4 * (dxx * dyy - dxy * dxy)))


@pytest.mark.parametrize("half_box", [1, 2, 3])
def test_shi_tomasi_matches_reference_transcription(half_box):
    """Dense Shi-Tomasi map == the reference's per-point score at every
    pixel where the reference reads inside the image; zero on the
    border it cannot score."""
    from ptam_cg_tpu.ops import image as imageops
    im = np.random.default_rng(7 + half_box).integers(
        0, 256, (24, 32)).astype(np.float32)
    got = np.asarray(imageops.shi_tomasi_score_map(jnp.asarray(im),
                                                   half_box=half_box))
    b = half_box + 1
    H, W = im.shape
    ref = np.zeros((H, W))
    for y in range(b, H - b):
        for x in range(b, W - b):
            ref[y, x] = shi_tomasi_reference(im, half_box, x, y)
    # float32 box sums (running-sum differences) against float64.
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=0.05)
    assert np.all(got[:b] == 0) and np.all(got[:, :b] == 0)


def test_tiled_corner_selection():
    mask = np.zeros((16, 16), bool)
    score = np.zeros((16, 16), np.float32)
    # Two corners in the same 2x2 tile: only the stronger survives.
    mask[4, 4] = mask[4, 5] = True
    score[4, 4] = 5.0
    score[4, 5] = 9.0
    mask[8, 12] = True
    score[8, 12] = 7.0
    c = fastops.corners_from_mask(jnp.asarray(mask), jnp.asarray(score),
                                  8, tile=2)
    assert int(c.count) == 2
    got = {tuple(xy) for xy in np.asarray(c.xy[:2])}
    assert got == {(5, 4), (12, 8)}
