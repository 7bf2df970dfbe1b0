"""bfloat16 atlas path parity (VERDICT r1 #6): match positions and pose
must not drift meaningfully vs the float32 path — the reference's image
precision is uint8, so bf16's ~0.5-graylevel rounding is within spec."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptam_cg_tpu.config import FrontendConfig
from ptam_cg_tpu.io import synth
from ptam_cg_tpu.models import keyframe
from ptam_cg_tpu.ops import patch as patchops
from ptam_cg_tpu.ops.gather import gather_windows

REF_PARAMS = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)
SIZE = (320, 240)


def test_gather_windows_bf16_outputs_f32_and_matches():
    rng = np.random.default_rng(0)
    atlas = rng.uniform(0, 255, (360, 320)).astype(np.float32)
    origins = np.stack([rng.integers(0, 300, 64),
                        rng.integers(0, 280, 64)], -1).astype(np.int32)
    w32 = gather_windows(jnp.asarray(atlas), jnp.asarray(origins), 16)
    wb = gather_windows(jnp.asarray(atlas, jnp.bfloat16),
                        jnp.asarray(origins), 16)
    assert w32.dtype == jnp.float32 and wb.dtype == jnp.float32
    # bf16 rounds each gray value to <= 0.5 levels at 255 scale.
    assert float(jnp.max(jnp.abs(w32 - wb))) <= 1.0


def test_ssd_search_bf16_match_position_parity():
    """Windowed ZMSSD over a bf16 atlas finds the same integer match as
    float32 for (almost) every point."""
    rng = np.random.default_rng(1)
    atlas = rng.uniform(0, 255, (240, 320)).astype(np.float32)
    corner_mask = jnp.ones((240, 320), bool)
    N = 128
    cx = rng.integers(24, 296, N)
    cy = rng.integers(24, 216, N)
    # Templates cut from the true atlas a few pixels off-center.
    tmpl = np.stack([atlas[y - 2 - 4:y - 2 + 4, x + 3 - 4:x + 3 + 4]
                     for x, y in zip(cx, cy)])
    centers = jnp.asarray(np.stack([cx, cy], -1), jnp.float32)
    radius = jnp.full(N, 8.0)
    bounds = jnp.broadcast_to(jnp.asarray([0., 0., 320., 240.]), (N, 4))

    kw = dict(r_win=8, max_ssd=8 * 8 * 500.0)
    r32 = patchops.ssd_search(jnp.asarray(atlas), corner_mask,
                              jnp.asarray(tmpl), centers, radius, bounds,
                              **kw)
    rb = patchops.ssd_search(jnp.asarray(atlas, jnp.bfloat16),
                             corner_mask, jnp.asarray(tmpl), centers,
                             radius, bounds, **kw)
    f32 = np.asarray(r32.found)
    fb = np.asarray(rb.found)
    assert f32.mean() > 0.9
    same = (np.asarray(r32.pos) == np.asarray(rb.pos)).all(-1)
    agree = (same & f32 & fb).sum() / max((f32 & fb).sum(), 1)
    assert agree >= 0.98, agree


@pytest.mark.slow
def test_track_map_bf16_pose_parity():
    """Full track_map on a bf16-atlas frame+map: pose within tight bounds
    of the f32 result on the synthetic scene."""
    from ptam_cg_tpu.utils import se3 as se3lib

    seq = synth.SyntheticSequence(REF_PARAMS, image_size=SIZE, n_frames=4,
                                  seed=3, height=1.5, radius=0.12,
                                  sweep=0.6)
    # Build the same GT map twice, one with bf16 atlases.
    outs = {}
    for bf16 in (False, True):
        cfg = FrontendConfig(atlas_bf16=bf16)
        f0 = seq.frame(0)
        ff0 = keyframe.build_frame(f0, cfg, candidate_min_score=100.0)
        from ptam_cg_tpu.models import map_state, tracker
        m = map_state.empty_map(
            SIZE, max_points=512, max_kfs=4,
            atlas_dtype=jnp.bfloat16 if bf16 else jnp.float32)
        m = map_state.insert_keyframe(m, 0, ff0, seq.pose(0), 1.5, 0.1)
        # GT points on the plane from candidates (same recipe as the
        # tracker fixture, trimmed).
        W, H = SIZE
        from ptam_cg_tpu.camera import atan
        from ptam_cg_tpu.ops import levels as levelops
        T_wc = se3lib.inv(seq.pose(0))
        pts, centers, lv_l = [], [], []
        cand_xy = np.asarray(ff0.cand_xy)
        cand_valid = np.asarray(ff0.cand_valid)
        for lev in range(4):
            for (x, y) in cand_xy[lev][cand_valid[lev]][:120]:
                p0 = np.asarray(levelops.level_zero_pos(
                    jnp.array([float(x), float(y)]), lev))
                z1 = np.asarray(atan.unproject(
                    jnp.asarray(p0, jnp.float32), seq.cam))
                d = np.asarray(T_wc.R) @ np.array([z1[0], z1[1], 1.0])
                o = np.asarray(T_wc.t)
                s = -o[2] / d[2]
                if s <= 0:
                    continue
                pts.append(o + s * d)
                centers.append([float(x), float(y)])
                lv_l.append(lev)
        n = len(pts)
        P = 512
        pos = np.zeros((P, 3), np.float32)
        pos[:n] = np.stack(pts)
        ctr = np.zeros((P, 2), np.float32)
        ctr[:n] = np.stack(centers)
        lv = np.zeros(P, np.int32)
        lv[:n] = np.array(lv_l)
        c_nc, r_nc, d_nc, nrm = map_state.make_point_rays(
            jnp.asarray(ctr), jnp.asarray(lv), seq.pose(0), seq.cam, SIZE)
        m = m._replace(
            point_pos=jnp.asarray(pos),
            point_valid=jnp.asarray(np.arange(P) < n),
            point_src_level=jnp.asarray(lv), point_center=jnp.asarray(ctr),
            point_center_nc=c_nc, point_right_nc=r_nc, point_down_nc=d_nc,
            point_normal_nc=nrm, good=jnp.asarray(True))
        m = map_state.refresh_pixel_vectors(m)

        ff1 = keyframe.build_frame(seq.frame(1), cfg,
                                   candidate_min_score=100.0)
        res = tracker.track_map(m, ff1, seq.pose(1), seq.cam, SIZE,
                                jax.random.PRNGKey(1), jnp.float32(0.0),
                                jnp.asarray(False))
        outs[bf16] = res

    r0, r1 = outs[False], outs[True]
    n0 = int(np.asarray(r0.meas_valid).sum())
    n1 = int(np.asarray(r1.meas_valid).sum())
    assert n1 > 0.9 * n0, (n0, n1)
    # Pose agreement.
    dR = np.asarray(r0.pose.R) @ np.asarray(r1.pose.R).T
    ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
    assert ang < 2e-3, ang
    assert np.linalg.norm(np.asarray(r0.pose.t)
                          - np.asarray(r1.pose.t)) < 2e-3
    # Found positions: overwhelmingly within half a pixel.
    both = np.asarray(r0.meas_valid) & np.asarray(r1.meas_valid)
    dpos = np.abs(np.asarray(r0.meas_pos) - np.asarray(r1.meas_pos))
    frac = (dpos[both].max(-1) <= 0.5).mean()
    assert frac > 0.97, frac
