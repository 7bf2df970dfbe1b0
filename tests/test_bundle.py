"""Bundle adjustment tests on synthetic problems with analytic optima
(ref parity: src/Bundle.cc LM + Schur)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptam_cg_tpu.camera import atan
from ptam_cg_tpu.config import BundleConfig
from ptam_cg_tpu.models import bundle
from ptam_cg_tpu.utils import se3 as se3lib

REF_PARAMS = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)
SIZE = (640, 480)


def make_problem(seed=0, n_cams=4, n_pts=64, noise_px=0.0,
                 perturb_cams=0.0, perturb_pts=0.0, n_fixed=2,
                 cap_meas=512, outliers=0):
    """Cameras on an arc viewing a random 3D point cloud around z~4."""
    rng = np.random.default_rng(seed)
    cam = atan.make_camera(REF_PARAMS, SIZE)

    pts = rng.uniform([-1.5, -1.2, 3.0], [1.5, 1.2, 5.5],
                      (n_pts, 3)).astype(np.float32)
    poses = []
    for j in range(n_cams):
        xi = np.zeros(6, np.float32)
        xi[0] = 0.25 * j          # sideways baseline
        xi[4] = -0.04 * j         # slight pan to keep points in view
        poses.append(se3lib.se3_exp(jnp.asarray(xi)))
    R_gt = jnp.stack([p.R for p in poses])
    t_gt = jnp.stack([p.t for p in poses])

    meas_cam, meas_pt, meas_pos = [], [], []
    for j in range(n_cams):
        p_cam = pts @ np.asarray(R_gt[j]).T + np.asarray(t_gt[j])
        z1 = p_cam[:, :2] / p_cam[:, 2:3]
        pix = np.asarray(atan.project(jnp.asarray(z1), cam))
        inside = ((pix[:, 0] > 5) & (pix[:, 0] < SIZE[0] - 5)
                  & (pix[:, 1] > 5) & (pix[:, 1] < SIZE[1] - 5)
                  & (p_cam[:, 2] > 0.1))
        for i in np.nonzero(inside)[0]:
            meas_cam.append(j)
            meas_pt.append(int(i))
            meas_pos.append(pix[i] + rng.normal(0, noise_px, 2))

    M = cap_meas
    n_meas = len(meas_cam)
    assert n_meas <= M, n_meas
    mc = np.zeros(M, np.int32)
    mp = np.zeros(M, np.int32)
    mpos = np.zeros((M, 2), np.float32)
    mvalid = np.zeros(M, bool)
    mc[:n_meas] = meas_cam
    mp[:n_meas] = meas_pt
    mpos[:n_meas] = np.asarray(meas_pos)
    mvalid[:n_meas] = True
    # Inject gross outliers.
    out_idx = rng.choice(n_meas, size=outliers, replace=False) \
        if outliers else []
    for i in out_idx:
        mpos[i] += rng.uniform(40, 80, 2) * rng.choice([-1, 1], 2)

    # Perturb initial estimate.
    R0 = np.asarray(R_gt).copy()
    t0 = np.asarray(t_gt).copy()
    for j in range(n_fixed, n_cams):
        xi = rng.normal(0, perturb_cams, 6).astype(np.float32)
        d = se3lib.se3_exp(jnp.asarray(xi))
        R0[j] = np.asarray(d.R) @ R0[j]
        t0[j] = np.asarray(d.R) @ t0[j] + np.asarray(d.t)
    pts0 = pts + rng.normal(0, perturb_pts, pts.shape).astype(np.float32)

    fixed = np.zeros(n_cams, bool)
    fixed[:n_fixed] = True
    prob = bundle.BundleProblem(
        cam_R=jnp.asarray(R0), cam_t=jnp.asarray(t0),
        cam_fixed=jnp.asarray(fixed), cam_valid=jnp.ones(n_cams, bool),
        pt_pos=jnp.asarray(pts0), pt_valid=jnp.ones(n_pts, bool),
        meas_cam=jnp.asarray(mc), meas_pt=jnp.asarray(mp),
        meas_pos=jnp.asarray(mpos),
        meas_sqrt_inv_noise=jnp.ones(M, jnp.float32),
        meas_valid=jnp.asarray(mvalid),
        meas_bad=jnp.zeros(M, bool))
    return prob, cam, (R_gt, t_gt, jnp.asarray(pts)), np.asarray(out_idx)


def test_ba_perfect_data_stays_converged():
    prob, cam, _, _ = make_problem()
    state, n = bundle.compute(prob, cam)
    assert bool(state.converged)
    assert float(bundle.residual_rms(state.problem, cam)) < 0.01


def test_ba_recovers_perturbed_geometry():
    prob, cam, (R_gt, t_gt, pts_gt), _ = make_problem(
        seed=1, perturb_cams=0.02, perturb_pts=0.05)
    rms0 = float(bundle.residual_rms(prob, cam))
    state, n = bundle.compute(prob, cam)
    rms1 = float(bundle.residual_rms(state.problem, cam))
    assert rms1 < 0.05, (rms0, rms1, n)
    # Camera poses recovered.
    for j in range(2, 4):
        dR = np.asarray(state.problem.cam_R[j]) @ np.asarray(R_gt[j]).T
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        assert ang < 2e-3, (j, ang)
        assert np.linalg.norm(np.asarray(state.problem.cam_t[j])
                              - np.asarray(t_gt[j])) < 5e-3
    # Points recovered.
    err = np.linalg.norm(np.asarray(state.problem.pt_pos)
                         - np.asarray(pts_gt), axis=-1)
    assert np.median(err) < 5e-3


def test_ba_noisy_converges_to_noise_floor():
    prob, cam, _, _ = make_problem(seed=2, noise_px=0.5,
                                   perturb_cams=0.01, perturb_pts=0.03)
    state, _ = bundle.compute(prob, cam)
    rms = float(bundle.residual_rms(state.problem, cam))
    assert 0.2 < rms < 1.0, rms   # ~noise level, not collapsed/diverged


def test_ba_fixed_cameras_unchanged():
    prob, cam, _, _ = make_problem(seed=3, perturb_cams=0.02,
                                   perturb_pts=0.05)
    state, _ = bundle.compute(prob, cam)
    np.testing.assert_allclose(state.problem.cam_R[:2], prob.cam_R[:2],
                               atol=0)
    np.testing.assert_allclose(state.problem.cam_t[:2], prob.cam_t[:2],
                               atol=0)


def test_ba_prunes_gross_outliers():
    prob, cam, (R_gt, t_gt, pts_gt), out_idx = make_problem(
        seed=4, perturb_pts=0.02, outliers=12)
    state, _ = bundle.compute(prob, cam)
    bad = np.asarray(state.problem.meas_bad)
    # Most injected outliers must be pruned.
    assert bad[out_idx].mean() > 0.7, bad[out_idx]
    # And the solution still recovers.
    err = np.linalg.norm(np.asarray(state.problem.pt_pos)
                         - np.asarray(pts_gt), axis=-1)
    assert np.median(err) < 0.01, np.median(err)


def test_ba_respects_max_iterations():
    prob, cam, _, _ = make_problem(seed=5, perturb_cams=0.1,
                                   perturb_pts=0.2)
    cfg = BundleConfig(max_iterations=3)
    state, n = bundle.compute(prob, cam, cfg)
    assert int(state.iters) <= 3 + 1   # inner loop may overshoot by one


def test_ba_abort_between_steps():
    prob, cam, _, _ = make_problem(seed=6, perturb_cams=0.05,
                                   perturb_pts=0.1)
    calls = []

    def abort():
        calls.append(1)
        return len(calls) >= 1    # abort after first step

    state, n = bundle.compute(prob, cam, abort_check=abort)
    assert n == 1


def test_nan_point_measurements_pruned_not_poisoning():
    """A NaN map point's measurements become bad projections and get
    pruned; the solve stays finite (ref NaN guards:
    src/Bundle.cc:70-74, 478-482)."""
    prob, cam, gt, _ = make_problem(perturb_cams=0.02, perturb_pts=0.02)
    pts = np.asarray(prob.pt_pos).copy()
    pts[3] = np.nan
    prob = prob._replace(pt_pos=jnp.asarray(pts))
    state, n = bundle.compute(prob, cam)
    assert not bool(state.failed)
    assert np.isfinite(float(state.last_error))
    # The poisoned point's measurements were all marked bad.
    poisoned = np.asarray(prob.meas_pt) == 3
    active = np.asarray(prob.meas_valid)
    assert np.all(np.asarray(state.problem.meas_bad)[poisoned & active])
    # Everything the solver produced is finite (except the NaN input
    # point itself, which nothing updates).
    out_pts = np.asarray(state.problem.pt_pos)
    assert np.isfinite(out_pts[np.arange(len(out_pts)) != 3]).all()
    assert np.isfinite(np.asarray(state.problem.cam_t)).all()


def test_blown_solve_sets_failed_flag():
    """A problem whose normal equations overflow float32 during the
    solve (finite but absurd noise scaling) must set LMState.failed so
    the MapMaker can ditch the map (ref: Bundle::Compute -> -1,
    src/Bundle.cc:149-150)."""
    prob, cam, gt, _ = make_problem(perturb_cams=0.02, perturb_pts=0.02)
    noise = np.asarray(prob.meas_sqrt_inv_noise).copy()
    # Finite residuals (err_sq < f32 max) but J^T J overflows -> inf/NaN
    # inside the Schur solve, which no input sanitizer can catch.
    noise[np.asarray(prob.meas_valid)] = 1e18
    prob = prob._replace(meas_sqrt_inv_noise=jnp.asarray(noise))
    state, n = bundle.compute(prob, cam)
    assert bool(state.failed)


def test_lean_memory_step_matches_dense():
    """The memory-lean LM step (soff_tiles/u_chunks — the MapMaker's
    big-tier product configuration, which keeps the dense step's
    GB-scale temporaries from materializing at once) must produce the
    dense step's results: same accept/convergence
    flags and matching poses/points to f32 reassociation tolerance."""
    import dataclasses

    prob, cam, _, _ = make_problem(seed=11, n_cams=4, n_pts=64,
                                   noise_px=0.3, perturb_cams=0.02,
                                   perturb_pts=0.02)
    cfg = BundleConfig()
    # n_pts=64 % 8 == 0 and cap_meas=512 % 8 == 0: both lean paths engage.
    lean = dataclasses.replace(cfg, soff_tiles=8, u_chunks=8)
    assert bundle.lean_tiles(lean, prob.pt_pos.shape[0]) == 8

    sd = bundle.init_lm(prob, cfg)
    sl = bundle.init_lm(prob, lean)
    for _ in range(4):
        sd = bundle.lm_step(sd, cam, cfg)
        sl = bundle.lm_step(sl, cam, lean)
    assert int(sd.iters) == int(sl.iters)
    assert int(sd.accepted) == int(sl.accepted)
    assert bool(sd.failed) == bool(sl.failed) is False
    np.testing.assert_allclose(np.asarray(sl.problem.cam_t),
                               np.asarray(sd.problem.cam_t),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(sl.problem.cam_R),
                               np.asarray(sd.problem.cam_R),
                               rtol=0, atol=1e-4)
    dp = np.abs(np.asarray(sl.problem.pt_pos)
                - np.asarray(sd.problem.pt_pos))
    assert np.percentile(dp, 99) < 1e-3, np.percentile(dp, 99)
    np.testing.assert_array_equal(np.asarray(sl.problem.meas_bad),
                                  np.asarray(sd.problem.meas_bad))


def test_lean_memory_fallback_non_divisible():
    """Non-divisible P/M fall back to the dense path BIT-exactly (the
    guard in bundle.lean_tiles / _accumulators)."""
    import dataclasses

    prob, cam, _, _ = make_problem(seed=12, n_pts=63, cap_meas=509,
                                   perturb_pts=0.01)
    cfg = BundleConfig()
    lean = dataclasses.replace(cfg, soff_tiles=8, u_chunks=8)
    assert bundle.lean_tiles(lean, prob.pt_pos.shape[0]) == 1
    sd = bundle.lm_step(bundle.init_lm(prob, cfg), cam, cfg)
    sl = bundle.lm_step(bundle.init_lm(prob, lean), cam, lean)
    np.testing.assert_array_equal(np.asarray(sd.problem.pt_pos),
                                  np.asarray(sl.problem.pt_pos))
    np.testing.assert_array_equal(np.asarray(sd.problem.cam_t),
                                  np.asarray(sl.problem.cam_t))
