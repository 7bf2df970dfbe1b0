"""The tracking engine: per-frame pose estimation as one jitted program.

Batched re-architecture of the reference Tracker (ref: src/Tracker.cc).
The reference iterates point-by-point through PVS construction, patch
search, and WLS accumulation on two CPU threads; here every stage is a
batched tensor op over fixed-capacity point sets:

- PVS: all map points projected/warp-classified at once
  (ref: src/Tracker.cc:453-478)
- coarse stage: top-``coarse_cap`` high-level points, 30px search, 8
  subpix its, 10 GN iterations (ref: :491-569)
- fine stage: up to ``fine_cap`` points at 5/10px, level-3 points with
  subpix, 10 GN iterations with Tukey reweighting and the reference's
  sigma-override hack after iteration 5 (ref: :576-657, :928-1005)
- motion model / SBI rotation seed (ref: :1012-1056)
- tracking-quality state machine (ref: :1062-1107)

Randomized subset selection replaces std::random_shuffle with seeded
``jax.random`` keys so runs are reproducible.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ptam_cg_tpu.camera import atan
from ptam_cg_tpu.config import LEVELS, TrackerConfig
from ptam_cg_tpu.models.keyframe import FrameFeatures
from ptam_cg_tpu.models.map_state import MapState
from ptam_cg_tpu.ops import levels as levelops
from ptam_cg_tpu.ops import patch as patchops
from ptam_cg_tpu.ops import sbi as sbiops
from ptam_cg_tpu.utils import geometry as geomlib
from ptam_cg_tpu.utils import mest
from ptam_cg_tpu.utils import se3 as se3lib
from ptam_cg_tpu.utils.se3 import SE3

Array = jax.Array

# Static capacities for the per-frame working sets.
COARSE_CAP = 128           # >= 2 * CoarseMax (just-recovered doubling)
FINE_CAP = 1024
TRACK_CAP = COARSE_CAP + FINE_CAP

# Quality enum (ref: Tracker::{BAD, DODGY, GOOD}).
QUALITY_BAD = 0
QUALITY_DODGY = 1
QUALITY_GOOD = 2

R_WIN = 16                 # coarse static search window radius (level px)
# Fine-stage static window: fine radii are <= 10 level-px (config-
# validated), and the subpix reuse needs one spare pixel of bilinear
# margin, so 11 suffices. A smaller window shrinks every per-point
# tensor in the hot path — window gather (N,2R+8,·), integral images,
# the 64-shift ZMSSD cross term ((2R+1)^2 candidate maps) — and the
# examined CANDIDATE set is identical to R_WIN=16 (radius-bounded;
# tests/test_patch.py::test_ssd_search_window_size_invariance). One
# behavioral difference remains (ADVICE r3): the reused window also
# bounds subpix excursion, so an at-radius match (offset 10) has ~1 px
# of in-window travel at r_win=11 vs ~5 px at 16 before subpix drops
# the measurement. The reference declares subpix "should never travel
# more than a pixel" (src/PatchFinder.cc:249-252), so 1 px of margin is
# in-spec; test_subpix_window_reuse_near_radius covers it.
FINE_R_WIN = 11
MAX_SSD = 8 * 8 * 500.0    # ref: src/PatchFinder.cc:18-19


class TrackerState(NamedTuple):
    pose: SE3                  # camera from world
    velocity: Array            # (6,) twist/frame
    msd_vel: Array             # () scene-depth-scaled velocity magnitude
    lost_frames: Array         # () int32
    quality: Array             # () int32 QUALITY_*
    just_recovered: Array      # () bool
    depth_mean: Array          # () current scene depth mean
    depth_sigma: Array         # ()
    key: Array                 # (2,) uint32 PRNG key, advanced per frame


def init_tracker_state(pose: SE3 | None = None,
                       key: Array | None = None,
                       seed: int = 0) -> TrackerState:
    if pose is None:
        pose = se3lib.identity()
    if key is None:
        key = jax.random.PRNGKey(seed)
    return TrackerState(
        pose=pose, velocity=jnp.zeros(6, jnp.float32),
        msd_vel=jnp.float32(0.0), lost_frames=jnp.int32(0),
        quality=jnp.int32(QUALITY_GOOD), just_recovered=jnp.asarray(False),
        depth_mean=jnp.float32(1.0), depth_sigma=jnp.float32(1.0),
        key=key)


class TrackView(NamedTuple):
    """The 14 MapState leaves the per-frame TRACKING program actually
    reads — a slim duck-typed stand-in for MapState at the jit boundary.

    Host dispatch cost grows with the argument pytree's leaf count.
    The full MapState is ~36 leaves; tracking + the per-frame decision
    scalars touch only these. ``make_track_view`` builds one for free
    (host tuple of existing device buffers — no device ops). Every
    consumer (``track_map``, ``local_point_mask``,
    ``map_state.closest_kf_distances``, ``need_new_kf``) accesses fields
    by name, so MapState and TrackView interchange transparently."""
    point_pos: Array          # (P, 3)
    point_valid: Array        # (P,)
    point_center: Array       # (P, 2)
    point_src_kf: Array       # (P,)
    point_src_level: Array    # (P,)
    point_right_w: Array      # (P, 3)
    point_down_w: Array       # (P, 3)
    point_inlier: Array       # (P,)
    point_outlier: Array      # (P,)
    kf_R: Array               # (K, 3, 3)
    kf_t: Array               # (K, 3)
    kf_valid: Array           # (K,)
    kf_atlas: Array           # (K, Ha, W)
    meas_valid: Array         # (K, P)


def make_track_view(m) -> TrackView:
    """Slice the tracking-visible leaves out of a MapState (free: host
    references to the same device buffers)."""
    return TrackView(
        point_pos=m.point_pos, point_valid=m.point_valid,
        point_center=m.point_center, point_src_kf=m.point_src_kf,
        point_src_level=m.point_src_level,
        point_right_w=m.point_right_w, point_down_w=m.point_down_w,
        point_inlier=m.point_inlier, point_outlier=m.point_outlier,
        kf_R=m.kf_R, kf_t=m.kf_t, kf_valid=m.kf_valid,
        kf_atlas=m.kf_atlas, meas_valid=m.meas_valid)


class TrackResult(NamedTuple):
    pose: SE3
    # Measurements over the working set (TRACK_CAP entries):
    meas_point: Array       # (T,) int32 map point index
    meas_pos: Array         # (T, 2) level-0 found position
    meas_level: Array       # (T,) int32
    meas_subpix: Array      # (T,) bool
    meas_valid: Array       # (T,) bool
    attempted: Array        # (LEVELS,) int32
    found: Array            # (LEVELS,) int32
    did_coarse: Array       # () bool
    depth_mean: Array       # ()
    depth_sigma: Array      # ()
    inlier_delta: Array     # (P,) int32 per-point inlier increments
    outlier_delta: Array    # (P,) int32


def validate_config(cfg: TrackerConfig) -> None:
    """Reject configs whose value-level search radii exceed the static
    window ``R_WIN`` — otherwise ``ssd_search`` would silently truncate
    the search (the window it examines is r_win-bounded regardless of the
    requested radius). Checks every eligible level including the
    just-recovered doubled coarse range (ref: src/Tracker.cc:505-516).
    """
    import math

    # Coarse stage runs at levels >= LEVELS-2; worst radius is at the
    # lowest eligible level with the doubled just-recovered range. The
    # window must exceed the radius by 1 px: the subpix reuse of the
    # search windows needs a bilinear margin around an at-radius
    # candidate (ops/patch.py::subpix_refine in_win check).
    worst_coarse = math.ceil(2.0 * cfg.coarse_range / (1 << (LEVELS - 2)))
    if worst_coarse > R_WIN - 1:
        raise ValueError(
            f"TrackerConfig.coarse_range={cfg.coarse_range} needs a "
            f"search radius of {worst_coarse} level-px at level "
            f"{LEVELS - 2} (just-recovered doubling), but the static "
            f"search window is R_WIN={R_WIN} (usable radius "
            f"{R_WIN - 1}). Reduce coarse_range to "
            f"<= {(R_WIN - 1) * (1 << (LEVELS - 2)) // 2}.")
    # Fine stage runs at any level; worst radius is at level 0.
    worst_fine = math.ceil(max(cfg.fine_range_after_coarse,
                               cfg.fine_range_no_coarse))
    if worst_fine > FINE_R_WIN - 1:
        raise ValueError(
            f"TrackerConfig fine range {worst_fine} exceeds the fine "
            f"static search window FINE_R_WIN={FINE_R_WIN} (usable "
            f"radius {FINE_R_WIN - 1}) at level 0. Reduce "
            f"fine_range_after_coarse/fine_range_no_coarse to "
            f"<= {FINE_R_WIN - 1}.")


def _topk_pad(keys: Array, cap: int) -> Array:
    """top_k indices padded to ``cap`` when the array is smaller than the
    capacity (small test maps)."""
    n = keys.shape[0]
    k = min(cap, n)
    _, idx = jax.lax.top_k(keys, k)
    if k < cap:
        idx = jnp.concatenate([idx, jnp.zeros(cap - k, idx.dtype)])
    return idx


def _project_points(pose: SE3, pts_w: Array, cam: atan.Camera,
                    image_size) -> tuple:
    """Batched TrackerData::Project (ref: include/Tracker.h:69-86)."""
    W, H = image_size
    p_cam = pts_w @ pose.R.T + pose.t
    z = p_cam[..., 2]
    z_ok = z > 0.001
    safe_z = jnp.where(z_ok, z, 1.0)
    z1 = p_cam[..., :2] / safe_z[..., None]
    r_ok = jnp.sum(z1 * z1, axis=-1) <= cam.largest_radius ** 2
    pix = atan.project(z1, cam)
    in_im = ((pix[..., 0] >= 0) & (pix[..., 1] >= 0)
             & (pix[..., 0] <= W) & (pix[..., 1] <= H))
    ok = z_ok & r_ok & in_im & atan.project_valid(z1, cam)
    return p_cam, z1, pix, ok


def _pose_jacobian(p_cam: Array, cam_derivs: Array) -> Array:
    """Batched TrackerData::CalcJacobian (ref: include/Tracker.h:127-139):
    (N, 2, 6) d(pixel)/d(left-mult twist)."""
    z = p_cam[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    gen = se3lib.motion_jacobian(p_cam)            # (N, 6, 3)
    plane = (gen[..., :2] - p_cam[..., None, :2]
             * gen[..., 2:] * inv_z[..., None, None]) * inv_z[..., None, None]
    # (N, 6, 2) -> apply cam derivs -> (N, 2, 6)
    return jnp.einsum("nij,nmj->nim", cam_derivs, plane)


def _search_subset(m: MapState, frame: FrameFeatures, pose: SE3,
                   cam: atan.Camera, image_size, idx: Array, active: Array,
                   range_l0: Array, subpix_its: int,
                   subpix_level3_only: bool, bf16_cross: bool = False,
                   r_win: int = R_WIN):
    """Template warp + windowed ZMSSD + optional subpix for a gathered
    subset of map points (batched Tracker::SearchForPoints,
    ref: src/Tracker.cc:867-912)."""
    W, H = image_size
    pts_w = m.point_pos[idx]
    p_cam, z1, pix, proj_ok = _project_points(pose, pts_w, cam, image_size)
    cam_derivs = atan.project_derivs(z1, cam)
    warp = patchops.search_level_and_warp(
        p_cam, pose.R, m.point_right_w[idx], m.point_down_w[idx], cam_derivs)
    level = warp.level
    scale = levelops.level_scale(level)

    # Source template: center in source-level coords -> source atlas coords.
    src_center = levelops.atlas_pos(m.point_center[idx],
                                    m.point_src_level[idx], H, W)
    m2 = patchops.inv2x2(warp.warp_inv) * scale[..., None, None]
    sb = levelops.level_bounds(m.point_src_level[idx], H, W)
    src_bounds = jnp.stack(sb, axis=-1)
    templates, tmpl_ok = patchops.make_warped_templates(
        m.kf_atlas, m.point_src_kf[idx], src_center, m2, src_bounds)

    attempted = active & proj_ok & warp.good & tmpl_ok

    # Predicted position in the current frame's atlas coords.
    center_level = levelops.level_n_pos(pix, level)
    centers = levelops.atlas_pos(center_level, level, H, W)
    radius = jnp.ceil(range_l0 / scale)
    cb = levelops.level_bounds(level, H, W)
    bounds = jnp.stack(cb, axis=-1)

    res, win, win_origin = patchops.ssd_search(
        frame.atlas, frame.corner_mask, templates, centers, radius, bounds,
        r_win=r_win, max_ssd=MAX_SSD, return_windows=True,
        bf16_cross=bf16_cross)
    found = attempted & res.found

    pos_atlas = res.pos
    subpix_done = jnp.zeros_like(found)
    if subpix_its > 0:
        # Reuse the search windows — the best candidate lies inside them.
        ref = patchops.subpix_refine(frame.atlas, templates, res.pos,
                                     bounds, max_its=subpix_its,
                                     windows=win, win_origin=win_origin)
        if subpix_level3_only:
            use = found & (level == LEVELS - 1)
        else:
            use = found
        # Subpix failure kills the measurement (ref: src/Tracker.cc:897-905).
        found = jnp.where(use, found & ref.converged, found)
        pos_atlas = jnp.where(use[:, None], ref.pos, pos_atlas)
        subpix_done = use

    # Atlas coords -> level coords -> level-0 coords.
    offs = jnp.asarray([[c, r] for (r, c) in levelops.level_offsets(H, W)],
                       jnp.float32)
    pos_level = pos_atlas - offs[level]
    pos_l0 = levelops.level_zero_pos(pos_level, level)
    return dict(found=found, attempted=attempted, pos_l0=pos_l0,
                level=level, subpix=subpix_done & found)


def _gn_pose_iterations(pose: SE3, cam: atan.Camera, image_size,
                        pts_w: Array, found: Array, v2found: Array,
                        level: Array, n_iters: int,
                        override_after: int, override_val: float,
                        mest_kind: int = mest.TUKEY):
    """Batched Gauss-Newton pose loop with robust reweighting
    (ref: src/Tracker.cc:546-568 (coarse), :621-657 (fine),
    CalcPoseUpdate :928-1005). Returns (pose, final_weights).

    The whole solve is traced under pinned float32 matmul precision: a
    reduced default matmul precision (TF32 on the GPU) corrupts the 6x6
    normal equations enough to degrade the pose over a sequence. The
    image-value gather/ZMSSD dots elsewhere deliberately stay at the
    default — uint8-in-spec (ref precision: src/ImageProcess.cc).
    """
    with jax.default_matmul_precision("float32"):
        return _gn_pose_iterations_impl(
            pose, cam, image_size, pts_w, found, v2found, level,
            n_iters, override_after, override_val, mest_kind)


def _gn_pose_iterations_impl(pose: SE3, cam: atan.Camera, image_size,
                             pts_w: Array, found: Array, v2found: Array,
                             level: Array, n_iters: int,
                             override_after: int, override_val: float,
                             mest_kind: int = mest.TUKEY):
    sqrt_inv_noise = 1.0 / levelops.level_scale(level)

    def one_iter(it, carry):
        pose_R, pose_t, _w = carry
        pose_i = SE3(pose_R, pose_t)
        p_cam, z1, pix, proj_ok = _project_points(pose_i, pts_w, cam,
                                                  image_size)
        cam_derivs = atan.project_derivs(z1, cam)
        J = _pose_jacobian(p_cam, cam_derivs)          # (N, 2, 6)
        err = (v2found - pix) * sqrt_inv_noise[:, None]
        ok = found & proj_ok
        err_sq = jnp.sum(err * err, axis=-1)
        # Approx median: this runs inside every GN iteration, where a
        # full sort per iteration would dominate the solve.
        sigma_sq = mest.find_sigma_squared(err_sq, ok, mest_kind,
                                           approx=True)
        sigma_sq = jnp.where(it > override_after,
                             jnp.float32(override_val), sigma_sq)
        w = jnp.where(ok, mest.weight(err_sq, sigma_sq, mest_kind), 0.0)
        Js = J * sqrt_inv_noise[:, None, None]
        JTJ = jnp.einsum("n,nij,nik->jk", w, Js, Js) + 100.0 * jnp.eye(6)
        rhs = jnp.einsum("n,nij,ni->j", w, Js, err)
        upd = jnp.linalg.solve(JTJ, rhs)
        new_pose = se3lib.mul(se3lib.se3_exp(upd), pose_i)
        return new_pose.R, new_pose.t, w, jnp.sum(upd * upd)

    # while_loop with a converged early exit, restricted to the
    # OVERRIDE-sigma regime (it > override_after + 1): once the solve is
    # in that regime the remaining fixed-count iterations see the same
    # constant sigma and a ~zero update, so exiting reproduces the
    # 10-iteration result (weights included) to float noise — the
    # reference's fixed loop is src/Tracker.cc:552,615. Typical
    # steady-state frames settle by iteration ~6-7, saving ~3 of the 10
    # serial iterations that dominated the round-3 flat trace.
    def loop_cond(carry):
        it, _, _, _, upd_sq = carry
        settled = (it > override_after + 1) & (upd_sq < 1e-10)
        return (it < n_iters) & ~settled

    def loop_body(carry):
        it, R, t, w, _ = carry
        R, t, w, upd_sq = one_iter(it, (R, t, w))
        return it + 1, R, t, w, upd_sq

    init = (jnp.int32(0), pose.R, pose.t,
            jnp.zeros(pts_w.shape[0], jnp.float32), jnp.float32(jnp.inf))
    _, R, t, w, _ = jax.lax.while_loop(loop_cond, loop_body, init)
    return SE3(R, t), w


def local_point_mask(m: MapState, pose: SE3, n_nearest: int = 4) -> Array:
    """Points measured by the ``n_nearest`` keyframes to ``pose`` — the
    PVS restriction of Tracker::TrackMapLocal (ref: src/Tracker.cc:700-857,
    which tracks only ~200 points from the 4 nearest KFs)."""
    from ptam_cg_tpu.models import map_state as ms

    d = ms.closest_kf_distances(m, pose)
    neg = jnp.where(jnp.isfinite(d), -d, -jnp.inf)
    _, idx = jax.lax.top_k(neg, min(n_nearest, d.shape[0]))
    near = jnp.zeros_like(m.kf_valid).at[idx].set(True)
    near = near & m.kf_valid
    return jnp.any(m.meas_valid & near[:, None], axis=0) & m.point_valid


def track_map(m: MapState, frame: FrameFeatures, pose: SE3,
              cam: atan.Camera, image_size, key: Array,
              msd_vel: Array, just_recovered: Array,
              cfg: TrackerConfig = TrackerConfig(),
              point_filter: Array | None = None) -> TrackResult:
    """Full two-stage coarse/fine map tracking (ref: Tracker::TrackMap,
    src/Tracker.cc:442-698). One jitted program.

    ``point_filter``: optional (P,) mask restricting the PVS — pass
    ``local_point_mask(...)`` for TrackMapLocal behavior.

    The whole program runs under pinned-f32 matmul precision: the PVS
    projection / warp-matrix stage feeds the pose chain whose bf16
    drift round 3 measured as runaway scale (see se3._pinned_f32). The
    image-value hot dots inside (window row-takes, one-hot template
    interpolation) opt back into the fast default with an explicit
    ``precision=`` at their call sites — explicit beats implicit.
    """
    with jax.default_matmul_precision("float32"):
        return _track_map_impl(m, frame, pose, cam, image_size, key,
                               msd_vel, just_recovered, cfg, point_filter)


def _track_map_impl(m: MapState, frame: FrameFeatures, pose: SE3,
                    cam: atan.Camera, image_size, key: Array,
                    msd_vel: Array, just_recovered: Array,
                    cfg: TrackerConfig = TrackerConfig(),
                    point_filter: Array | None = None) -> TrackResult:
    W, H = image_size
    P = m.point_pos.shape[0]
    k_coarse, k_fine = jax.random.split(key)

    # ---- PVS: classify every map point ----------------------------------
    p_cam, z1, pix, proj_ok = _project_points(pose, m.point_pos, cam,
                                              image_size)
    cam_derivs = atan.project_derivs(z1, cam)
    warp = patchops.search_level_and_warp(
        p_cam, pose.R, m.point_right_w, m.point_down_w, cam_derivs)
    pvs = m.point_valid & proj_ok & warp.good
    if point_filter is not None:
        pvs = pvs & point_filter
    level = warp.level

    # ---- coarse stage selection ----------------------------------------
    n_coarse_target = jnp.where(just_recovered, 2 * cfg.coarse_max,
                                cfg.coarse_max)
    coarse_range = jnp.where(just_recovered, 2.0 * cfg.coarse_range,
                             cfg.coarse_range)
    coarse_eligible = pvs & (level >= LEVELS - 2)
    n_eligible = jnp.sum(coarse_eligible.astype(jnp.int32))
    rand_c = jax.random.uniform(k_coarse, (P,))
    coarse_key_arr = jnp.where(
        coarse_eligible, level.astype(jnp.float32) * 10.0 + rand_c, -jnp.inf)
    coarse_idx = _topk_pad(coarse_key_arr, COARSE_CAP)
    slot = jnp.arange(COARSE_CAP)
    coarse_active = ((slot < n_coarse_target)
                     & (jnp.take(coarse_eligible, coarse_idx)))
    coarse_active = coarse_active & (slot < min(COARSE_CAP, P))

    try_coarse = jnp.asarray(not cfg.disable_coarse) & (
        (msd_vel >= cfg.coarse_min_velocity) | just_recovered)
    do_coarse_search = try_coarse & (n_eligible > cfg.coarse_min)

    def run_coarse_search(_):
        return _search_subset(
            m, frame, pose, cam, image_size, coarse_idx,
            coarse_active, coarse_range,
            cfg.coarse_subpix_its, subpix_level3_only=False,
            bf16_cross=cfg.zmssd_bf16_cross)

    def skip_coarse_search(_):
        zb = jnp.zeros(COARSE_CAP, bool)
        return dict(found=zb, attempted=zb,
                    pos_l0=jnp.zeros((COARSE_CAP, 2), jnp.float32),
                    level=jnp.zeros(COARSE_CAP, jnp.int32), subpix=zb)

    # lax.cond actually skips the search work when the velocity gate is
    # off (the common steady-state case).
    cres = jax.lax.cond(do_coarse_search, run_coarse_search,
                        skip_coarse_search, 0)
    n_coarse_found = jnp.sum(cres["found"].astype(jnp.int32))
    did_coarse = do_coarse_search & (n_coarse_found >= cfg.coarse_min)

    coarse_pts = m.point_pos[coarse_idx]

    def run_coarse(p):
        new_pose, _ = _gn_pose_iterations(
            p, cam, image_size, coarse_pts, cres["found"], cres["pos_l0"],
            cres["level"], cfg.pose_iterations, override_after=5,
            override_val=1.0, mest_kind=mest.estimator_id(cfg.mestimator))
        return new_pose

    pose_after_coarse = jax.lax.cond(
        did_coarse, run_coarse, lambda p: SE3(p.R, p.t), pose)

    # ---- fine stage selection ------------------------------------------
    # Coarse points stay in the iteration set whenever the coarse search
    # ran, even if the GN gate failed (ref: src/Tracker.cc:550-553).
    coarse_used = coarse_active & do_coarse_search
    # .add not .set: padded duplicate indices must not erase true entries.
    in_coarse = jnp.zeros(P, jnp.int32).at[coarse_idx].add(
        coarse_used.astype(jnp.int32)) > 0
    fine_eligible = pvs & ~in_coarse
    rand_f = jax.random.uniform(k_fine, (P,))
    # Level-3 points always first (ref does all of avPVS[3] with subpix).
    fine_key_arr = jnp.where(
        fine_eligible,
        (level == LEVELS - 1).astype(jnp.float32) * 10.0 + rand_f, -jnp.inf)
    fine_idx = _topk_pad(fine_key_arr, FINE_CAP)
    n_fine_allowed = jnp.maximum(
        cfg.max_patches_per_frame
        - jnp.sum(coarse_used.astype(jnp.int32)), 0)
    fslot = jnp.arange(FINE_CAP)
    fine_active = ((fslot < n_fine_allowed)
                   & jnp.take(fine_eligible, fine_idx)
                   & (fslot < min(FINE_CAP, P)))

    fine_range = jnp.where(did_coarse, cfg.fine_range_after_coarse,
                           cfg.fine_range_no_coarse)
    fres = _search_subset(m, frame, pose_after_coarse, cam, image_size,
                          fine_idx, fine_active, fine_range,
                          subpix_its=8,
                          subpix_level3_only=not cfg.subpix_all,
                          bf16_cross=cfg.zmssd_bf16_cross,
                          r_win=FINE_R_WIN)

    # ---- combined GN over coarse + fine measurements -------------------
    all_idx = jnp.concatenate([coarse_idx, fine_idx])
    all_found = jnp.concatenate([cres["found"], fres["found"]])
    all_pos = jnp.concatenate([cres["pos_l0"], fres["pos_l0"]])
    all_level = jnp.concatenate([cres["level"], fres["level"]])
    all_subpix = jnp.concatenate([cres["subpix"], fres["subpix"]])
    all_pts = m.point_pos[all_idx]

    final_pose, final_w = _gn_pose_iterations(
        pose_after_coarse, cam, image_size, all_pts, all_found, all_pos,
        all_level, cfg.pose_iterations, override_after=5, override_val=16.0,
        mest_kind=mest.estimator_id(cfg.mestimator))

    # Outlier accounting at the last iteration
    # (ref: src/Tracker.cc:989-997 with bMarkOutliers on iter 9).
    is_outlier = all_found & (final_w == 0.0)
    is_inlier = all_found & (final_w > 0.0)
    inlier_delta = jnp.zeros(P, jnp.int32).at[all_idx].add(
        is_inlier.astype(jnp.int32), mode="drop")
    outlier_delta = jnp.zeros(P, jnp.int32).at[all_idx].add(
        is_outlier.astype(jnp.int32), mode="drop")

    # ---- per-level stats ------------------------------------------------
    att_all = jnp.concatenate([cres["attempted"], fres["attempted"]])
    attempted = jnp.zeros(LEVELS, jnp.int32).at[all_level].add(
        att_all.astype(jnp.int32), mode="drop")
    found_stats = jnp.zeros(LEVELS, jnp.int32).at[all_level].add(
        all_found.astype(jnp.int32), mode="drop")

    # ---- scene depth (ref: src/Tracker.cc:679-697) ----------------------
    p_cam_f, _, _, _ = _project_points(final_pose, all_pts, cam, image_size)
    zs = p_cam_f[..., 2]
    nf = jnp.sum(all_found.astype(jnp.float32))
    zsum = jnp.sum(jnp.where(all_found, zs, 0.0))
    zsq = jnp.sum(jnp.where(all_found, zs * zs, 0.0))
    depth_ok = nf > 20
    mean = jnp.where(depth_ok, zsum / jnp.maximum(nf, 1.0), 1.0)
    sigma = jnp.where(
        depth_ok,
        jnp.sqrt(jnp.maximum(zsq / jnp.maximum(nf, 1.0) - mean * mean,
                             1e-12)), 1.0)

    return TrackResult(
        pose=final_pose, meas_point=all_idx, meas_pos=all_pos,
        meas_level=all_level, meas_subpix=all_subpix, meas_valid=all_found,
        attempted=attempted, found=found_stats, did_coarse=did_coarse,
        depth_mean=mean, depth_sigma=sigma,
        inlier_delta=inlier_delta, outlier_delta=outlier_delta)


class FrameOutput(NamedTuple):
    state: TrackerState
    result: TrackResult
    sbi_score: Array


def track_frame(state: TrackerState, m: MapState, frame: FrameFeatures,
                prev_sbi: sbiops.SBI, cam: atan.Camera, image_size,
                cam_params: Array, key: Array | None = None,
                cfg: TrackerConfig = TrackerConfig(),
                wiggle_scale: float = 0.1,
                point_filter: Array | None = None) -> FrameOutput:
    """Full per-frame step once the map is good
    (ref: Tracker::TrackFrame, src/Tracker.cc:86-188): motion-model
    predict (+ SBI rotation seed), TrackMap, motion-model update,
    quality assessment. One jitted program.

    The per-frame PRNG key is carried in ``state.key`` and advanced here
    (host-side ``PRNGKey``/``split`` calls would be extra per-frame
    device programs). Passing ``key``
    explicitly overrides the state key for this frame (tests).

    Pinned-f32 matmuls throughout (motion model, SBI seed conversion,
    quality KF distances; see track_map docstring)."""
    with jax.default_matmul_precision("float32"):
        return _track_frame_impl(state, m, frame, prev_sbi, cam,
                                 image_size, cam_params, key, cfg,
                                 wiggle_scale, point_filter)


def _track_frame_impl(state: TrackerState, m: MapState,
                      frame: FrameFeatures, prev_sbi: sbiops.SBI,
                      cam: atan.Camera, image_size,
                      cam_params: Array, key: Array | None = None,
                      cfg: TrackerConfig = TrackerConfig(),
                      wiggle_scale: float = 0.1,
                      point_filter: Array | None = None) -> FrameOutput:
    W, H = image_size
    k_next, k_frame = jax.random.split(state.key)
    if key is not None:
        k_frame = key
    sbi_size = ((H >> 3) // 2, (W >> 3) // 2)

    # --- PredictPoseWithMotionModel (ref: src/Tracker.cc:1012-1029) ---
    start_pose = state.pose
    vel = state.velocity
    if cfg.use_rotation_estimator:
        rot, score = sbiops.calc_sbi_rotation(frame.sbi_track, prev_sbi,
                                              cam_params, sbi_size, 10)
        rotvec = se3lib.so3_log(rot.R)
        vel = jnp.concatenate([
            jnp.array([0.0, 0.0], jnp.float32), vel[2:3], rotvec])
    else:
        score = jnp.float32(0.0)
    pred_pose = se3lib.mul(se3lib.se3_exp(vel), start_pose)

    # TrackMapLocal: PVS restricted to points seen by the nearest KFs
    # (ref: src/Tracker.cc:700-857). Static config flag — compiles a
    # separate variant; the mask itself is cheap (top_k over K).
    if cfg.track_local and point_filter is None:
        point_filter = local_point_mask(m, pred_pose, cfg.track_local_kfs)

    res = track_map(m, frame, pred_pose, cam, image_size, k_frame,
                    state.msd_vel, state.just_recovered, cfg,
                    point_filter=point_filter)

    # --- UpdateMotionModel (ref: src/Tracker.cc:1035-1056) ---
    motion = se3lib.se3_log(se3lib.mul(res.pose, se3lib.inv(start_pose)))
    if cfg.use_constant_velocity:
        new_vel = motion
    else:
        new_vel = 0.9 * (0.5 * motion + 0.5 * state.velocity)
    depth = jnp.maximum(res.depth_mean, 1e-6)
    v6 = new_vel.at[:3].multiply(1.0 / depth)
    msd_vel = jnp.linalg.norm(v6)

    # --- AssessTrackingQuality (ref: src/Tracker.cc:1062-1107) ---
    total_att = jnp.sum(res.attempted)
    total_found = jnp.sum(res.found)
    large_att = jnp.sum(res.attempted[2:])
    large_found = jnp.sum(res.found[2:])
    frac = total_found / jnp.maximum(total_att, 1).astype(jnp.float32)
    large_frac = jnp.where(
        large_att > 10,
        large_found / jnp.maximum(large_att, 1).astype(jnp.float32), frac)
    # DODGY branch: a camera far from every keyframe is treated as lost
    # even if some patches still match (ref: src/Tracker.cc:1095-1101,
    # dDist > GetWiggleScale() * 10 -> BAD).
    from ptam_cg_tpu.models import map_state as ms
    kf_dist = jnp.min(ms.closest_kf_distances(m, res.pose))
    far_from_map = kf_dist > cfg.quality_max_kf_dist_mult * wiggle_scale
    quality = jnp.where(
        (total_found == 0) | (total_att == 0), QUALITY_BAD,
        jnp.where(frac > cfg.tracking_quality_good, QUALITY_GOOD,
                  jnp.where(large_frac < cfg.tracking_quality_lost,
                            QUALITY_BAD,
                            jnp.where(far_from_map, QUALITY_BAD,
                                      QUALITY_DODGY))))
    lost = jnp.where(quality == QUALITY_BAD, state.lost_frames + 1, 0)

    new_state = TrackerState(
        pose=res.pose, velocity=new_vel, msd_vel=msd_vel,
        lost_frames=lost, quality=quality,
        just_recovered=jnp.asarray(False),
        depth_mean=res.depth_mean, depth_sigma=res.depth_sigma,
        key=k_next)
    return FrameOutput(state=new_state, result=res, sbi_score=score)


class FusedFrameOutput(NamedTuple):
    state: TrackerState
    result: TrackResult
    sbi_score: Array
    sbi: sbiops.SBI         # relocalizer SBI of this frame
    sbi_track: sbiops.SBI   # rotation-estimator SBI (next frame's prev)


def track_frame_from_image(state: TrackerState, m: MapState, im: Array,
                           prev_sbi, cam: atan.Camera, image_size,
                           cam_params: Array,
                           cfg: TrackerConfig = TrackerConfig(),
                           frontend_cfg=None, wiggle_scale: float = 0.1,
                           point_filter: Array | None = None
                           ) -> FusedFrameOutput:
    """Fused per-frame step: frontend build (MakeKeyFrame_Lite
    equivalent) + track_frame in ONE jitted program — one device
    dispatch per frame instead of two. The tracking stage only consumes
    the atlas/corner mask/SBIs, so the keyframe-only candidate fields
    never materialize."""
    from ptam_cg_tpu.config import FrontendConfig
    from ptam_cg_tpu.models import keyframe as kflib

    if frontend_cfg is None:
        frontend_cfg = FrontendConfig()
    ff = kflib.build_frame_tracking(im, frontend_cfg)
    out = track_frame(state, m, ff, prev_sbi, cam, image_size,
                      cam_params, None, cfg, wiggle_scale, point_filter)
    return FusedFrameOutput(state=out.state, result=out.result,
                            sbi_score=out.sbi_score, sbi=ff.sbi,
                            sbi_track=ff.sbi_track)
