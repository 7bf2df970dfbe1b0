"""The mapping engine: keyframe integration, epipolar map expansion,
re-find data association, robust BA glue, and map maintenance.

Batched re-architecture of the reference MapMaker (ref: src/MapMaker.cc).
The reference runs these jobs serially point-by-point on its own CPU
thread; here each job is a batched jitted program over the dense MapState,
and a thin host scheduler (``MapMaker.step``) reproduces the priority loop
(ref: src/MapMaker.cc:57-114): local BA -> refind-new -> global BA ->
failure-queue refind -> bad-point GC -> keyframe integration.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ptam_cg_tpu.camera import atan
from ptam_cg_tpu.config import (LEVELS, BundleConfig, MapMakerConfig)
from ptam_cg_tpu.models import bundle as bundlelib
from ptam_cg_tpu.models import map_state as ms
from ptam_cg_tpu.models.keyframe import FrameFeatures
from ptam_cg_tpu.models.map_state import MapState
from ptam_cg_tpu.ops import levels as levelops
from ptam_cg_tpu.ops import patch as patchops
from ptam_cg_tpu.utils import geometry
from ptam_cg_tpu.utils import se3 as se3lib
from ptam_cg_tpu.utils.se3 import SE3

Array = jax.Array

_DBG = bool(os.environ.get("PTAM_DEBUG_TIMING"))

MAX_SSD = 8 * 8 * 500.0

#: Above this dense-W-block byte size, the BA while_loop CHUNK program
#: is dispatched as SINGLE lm_step programs instead: a GB-scale
#: loop-carried LMState in the chunk's while_loop is the case the
#: split guards against, while at product scales the chunk saves
#: per-step dispatch round trips. 256 MB keeps every product tier
#: (<=128 KF / 8k pts: W = 18*128*8192*4 = 75 MB) on the chunk and the
#: 500-KF scales on the per-step path. Whether the split still pays on
#: the GPU is ROADMAP C4. See bundle._cached_lm_step_flags.
BA_CHUNK_W_BYTES_LIMIT = 256 * 2 ** 20


def ba_use_single_step(c_cap: int, p_cap: int) -> bool:
    """True when BA at caps (c_cap, p_cap) should dispatch standalone
    LM steps instead of the while_loop chunk (see BA_CHUNK_W_BYTES_LIMIT)."""
    return 18 * c_cap * p_cap * 4 > BA_CHUNK_W_BYTES_LIMIT


# ---------------------------------------------------------------------------
# Epipolar map-point creation (one pyramid level at a time)
# ---------------------------------------------------------------------------

def add_points_epipolar(m: MapState, src_kf, tgt_kf, level: int,
                        cam: atan.Camera, image_size,
                        wiggle_scale: float,
                        thin_radius: float = 10.0) -> Tuple[MapState, Array, Array]:
    """Batched ThinCandidates + AddPointEpipolar for every candidate of
    ``src_kf`` at ``level`` (ref: src/MapMaker.cc:415-457, 529-688).

    Returns (new map, n_added, new_point_mask (P,)).
    """
    W, H = image_size
    P = m.point_pos.shape[0]
    scale = float(1 << level)
    cand_xy = m.kf_cand_xy[src_kf, level].astype(jnp.float32)   # (C, 2)
    cand_ok = m.kf_cand_valid[src_kf, level]
    C = cand_xy.shape[0]

    src_pose = SE3(m.kf_R[src_kf], m.kf_t[src_kf])
    tgt_pose = SE3(m.kf_R[tgt_kf], m.kf_t[tgt_kf])

    # --- ThinCandidates: drop candidates near existing measurements at
    # this level or one higher (ref: src/MapMaker.cc:415-441).
    busy = (m.meas_valid[src_kf]
            & ((m.meas_level[src_kf] == level)
               | (m.meas_level[src_kf] == level + 1)))          # (P,)
    busy_pos = m.meas_pos[src_kf] / scale                        # (P, 2)
    d2 = jnp.sum((cand_xy[:, None, :] - busy_pos[None]) ** 2, axis=-1)
    d2 = jnp.where(busy[None, :], d2, jnp.inf)
    cand_ok = cand_ok & (jnp.min(d2, axis=-1) >= thin_radius ** 2)

    # --- Source ray and epipolar segment in the target view
    # (ref: src/MapMaker.cc:544-600).
    root_pos = levelops.level_zero_pos(cand_xy, level)           # (C, 2) L0
    z1_src = atan.unproject(root_pos, cam)
    ray_sc = jnp.concatenate([z1_src, jnp.ones((C, 1))], axis=-1)
    ray_sc = ray_sc / jnp.linalg.norm(ray_sc, axis=-1, keepdims=True)
    ray_wc = ray_sc @ src_pose.R                                  # R^T rows
    ray_tc = ray_wc @ tgt_pose.R.T

    depth_mean = m.kf_depth_mean[src_kf]
    depth_sigma = m.kf_depth_sigma[src_kf]
    start_depth = jnp.maximum(wiggle_scale, depth_mean - depth_sigma)
    end_depth = jnp.minimum(40.0 * wiggle_scale, depth_mean + depth_sigma)

    cam_center_w = -src_pose.R.T @ src_pose.t
    cam_center_t = tgt_pose.R @ cam_center_w + tgt_pose.t
    ray_start = cam_center_t[None] + start_depth * ray_tc         # (C, 3)
    ray_end = cam_center_t[None] + end_depth * ray_tc
    geom_ok = (ray_end[:, 2] > ray_start[:, 2]) & (ray_end[:, 2] > 0.0)
    # Nudge the start in front of the camera if needed.
    need = ray_start[:, 2] <= 0.0
    tshift = (0.001 - ray_start[:, 2]) / jnp.where(
        jnp.abs(ray_tc[:, 2]) < 1e-12, 1e-12, ray_tc[:, 2])
    ray_start = jnp.where(need[:, None], ray_start + tshift[:, None]
                          * ray_tc, ray_start)

    v2a = ray_start[:, :2] / ray_start[:, 2:3]
    v2b = ray_end[:, :2] / ray_end[:, 2:3]
    along = v2a - v2b
    seg_len2 = jnp.sum(along * along, axis=-1)
    geom_ok = geom_ok & (seg_len2 >= 1e-8)
    along = along / jnp.sqrt(jnp.maximum(seg_len2, 1e-12))[:, None]
    normal = jnp.stack([along[:, 1], -along[:, 0]], axis=-1)
    norm_dist = jnp.sum(v2a * normal, axis=-1)
    geom_ok = geom_ok & (jnp.abs(norm_dist) <= cam.largest_radius)
    min_len = jnp.clip(jnp.minimum(jnp.sum(along * v2a, -1),
                                   jnp.sum(along * v2b, -1)) - 0.05,
                       -2.0, 2.0)
    max_len = jnp.clip(jnp.maximum(jnp.sum(along * v2a, -1),
                                   jnp.sum(along * v2b, -1)) + 0.05,
                       -2.0, 2.0)

    # --- Source templates: unwarped 8x8 at the candidate, from src atlas
    # (ref: MakeTemplateCoarseNoWarp, src/PatchFinder.cc:137-148).
    cand_atlas = levelops.atlas_pos(cand_xy, jnp.full(C, level, jnp.int32),
                                    H, W)
    src_b = jnp.stack(levelops.level_bounds(
        jnp.full(C, level, jnp.int32), H, W), axis=-1)
    templates, tmpl_ok = patchops.make_warped_templates(
        m.kf_atlas, jnp.full(C, src_kf, jnp.int32), cand_atlas,
        jnp.broadcast_to(jnp.eye(2), (C, 2, 2)), src_b)

    # --- Target corners at this level + their z=1-plane cache
    # (ref: src/MapMaker.cc:608-617).
    corners = m.kf_max_xy[tgt_kf, level].astype(jnp.float32)     # (N, 2)
    corners_valid = m.kf_max_valid[tgt_kf, level]
    corners_l0 = levelops.level_zero_pos(corners, level)
    corner_z1 = atan.unproject(corners_l0, cam)                   # (N, 2)

    max_dist = cam.one_pixel_dist * (4.0 + 1.0 * scale)
    dd = norm_dist[:, None] - jnp.einsum("nj,cj->cn", corner_z1, normal)
    along_pos = jnp.einsum("nj,cj->cn", corner_z1, along)        # (C, N)
    pair_ok = ((dd * dd <= max_dist * max_dist)
               & (along_pos >= min_len[:, None])
               & (along_pos <= max_len[:, None])
               & corners_valid[None, :])

    # --- ZMSSD of every (candidate, corner) pair as one matmul
    # (ref: ZMSSDAtPoint over the corner loop, src/MapMaker.cc:622-636).
    # Patch extraction via the banded row-take gather: vmap(dynamic_slice)
    # lowers to a SERIAL while loop inside large programs (round-1 trace).
    from ptam_cg_tpu.ops.gather import gather_windows

    tgt_atlas = m.kf_atlas[tgt_kf]
    corner_atlas = levelops.atlas_pos(corners, jnp.full(
        corners.shape[0], level, jnp.int32), H, W)
    origin = jnp.stack([corner_atlas[:, 1].astype(jnp.int32) - 4,
                        corner_atlas[:, 0].astype(jnp.int32) - 4], -1)
    patches = gather_windows(tgt_atlas, origin, 8)                # (N, 8, 8)
    I = patches.reshape(-1, 64)
    T = templates.reshape(-1, 64)
    SA = jnp.sum(T, axis=-1)                                      # (C,)
    SB = jnp.sum(I, axis=-1)                                      # (N,)
    ST2 = jnp.sum(T * T, axis=-1)
    SI2 = jnp.sum(I * I, axis=-1)
    # Explicit DEFAULT precision: an image-value dot, exempt from the
    # job-level pinned-f32 context (TF32 on the GPU).
    cross = jnp.matmul(T, I.T,
                       precision=jax.lax.Precision.DEFAULT)  # (C, N)
    zmssd = ((2.0 * SA[:, None] * SB[None] - SA[:, None] ** 2
              - SB[None] ** 2) / 64.0
             + SI2[None] + ST2[:, None] - 2.0 * cross)
    zmssd = jnp.where(pair_ok, zmssd, jnp.float32(3.4e38))
    best_n = jnp.argmin(zmssd, axis=-1)                           # (C,)
    best_ssd = jnp.take_along_axis(zmssd, best_n[:, None], axis=-1)[:, 0]
    found = best_ssd < MAX_SSD

    # --- Sub-pixel refinement on the target (ref: :642-649).
    start_pos = corner_atlas[best_n]
    tgt_b = jnp.stack(levelops.level_bounds(
        jnp.full(C, level, jnp.int32), H, W), axis=-1)
    sp = patchops.subpix_refine(tgt_atlas, templates, start_pos, tgt_b,
                                max_its=10)
    accepted = (cand_ok & geom_ok & tmpl_ok & found & sp.converged)

    # --- Triangulate (ref: :651-653).
    offs = jnp.asarray([[c, r] for (r, c) in levelops.level_offsets(H, W)],
                       jnp.float32)
    tgt_level_pos = sp.pos - offs[level]
    tgt_l0 = levelops.level_zero_pos(tgt_level_pos, level)
    z1_tgt = atan.unproject(tgt_l0, cam)
    src_from_tgt = se3lib.mul(src_pose, se3lib.inv(tgt_pose))
    p_tgt = geometry.triangulate(src_from_tgt, z1_src, z1_tgt)
    p_world = se3lib.apply(se3lib.inv(tgt_pose), p_tgt)

    # --- Allocate map slots for accepted candidates -----------------------
    free_idx = jnp.nonzero(~m.point_valid, size=C, fill_value=P)[0]
    rank = jnp.cumsum(accepted.astype(jnp.int32)) - 1
    slot = jnp.where(accepted, free_idx[jnp.clip(rank, 0, C - 1)], P)
    n_added = jnp.sum((accepted & (slot < P)).astype(jnp.int32))

    c_nc, r_nc, d_nc, nrm = ms.make_point_rays(
        cand_xy, jnp.full(C, level, jnp.int32), src_pose, cam, image_size)

    def scat(arr, val):
        return arr.at[slot].set(val, mode="drop")

    new_m = m._replace(
        point_pos=scat(m.point_pos, p_world),
        point_valid=m.point_valid.at[slot].set(True, mode="drop"),
        point_src_kf=scat(m.point_src_kf, jnp.full(C, src_kf, jnp.int32)),
        point_src_level=scat(m.point_src_level,
                             jnp.full(C, level, jnp.int32)),
        point_center=scat(m.point_center, cand_xy),
        point_center_nc=scat(m.point_center_nc, c_nc),
        point_right_nc=scat(m.point_right_nc, r_nc),
        point_down_nc=scat(m.point_down_nc, d_nc),
        point_normal_nc=scat(m.point_normal_nc, nrm),
        point_inlier=scat(m.point_inlier, jnp.zeros(C, jnp.int32)),
        point_outlier=scat(m.point_outlier, jnp.zeros(C, jnp.int32)),
        point_source=scat(m.point_source,
                          jnp.full(C, ms.SRC_EPIPOLAR, jnp.int32)),
    )
    new_m = ms.refresh_pixel_vectors(new_m)

    # --- Measurements in both keyframes (ref: :668-684) ------------------
    ok_slot = accepted & (slot < P)
    new_m = ms.set_measurements(
        new_m, src_kf, slot, root_pos,
        jnp.full(C, level, jnp.int32), jnp.ones(C, bool),
        jnp.full(C, ms.SRC_ROOT, jnp.int32), ok_slot)
    new_m = ms.set_measurements(
        new_m, tgt_kf, slot, tgt_l0,
        jnp.full(C, level, jnp.int32), jnp.ones(C, bool),
        jnp.full(C, ms.SRC_EPIPOLAR, jnp.int32), ok_slot)

    new_mask = jnp.zeros(P, bool).at[slot].set(True, mode="drop")
    return new_m, n_added, new_mask


# ---------------------------------------------------------------------------
# Re-find data association
# ---------------------------------------------------------------------------

def refind_in_kf(m: MapState, k, point_mask: Array, cam: atan.Camera,
                 image_size, range_l0: float = 4.0) -> Tuple[MapState, Array]:
    """Batched ReFind_Common over all selected points in keyframe ``k``
    (ref: src/MapMaker.cc:943-1020). Returns (map, n_found)."""
    W, H = image_size
    P = m.point_pos.shape[0]
    pose = SE3(m.kf_R[k], m.kf_t[k])

    active = (point_mask & m.point_valid & m.kf_valid[k]
              & ~m.meas_valid[k] & ~m.never_retry[k])

    p_cam = m.point_pos @ pose.R.T + pose.t
    z = p_cam[:, 2]
    z_ok = z > 0.001
    safe_z = jnp.where(z_ok, z, 1.0)
    z1 = p_cam[:, :2] / safe_z[:, None]
    r_ok = jnp.sum(z1 * z1, -1) <= cam.largest_radius ** 2
    pix = atan.project(z1, cam)
    in_im = ((pix[:, 0] >= 0) & (pix[:, 1] >= 0)
             & (pix[:, 0] <= W) & (pix[:, 1] <= H))
    proj_ok = z_ok & r_ok & in_im

    cam_derivs = atan.project_derivs(z1, cam)
    warp = patchops.search_level_and_warp(
        p_cam, pose.R, m.point_right_w, m.point_down_w, cam_derivs)
    level = warp.level
    scale = levelops.level_scale(level)

    src_center = levelops.atlas_pos(m.point_center, m.point_src_level,
                                    H, W)
    m2 = patchops.inv2x2(warp.warp_inv) * scale[..., None, None]
    src_b = jnp.stack(levelops.level_bounds(m.point_src_level, H, W),
                      axis=-1)
    templates, tmpl_ok = patchops.make_warped_templates(
        m.kf_atlas, m.point_src_kf, src_center, m2, src_b)

    searchable = active & proj_ok & warp.good & tmpl_ok
    centers = levelops.atlas_pos(levelops.level_n_pos(pix, level), level,
                                 H, W)
    radius = jnp.ceil(range_l0 / scale)
    bounds = jnp.stack(levelops.level_bounds(level, H, W), axis=-1)
    res, win, win_origin = patchops.ssd_search(
        m.kf_atlas[k], m.kf_corner_mask[k], templates, centers, radius,
        bounds, r_win=4, max_ssd=MAX_SSD, return_windows=True)
    found = searchable & res.found

    # Subpix for level > 0 (ref: :997-1008).
    sp = patchops.subpix_refine(m.kf_atlas[k], templates, res.pos, bounds,
                                max_its=8, windows=win,
                                win_origin=win_origin)
    use_sp = found & (level > 0)
    pos_atlas = jnp.where(use_sp[:, None], sp.pos, res.pos)
    offs = jnp.asarray([[c, r] for (r, c) in levelops.level_offsets(H, W)],
                       jnp.float32)
    pos_l0 = levelops.level_zero_pos(pos_atlas - offs[level], level)

    # Failures -> never retry (every failure branch in the reference
    # inserts into sNeverRetryKFs).
    fail = active & ~found
    new_never = m.never_retry.at[k].set(m.never_retry[k] | fail)

    idx = jnp.arange(P)
    new_m = m._replace(never_retry=new_never)
    new_m = ms.set_measurements(
        new_m, k, idx, pos_l0, level, use_sp,
        jnp.full(P, ms.SRC_REFIND, jnp.int32), found)
    return new_m, jnp.sum(found.astype(jnp.int32))


def refind_all_kfs(m: MapState, mask2d: Array, cam: atan.Camera,
                   image_size, ks: Array | None = None
                   ) -> Tuple[MapState, Array]:
    """Re-find over keyframes in ONE jitted program: a lax.scan of
    ``refind_in_kf`` over the KF axis (instead of K sequential host
    dispatches).
    ``mask2d`` is (K, P): the per-keyframe point selection (broadcast a
    (P,) mask for ReFindNewlyMade, pass the failure mask for
    ReFindFromFailureQueue; ref: src/MapMaker.cc:1046-1081).

    ``ks``: optional (S,) keyframe-index array to scan a SPAN of slots
    instead of all K — the scheduler splits the 64/128-KF scan into
    16-KF spans dispatched on successive frames so a single scan never
    monopolizes the device behind a tracking frame. Indices
    past K-1 are clamped by gather; a re-scanned slot is a no-op (its
    ``has_work`` check excludes already-measured points).

    Returns (map, found count over the scanned span).
    """
    K = m.kf_valid.shape[0]
    if ks is None:
        ks = jnp.arange(K)

    def body(carry, k):
        mm_ = carry
        # Runtime skip for keyframes with no work: lax.cond executes only
        # one branch, so invalid/empty KF slots cost ~nothing instead of
        # a full P-point window search (matters at 16 slots x 4096 pts).
        has_work = mm_.kf_valid[k] & jnp.any(
            mask2d[k] & mm_.point_valid & ~mm_.meas_valid[k]
            & ~mm_.never_retry[k])

        def run(mm__):
            return refind_in_kf(mm__, k, mask2d[k], cam, image_size)

        def skip(mm__):
            return mm__, jnp.int32(0)

        new_m, nf = jax.lax.cond(has_work, run, skip, mm_)
        return new_m, nf

    m, nfs = jax.lax.scan(body, m, ks)
    return m, jnp.sum(nfs)


def local_ba_masks(m: MapState, newest, n_neighbors: int = 4):
    """Adjust/fixed/point masks for local BA, all device-side
    (ref: BundleAdjustRecent, src/MapMaker.cc:788-829): newest + the
    ``n_neighbors`` nearest non-fixed KFs adjusted; every other KF that
    observes one of their points is held fixed."""
    K = m.kf_valid.shape[0]
    d = ms.closest_kf_distances(m, SE3(m.kf_R[newest], m.kf_t[newest]))
    d = d.at[newest].set(jnp.inf)
    _, idx = jax.lax.top_k(-d, min(n_neighbors, K))
    near = jnp.zeros(K, bool).at[idx].set(jnp.isfinite(d[idx]))
    adjust = (near & ~m.kf_fixed).at[newest].set(True) & m.kf_valid
    pts = jnp.any(m.meas_valid & adjust[:, None], axis=0) & m.point_valid
    observers = jnp.any(m.meas_valid & pts[None, :], axis=1)
    fixed = observers & ~adjust & m.kf_valid
    return adjust, fixed, pts


#: Epipolar expansion level order (ref: AddSomeMapPoints calls,
#: src/MapMaker.cc:507-510: levels 3, 0, 1, 2).
EPI_LEVEL_ORDER = (3, 0, 1, 2)


def integrate_insert_program(m: MapState, features: FrameFeatures,
                             pose: SE3, meas_point: Array,
                             meas_pos: Array, meas_level: Array,
                             meas_subpix: Array, meas_valid: Array,
                             depth_mean, depth_sigma, cam: atan.Camera,
                             image_size):
    """Keyframe-integration phase 0 as one jitted program: slot
    allocation, insert, tracker measurements, re-find of all existing
    points in the new KF (ref: AddKeyFrameFromTopOfQueue,
    src/MapMaker.cc:493-505). Returns (map, slot device scalar)."""
    # First free keyframe slot (the engine's capacity heuristic
    # guarantees one exists before enqueueing).
    slot = jnp.argmin(m.kf_valid.astype(jnp.int32))
    m = ms.insert_keyframe(m, slot, features, pose, depth_mean,
                           depth_sigma)
    m = ms.set_measurements(
        m, slot, meas_point, meas_pos, meas_level, meas_subpix,
        jnp.full_like(meas_level, ms.SRC_TRACKER), meas_valid)
    m, _ = refind_in_kf(m, slot, m.point_valid, cam, image_size)
    return m, slot.astype(jnp.int32)


def integrate_epi_program(m: MapState, slot, new_point_mask: Array,
                          total, level: int, cam: atan.Camera,
                          image_size, wiggle_scale: float,
                          thin_radius: float, pack: bool = False):
    """One epipolar-expansion level of keyframe integration
    (ref: AddSomeMapPoints, src/MapMaker.cc:448-457, 507-510), target KF
    chosen device-side. With ``pack`` (the final level) the result also
    carries the packed (slot, n_added_total) control vector so the
    caller pays ONE deferred read for the whole integration."""
    tgt = closest_kf(m, slot)
    m, n, mask_l = add_points_epipolar(
        m, slot, tgt, level, cam, image_size, wiggle_scale, thin_radius)
    new_point_mask = new_point_mask | mask_l
    total = total + n
    if pack:
        return m, new_point_mask, jnp.stack([slot.astype(jnp.int32),
                                             total])
    return m, new_point_mask, total


def integrate_keyframe_program(m: MapState, features: FrameFeatures,
                               pose: SE3, meas_point: Array,
                               meas_pos: Array, meas_level: Array,
                               meas_subpix: Array, meas_valid: Array,
                               depth_mean, depth_sigma,
                               new_point_mask: Array, cam: atan.Camera,
                               image_size, wiggle_scale: float,
                               thin_radius: float):
    """Whole keyframe integration as ONE jitted program
    (ref: AddKeyFrameFromTopOfQueue, src/MapMaker.cc:493-518): the
    composition of ``integrate_insert_program`` + the four
    ``integrate_epi_program`` levels. The production scheduler runs the
    five phases as SEPARATE dispatches interleaved with tracking frames
    (round 4 — bounding the KF-frame latency spike); this fused variant
    remains the single-dispatch reference for throughput benches
    (bench_mapping.py) and equality tests.

    Returns (map, new_point_mask | added, packed (slot, n_added)).
    """
    m, slot = integrate_insert_program(
        m, features, pose, meas_point, meas_pos, meas_level, meas_subpix,
        meas_valid, depth_mean, depth_sigma, cam, image_size)
    total = jnp.int32(0)
    for lev in EPI_LEVEL_ORDER[:-1]:
        m, new_point_mask, total = integrate_epi_program(
            m, slot, new_point_mask, total, lev, cam, image_size,
            wiggle_scale, thin_radius)
    # slot + n_added packed so the caller pays ONE blocking read.
    m, new_point_mask, slot_n = integrate_epi_program(
        m, slot, new_point_mask, total, EPI_LEVEL_ORDER[-1], cam,
        image_size, wiggle_scale, thin_radius, pack=True)
    return m, new_point_mask, slot_n


def epipolar_job(m: MapState, src_kf, new_point_mask: Array, level: int,
                 cam: atan.Camera, image_size, wiggle_scale: float,
                 thin_radius: float):
    """AddSomeMapPoints with the closest-KF target chosen device-side
    (ref: src/MapMaker.cc:448-457). Jittable with ``level`` static."""
    tgt = closest_kf(m, src_kf)
    m, n, mask = add_points_epipolar(m, src_kf, tgt, level, cam,
                                     image_size, wiggle_scale, thin_radius)
    return m, n, new_point_mask | mask


def apply_bundle_job(m: MapState, prob, meas_k, meas_p, adjust_kf,
                     point_mask, failure_mask, cam_idx=None, pt_idx=None):
    """apply_bundle + failure-queue accumulation in one program."""
    out, retry = apply_bundle(m, prob, meas_k, meas_p, adjust_kf,
                              point_mask, cam_idx, pt_idx)
    return out, failure_mask | retry


# ---------------------------------------------------------------------------
# Bad-point GC / plane alignment / transforms
# ---------------------------------------------------------------------------

def handle_bad_points(m: MapState,
                      cfg: MapMakerConfig = MapMakerConfig()) -> MapState:
    """Outlier-count GC (ref: MapMaker::HandleBadPoints,
    src/MapMaker.cc:131-153): more outliers than inliers and > threshold
    -> point trashed (valid=False) and measurements erased."""
    bad = (m.point_valid
           & (m.point_outlier > cfg.bad_point_outlier_min)
           & (m.point_outlier > m.point_inlier))
    return m._replace(
        point_valid=m.point_valid & ~bad,
        meas_valid=m.meas_valid & ~bad[None, :])


def plane_aligner(m: MapState, key: Array, n_ransacs: int = 100) -> SE3:
    """RANSAC dominant plane -> SE3 putting it at z=0
    (ref: CalcPlaneAligner, src/MapMaker.cc:1100-1195)."""
    P = m.point_pos.shape[0]
    valid = m.point_valid
    n = jnp.sum(valid.astype(jnp.int32))

    # Sample 3 distinct valid indices per trial via random keys.
    r = jax.random.uniform(key, (n_ransacs, P))
    r = jnp.where(valid[None], r, -1.0)
    _, idx3 = jax.lax.top_k(r, 3)                         # (T, 3)
    pa = m.point_pos[idx3[:, 0]]
    pb = m.point_pos[idx3[:, 1]]
    pc = m.point_pos[idx3[:, 2]]
    mean3 = (pa + pb + pc) / 3.0
    nrm = jnp.cross(pc - pa, pb - pa)
    nlen = jnp.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = nrm / jnp.where(nlen < 1e-12, 1.0, nlen)

    diff = m.point_pos[None] - mean3[:, None]             # (T, P, 3)
    ndist = jnp.abs(jnp.einsum("tpj,tj->tp", diff, nrm))
    ndist = jnp.minimum(ndist, 0.05)
    dist_sq = jnp.sum(diff * diff, axis=-1)
    contrib = jnp.where(valid[None] & (dist_sq > 0), ndist, 0.0)
    scores = jnp.sum(contrib, axis=-1)
    scores = jnp.where(nlen[:, 0] < 1e-12, jnp.inf, scores)
    best = jnp.argmin(scores)
    bmean, bnorm = mean3[best], nrm[best]

    diffb = m.point_pos - bmean
    inl = valid & (jnp.abs(diffb @ bnorm) < 0.05) \
        & (jnp.sum(diffb * diffb, -1) > 0)
    wn = jnp.maximum(jnp.sum(inl.astype(jnp.float32)), 1.0)
    mean_in = jnp.sum(jnp.where(inl[:, None], m.point_pos, 0.0),
                      axis=0) / wn
    d = (m.point_pos - mean_in) * inl[:, None]
    cov = jnp.dot(d.T, d, precision=jax.lax.Precision.HIGHEST)
    _, vecs = jnp.linalg.eigh(cov)
    normal = vecs[:, 0]
    normal = jnp.where(normal[2] > 0, -normal, normal)

    # Gram-Schmidt rotation with the normal as the z row.
    r0 = jnp.array([1.0, 0.0, 0.0])
    r0 = r0 - normal * (r0 @ normal)
    r0 = r0 / jnp.maximum(jnp.linalg.norm(r0), 1e-12)
    r1 = jnp.cross(normal, r0)
    R = jnp.stack([r0, r1, normal])
    t = -(R @ mean_in)
    # Too few points -> identity (ref: :1103-1106).
    R = jnp.where(n < 10, jnp.eye(3), R)
    t = jnp.where(n < 10, jnp.zeros(3), t)
    return SE3(R, t)


def apply_global_transform(m: MapState, T: SE3) -> MapState:
    """ApplyGlobalTransformationToMap (ref: src/MapMaker.cc:463-472):
    poses compose with T^-1, points move by T."""
    Tinv = se3lib.inv(T)
    new_R = jnp.einsum("kij,jl->kil", m.kf_R, Tinv.R)
    new_t = jnp.einsum("kij,j->ki", m.kf_R, Tinv.t) + m.kf_t
    new_pts = m.point_pos @ T.R.T + T.t
    out = m._replace(kf_R=new_R, kf_t=new_t, point_pos=new_pts)
    return ms.refresh_pixel_vectors(out)


# ---------------------------------------------------------------------------
# BA extraction / application
# ---------------------------------------------------------------------------

def extract_bundle(m: MapState, adjust_kf: Array, fixed_kf: Array,
                   point_mask: Array, max_meas: int):
    """Dense measurement matrix -> masked BundleProblem
    (ref: MapMaker::BundleAdjust ID-mapping, src/MapMaker.cc:838-888).

    Returns (problem, meas_k (M,), meas_p (M,), n_selected) —
    ``n_selected`` is the TRUE measurement count before the static
    ``max_meas`` cap. If it exceeds the cap, the selection is
    PRIORITIZED rather than arbitrarily truncated (VERDICT r2 #2):
    ROOT-provenance measurements first (they anchor a point's source
    patch; losing one kills the point, ref: src/MapMaker.cc:916-919),
    then measurements of scarcely-observed points (BA needs >= 2 views
    to constrain a point at all), then newer keyframes. MapMaker warns
    when the prioritized path engages.
    """
    K, P = m.meas_valid.shape
    incl_kf = adjust_kf | fixed_kf
    pt_ok = point_mask & m.point_valid
    include = m.meas_valid & incl_kf[:, None] & pt_ok[None, :]
    n = jnp.sum(include.astype(jnp.int32))
    k_idx, p_idx = _select_measurements(m, include, max_meas, n)
    mvalid = jnp.arange(max_meas) < n

    level = m.meas_level[k_idx, p_idx]
    prob = bundlelib.BundleProblem(
        cam_R=m.kf_R, cam_t=m.kf_t,
        cam_fixed=fixed_kf | ~adjust_kf,
        cam_valid=incl_kf,
        pt_pos=m.point_pos, pt_valid=pt_ok,
        meas_cam=k_idx, meas_pt=p_idx,
        meas_pos=m.meas_pos[k_idx, p_idx],
        meas_sqrt_inv_noise=1.0 / levelops.level_scale(level),
        meas_valid=mvalid,
        meas_bad=jnp.zeros(max_meas, bool))
    return prob, k_idx, p_idx, n


def _pow2ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << (max(int(n), 1) - 1).bit_length()


def _select_measurements(m: MapState, include: Array, max_meas: int,
                         n: Array):
    """Pick ``max_meas`` (k, p) measurement indices from the (K, P)
    ``include`` table — lexical when everything fits, PRIORITIZED on
    overflow (see extract_bundle docstring for the policy)."""
    K, P = include.shape

    def lexical(_):
        k, p = jnp.nonzero(include, size=max_meas, fill_value=0)
        return k.astype(jnp.int32), p.astype(jnp.int32)

    def prioritized(_):
        cnt = jnp.sum(include.astype(jnp.float32), axis=0)     # (P,)
        score = (2.0 * (m.meas_source == ms.SRC_ROOT).astype(jnp.float32)
                 + 4.0 / jnp.maximum(cnt, 1.0)[None, :]
                 + 0.5 * (jnp.arange(K, dtype=jnp.float32) / K)[:, None]
                 + 1.0)
        flat = jnp.where(include, score, 0.0).reshape(-1)
        _, idx = jax.lax.top_k(flat, max_meas)
        return ((idx // P).astype(jnp.int32),
                (idx % P).astype(jnp.int32))

    # Only the taken branch executes under lax.cond, so the top_k over
    # the full (K*P) table costs nothing until an overflow happens.
    return jax.lax.cond(n <= max_meas, lexical, prioritized, None)


def extract_bundle_compact(m: MapState, adjust_kf: Array, fixed_kf: Array,
                           point_mask: Array, max_cams: int, max_pts: int,
                           max_meas: int):
    """``extract_bundle`` with CAMERA and POINT compaction: the problem
    is gathered into (max_cams, max_pts, max_meas)-shaped buffers holding
    only included cameras / observed points, so LM-step cost follows the
    LIVE map size instead of the map's static capacity. MapMaker sizes
    the caps from host-known counts in power-of-two tiers
    (``MapMaker._ba_caps``), instead of paying full-capacity shapes
    (e.g. C=16, P=4096, M=16384) for a ~10-KF/450-pt map on every BA
    dispatch.

    Returns ``(prob, meas_k, meas_p, cam_idx, pt_idx, counts)``:
    ``meas_k``/``meas_p`` stay GLOBAL (K, P)-space indices (outlier
    write-back uses them), ``cam_idx``/``pt_idx`` map compact slot ->
    global index (fill K / P = unused slot), and ``counts`` is the int32
    vector (n_cams, n_pts, n_meas) of TRUE pre-cap sizes for the
    caller's deferred overflow check (tier escalation / warning).
    """
    K, P = m.meas_valid.shape
    incl_kf = adjust_kf | fixed_kf
    pt_ok = point_mask & m.point_valid
    include = m.meas_valid & incl_kf[:, None] & pt_ok[None, :]
    pt_used = jnp.any(include, axis=0)
    n_c = jnp.sum(incl_kf.astype(jnp.int32))
    n_p = jnp.sum(pt_used.astype(jnp.int32))
    n = jnp.sum(include.astype(jnp.int32))

    cam_idx = jnp.nonzero(incl_kf, size=max_cams,
                          fill_value=K)[0].astype(jnp.int32)
    pt_idx = jnp.nonzero(pt_used, size=max_pts,
                         fill_value=P)[0].astype(jnp.int32)
    # Global -> compact slot maps; overflowing/unincluded entries keep
    # the out-of-range cap value (their measurements are masked below;
    # one-hot rows / mode="drop" scatters drop them device-side).
    cam_slot = jnp.full((K,), max_cams, jnp.int32).at[cam_idx].set(
        jnp.arange(max_cams, dtype=jnp.int32), mode="drop")
    pt_slot = jnp.full((P,), max_pts, jnp.int32).at[pt_idx].set(
        jnp.arange(max_pts, dtype=jnp.int32), mode="drop")

    k_idx, p_idx = _select_measurements(m, include, max_meas, n)
    mc = cam_slot[k_idx]
    mp = pt_slot[p_idx]
    mvalid = ((jnp.arange(max_meas) < n) & (mc < max_cams)
              & (mp < max_pts))

    cam_g = jnp.minimum(cam_idx, K - 1)     # clamp gathers; slots with
    pt_g = jnp.minimum(pt_idx, P - 1)       # fill stay invalid below
    level = m.meas_level[k_idx, p_idx]
    prob = bundlelib.BundleProblem(
        cam_R=m.kf_R[cam_g], cam_t=m.kf_t[cam_g],
        cam_fixed=(fixed_kf | ~adjust_kf)[cam_g] | (cam_idx >= K),
        cam_valid=incl_kf[cam_g] & (cam_idx < K),
        pt_pos=m.point_pos[pt_g],
        pt_valid=pt_used[pt_g] & (pt_idx < P),
        meas_cam=mc, meas_pt=mp,
        meas_pos=m.meas_pos[k_idx, p_idx],
        meas_sqrt_inv_noise=1.0 / levelops.level_scale(level),
        meas_valid=mvalid,
        meas_bad=jnp.zeros(max_meas, bool))
    counts = jnp.stack([n_c, n_p, n])
    return prob, k_idx, p_idx, cam_idx, pt_idx, counts


def apply_bundle(m: MapState, prob: bundlelib.BundleProblem,
                 meas_k: Array, meas_p: Array, adjust_kf: Array,
                 point_mask: Array, cam_idx: Optional[Array] = None,
                 pt_idx: Optional[Array] = None) -> Tuple[MapState, Array]:
    """Write back BA results + outlier handling by provenance
    (ref: src/MapMaker.cc:893-933).

    ``cam_idx``/``pt_idx``: compact slot -> global index maps from
    ``extract_bundle_compact`` (None for the dense full-capacity
    extract). ``meas_k``/``meas_p`` are global either way.

    Returns (map, failure_mask (K, P)) where failure_mask marks
    measurements to retry via the failure queue.
    """
    K, P = m.meas_valid.shape
    pt_ok = point_mask & m.point_valid
    if cam_idx is None:
        cam_R_full, cam_t_full = prob.cam_R, prob.cam_t
        pt_pos_full = prob.pt_pos
    else:
        # Scatter compact results back to capacity space; out-of-range
        # fill slots (K / P) drop. Untouched entries keep map values.
        cam_R_full = m.kf_R.at[cam_idx].set(prob.cam_R, mode="drop")
        cam_t_full = m.kf_t.at[cam_idx].set(prob.cam_t, mode="drop")
        pt_pos_full = m.point_pos.at[pt_idx].set(prob.pt_pos,
                                                 mode="drop")
    new_R = jnp.where(adjust_kf[:, None, None], cam_R_full, m.kf_R)
    new_t = jnp.where(adjust_kf[:, None], cam_t_full, m.kf_t)
    new_pts = jnp.where(pt_ok[:, None], pt_pos_full, m.point_pos)

    out_mask2d = jnp.zeros((K, P), bool).at[meas_k, meas_p].max(
        prob.meas_bad & prob.meas_valid)
    src = m.meas_source
    # Root-source outlier or too-few measurements -> bad point. The
    # count is taken BEFORE removal, like the reference's serial check
    # (ref: src/MapMaker.cc:920 GoodMeasCount() <= 2).
    good_count = jnp.sum(m.meas_valid.astype(jnp.int32), axis=0)  # (P,)
    root_out = jnp.any(out_mask2d & (src == ms.SRC_ROOT), axis=0)
    any_out = jnp.any(out_mask2d, axis=0)
    point_bad = any_out & (root_out | (good_count <= 2))

    retry = out_mask2d & ((src == ms.SRC_TRACKER)
                          | (src == ms.SRC_EPIPOLAR)) \
        & ~point_bad[None, :]
    never = out_mask2d & ~retry & ~point_bad[None, :]

    out = m._replace(
        kf_R=new_R, kf_t=new_t, point_pos=new_pts,
        meas_valid=m.meas_valid & ~out_mask2d & ~point_bad[None, :],
        point_valid=m.point_valid & ~point_bad,
        never_retry=m.never_retry | never)
    out = ms.refresh_pixel_vectors(out)
    return out, retry


# ---------------------------------------------------------------------------
# Keyframe distances / heuristics
# ---------------------------------------------------------------------------

def closest_kf(m: MapState, k) -> Array:
    """Index of the nearest other valid keyframe (ref: ClosestKeyFrame,
    src/MapMaker.cc:737-752)."""
    d = ms.closest_kf_distances(m, SE3(m.kf_R[k], m.kf_t[k]))
    d = d.at[k].set(jnp.inf)
    return jnp.argmin(d)


def need_new_kf(m: MapState, pose: SE3, depth_mean,
                wiggle_depth_norm, max_dist_mult: float) -> Array:
    """ref: MapMaker::IsNeedNewKeyFrame (src/MapMaker.cc:754-763)."""
    d = ms.closest_kf_distances(m, pose)
    dist = jnp.min(d) / jnp.maximum(depth_mean, 1e-6)
    return dist > max_dist_mult * wiggle_depth_norm


# ---------------------------------------------------------------------------
# Host orchestrator
# ---------------------------------------------------------------------------

class MapMaker:
    """Host-side priority scheduler over the jitted mapping jobs
    (ref: MapMaker::run, src/MapMaker.cc:57-114). Instead of a CPU thread
    with flag-polling, the caller invokes ``step()`` whenever it wants
    mapping work done; pending keyframes abort long BA runs between jitted
    LM steps just like the reference's abort flag."""

    def __init__(self, m: MapState, cam: atan.Camera, image_size,
                 cfg: MapMakerConfig = MapMakerConfig(),
                 ba_cfg: BundleConfig = BundleConfig(),
                 max_ba_meas: Optional[int] = None, seed: int = 0,
                 mesh=None, mesh_axis: str = "mp",
                 deterministic: Optional[bool] = None):
        """``mesh``: optional ``jax.sharding.Mesh``. When it has more
        than one device on ``mesh_axis``, GLOBAL bundle adjustment runs
        point-sharded over the mesh (parallel/sharded_ba.py) through the
        same non-blocking chunk state machine — the reference's
        always-reachable global BA (ref: src/MapMaker.cc:98-99), scaled
        past one chip. Local/recent BA stays single-device (its problem
        is small and latency-critical).

        ``deterministic``: scheduler determinism mode (round 5 —
        VERDICT r4 #2: the wall-clock BA chunk sizer made KF cadence,
        and therefore the whole map, vary with HOST LOAD even on CPU
        with a fixed seed, which is how the 128-KF capacity e2e went
        flaky). True = every readiness gate blocks and BA chunks are a
        fixed ``ba_steps_per_pass`` iterations, so a run is a pure
        function of its inputs — the reference's deterministic dataset
        replay (ref: src/VideoSource.cc:59-151). False = latency mode:
        non-blocking readiness gates + the measured per-step EMA chunk
        sizer, where a host read never waits on unfinished work). None
        (default) auto-selects: deterministic on the CPU backend (tests,
        dataset replay), latency mode on accelerators.
        """
        self.map = m
        self.cam = cam
        self.image_size = image_size
        self.cfg = cfg
        self.ba_cfg = ba_cfg
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self._use_sharded = (mesh is not None
                             and mesh.shape[mesh_axis] > 1)
        if deterministic is None:
            deterministic = jax.default_backend() == "cpu"
        self.deterministic = deterministic
        K, P = m.meas_valid.shape
        if max_ba_meas is None:
            # Auto-size the global-BA measurement capacity to the map's
            # keyframe capacity x the expected per-KF measurement budget
            # (VERDICT r2 #2: 4096 overflowed at a mere 8 KFs). The hard
            # worst case is K*P (every point seen in every KF) which is
            # infeasible to allocate at MAX_KEYFRAMES x MAX_POINTS; if a
            # run ever exceeds this heuristic, extract_bundle switches
            # to prioritized selection and a warning fires.
            from ptam_cg_tpu.config import MAX_MEAS_PER_KF
            max_ba_meas = min(K * MAX_MEAS_PER_KF, K * P)
        self.max_ba_meas = max_ba_meas
        self.failure_mask = jnp.zeros((K, P), bool)
        self.new_point_mask = jnp.zeros(P, bool)

        # --- jitted mapping programs (VERDICT r1 #2: no eager jnp ops in
        # the priority loop; each job is one device dispatch). Built once
        # per MapMaker; config scalars are baked in as compile-time
        # constants.
        wiggle, thin = cfg.wiggle_scale, cfg.thin_candidates_radius

        def pinned(fn):
            # Every mapping job runs its geometry (triangulation,
            # epipolar rays, pose products, plane fit) at pinned-f32
            # matmul precision (see utils/se3._pinned_f32). Image-value
            # ZMSSD dots inside opt back into the default explicitly.
            def wrapped(*a, **k):
                with jax.default_matmul_precision("float32"):
                    return fn(*a, **k)
            return jax.jit(wrapped)

        self._jit_integrate = pinned(
            lambda m_, feat, pose, mpt, mpos, mlvl, msub, mval, dm, ds,
            npm: integrate_keyframe_program(
                m_, feat, pose, mpt, mpos, mlvl, msub, mval, dm, ds,
                npm, cam, image_size, wiggle, thin))
        # Phase-split keyframe integration (round 4): the scheduler runs
        # insert+refind and each epipolar level as SEPARATE dispatches on
        # successive frames, so no single KF-integration program
        # monopolizes the device behind a tracking frame.
        self._jit_int_insert = pinned(
            lambda m_, feat, pose, mpt, mpos, mlvl, msub, mval, dm, ds:
            integrate_insert_program(m_, feat, pose, mpt, mpos, mlvl,
                                     msub, mval, dm, ds, cam, image_size))
        self._jit_int_epi = {
            lev: pinned(lambda m_, slot, npm, tot, lev=lev:
                        integrate_epi_program(m_, slot, npm, tot, lev,
                                              cam, image_size, wiggle,
                                              thin))
            for lev in EPI_LEVEL_ORDER[:-1]}
        self._jit_int_final = pinned(
            lambda m_, slot, npm, tot: integrate_epi_program(
                m_, slot, npm, tot, EPI_LEVEL_ORDER[-1], cam, image_size,
                wiggle, thin, pack=True))
        #: In-flight phased integration: {"phase": i, "slot": dev,
        #: "tot": dev} — advanced one dispatch per scheduler pass.
        self._integrate_job = None
        #: Backpressure marker: one output leaf of the most recent
        #: mapping dispatch. step() skips issuing a new mapping job
        #: while it hasn't landed, so the device queue never holds more
        #: than ~one mapping program + the tracking pipeline — without
        #: this, a max-rate frame feed accumulates a dispatch backlog
        #: that the (rare) forced decision read then pays in one
        #: blocking hit.
        self._last_dispatch = None
        self._jit_refind_all = pinned(
            lambda m_, mask2d: refind_all_kfs(m_, mask2d, cam, image_size))
        # Span-scan variant: the same lax.scan over a 16-slot index
        # window so the 64/128-KF refind spreads over several frames.
        # One compiled
        # program serves every span (the index array is traced).
        self._jit_refind_span = pinned(
            lambda m_, mask2d, ks: refind_all_kfs(m_, mask2d, cam,
                                                  image_size, ks))
        span = min(16, K)
        self._span_ks = [jnp.arange(k0, k0 + span)
                         for k0 in range(0, K - span + 1, span)]
        if K % span:    # tail span re-uses the last full window's shape
            self._span_ks.append(jnp.arange(K - span, K))
        #: In-flight span-refind task: {"mask2d": (K,P) bool, "i": int}.
        self._refind_task = None
        self._jit_epipolar = {
            lev: pinned(lambda m_, src, npm, lev=lev: epipolar_job(
                m_, src, npm, lev, cam, image_size, wiggle, thin))
            for lev in range(LEVELS)}
        self._jit_local_masks = pinned(local_ba_masks)
        #: Compact extraction: static (max_cams, max_pts, max_meas) caps
        #: — one compiled variant per tier, cached by jit's shape/static
        #: specialization.
        self._jit_extract = jax.jit(extract_bundle_compact,
                                    static_argnums=(4, 5, 6))
        self._jit_apply = pinned(apply_bundle_job)
        # --- BA size tiers (power-of-two caps; see extract_bundle_compact
        # and _ba_caps). Floors only ratchet UP (overflow escalation).
        self._tier_c_floor = 4
        self._tier_p_floor = 1024
        self._tier_m_floor = 4096
        #: Host-side live point-count estimate; the engine refreshes it
        #: from its deferred decision reads (lags <= decision_interval
        #: frames — the 1.5x tier margin absorbs the lag).
        self._n_points_hint = 0
        #: True measurement count observed at the last BA extract
        #: (deferred read) — sizes the next run's measurement cap.
        self._last_n_sel = 0
        self._jit_gc = pinned(lambda m_: handle_bad_points(m_, cfg))
        self._jit_plane_align = pinned(
            lambda m_, key: apply_global_transform(
                m_, plane_aligner(m_, key, cfg.plane_aligner_ransacs)))
        #: Host-side keyframe count — avoids a device sync per frame in
        #: the engine's KF heuristics (updated by integrate/init).
        self._n_kfs_host = int(jnp.sum(m.kf_valid.astype(jnp.int32)))
        #: Host mirror of map.good — the device flag only transitions at
        #: stereo init (initializer sets this True) and reset; reading
        #: bool(self.map.good) in step() was a blocking device round
        #: trip on every frame whose map object had just changed.
        self.good_host = bool(m.good)
        #: Deferred KF-integration result (see integrate_keyframe): the
        #: (slot, n_added) vector is async-copied and read on a later
        #: pass so the KF frame never blocks on the integrate program.
        self._pending_integrate = None
        #: In-flight non-blocking BA job (see _ba_start/_ba_poll).
        self._ba_job = None
        # Host-side pending flags avoid per-frame device syncs
        # (bool(jnp.any(...)) blocks the dispatch pipeline).
        self._new_points_pending = False
        self._failures_pending = False
        self._map_dirty = False
        self.converged_recent = True
        self.converged_full = True
        #: Set when BA blows up numerically — the engine must ditch the
        #: map (ref: src/MapMaker.cc:887-892 "Ditching the map").
        self.reset_requested = False
        self.kf_queue: list = []          # [(FrameFeatures, pose, meas)]
        self.wiggle_depth_norm = 1.0
        self.key = jax.random.PRNGKey(seed)
        self._rng = np.random.default_rng(seed)
        #: LM scalar template (lambda etc. are config constants): a
        #: fresh init_lm per BA run would device_put ~7 scalars.
        self._lm_template = bundlelib.init_lm(None, ba_cfg)
        #: Cached device zero (a fresh jnp.int32(0) per keyframe is an
        #: eager device_put).
        self._zero_i32 = jnp.int32(0)
        #: Measured per-LM-step wall time EMA (ms); None until the first
        #: chunk lands. Sizes BA chunks to cfg.ba_latency_budget_ms so a
        #: chunk never monopolizes the device much longer than a frame
        #: budget.
        self._ba_step_ms = None

    # -- small helpers ----------------------------------------------------
    def _next_key(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def _note_dispatch(self, arr):
        """Record one output leaf of a mapping dispatch for the
        scheduler's backpressure gate (see _last_dispatch)."""
        self._last_dispatch = arr

    def queue_size(self) -> int:
        return len(self.kf_queue)

    def n_kfs(self) -> int:
        return self._n_kfs_host

    # -- jobs -------------------------------------------------------------
    def bundle_adjust(self, adjust_kf, fixed_kf, point_mask, recent: bool,
                      full: bool = False, sharded: bool = False):
        """Synchronous BA run to convergence/abort — used by stereo init
        and direct callers. The priority loop instead uses the
        NON-BLOCKING state machine (``_ba_start``/``_ba_poll``)."""
        self._ba_start(adjust_kf, fixed_kf, point_mask, recent, full,
                       sharded=sharded)
        while self._ba_job is not None:
            self._ba_poll(block=True)

    # --- non-blocking BA state machine --------------------------------
    # The reference's mapping-thread BA polls an abort flag between LM
    # iterations (ref: src/Bundle.cc:134,338). Here one LM *chunk*
    # (ba_steps_per_pass iterations as a single device dispatch) is in
    # flight at a time; its control scalars are copied to the host
    # asynchronously and read on a LATER priority pass once ready — the
    # frame loop never blocks on BA.

    def _ba_caps(self):
        """Power-of-two BA problem caps from HOST-known size estimates
        (no device reads): keyframe count, the engine-fed live point
        count, and the previous extract's true measurement count. The
        margins + the ratcheting floors keep overflow transient: an
        undersized pass still optimizes a correct (prioritized) subset,
        escalates the floor, and the next pass covers everything. Caps
        are clamped to map capacity / max_ba_meas — a warning only fires
        when even the MAXIMUM tier overflows (see _ba_poll)."""
        K, P = self.map.meas_valid.shape
        n_c = max(self._n_kfs_host + len(self.kf_queue),
                  self._tier_c_floor)
        c_cap = min(_pow2ceil(n_c), _pow2ceil(K))
        n_p = max(int(self._n_points_hint * 1.5) + 64,
                  self._tier_p_floor)
        p_cap = min(_pow2ceil(n_p), _pow2ceil(P))
        n_m = max(int(self._last_n_sel * 1.5), c_cap * 256,
                  self._tier_m_floor)
        m_cap = min(_pow2ceil(n_m), _pow2ceil(self.max_ba_meas))
        return c_cap, p_cap, m_cap

    def _ba_start(self, adjust_kf, fixed_kf, point_mask, recent: bool,
                  full: bool = False, sharded: bool = False):
        """Dispatch the BA problem EXTRACTION only (at 64-KF scale the
        compact extract is a large program — its own frame slot). The
        first LM chunk goes out at the next ``_ba_poll``."""
        caps = self._ba_caps()
        prob, mk, mp, cam_idx, pt_idx, counts = self._jit_extract(
            self.map, adjust_kf, fixed_kf, point_mask, *caps)
        # Capacity-overflow check: deferred (async copy, read at the
        # first chunk poll together with the chunk flags) — never a
        # blocking read in the frame loop.
        counts.copy_to_host_async()
        self._note_dispatch(counts)
        self._ba_job = dict(mk=mk, mp=mp, cam_idx=cam_idx, pt_idx=pt_idx,
                            adjust=adjust_kf, pmask=point_mask,
                            recent=recent, full=full, flags=None,
                            check_sel=counts, caps=caps, sharded=sharded,
                            prob=prob, state=None)

    def _ba_init_state(self):
        """Phase 2 of the BA start: shard (if meshed) + LM-state init +
        first chunk dispatch."""
        job = self._ba_job
        prob = job.pop("prob")
        if job["sharded"]:
            # Point-shard the problem over the mesh; the host-side
            # measurement reorder blocks on the extract result, which is
            # acceptable at global-BA cadence (one shard per BA run).
            from ptam_cg_tpu.parallel import sharded_ba
            sprob, perm = sharded_ba.shard_problem(
                prob, self.mesh, self.mesh_axis, return_perm=True)
            job.update(orig_prob=prob, perm=perm)
            job["state"] = self._lm_template._replace(problem=sprob)
        else:
            job["state"] = self._lm_template._replace(problem=prob)
        self._ba_dispatch_chunk()

    def _chunk_steps(self) -> int:
        """LM iterations for the next chunk. Deterministic mode: a fixed
        ``ba_steps_per_pass`` — chunk sizing must be a pure function of
        the run's inputs, never of host load (VERDICT r4 #2). Latency
        mode: fit the measured per-step time into
        ``ba_latency_budget_ms`` (hard cap ba_steps_per_pass); the first
        chunk of a MapMaker's life is a 1-step probe."""
        if self.deterministic:
            return self.cfg.ba_steps_per_pass
        if self._ba_step_ms is None:
            return 1
        return max(1, min(self.cfg.ba_steps_per_pass,
                          int(self.cfg.ba_latency_budget_ms
                              / max(self._ba_step_ms, 1e-3))))

    def _ba_dispatch_chunk(self):
        job = self._ba_job
        kind = bundlelib.mest.estimator_id(self.ba_cfg.mestimator)
        c_cap, p_cap, _ = job["caps"]
        if not job["sharded"] and ba_use_single_step(c_cap, p_cap):
            # Large problem: dispatch ONE lm_step per poll instead of
            # the while_loop chunk (see BA_CHUNK_W_BYTES_LIMIT), in the
            # MEMORY-LEAN configuration that tiles the Schur accumulation
            # (config.BundleConfig.soff_tiles; falls back to dense
            # per-field unless the caps divide exactly). Whether the
            # lean path pays on the GPU is ROADMAP C5.
            import dataclasses
            lean = dataclasses.replace(self.ba_cfg, soff_tiles=8,
                                       u_chunks=8)
            stepf = bundlelib._cached_lm_step_flags(lean, kind)
            state, flags = stepf(job["state"], self.cam)
        elif job["sharded"]:
            from ptam_cg_tpu.parallel import sharded_ba
            chunkf = sharded_ba.cached_sharded_lm_chunk(
                self.mesh, self.ba_cfg, kind, self.mesh_axis)
            state, flags = chunkf(job["state"], self.cam,
                                  self._chunk_target(job))
        else:
            chunkf = bundlelib._cached_lm_chunk(self.ba_cfg, kind)
            state, flags = chunkf(job["state"], self.cam,
                                  self._chunk_target(job))
        flags.copy_to_host_async()
        job["state"] = state
        job["flags"] = flags
        job["iters_before"] = job.get("iters_done", 0)
        job["t_dispatch"] = time.perf_counter()
        job["t_notready"] = job["t_dispatch"]
        self._note_dispatch(flags)

    def _chunk_target(self, job) -> Array:
        """Chunk iteration limit: host-known iters so far + the fitted
        per-chunk budget, capped at the global max."""
        return jnp.int32(self.ba_cfg.max_iterations if job["full"]
                         else min(job.get("iters_done", 0)
                                  + self._chunk_steps(),
                                  self.ba_cfg.max_iterations))

    def _ba_poll(self, block: bool = False):
        """Advance the in-flight BA job. Returns True while busy."""
        job = self._ba_job
        if job is None:
            return False
        if job["state"] is None:
            # Extract dispatched, LM not started. A keyframe queued in
            # the gap aborts for free — nothing has been computed yet.
            if self.kf_queue and not block:
                self._ba_job = None
                return False
            self._ba_init_state()
            return True
        if not block and not job["flags"].is_ready():
            job["t_notready"] = time.perf_counter()
            return True
        # Per-step wall-time EMA for latency-fitted chunk sizing.
        # De-biased (round 5, ADVICE r4): the chunk completed somewhere
        # between the last not-ready poll and now, so the midpoint of
        # that window estimates completion instead of charging the full
        # poll-discovery latency (up to one scheduler-pass interval,
        # which systematically undersized chunks vs the budget). Stalls
        # are excluded (>5 s).
        now = time.perf_counter()
        t_lo = max(job.get("t_notready", job["t_dispatch"]),
                   job["t_dispatch"])
        dt = ((t_lo + now) / 2.0 - job["t_dispatch"] if not block
              else now - job["t_dispatch"])
        if job.get("check_sel") is not None:
            n_c, n_p, n_sel = (int(x) for x in
                               np.asarray(job["check_sel"]))
            job["check_sel"] = None
            c_cap, p_cap, m_cap = job["caps"]
            self._last_n_sel = n_sel
            # Tier escalation: an undersized cap ratchets its floor so
            # the NEXT extract covers everything; this pass already ran
            # on a correct (prioritized) subset. A warning fires only
            # when the MAXIMUM tier (map capacity / max_ba_meas) is the
            # one that overflowed.
            if n_c > c_cap:
                self._tier_c_floor = max(self._tier_c_floor, n_c)
            if n_p > p_cap:
                self._tier_p_floor = max(self._tier_p_floor,
                                         int(n_p * 1.25))
            if n_sel > m_cap:
                self._tier_m_floor = max(self._tier_m_floor,
                                         int(n_sel * 1.25))
            if n_sel > m_cap and m_cap >= self.max_ba_meas:
                import warnings
                warnings.warn(
                    f"BA measurement capacity exceeded: {n_sel} "
                    f"selected > max_ba_meas={self.max_ba_meas}; this "
                    f"pass optimizes a PRIORITIZED subset (ROOT "
                    f"provenance, scarce points, newest KFs first). "
                    f"Raise MapMaker(max_ba_meas=...) to cover the full "
                    f"set.", RuntimeWarning, stacklevel=2)
        conv, iters, failed, accepted = (
            int(x) for x in np.asarray(job["flags"]))
        n_new = iters - job.get("iters_before", 0)
        # Readiness floor: a chunk that reports ready less than 0.2 ms
        # per step after its dispatch is taken as a false readiness
        # report, not a measurement; the EMA is left untouched and chunk
        # sizing falls back to the ``ba_steps_per_pass`` cap. Whether
        # the floor is still needed on the GPU is re-measured under
        # ROADMAP C2.
        if (n_new > 0 and 0.2e-3 * n_new < dt < 5.0
                and not self.deterministic):
            per_ms = dt / n_new * 1000.0
            self._ba_step_ms = (per_ms if self._ba_step_ms is None
                                else 0.7 * self._ba_step_ms
                                + 0.3 * per_ms)
            if _DBG:
                import sys
                print(f"#dbg ba-chunk {n_new} iters {dt*1e3:.1f}ms "
                      f"({per_ms:.1f}ms/step, ema "
                      f"{self._ba_step_ms:.1f}, budget "
                      f"{self.cfg.ba_latency_budget_ms}ms -> next "
                      f"chunk {self._chunk_steps()} steps)",
                      file=sys.stderr)
        job["iters_done"] = iters
        if failed:
            # Cholesky/NaN blow-up: ditch the map
            # (ref: src/MapMaker.cc:887-892).
            self.reset_requested = True
            self._ba_job = None
            return False
        aborted = len(self.kf_queue) > 0    # ref abort flag
        done = (conv or failed or aborted
                or iters >= self.ba_cfg.max_iterations)
        if not done:
            self._ba_dispatch_chunk()
            return True
        # Finalize: apply results + converged bookkeeping
        # (ref: src/MapMaker.cc:893-909).
        prob = job["state"].problem
        if job["sharded"]:
            # Map the sharded measurement state back to extract order so
            # apply_bundle indexes outlier flags identically to the
            # single-device path.
            from ptam_cg_tpu.parallel import sharded_ba
            prob = sharded_ba.unshard_measurements(
                job["orig_prob"], prob, job["perm"])
        self.map, self.failure_mask = self._jit_apply(
            self.map, prob, job["mk"], job["mp"],
            job["adjust"], job["pmask"], self.failure_mask,
            job["cam_idx"], job["pt_idx"])
        self._note_dispatch(self.map.point_pos)
        self._failures_pending = True
        self._map_dirty = True
        if accepted > 0:
            if job["recent"]:
                self.converged_recent = False
            self.converged_full = False
        if conv:
            self.converged_recent = True
            if not job["recent"]:
                self.converged_full = True
        self._ba_job = None
        return False

    def bundle_adjust_all(self, full: bool = False,
                          start_only: bool = False):
        """Global BA over every valid keyframe (ref: BundleAdjustAll,
        src/MapMaker.cc:768-783). With a >1-device ``mesh`` the solve
        runs point-sharded over it (VERDICT r2 #3: the distributed BA is
        a product path, not a library curiosity)."""
        kf_valid = self.map.kf_valid
        fixed = kf_valid & self.map.kf_fixed
        adjust = kf_valid & ~self.map.kf_fixed
        if start_only:
            self._ba_start(adjust, fixed, self.map.point_valid,
                           recent=False, full=full,
                           sharded=self._use_sharded)
        else:
            self.bundle_adjust(adjust, fixed, self.map.point_valid,
                               recent=False, full=full,
                               sharded=self._use_sharded)

    def bundle_adjust_recent(self, newest: int, start_only: bool = False):
        """Local BA: newest + 4 nearest adjusted; other observers fixed
        (ref: BundleAdjustRecent, src/MapMaker.cc:788-829)."""
        if self.n_kfs() < 8:
            self.converged_recent = True
            return
        adjust, fixed, pts = self._jit_local_masks(self.map, newest)
        if start_only:
            self._ba_start(adjust, fixed, pts, recent=True)
        else:
            self.bundle_adjust(adjust, fixed, pts, recent=True)

    def add_some_map_points(self, src_kf: int, level: int):
        """One epipolar-expansion dispatch (ref: AddSomeMapPoints,
        src/MapMaker.cc:448-457). Target KF chosen device-side."""
        self.map, n, self.new_point_mask = self._jit_epipolar[level](
            self.map, src_kf, self.new_point_mask)
        n = int(n)
        if n > 0:
            self._new_points_pending = True
        return n

    # --- span-refind task machine -------------------------------------
    # The all-KF refind scan is long at 64 KFs in one dispatch; the
    # scheduler instead snapshots the selection mask and dispatches one
    # 16-slot span per pass. Map updates
    # between spans are safe: refind_in_kf's active set excludes
    # already-measured points, so a span is idempotent over them.

    def _start_refind_task(self, mask2d: Array):
        self._refind_task = dict(mask2d=mask2d, i=0)

    def _refind_advance(self):
        task = self._refind_task
        self.map, _ = self._jit_refind_span(
            self.map, task["mask2d"], self._span_ks[task["i"]])
        self._note_dispatch(self.map.point_pos)
        task["i"] += 1
        if task["i"] >= len(self._span_ks):
            self._refind_task = None

    def refind_newly_made(self, spread: bool = False):
        """(ref: ReFindNewlyMade, src/MapMaker.cc:1046-1065). With
        ``spread`` the scan becomes a span task advanced by later
        scheduler passes; otherwise every span dispatches back-to-back
        (one device queue, same results)."""
        if self._new_points_pending and self._refind_task is None:
            K = self.map.kf_valid.shape[0]
            mask2d = jnp.broadcast_to(self.new_point_mask, (K,) +
                                      self.new_point_mask.shape)
            self._start_refind_task(mask2d)
            self.new_point_mask = jnp.zeros_like(self.new_point_mask)
            self._new_points_pending = False
        if not spread:
            while self._refind_task is not None:
                self._refind_advance()

    def refind_from_failure_queue(self, spread: bool = False):
        """(ref: ReFindFromFailureQueue, src/MapMaker.cc:1070-1081)."""
        if self._failures_pending and self._refind_task is None:
            self._start_refind_task(self.failure_mask)
            self.failure_mask = jnp.zeros_like(self.failure_mask)
            self._failures_pending = False
        if not spread:
            while self._refind_task is not None:
                self._refind_advance()

    def handle_bad_points(self):
        # Only worth running after the map actually changed (tracker
        # outlier counts mutate on the engine side, which sets dirty).
        if not self._map_dirty:
            return
        self.map = self._jit_gc(self.map)
        self._note_dispatch(self.map.point_valid)
        self._map_dirty = False

    def mark_dirty(self):
        self._map_dirty = True

    def add_keyframe(self, features: FrameFeatures, pose: SE3,
                     meas: dict, depth_mean: float, depth_sigma: float):
        """Tracker entry point (ref: MapMaker::AddKeyFrame,
        src/MapMaker.cc:480-488): enqueue; BA aborts via queue_size."""
        self.kf_queue.append((features, pose, meas, depth_mean,
                              depth_sigma))

    # --- phased keyframe integration ----------------------------------
    # (ref: AddKeyFrameFromTopOfQueue, src/MapMaker.cc:493-518.) Five
    # bounded dispatches — insert+measurements+refind, then one epipolar
    # level each (order 3,0,1,2) — advanced one per scheduler pass so no
    # single program holds the device behind a tracking frame.
    # The (slot, n_added) control vector is packed by the final phase,
    # async-copied, and read by a later pass (``_drain_integrate``).

    def _integrate_start(self):
        """Phase 0: pop the queue, insert + tracker measurements +
        refind-in-new-KF as one dispatch."""
        if not self.kf_queue:
            return None
        K = self.map.kf_valid.shape[0]
        if self._n_kfs_host >= K:
            return None  # keyframe capacity exhausted
        features, pose, meas, dmean, dsigma = self.kf_queue.pop(0)
        self.map, slot = self._jit_int_insert(
            self.map, features, pose, meas["point"], meas["pos"],
            meas["level"], meas["subpix"], meas["valid"],
            jnp.float32(dmean), jnp.float32(dsigma))
        self._n_kfs_host += 1
        self._integrate_job = dict(slot=slot, tot=self._zero_i32,
                                   phase=0)
        self._note_dispatch(slot)
        self.converged_recent = False
        self.converged_full = False
        return None

    def _integrate_advance(self):
        """One epipolar-level dispatch; the final level packs the
        deferred (slot, n_added) read."""
        job = self._integrate_job
        ph = job["phase"]
        if ph < len(EPI_LEVEL_ORDER) - 1:
            lev = EPI_LEVEL_ORDER[ph]
            self.map, self.new_point_mask, job["tot"] = \
                self._jit_int_epi[lev](self.map, job["slot"],
                                       self.new_point_mask, job["tot"])
            job["phase"] = ph + 1
            self._note_dispatch(job["tot"])
        else:
            self.map, self.new_point_mask, slot_n = self._jit_int_final(
                self.map, job["slot"], self.new_point_mask, job["tot"])
            slot_n.copy_to_host_async()
            self._pending_integrate = slot_n
            self._integrate_job = None
            self._note_dispatch(slot_n)

    def integrate_keyframe(self):
        """Run a full keyframe integration with ALL phases dispatched
        back-to-back (the synchronous/compat entry; the scheduler
        advances one phase per pass instead)."""
        if self._integrate_job is None:
            before = self._n_kfs_host
            self._integrate_start()
            if self._n_kfs_host == before:
                return None   # nothing to integrate / capacity full
        while self._integrate_job is not None:
            self._integrate_advance()
        return None

    def _drain_integrate(self, block: bool = False):
        """Land a deferred KF integration once its control vector has
        arrived. Returns the new keyframe slot, or None."""
        p = self._pending_integrate
        if p is None:
            return None
        if not block and not p.is_ready():
            return None
        slot, n_added = (int(x) for x in np.asarray(p))
        self._pending_integrate = None
        if n_added > 0:
            self._new_points_pending = True
        return slot

    def drain_all(self):
        """Land every in-flight/pending mapping job synchronously:
        phased integrations, deferred reads, BA chunks, queued
        keyframes, span-refind tasks. Benches and tests use this to
        reach a quiescent map; the engine never calls it. Returns the
        last integrated keyframe slot (or None)."""
        last_slot = None
        while True:
            if self._integrate_job is not None:
                while self._integrate_job is not None:
                    self._integrate_advance()
            elif self._pending_integrate is not None:
                slot = self._drain_integrate(block=True)
                if slot is not None:
                    last_slot = slot
            elif self._ba_job is not None:
                self._ba_poll(block=True)
            elif self._refind_task is not None:
                self._refind_advance()
            elif self.kf_queue:
                self.integrate_keyframe()
            else:
                break
        return last_slot

    # -- the priority loop -------------------------------------------------
    def step(self, newest_kf: Optional[int] = None):
        """One pass of the mapping priority hierarchy
        (ref: MapMaker::run, src/MapMaker.cc:82-113), with a latency
        invariant: at most ONE bounded mapping dispatch per pass in
        steady state — TWO under KF queue pressure (the capped
        integration burst) — so tracking never queues behind a long
        mapping program on the single device: the dispatch-level
        equivalent of the reference's
        two-thread latency isolation (ref: include/MapMaker.h:37-38,
        src/MapMaker.cc:57-114).

        BA runs through the non-blocking state machine: one
        latency-fitted LM chunk in flight at a time, polled here — the
        frame loop never blocks on BA. A queued keyframe aborts the job
        at its next completed chunk (the reference's abort flag,
        src/MapMaker.cc:486-487); keyframe integration itself advances
        in five bounded phases."""
        if self.reset_requested or not self.good_host:
            return
        # Backpressure: while the previous mapping program is still
        # executing, issue nothing — the device queue stays ~one mapping
        # job deep and blocking reads never pay a long backlog. In
        # deterministic mode the gate BLOCKS instead of skipping: which
        # passes do work must never depend on device timing (see
        # __init__'s deterministic docstring).
        if self._last_dispatch is not None:
            if self.deterministic:
                self._last_dispatch.block_until_ready()
            elif not self._last_dispatch.is_ready():
                if self._pending_integrate is not None:
                    return self._drain_integrate()
                return None
            self._last_dispatch = None
        # Land a deferred KF integration read first (a host read, not a
        # dispatch — the pass can still issue one dispatch below).
        ret = None
        if self._pending_integrate is not None:
            ret = self._drain_integrate(block=self.deterministic)
            if ret is None:
                return None   # control read still in flight
        # An in-flight phased integration owns the pass. Pressure-
        # adaptive: queued keyframes accelerate phase advancement — but
        # the burst is CAPPED at two phases so the documented latency
        # bound (at most two bounded dispatches per pass) holds even
        # under KF queue pressure (ADVICE r4:
        # the uncapped 1+len(queue) burst could stack several programs
        # exactly when latency is worst).
        if self._integrate_job is not None:
            for _ in range(1 + min(1, len(self.kf_queue))):
                if self._integrate_job is None:
                    break
                self._integrate_advance()
            return ret
        if self._ba_job is not None:
            if self.deterministic and self._ba_job.get("flags") is not None:
                self._ba_job["flags"].block_until_ready()
            # Advance (or finalize/abort) the in-flight BA; nothing else
            # runs while BA owns the map — except KF integration after
            # an abort finalizes.
            if self._ba_poll():
                return ret
            if self.kf_queue:
                self._integrate_push()
            return ret
        if self.kf_queue:
            self._integrate_push()
            return ret
        if not self.converged_recent and newest_kf is not None:
            self.bundle_adjust_recent(newest_kf, start_only=True)
            return ret
        # An in-flight span-refind task owns the pass.
        if self._refind_task is not None:
            self._refind_advance()
            return ret
        if self.converged_recent and self._new_points_pending:
            self.refind_newly_made(spread=True)
            return ret
        if self.converged_recent and not self.converged_full:
            self.bundle_adjust_all(start_only=True)
            return ret
        if self.converged_recent and self.converged_full \
                and self._failures_pending \
                and self._rng.integers(20) == 0:
            self.refind_from_failure_queue(spread=True)
            return ret
        self.handle_bad_points()
        return ret

    def _integrate_push(self):
        """Start the next queued integration; under queue pressure also
        advance ONE extra phase this pass (throughput over latency when
        keyframes are arriving faster than one phase per frame — capped
        at two dispatches total so the pass latency bound holds,
        ADVICE r4)."""
        self._integrate_start()
        for _ in range(min(1, len(self.kf_queue))):
            if self._integrate_job is None:
                break
            self._integrate_advance()
