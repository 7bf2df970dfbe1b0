"""MapState: the device-resident, static-shape SLAM map.

Static-shape re-architecture of the reference's Map/MapPoint/KeyFrame heap
objects (ref: include/Map.h:32-101, include/KeyFrame.h:130-152). The
reference shares a pointer-linked map between two threads with a trash
list standing in for deletion (ref: include/Map.h:8-13); here the map is
one SoA pytree of fixed-capacity arrays with validity masks — "trash" is
just ``point_valid=False`` — functionally updated, so tracking and
mapping can run on different devices/streams without data races.

Capacities are set at construction (shapes carry them); all update
functions are pure and jit-safe.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ptam_cg_tpu.config import LEVELS
from ptam_cg_tpu.models.keyframe import CAND_CAP, NONMAX_CAP, FrameFeatures
from ptam_cg_tpu.ops import levels as levelops
from ptam_cg_tpu.utils import se3 as se3lib
from ptam_cg_tpu.utils.se3 import SE3, _pinned_f32

Array = jax.Array

# Measurement source enum (ref: include/KeyFrame.h:50).
SRC_TRACKER = 0
SRC_REFIND = 1
SRC_ROOT = 2
SRC_TRAIL = 3
SRC_EPIPOLAR = 4


class MapState(NamedTuple):
    # ---- points (capacity P) ----
    point_pos: Array          # (P, 3) world position
    point_valid: Array        # (P,) bool (in use and not trashed)
    point_src_kf: Array       # (P,) int32 source keyframe slot
    point_src_level: Array    # (P,) int32 source pyramid level
    point_center: Array       # (P, 2) float32 center in source-level coords
    point_center_nc: Array    # (P, 3) unit ray to patch center (src-KF frame)
    point_right_nc: Array     # (P, 3) unit ray one pixel right
    point_down_nc: Array      # (P, 3) unit ray one pixel down
    point_normal_nc: Array    # (P, 3) patch normal (src-KF frame)
    point_right_w: Array      # (P, 3) world one-pixel-right step
    point_down_w: Array       # (P, 3) world one-pixel-down step
    point_inlier: Array       # (P,) int32 tracker inlier count
    point_outlier: Array      # (P,) int32 tracker outlier count
    point_source: Array       # (P,) int32 creation provenance (SRC_*)

    # ---- keyframes (capacity K) ----
    kf_R: Array               # (K, 3, 3) world->cam rotation
    kf_t: Array               # (K, 3)
    kf_valid: Array           # (K,) bool
    kf_fixed: Array           # (K,) bool — pose fixed in BA (first KF)
    kf_atlas: Array           # (K, Ha, W) float32 pyramid atlas
    kf_corner_mask: Array     # (K, Ha, W) bool
    kf_max_xy: Array          # (K, LEVELS, NONMAX_CAP, 2) int32
    kf_max_valid: Array       # (K, LEVELS, NONMAX_CAP) bool
    kf_cand_xy: Array         # (K, LEVELS, CAND_CAP, 2) int32
    kf_cand_score: Array      # (K, LEVELS, CAND_CAP) float32
    kf_cand_valid: Array      # (K, LEVELS, CAND_CAP) bool
    kf_sbi: Array             # (K, h_sbi, w_sbi) float32 template
    kf_sbi_jac: Array         # (K, h_sbi, w_sbi, 2)
    kf_depth_mean: Array      # (K,) scene depth stats
    kf_depth_sigma: Array     # (K,)

    # ---- measurements: DENSE (keyframe, point) matrices ----
    # The reference keeps a std::map<MapPoint*, Measurement> per KF plus
    # per-point sets of measuring/never-retry KFs (ref: include/KeyFrame.h,
    # MapMakerData). With fixed capacities a dense (K, P) layout is the
    # static-shape equivalent: O(1) indexed, no dedup, trivially batched.
    meas_valid: Array         # (K, P) bool — measurement exists
    meas_pos: Array           # (K, P, 2) float32 level-0 position
    meas_level: Array         # (K, P) int32
    meas_subpix: Array        # (K, P) bool
    meas_source: Array        # (K, P) int32 SRC_*
    never_retry: Array        # (K, P) bool (MapMakerData::sNeverRetryKFs)

    good: Array               # () bool — map initialized

    # ------------------------------------------------------------------
    @property
    def num_points_cap(self) -> int:
        return self.point_pos.shape[0]

    @property
    def num_kfs_cap(self) -> int:
        return self.kf_R.shape[0]

    def kf_pose(self, k) -> SE3:
        return SE3(self.kf_R[k], self.kf_t[k])

    def n_points(self) -> Array:
        return jnp.sum(self.point_valid.astype(jnp.int32))

    def n_kfs(self) -> Array:
        return jnp.sum(self.kf_valid.astype(jnp.int32))


def empty_map(image_size: Tuple[int, int], max_points: int = 2048,
              max_kfs: int = 32, atlas_dtype=jnp.float32) -> MapState:
    """Allocate an all-invalid map (Map::Reset equivalent).
    ``atlas_dtype``: storage dtype of the keyframe pyramid atlases —
    pass jnp.bfloat16 with FrontendConfig.atlas_bf16."""
    W, H = image_size
    Ha = H + H // 2
    h_sbi, w_sbi = (H >> 3) // 2, (W >> 3) // 2
    P, K = max_points, max_kfs
    f32, i32 = jnp.float32, jnp.int32
    z = jnp.zeros
    return MapState(
        point_pos=z((P, 3), f32), point_valid=z(P, bool),
        point_src_kf=z(P, i32), point_src_level=z(P, i32),
        point_center=z((P, 2), f32), point_center_nc=z((P, 3), f32),
        point_right_nc=z((P, 3), f32), point_down_nc=z((P, 3), f32),
        point_normal_nc=z((P, 3), f32), point_right_w=z((P, 3), f32),
        point_down_w=z((P, 3), f32), point_inlier=z(P, i32),
        point_outlier=z(P, i32), point_source=z(P, i32),
        kf_R=jnp.broadcast_to(jnp.eye(3, dtype=f32), (K, 3, 3)),
        kf_t=z((K, 3), f32), kf_valid=z(K, bool), kf_fixed=z(K, bool),
        kf_atlas=z((K, Ha, W), atlas_dtype),
        kf_corner_mask=z((K, Ha, W), bool),
        kf_max_xy=z((K, LEVELS, NONMAX_CAP, 2), i32),
        kf_max_valid=z((K, LEVELS, NONMAX_CAP), bool),
        kf_cand_xy=z((K, LEVELS, CAND_CAP, 2), i32),
        kf_cand_score=z((K, LEVELS, CAND_CAP), f32),
        kf_cand_valid=z((K, LEVELS, CAND_CAP), bool),
        kf_sbi=z((K, h_sbi, w_sbi), f32),
        kf_sbi_jac=z((K, h_sbi, w_sbi, 2), f32),
        kf_depth_mean=jnp.ones(K, f32), kf_depth_sigma=jnp.ones(K, f32),
        meas_valid=z((K, P), bool), meas_pos=z((K, P, 2), f32),
        meas_level=z((K, P), i32), meas_subpix=z((K, P), bool),
        meas_source=z((K, P), i32), never_retry=z((K, P), bool),
        good=jnp.asarray(False),
    )


def set_measurements(m: MapState, kf, point_idx: Array, pos: Array,
                     level: Array, subpix: Array, source: Array,
                     valid: Array) -> MapState:
    """Scatter a batch of measurements into keyframe ``kf``'s dense row.
    ``valid`` gates which entries are written (duplicate indices in the
    padded tail are harmless because their valid flag is False)."""
    P = m.point_pos.shape[0]
    ok = valid & (point_idx >= 0) & (point_idx < P)
    # Invalid entries scatter to index P -> dropped; valid indices are
    # unique, so no duplicate-scatter nondeterminism.
    idx = jnp.where(ok, point_idx, P)
    wr = lambda tbl, val: tbl[kf].at[idx].set(val, mode="drop")
    return m._replace(
        meas_valid=m.meas_valid.at[kf, idx].set(True, mode="drop"),
        meas_pos=m.meas_pos.at[kf].set(wr(m.meas_pos, pos)),
        meas_level=m.meas_level.at[kf].set(wr(m.meas_level, level)),
        meas_subpix=m.meas_subpix.at[kf].set(wr(m.meas_subpix, subpix)),
        meas_source=m.meas_source.at[kf].set(wr(m.meas_source, source)),
    )


def scene_depth_for_kf(m: MapState, k) -> tuple:
    """RefreshSceneDepth over the dense measurement row
    (ref: src/MapMaker.cc:1202-1219)."""
    sel = m.meas_valid[k] & m.point_valid
    p_cam = (m.point_pos @ m.kf_R[k].T) + m.kf_t[k]
    z = p_cam[:, 2]
    n = jnp.maximum(jnp.sum(sel.astype(jnp.float32)), 1.0)
    mean = jnp.sum(jnp.where(sel, z, 0.0)) / n
    var = jnp.sum(jnp.where(sel, z * z, 0.0)) / n - mean * mean
    return mean, jnp.sqrt(jnp.maximum(var, 1e-12))


def insert_keyframe(m: MapState, slot, features: FrameFeatures, pose: SE3,
                    depth_mean=1.0, depth_sigma=1.0,
                    fixed=False) -> MapState:
    """Write a FrameFeatures + pose into keyframe ``slot`` (traced int)."""
    upd = lambda arr, val: arr.at[slot].set(val)
    return m._replace(
        kf_R=upd(m.kf_R, pose.R), kf_t=upd(m.kf_t, pose.t),
        kf_valid=upd(m.kf_valid, True),
        kf_fixed=upd(m.kf_fixed, fixed),
        kf_atlas=upd(m.kf_atlas, features.atlas),
        kf_corner_mask=upd(m.kf_corner_mask, features.corner_mask),
        kf_max_xy=upd(m.kf_max_xy, features.max_xy),
        kf_max_valid=upd(m.kf_max_valid, features.max_valid),
        kf_cand_xy=upd(m.kf_cand_xy, features.cand_xy),
        kf_cand_score=upd(m.kf_cand_score, features.cand_score),
        kf_cand_valid=upd(m.kf_cand_valid, features.cand_valid),
        kf_sbi=upd(m.kf_sbi, features.sbi.template),
        kf_sbi_jac=upd(m.kf_sbi_jac, features.sbi.jac),
        kf_depth_mean=upd(m.kf_depth_mean, depth_mean),
        kf_depth_sigma=upd(m.kf_depth_sigma, depth_sigma),
    )


@_pinned_f32
def make_point_rays(center_level_xy: Array, level, pose: SE3, cam,
                    image_size: Tuple[int, int]):
    """Compute the source-KF unit rays + normal for new points
    (ref: MapMaker::AddPointEpipolar sets v3Center_NC etc. by unprojecting
    the patch center and its one-pixel neighbours, src/MapMaker.cc:638-658;
    normal is -z i.e. facing the camera).

    Returns dict of (center_nc, right_nc, down_nc, normal_nc), all unit,
    broadcast over leading dims of ``center_level_xy``.
    """
    from ptam_cg_tpu.camera import atan

    p0 = levelops.level_zero_pos(center_level_xy, level)
    one = jnp.asarray(levelops.level_scale(level))[..., None]

    def unproj_ray(pix):
        z1 = atan.unproject(pix, cam)
        ray = jnp.concatenate([z1, jnp.ones_like(z1[..., :1])], axis=-1)
        return ray / jnp.linalg.norm(ray, axis=-1, keepdims=True)

    dx = jnp.stack([jnp.ones_like(p0[..., 0]),
                    jnp.zeros_like(p0[..., 0])], axis=-1)
    dy = jnp.stack([jnp.zeros_like(p0[..., 0]),
                    jnp.ones_like(p0[..., 0])], axis=-1)
    center_nc = unproj_ray(p0)
    right_nc = unproj_ray(p0 + dx * one)
    down_nc = unproj_ray(p0 + dy * one)
    normal = jnp.zeros_like(center_nc).at[..., 2].set(-1.0)
    return center_nc, right_nc, down_nc, normal


@_pinned_f32
def refresh_pixel_vectors(m: MapState) -> MapState:
    """Recompute world pixel-step vectors for every point
    (ref: MapPoint::RefreshPixelVectors, src/Map.cc:40-65), vectorized."""
    R = m.kf_R[m.point_src_kf]              # (P, 3, 3)
    t = m.kf_t[m.point_src_kf]
    plane_pt_c = jnp.einsum("pij,pj->pi", R, m.point_pos) + t
    cam_height = jnp.abs(jnp.sum(plane_pt_c * m.point_normal_nc, axis=-1))

    def rate(v):
        return jnp.abs(jnp.sum(v * m.point_normal_nc, axis=-1))

    def on_plane(v):
        r = jnp.maximum(rate(v), 1e-9)
        return v * (cam_height / r)[..., None]

    center_p = on_plane(m.point_center_nc)
    right_p = on_plane(m.point_right_nc)
    down_p = on_plane(m.point_down_nc)
    Rt = jnp.swapaxes(R, -1, -2)
    right_w = jnp.einsum("pij,pj->pi", Rt, right_p - center_p)
    down_w = jnp.einsum("pij,pj->pi", Rt, down_p - center_p)
    return m._replace(point_right_w=right_w, point_down_w=down_w)


@_pinned_f32
def kf_linear_dist(m: MapState, pose: SE3, depth_mean, k) -> Array:
    """Depth-weighted keyframe distance (ref: MapMaker::KeyFrameLinearDist
    src/MapMaker.cc:696-703 — camera-center distance; the caller divides
    by scene depth where needed)."""
    c1 = -pose.R.T @ pose.t                 # camera center in world
    c2 = -m.kf_R[k].T @ m.kf_t[k]
    return jnp.linalg.norm(c1 - c2)


@_pinned_f32
def closest_kf_distances(m: MapState, pose: SE3) -> Array:
    """Distance from ``pose`` to every valid keyframe (inf if invalid)."""
    c = -jnp.swapaxes(pose.R, -1, -2) @ pose.t
    centers = -jnp.einsum("kji,kj->ki", m.kf_R, m.kf_t)
    d = jnp.linalg.norm(centers - c, axis=-1)
    return jnp.where(m.kf_valid, d, jnp.inf)
