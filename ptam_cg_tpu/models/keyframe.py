"""FrameFeatures: the static-shape, device-resident frame data model.

Static-shape re-architecture of the reference's KeyFrame/Level structs
(ref: include/KeyFrame.h:130-152, src/KeyFrame.cc:18-82). The reference
holds per-level images + variable-length corner/candidate vectors + a row
LUT; here a frame is ONE pytree of fixed-shape arrays:

- ``atlas``: all 4 pyramid levels packed in one (1.5H, W) image
- ``corner_mask``: dense FAST-corner mask in the same atlas layout — the
  replacement for vCorners + vCornerRowLUT (the patch search reads it as
  a mask instead of scanning a sorted list)
- fixed-capacity nonmax-suppressed corner lists and Shi-Tomasi candidate
  lists per level (for epipolar search / map-point creation)
- the SBI template + jacobians for relocalization

``make_frame_lite`` mirrors MakeKeyFrame_Lite (pyramid + FAST), and
``make_frame_rest`` mirrors MakeKeyFrame_Rest (nonmax, candidates, SBI).
Both are jit-friendly; ``build_frame`` fuses them.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ptam_cg_tpu.config import (LEVELS, MAX_CANDIDATES, MAX_NONMAX_CORNERS,
                                FrontendConfig)
from ptam_cg_tpu.ops import fast as fastops
from ptam_cg_tpu.ops import image as imops
from ptam_cg_tpu.ops import levels as levelops
from ptam_cg_tpu.ops import sbi as sbiops

Array = jax.Array

#: Uniform per-level capacity for the nonmax corner lists.
NONMAX_CAP = max(MAX_NONMAX_CORNERS)
CAND_CAP = MAX_CANDIDATES


class FrameFeatures(NamedTuple):
    atlas: Array            # (Ha, W) float32 packed pyramid
    corner_mask: Array      # (Ha, W) bool — raw FAST corners (all levels)
    corner_count: Array     # (LEVELS,) int32
    max_xy: Array           # (LEVELS, NONMAX_CAP, 2) int32 level coords
    max_score: Array        # (LEVELS, NONMAX_CAP) float32 FAST score
    max_valid: Array        # (LEVELS, NONMAX_CAP) bool
    cand_xy: Array          # (LEVELS, CAND_CAP, 2) int32 level coords
    cand_score: Array       # (LEVELS, CAND_CAP) float32 Shi-Tomasi
    cand_valid: Array       # (LEVELS, CAND_CAP) bool
    #: Relocalizer SBI, blur 2.5 (ref: KeyFrame pSBI, src/KeyFrame.cc:81).
    sbi: sbiops.SBI
    #: Rotation-estimator SBI, blur Tracker.RotationEstimatorBlur = 0.75
    #: (ref: src/Tracker.cc:98-108 mpSBIThisFrame).
    sbi_track: sbiops.SBI


class TrackFeatures(NamedTuple):
    """Slim per-frame build for the TRACKING stage: just what the
    tracker reads (the reference's MakeKeyFrame_Lite split,
    src/KeyFrame.cc:18-54): 6 leaves instead of FrameFeatures' 13, so no
    empty nonmax/candidate buffers ride through the per-frame
    dispatch."""

    atlas: Array            # (Ha, W) float32 packed pyramid
    corner_mask: Array      # (Ha, W) bool — raw FAST corners
    sbi: sbiops.SBI         # relocalizer SBI (blur 2.5)
    sbi_track: sbiops.SBI   # rotation-estimator SBI (blur 0.75)


def make_frame_lite(im: Array,
                    cfg: FrontendConfig = FrontendConfig()) -> tuple:
    """Pyramid + per-level FAST (ref: MakeKeyFrame_Lite,
    src/KeyFrame.cc:18-54). Returns (pyramid tuple, atlas, corner_mask,
    score_maps tuple, corner_count)."""
    h, w = im.shape
    pyramid = imops.build_pyramid(im, LEVELS)
    atlas = levelops.pack_atlas(pyramid)

    masks, scores, counts = [], [], []
    for lev in range(LEVELS):
        is_c, sc = fastops.fast_score_map(
            pyramid[lev], float(cfg.fast_thresholds[lev]))
        masks.append(is_c)
        scores.append(sc)
        counts.append(jnp.sum(is_c.astype(jnp.int32)))
    corner_mask = levelops.pack_atlas(
        tuple(m.astype(jnp.float32) for m in masks)) > 0.5
    return pyramid, atlas, corner_mask, tuple(scores), jnp.stack(counts)


def make_frame_rest(pyramid: Tuple[Array, ...], scores: Tuple[Array, ...],
                    masks_needed: bool = True,
                    cfg: FrontendConfig = FrontendConfig(),
                    candidate_min_score: float = 400.0,
                    sbi_blur: float = 2.5):
    """Nonmax + Shi-Tomasi candidates + SBI (ref: MakeKeyFrame_Rest,
    src/KeyFrame.cc:61-82). Returns (max lists, cand lists, SBI)."""
    max_xy, max_score, max_valid = [], [], []
    cand_xy, cand_score, cand_valid = [], [], []
    for lev in range(LEVELS):
        sc = scores[lev]
        keep = fastops.nonmax_3x3(sc)
        # tile=2: nonmax already enforces 3x3 spacing, so one-per-2x2
        # tiled selection loses almost nothing and avoids the full-image
        # top_k sort.
        corners = fastops.corners_from_mask(keep, sc, NONMAX_CAP, tile=2)
        max_xy.append(corners.xy)
        max_score.append(corners.score)
        max_valid.append(corners.valid)

        # Candidates: nonmax corners with >=10px border and Shi-Tomasi
        # score above threshold (ref: src/KeyFrame.cc:67-78).
        st = imops.shi_tomasi_score_map(pyramid[lev], half_box=3)
        hl, wl = pyramid[lev].shape
        border = jnp.zeros((hl, wl), bool)
        if hl > 20 and wl > 20:
            border = border.at[10:-10, 10:-10].set(True)
        cand_mask = keep & border & (st > candidate_min_score)
        cands = fastops.corners_from_mask(cand_mask, st, CAND_CAP, tile=2)
        cand_xy.append(cands.xy)
        cand_score.append(cands.score)
        cand_valid.append(cands.valid)

    the_sbi = sbiops.make_sbi(pyramid[3], sbi_blur)
    return ((jnp.stack(max_xy), jnp.stack(max_score), jnp.stack(max_valid)),
            (jnp.stack(cand_xy), jnp.stack(cand_score),
             jnp.stack(cand_valid)),
            the_sbi)


def build_frame(im: Array, cfg: FrontendConfig = FrontendConfig(),
                candidate_min_score: float = 400.0,
                sbi_blur: float = 2.5,
                track_blur: float = 0.75) -> FrameFeatures:
    """Full frame build (Lite + Rest)."""
    pyramid, atlas, corner_mask, scores, counts = make_frame_lite(im, cfg)
    (mx, ms, mv), (cx, cs, cv), the_sbi = make_frame_rest(
        pyramid, scores, True, cfg, candidate_min_score, sbi_blur)
    sbi_track = sbiops.make_sbi(pyramid[3], track_blur)
    if cfg.atlas_bf16:
        atlas = atlas.astype(jnp.bfloat16)
    return FrameFeatures(
        atlas=atlas, corner_mask=corner_mask, corner_count=counts,
        max_xy=mx, max_score=ms, max_valid=mv,
        cand_xy=cx, cand_score=cs, cand_valid=cv, sbi=the_sbi,
        sbi_track=sbi_track)


def build_frame_tracking(im: Array, cfg: FrontendConfig = FrontendConfig(),
                         sbi_blur: float = 2.5,
                         track_blur: float = 0.75) -> TrackFeatures:
    """Per-frame tracking build: pyramid atlas + corner mask + SBI ONLY.

    The reference runs MakeKeyFrame_Rest (nonmax, Shi-Tomasi candidates)
    only on frames that become keyframes (ref: src/KeyFrame.cc:61-82 is
    called from the mapmaker / init paths, not per frame) — the per-frame
    tracker needs just the corner mask and SBI. Returns the slim
    ``TrackFeatures``; run ``build_frame`` before inserting a frame as a
    keyframe.
    """
    pyramid, atlas, corner_mask, scores, counts = make_frame_lite(im, cfg)
    the_sbi = sbiops.make_sbi(pyramid[3], sbi_blur)
    sbi_track = sbiops.make_sbi(pyramid[3], track_blur)
    if cfg.atlas_bf16:
        atlas = atlas.astype(jnp.bfloat16)
    return TrackFeatures(atlas=atlas, corner_mask=corner_mask,
                         sbi=the_sbi, sbi_track=sbi_track)
