"""Shared bench helpers: stall-aware frame-time summaries, the timing
fence, and the synthetic 640x480 tracking scene that ``bench.py`` and
``chip_smoke.py`` both drive.

Every bench reports median / p95 / mean / ex-stall mean and counts
stalls (single frames over ``STALL_THRESHOLD_S``) explicitly in its
output JSON, so one hung dispatch cannot pass for a slow mean.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np

#: A frame slower than this is a stall, not a compute spike: the worst
#: legitimate per-frame work item (KF integration + full build + a
#: 5-iteration BA chunk serialized on one device) is well under it.
STALL_THRESHOLD_S = 5.0

#: The reference's calibrated ATAN camera (config/camera.cfg).
REF_PARAMS = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)


def frame_stats(times_s, stall_threshold_s: float = STALL_THRESHOLD_S,
                prefix: str = "") -> dict:
    """Summarize per-frame wall-clock times (seconds) into a JSON-ready
    dict: median/p95/mean/max in ms, stall count + stalled seconds, and
    the ex-stall mean/FPS."""
    t = np.asarray(times_s, np.float64)
    assert t.ndim == 1 and len(t) > 0
    stall = t > stall_threshold_s
    ex = t[~stall]
    out = {
        "frames": int(len(t)),
        "median_ms": round(float(np.median(t)) * 1e3, 3),
        "p95_ms": round(float(np.percentile(t, 95)) * 1e3, 3),
        "mean_ms": round(float(t.mean()) * 1e3, 3),
        "max_ms": round(float(t.max()) * 1e3, 3),
        "stalls": int(stall.sum()),
        "stall_total_s": round(float(t[stall].sum()), 2),
        "ex_stall_mean_ms": (round(float(ex.mean()) * 1e3, 3)
                             if len(ex) else None),
        "ex_stall_fps": (round(float(1.0 / ex.mean()), 2)
                         if len(ex) and ex.mean() > 0 else None),
    }
    if prefix:
        out = {prefix + k: v for k, v in out.items()}
    return out


def sync_read(x) -> float:
    """End a timed window by HOST-READING a device value; returns a
    float of its first element.

    Programs on one device execute in order, so one host read of any
    output of the LAST program in a chained loop fences the whole
    window. The benches fence with this read rather than
    ``block_until_ready``; whether the read is still worth its cost on
    the GPU is re-measured under ROADMAP C2."""
    v = np.asarray(x).ravel()
    return float(v[0]) if v.size else 0.0


def read_rtt_s() -> float:
    """Measure the cost of one tiny dispatch + host scalar read (the
    sync_read overhead), for subtracting from short timed windows."""
    import jax
    import jax.numpy as jnp
    f = jax.jit(lambda a, b: a + b)
    z = jnp.zeros(())
    one = jnp.float32(1.0)
    float(f(z, one))                 # compile + settle
    t0 = time.perf_counter()
    float(f(z, one))
    return time.perf_counter() - t0


def fmt_stats(s: dict) -> str:
    """One stderr line for humans."""
    return (f"median={s['median_ms']:.2f}ms p95={s['p95_ms']:.2f}ms "
            f"mean={s['mean_ms']:.2f}ms max={s['max_ms']:.2f}ms "
            f"stalls={s['stalls']} (+{s['stall_total_s']}s) "
            f"ex-stall mean={s['ex_stall_mean_ms']}ms "
            f"(~{s['ex_stall_fps']} FPS)")


class TrackingScene(NamedTuple):
    seq: object           # synth.SyntheticSequence
    size: tuple           # (width, height)
    frame0: object        # FrameFeatures of frame 0
    pose0: object         # SE3 of frame 0 (world -> camera)
    map: object           # MapState with the ground-truth points
    n_points: int         # live points in ``map``


def make_tracking_scene(n_points: int = 2048, size=(640, 480),
                        n_frames: int = 8, atlas_bf16: bool = False,
                        max_kfs: int = 4) -> TrackingScene:
    """The reference's operating point as a fixed map: a seeded 640x480
    synthetic sequence, plus a map of up to ``n_points`` ground-truth
    plane points made from frame 0's Shi-Tomasi candidates (pixel rays
    intersected with the z=0 plane). ``n_frames`` frames span the same
    short arc whatever their number."""
    import jax
    import jax.numpy as jnp

    from ptam_cg_tpu.camera import atan
    from ptam_cg_tpu.config import FrontendConfig
    from ptam_cg_tpu.io import synth
    from ptam_cg_tpu.models import keyframe, map_state
    from ptam_cg_tpu.utils import se3 as se3lib

    seq = synth.SyntheticSequence(REF_PARAMS, image_size=size,
                                  n_frames=n_frames, seed=7, height=1.5,
                                  radius=0.2, sweep=0.6)
    cam = seq.cam
    f0 = seq.frame(0)
    fe_cfg = FrontendConfig(atlas_bf16=atlas_bf16)
    ff0 = jax.jit(lambda x: keyframe.build_frame(
        x, fe_cfg, candidate_min_score=50.0))(f0)
    pose0 = seq.pose(0)
    T_wc = se3lib.inv(pose0)

    P = n_points
    m = map_state.empty_map(size, max_points=P, max_kfs=max_kfs,
                            atlas_dtype=jnp.bfloat16 if atlas_bf16
                            else jnp.float32)
    m = map_state.insert_keyframe(m, 0, ff0, pose0, 1.5, 0.1)

    cand_xy = np.asarray(ff0.cand_xy)
    cand_valid = np.asarray(ff0.cand_valid)
    R_wc, origin = np.asarray(T_wc.R), np.asarray(T_wc.t)
    pts, centers, lvls = [], [], []
    for lev in range(4):
        for (x, y) in cand_xy[lev][cand_valid[lev]]:
            p0 = (np.array([x, y], np.float64) + 0.5) * (1 << lev) - 0.5
            z1 = np.asarray(atan.unproject(
                jnp.asarray(p0, jnp.float32), cam))
            ray = R_wc @ np.array([z1[0], z1[1], 1.0])
            s = -origin[2] / ray[2]
            if s <= 0:
                continue
            pts.append(origin + s * ray)
            centers.append([x, y])
            lvls.append(lev)
            if len(pts) >= P:
                break
        if len(pts) >= P:
            break
    n = len(pts)
    pos = np.zeros((P, 3), np.float32)
    pos[:n] = np.stack(pts)
    ctr = np.zeros((P, 2), np.float32)
    ctr[:n] = np.stack(centers)
    lv = np.zeros(P, np.int32)
    lv[:n] = np.array(lvls)
    c_nc, r_nc, d_nc, nrm = map_state.make_point_rays(
        jnp.asarray(ctr), jnp.asarray(lv), pose0, cam, size)
    m = m._replace(
        point_pos=jnp.asarray(pos),
        point_valid=jnp.asarray(np.arange(P) < n),
        point_src_level=jnp.asarray(lv), point_center=jnp.asarray(ctr),
        point_center_nc=c_nc, point_right_nc=r_nc, point_down_nc=d_nc,
        point_normal_nc=nrm, good=jnp.asarray(True))
    m = map_state.refresh_pixel_vectors(m)
    return TrackingScene(seq=seq, size=size, frame0=ff0, pose0=pose0,
                         map=m, n_points=n)
