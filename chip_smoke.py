"""Smoke test of the SLAM engine on NVIDIA GPUs.

    python chip_smoke.py             # one GPU: phases a-e
    python chip_smoke.py --chips 4   # four GPUs: the point-sharded global BA

Run from the repository root. Every phase drives the package through its
public entry points and raises on a miss, so any failure exits non-zero;
the JSON result is printed as the last line only when every phase passed.

One GPU:

a. Device gate: JAX's first device must be a GPU (no CPU fallback).
b. Tracking parity: the fused per-frame program
   (``tracker.track_frame_from_image``: frontend build + track) on 640x480
   frames against a 2048-point map, ``TRACK_FRAMES`` chained frames on the
   GPU at JAX's default matmul precision (so a missing float32 pin shows
   up here), then the same frames through the same jitted function on the
   host CPU at "highest" precision. Per-frame pose, found count and
   quality are compared within the TRACK_* tolerances below.
c. Bundle-adjustment parity: the single-device LM chunk
   (``bundle._cached_lm_chunk``) on GPU and CPU from identical inputs at
   64 KF / 4k points / 16k measurements and 128 KF / 16k / 64k, held to
   ``__graft_entry__.check_lm_agreement``.
d. Engine end to end: ``SLAMEngine`` at 640x480 (4096 points, 16
   keyframes, default scheduler mode, mapping active) over
   ``ENGINE_FRAMES`` frames of a seeded synthetic sequence: stereo init
   within 10 frames, at least 4 keyframes, no reset, more than 80% GOOD
   frames, ATE below 5% of the trajectory span; then ``drain_all`` and one
   full global BA that must not fail. Frame and compile times are printed
   for information; they are not a benchmark.
e. Replay: phase d's sequence twice more with ``deterministic=True``;
   prints whether the two maps are bit-identical (information, not a
   check).

``--chips 4`` runs only the multi-device path and what it is compared
with: ``dryrun_multichip(4)`` (the sharded LM chunk against the
single-GPU chunk at 128 KF / 16k / 64k) and one phase-d engine run with
``mesh=make_map_mesh(4)``, held to phase d's bounds.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np

#: Phase b: chained frames per device.
TRACK_FRAMES = 32
#: Phase b tolerances, GPU (default precision) against CPU (highest).
#: Pose: 1e-4 rad / 1e-4 scene units is under 0.1 px at the scene's
#: 1.5-unit depth, and about 70x the largest difference an H100 showed
#: (1.4e-6 rad, 6.1e-7); a missing float32 pin drifts by far more
#: within a few frames. Found count: reduced-precision rounding of the
#: image-value dots may flip a few ZMSSD accept decisions at the margin
#: (none flipped on the H100). Quality: identical on every frame.
TRACK_ROT_TOL_RAD = 1e-4
TRACK_TRANS_TOL = 1e-4
TRACK_FOUND_REL_TOL = 0.01
TRACK_FOUND_ABS_TOL = 5
#: Phase c problem scales (cameras, points, measurements) and LM
#: iterations per chunk. Two, as in ``dryrun_multichip``: the problem's
#: measurements are exact, so a few more steps bring its error down to
#: rounding level, where whether a step beats the last one (and so the
#: count of lambda retries) is decided by summation order.
BA_SCALES = ((64, 4096, 16384), (128, 16384, 65536))
BA_ITERS = 2
#: Phase d: frames of the engine sequence and its bounds (those of
#: tests/test_slam_e2e.py).
ENGINE_FRAMES = 240
ENGINE_INIT_BY = 10
ENGINE_MIN_KFS = 4
ENGINE_MIN_GOOD = 0.8
ENGINE_MAX_ATE_FRAC = 0.05


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


def device_gate():
    """Phase a: return JAX's devices, or exit non-zero unless the first
    one is a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU; JAX's first device is "
                         f"{devs[0].platform} ({devs[0].device_kind})")
    return devs


def card_lines() -> list:
    """``nvidia-smi``'s name and power limit of each card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


class CompileClock:
    """Sums JAX's tracing, lowering and backend-compile durations."""

    def __init__(self):
        self.total = 0.0

    def __call__(self, event, duration, **_):
        if event.startswith("/jax/core/compile/"):
            self.total += duration


def rotation_angle(Ra, Rb) -> np.ndarray:
    """Angle (rad) of Ra^T Rb for stacked 3x3 rotations, from the chord
    ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2) (exact near zero, where
    the arccos of the trace is not)."""
    d = np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64)
    chord = np.sqrt(np.einsum("nij,nij->n", d, d))
    return 2.0 * np.arcsin(np.minimum(chord / (2.0 * np.sqrt(2.0)), 1.0))


# ---------------------------------------------------------------------------
def phase_tracking(gpu, cpu, n_frames: int = TRACK_FRAMES,
                   size=(640, 480)) -> dict:
    """Phase b (see the module docstring)."""
    import jax
    import jax.numpy as jnp

    from bench_common import REF_PARAMS, make_tracking_scene
    from ptam_cg_tpu.config import EngineConfig
    from ptam_cg_tpu.models import tracker

    scene = make_tracking_scene(size=size, n_frames=n_frames + 1)
    cfg = EngineConfig()
    cam = scene.seq.cam
    cam_params = jnp.asarray(REF_PARAMS, jnp.float32)
    fused = jax.jit(lambda s, m_, im, ps: tracker.track_frame_from_image(
        s, m_, im, ps, cam, size, cam_params, cfg.tracker, cfg.frontend))
    frames = [np.asarray(scene.seq.frame(i)) for i in range(1, n_frames + 1)]
    inputs = (tracker.init_tracker_state(scene.pose0),
              tracker.make_track_view(scene.map), scene.frame0.sbi_track)

    def run(dev):
        st, mv, sbi = jax.device_put(inputs, dev)
        rows = []
        for im in frames:
            out = fused(st, mv, jax.device_put(im, dev), sbi)
            st, sbi = out.state, out.sbi_track
            rows.append((np.asarray(st.pose.R), np.asarray(st.pose.t),
                         int(jnp.sum(out.result.meas_valid)),
                         int(st.quality)))
        return [np.stack(c) for c in zip(*rows)]

    t0 = time.perf_counter()
    R_g, t_g, found_g, q_g = run(gpu)
    t_gpu = time.perf_counter() - t0
    with jax.default_matmul_precision("highest"):
        R_c, t_c, found_c, q_c = run(cpu)
    rot = rotation_angle(R_g, R_c)
    trans = np.linalg.norm(t_g - t_c, axis=-1)
    dfound = np.abs(found_g - found_c)
    found_tol = np.maximum(TRACK_FOUND_ABS_TOL,
                           TRACK_FOUND_REL_TOL * found_c)
    res = dict(frames=n_frames, map_points=scene.n_points,
               max_rot_rad=float(rot.max()), max_trans=float(trans.max()),
               max_found_diff=int(dfound.max()),
               found_gpu=[int(found_g.min()), int(found_g.max())],
               quality_mismatch=int((q_g != q_c).sum()),
               gpu_seconds_incl_compile=round(t_gpu, 3))
    log(f"phase b tracking parity: {json.dumps(res)}")
    assert rot.max() <= TRACK_ROT_TOL_RAD, ("rotation", rot)
    assert trans.max() <= TRACK_TRANS_TOL, ("translation", trans)
    assert np.all(dfound <= found_tol), ("n_found", found_g, found_c)
    assert np.array_equal(q_g, q_c), ("quality", q_g, q_c)
    assert found_c.min() > 100, ("reference lost the map", found_c)
    return res


def phase_ba(gpu, cpu, scales=BA_SCALES, iters: int = BA_ITERS) -> list:
    """Phase c (see the module docstring)."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import ba_problem, check_lm_agreement
    from ptam_cg_tpu.config import BundleConfig
    from ptam_cg_tpu.models import bundle
    from ptam_cg_tpu.utils import mest

    cfg = BundleConfig()
    chunk = bundle._cached_lm_chunk(cfg, mest.estimator_id(cfg.mestimator))
    results = []
    for C, P, M in scales:
        prob, cam = ba_problem(C, P, M)
        args = (bundle.init_lm(prob, cfg), cam, jnp.int32(iters))
        outs = []
        for dev in (gpu, cpu):
            out, flags = chunk(*jax.device_put(args, dev))
            _, n_it, failed, _ = (int(x) for x in np.asarray(flags))
            assert not failed, (dev, C, P, M)
            outs.append((out, n_it))
        (out_g, it_g), (out_c, it_c) = outs
        d = check_lm_agreement(out_g, out_c, it_g, it_c)
        d.update(C=C, P=P, M=M)
        log(f"phase c BA parity: {json.dumps(d)}")
        results.append(d)
    return results


def _engine_sequence(n_frames: int, size):
    from bench_common import REF_PARAMS
    from ptam_cg_tpu.io import synth

    seq = synth.SyntheticSequence(REF_PARAMS, image_size=size,
                                  n_frames=n_frames, seed=7, height=1.5,
                                  radius=0.35, sweep=1.3)
    frames = [np.asarray(seq.frame(i)).astype(np.uint8)
              for i in range(n_frames)]
    return seq, frames


def run_engine(frames, size, mesh=None, deterministic=None, clock=None):
    """Feed ``frames`` through a fresh SLAMEngine; returns (engine,
    per-frame FrameInfo list, per-frame seconds, per-frame compile
    seconds)."""
    from bench_common import REF_PARAMS
    from ptam_cg_tpu.config import CameraConfig, EngineConfig, MapMakerConfig
    from ptam_cg_tpu.models import engine as engine_lib

    cfg = EngineConfig(
        camera=CameraConfig(params=REF_PARAMS, image_size=size),
        mapmaker=MapMakerConfig(candidate_min_shi_tomasi_score=100.0))
    eng = engine_lib.SLAMEngine(cfg, image_size=size, max_points=4096,
                                max_kfs=16, auto_init_frames=6, seed=0,
                                mesh=mesh, deterministic=deterministic)
    infos, secs, comp = [], [], []
    for im in frames:
        c0 = clock.total if clock else 0.0
        t0 = time.perf_counter()
        infos.append(eng.process_frame(im))
        secs.append(time.perf_counter() - t0)
        comp.append((clock.total if clock else 0.0) - c0)
    return eng, infos, np.asarray(secs), np.asarray(comp)


def check_engine(seq, eng, infos) -> dict:
    """Phase d's bounds on one engine run, then drain + one full global
    BA. Returns the measured values; raises AssertionError on a miss."""
    import jax.numpy as jnp

    from ptam_cg_tpu.utils import evaluate
    from ptam_cg_tpu.utils.se3 import SE3

    stages = [inf.stage for inf in infos]
    assert "TRACKING" in stages, stages[:20]
    first = stages.index("TRACKING")
    resets = sum(1 for a, b in zip(stages[first:], stages[first + 1:])
                 if a == "TRACKING" and b != "TRACKING")
    tracking = [(i, inf) for i, inf in enumerate(infos)
                if inf.stage == "TRACKING"]
    good = sum(1 for _, inf in tracking if inf.quality == 2) / len(tracking)
    idx = [i for i, _ in tracking]
    est = np.asarray(evaluate.camera_centers(SE3(
        jnp.stack([inf.pose.R for _, inf in tracking]),
        jnp.stack([inf.pose.t for _, inf in tracking]))))
    gt = np.asarray(evaluate.camera_centers(SE3(seq.poses.R[np.array(idx)],
                                                seq.poses.t[np.array(idx)])))
    ate = float(evaluate.ate_rmse(jnp.asarray(est), jnp.asarray(gt)))
    span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    kfs = max(inf.n_kfs for inf in infos)

    mm = eng.mapmaker
    mm.map = eng.map
    mm.drain_all()
    mm.bundle_adjust_all(full=True)
    eng.map = mm.map
    res = dict(first_tracking_frame=first, resets=resets,
               keyframes=int(mm.n_kfs()), max_keyframes_seen=int(kfs),
               points=int(eng.map.n_points()), good_frac=round(good, 4),
               ate=ate, traj_span=span,
               full_ba_failed=bool(mm.reset_requested))
    assert first <= ENGINE_INIT_BY, ("stereo init", stages[:20])
    assert resets == 0, ("reset", stages)
    assert mm.n_kfs() >= ENGINE_MIN_KFS, ("keyframes", mm.n_kfs())
    assert good > ENGINE_MIN_GOOD, ("GOOD share", good)
    assert ate < ENGINE_MAX_ATE_FRAC * max(span, 0.1), ("ATE", ate, span)
    assert not mm.reset_requested, "full global BA failed"
    return res


def phase_engine(n_frames: int = ENGINE_FRAMES, size=(640, 480),
                 mesh=None, clock=None, tag: str = "d") -> dict:
    """Phase d (or its meshed variant)."""
    seq, frames = _engine_sequence(n_frames, size)
    eng, infos, secs, comp = run_engine(frames, size, mesh=mesh,
                                        clock=clock)
    res = check_engine(seq, eng, infos)
    quiet = secs[comp == 0.0]
    res.update(
        mode="deterministic" if eng._deterministic else "latency",
        frames=n_frames,
        compile_s=round(float(comp.sum()), 3),
        frames_without_compile=int(len(quiet)),
        frame_median_ms=round(float(np.median(quiet)) * 1e3, 3),
        frame_p95_ms=round(float(np.percentile(quiet, 95)) * 1e3, 3),
        total_s=round(float(secs.sum()), 3))
    log(f"phase {tag} engine: {json.dumps(res)}")
    eng.close()
    return res


def phase_replay(n_frames: int = ENGINE_FRAMES, size=(640, 480)) -> bool:
    """Phase e: are two deterministic replays bit-identical?"""
    import jax

    _, frames = _engine_sequence(n_frames, size)
    maps = []
    for _ in range(2):
        eng, _, _, _ = run_engine(frames, size, deterministic=True)
        eng.mapmaker.map = eng.map
        eng.mapmaker.drain_all()
        maps.append([np.asarray(x) for x in
                     jax.tree_util.tree_leaves(eng.mapmaker.map)])
        eng.close()
    same = all(np.array_equal(a, b) for a, b in zip(*maps))
    log(f"phase e deterministic replay: maps bit-identical = {same}")
    return same


# ---------------------------------------------------------------------------
def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    devs = device_gate()
    import jax

    from ptam_cg_tpu.utils.compile_cache import enable_compile_cache

    log(f"jax {jax.__version__}; device_kind {devs[0].device_kind}; "
        f"{len(devs)} device(s); compile cache {enable_compile_cache()}")
    for line in card_lines():
        print(line, flush=True)
    clock = CompileClock()
    jax.monitoring.register_event_duration_secs_listener(clock)
    t0 = time.perf_counter()
    if args.chips == 4:
        if len(devs) < 4:
            raise SystemExit(f"chip_smoke --chips 4: {len(devs)} GPU(s)")
        from __graft_entry__ import dryrun_multichip
        from ptam_cg_tpu.parallel.mesh import make_map_mesh

        dryrun_multichip(4)
        phase_engine(mesh=make_map_mesh(4), clock=clock, tag="d (mesh 4)")
        count = 4
    else:
        cpu = jax.devices("cpu")[0]
        phase_tracking(devs[0], cpu)
        phase_ba(devs[0], cpu)
        phase_engine(clock=clock)
        phase_replay()
        count = len(devs)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f}s "
        f"({clock.total:.1f}s tracing and compiling)")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}), flush=True)


if __name__ == "__main__":
    main()
