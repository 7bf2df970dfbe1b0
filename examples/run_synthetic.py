"""End-to-end demo: run the full SLAM engine on a synthetic ground-truth
sequence and report ATE (the BASELINE config 1-4 harness in miniature).

Usage: python examples/run_synthetic.py [--frames N] [--size WxH] [--cpu]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--size", default="320x240")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: JAX's default "
                         "backend, the GPU when there is one)")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a JAX profiler trace (XPlane) to DIR")
    ap.add_argument("--async-mapping", action="store_true",
                    help="run mapping jobs on a background thread")
    ap.add_argument("--ar", default=None, metavar="DIR",
                    help="write AR composites (EyeGame-parity eyeballs "
                         "tracking the camera) for tracked frames")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from ptam_cg_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from ptam_cg_tpu.config import (CameraConfig, EngineConfig,
                                    MapMakerConfig)
    from ptam_cg_tpu.io import synth
    from ptam_cg_tpu.models import engine as engine_lib
    from ptam_cg_tpu.utils import evaluate
    from ptam_cg_tpu.utils.se3 import SE3

    w, h = (int(x) for x in args.size.split("x"))
    size = (w, h)
    params = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)
    seq = synth.SyntheticSequence(params, image_size=size,
                                  n_frames=args.frames, seed=args.seed,
                                  height=1.5, radius=0.35, sweep=1.3)
    cfg = EngineConfig(
        camera=CameraConfig(params=params, image_size=size),
        mapmaker=MapMakerConfig(candidate_min_shi_tomasi_score=70.0))
    eng = engine_lib.SLAMEngine(cfg, image_size=size, max_points=2048,
                                max_kfs=12, auto_init_frames=6,
                                seed=args.seed,
                                async_mapping=args.async_mapping)
    ar_step = None
    if args.ar:
        from ptam_cg_tpu.viz import ar as arlib
        from ptam_cg_tpu.viz import mapviewer
        Path(args.ar).mkdir(parents=True, exist_ok=True)

        def _ar(frame_, R, t):
            pose = SE3(R, t)
            verts, tris, shades = arlib.make_eye_game(-R.T @ t)
            return arlib.render_ar_frame(frame_, pose, eng.cam, size,
                                         verts, tris, shades,
                                         ufb_size=size)
        ar_step = jax.jit(_ar)

    est, gt, times = [], [], []
    prof = None
    for i in range(args.frames):
        if args.profile and i == args.frames // 2:
            prof = jax.profiler.start_trace(args.profile)
        frame = seq.frame(i)
        t0 = time.perf_counter()
        info = eng.process_frame(frame)
        times.append(time.perf_counter() - t0)
        if args.profile and i == args.frames // 2 + 3:
            jax.profiler.stop_trace()
            print(f"profiler trace -> {args.profile}")
        print(f"frame {i:3d} [{info.stage:14s}] q={info.quality} "
              f"found={info.n_found:4d} pts={info.n_points:4d} "
              f"kfs={info.n_kfs} {'KF+' if info.added_kf else ''} "
              f"{'RELOC' if info.relocalized else ''} "
              f"({times[-1]*1000:.0f} ms)")
        if info.stage == "TRACKING":
            est.append(np.asarray(evaluate.camera_centers(
                SE3(info.pose.R[None], info.pose.t[None])))[0])
            c = seq.pose(i)
            gt.append(np.asarray(-jnp.asarray(c.R).T @ jnp.asarray(c.t)))
            if ar_step is not None:
                from ptam_cg_tpu.viz import mapviewer
                out = np.asarray(ar_step(jnp.asarray(frame, jnp.float32),
                                         info.pose.R, info.pose.t))
                mapviewer.save_ppm(
                    str(Path(args.ar) / f"ar_{i:05d}.ppm"),
                    np.repeat(np.clip(out, 0, 255)[..., None], 3, -1))

    if len(est) > 5:
        ate = evaluate.ate_rmse(jnp.asarray(np.stack(est)),
                                jnp.asarray(np.stack(gt)))
        span = float(np.linalg.norm(np.stack(gt).max(0)
                                    - np.stack(gt).min(0)))
        print(f"\nATE RMSE: {ate*1000:.1f} mm over a {span:.2f} m "
              f"trajectory ({len(est)} tracked frames)")
        print(f"median frame time: {np.median(times)*1000:.0f} ms")
        eng.close()
    else:
        eng.close()
        print("\nFAILED: tracking never started")
        sys.exit(1)


if __name__ == "__main__":
    main()
