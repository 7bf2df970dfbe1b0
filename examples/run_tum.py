"""Run the SLAM engine on a TUM-RGBD-format dataset directory.

Equivalent of the reference's dataset mode (VideoSource.DataSet in
settings.cfg, ref: src/VideoSource.cc:59-159). Reports ATE against
groundtruth.txt when present.

Usage:
  python examples/run_tum.py DATASET_DIR [--settings settings.cfg]
      [--frames N] [--native] [--cpu] [--ar out_dir] [--map out.ppm]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset")
    ap.add_argument("--settings", default=None,
                    help="reference-format settings.cfg")
    ap.add_argument("--frames", type=int, default=0,
                    help="frame cap (0 = whole dataset)")
    ap.add_argument("--native", action="store_true",
                    help="use the C++ prefetching frame pump")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: JAX's default "
                         "backend, the GPU when there is one)")
    ap.add_argument("--ar", default=None, metavar="OUT_DIR",
                    help="write AR-composited frames (EyeGame-parity "
                         "eyeballs on the dominant plane) as PPMs")
    ap.add_argument("--ar-every", type=int, default=5,
                    help="render every Nth tracked frame with --ar")
    ap.add_argument("--map", default=None,
                    help="write a top-down map render (PPM) at the end")
    ap.add_argument("--checkpoint", default=None,
                    help="write a map checkpoint (npz) at the end")
    ap.add_argument("--commands", default=None, metavar="FILE",
                    help="scripted console commands (the reference's "
                         "GUI.ParseLine analog): one per line, optional "
                         "@FRAME prefix; see ptam_cg_tpu/io/commands.py")
    ap.add_argument("--rate", type=float, default=0.0, metavar="HZ",
                    help="pace replay at HZ frames/s like the "
                         "reference's 25 FPS dataset sleep "
                         "(ref: src/VideoSource.cc:102-103); 0 = "
                         "unthrottled")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from ptam_cg_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import numpy as np

    from ptam_cg_tpu.config import EngineConfig
    from ptam_cg_tpu.io import settings as settingslib
    from ptam_cg_tpu.io import tum
    from ptam_cg_tpu.models import engine as engine_lib
    from ptam_cg_tpu.utils import evaluate
    from ptam_cg_tpu.viz import mapviewer

    if args.settings:
        cfg, _ = settingslib.load_engine_config(args.settings)
    else:
        cfg = EngineConfig()

    if args.native:
        from ptam_cg_tpu import native
        ds = native.NativeFramePump(args.dataset, prefetch=4, loop=False)
        n_frames = len(ds)
        frame_iter = iter(lambda: ds.next_frame(), None)
    else:
        ds = tum.TumDataset(args.dataset, loop=False)
        n_frames = len(ds)
        frame_iter = iter(ds)

    if args.frames:
        n_frames = min(n_frames, args.frames)

    # Image size from the first frame.
    try:
        ts0, f0 = next(frame_iter)
    except StopIteration:
        sys.exit("no decodable frames in the dataset. With --native the "
                 "C++ frame pump reads .npy/.pgm only — regenerate with "
                 "make_synth_tum.py (default .npy) or drop --native for "
                 "the Python reader (PNG via PIL).")
    size = (f0.shape[1], f0.shape[0])
    eng = engine_lib.SLAMEngine(cfg, image_size=size, max_points=4096,
                                max_kfs=16, auto_init_frames=8)

    gt = None
    try:
        gt = tum.load_groundtruth(args.dataset)
    except FileNotFoundError:
        pass

    ar_step = None
    if args.ar:
        from ptam_cg_tpu.viz import ar as arlib
        Path(args.ar).mkdir(parents=True, exist_ok=True)

        def _ar(frame_, R, t):
            from ptam_cg_tpu.utils.se3 import SE3 as _SE3
            import jax.numpy as jnp
            pose = _SE3(R, t)
            c = -R.T @ t
            verts, tris, shades = arlib.make_eye_game(c)
            return arlib.render_ar_frame(frame_, pose, eng.cam, size,
                                         verts, tris, shades,
                                         ufb_size=size)
        ar_step = jax.jit(_ar)

    console = None
    if args.commands:
        from ptam_cg_tpu.io import commands as cmdlib
        console = cmdlib.ScriptedConsole(
            eng, cmdlib.load_command_script(args.commands))

    est_centers, gt_centers, times, traj = [], [], [], []
    frame = f0
    ts = ts0
    # Paced replay (--rate): sleep to the tick like the reference's
    # dataset sleep.
    period = 1.0 / args.rate if args.rate > 0 else 0.0
    next_tick = time.perf_counter()
    for i in range(n_frames):
        if console is not None:
            for msg in console.on_frame(i):
                print(f"console @{i}: {msg}")
        if period:
            now = time.perf_counter()
            if now < next_tick:
                time.sleep(next_tick - now)
            next_tick = max(next_tick + period, time.perf_counter())
        t0 = time.perf_counter()
        info = eng.process_frame(frame)
        times.append(time.perf_counter() - t0)
        if i % 10 == 0 or info.added_kf:
            print(f"frame {i:4d} [{info.stage:14s}] q={info.quality} "
                  f"found={info.n_found:4d} pts={info.n_points:4d} "
                  f"kfs={info.n_kfs} ({times[-1]*1000:.0f} ms)")
        if info.stage == "TRACKING":
            import jax.numpy as jnp
            from ptam_cg_tpu.utils.se3 import SE3
            c = np.asarray(evaluate.camera_centers(
                SE3(info.pose.R[None], info.pose.t[None])))[0]
            est_centers.append(c)
            traj.append(c)
            if gt is not None:
                k = int(np.argmin(np.abs(gt[0] - ts)))
                gt_centers.append(gt[1][k])
            if ar_step is not None and i % args.ar_every == 0:
                out = np.asarray(ar_step(jnp.asarray(frame, jnp.float32),
                                         info.pose.R, info.pose.t))
                mapviewer.save_ppm(
                    str(Path(args.ar) / f"ar_{i:05d}.ppm"),
                    np.repeat(np.clip(out, 0, 255)[..., None], 3,
                              axis=-1))
        if i + 1 < n_frames:
            try:
                ts, frame = next(frame_iter)
            except StopIteration:
                break

    print(f"\nprocessed {len(times)} frames, median "
          f"{np.median(times)*1000:.0f} ms/frame")
    if gt is not None and len(est_centers) > 10:
        import jax.numpy as jnp
        ate = evaluate.ate_rmse(jnp.asarray(np.stack(est_centers)),
                                jnp.asarray(np.stack(gt_centers)))
        print(f"ATE RMSE vs groundtruth: {ate*1000:.1f} mm")
    if args.map:
        img = mapviewer.render_topdown(
            eng.map, trajectory=np.stack(traj) if traj else None)
        mapviewer.save_ppm(args.map, img)
        print(f"map render -> {args.map}")
    if args.checkpoint:
        from ptam_cg_tpu.io import checkpoint
        checkpoint.save_map(args.checkpoint, eng.map, eng.tracker_state)
        print(f"checkpoint -> {args.checkpoint}")


if __name__ == "__main__":
    main()
