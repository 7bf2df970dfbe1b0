"""Camera calibration entry point — the reference's SECOND executable
(ref: src/CameraCalibrator.cc:31-120 ``main``/``Run``: grab checkerboard
views, grow a grid per view, jointly optimize N poses + the 5 ATAN
params, then persist ``Camera.Parameters`` to a GVars cfg file,
src/CameraCalibrator.cc:122-146 ``SaveCalibration``).

Headless equivalent: views come from an image directory (any mix of
.pgm/.png/.npy grayscale files) or from the synthetic checkerboard
renderer (``--synthetic N``) when no captured data exists in this
environment. Prints per-view grid stats, the converged RMS reprojection
error (reference target: < 0.3 px typical, src/CameraCalibrator.cc:145),
and the recovered parameters; ``--out`` writes them in the exact
settings.cfg line format the reference's tracker consumes
(``Camera.Parameters=[ fx fy cx cy w ]``, config/settings.cfg:7).

Usage:
  python examples/run_calib.py IMAGE_DIR [--out camera.cfg]
  python examples/run_calib.py --synthetic 5 [--out camera.cfg]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def synthetic_views(n, size, params, blur=0.6):
    """Render n supersampled anti-aliased checkerboard views at strong
    tilts (near-frontal planar views leave focal/distortion/depth poorly
    conditioned — the reference docs likewise tell the user to shoot the
    grid at an angle)."""
    import jax.numpy as jnp
    import numpy as np

    from ptam_cg_tpu.camera import atan
    from ptam_cg_tpu.io import synth
    from ptam_cg_tpu.ops import image as imops
    from ptam_cg_tpu.utils import se3 as se3lib

    rng = np.random.RandomState(3)
    big = (size[0] * 2, size[1] * 2)
    cam2 = atan.make_camera(params, big)
    for _ in range(n):
        xi = np.array([
            rng.uniform(-1.0, 1.0), rng.uniform(-0.8, 0.8),
            rng.uniform(5.0, 7.0),
            rng.uniform(0.25, 0.6) * rng.choice([-1, 1]),
            rng.uniform(0.15, 0.55) * rng.choice([-1, 1]),
            rng.uniform(-0.6, 0.6)])
        pose = se3lib.se3_exp(jnp.asarray(xi, jnp.float32))
        im = imops.half_sample(synth.render_checkerboard(cam2, pose, big))
        if blur > 0:
            im = imops.gaussian_blur(im, blur)
        yield im


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("images", nargs="?", default=None,
                    help="directory of grayscale checkerboard views")
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="render N synthetic views instead of loading")
    ap.add_argument("--size", default="320x240",
                    help="image size for --synthetic (WxH)")
    ap.add_argument("--iters", type=int, default=100,
                    help="joint GN iterations (0.1-damped steps)")
    ap.add_argument("--out", default=None, metavar="CFG",
                    help="write Camera.Parameters in settings.cfg format")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: JAX's default "
                         "backend, the GPU when there is one)")
    args = ap.parse_args()
    if not args.synthetic and args.images is None:
        ap.error("give IMAGE_DIR or --synthetic N")

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from ptam_cg_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from ptam_cg_tpu.camera import calibrator

    gt_params = (0.62, 0.82, 0.5, 0.5, 0.15)
    if args.synthetic:
        w, h = (int(x) for x in args.size.split("x"))
        size = (w, h)
        views = synthetic_views(args.synthetic, size, gt_params)
    else:
        from ptam_cg_tpu.io.tum import _load_image
        paths = sorted(p for p in Path(args.images).iterdir()
                       if p.suffix.lower() in (".pgm", ".png", ".npy"))
        if not paths:
            sys.exit(f"no .pgm/.png/.npy images in {args.images}")
        ims = [np.asarray(_load_image(str(p)), np.float32) for p in paths]
        size = (ims[0].shape[1], ims[0].shape[0])
        views = (jnp.asarray(im) for im in ims)

    calib = calibrator.CameraCalibrator(size)
    added = 0
    for i, im in enumerate(views):
        ok = calib.add_image(im)
        if ok:
            print(f"view {i}: grid ok, {len(calib.views[-1].grid)} "
                  f"grid corners")
        else:
            print(f"view {i}: no grid found (skipped)")
        added += ok
    if added < 2:
        sys.exit("need at least 2 usable views "
                 "(ref: the calibrator optimizes across several grabs)")

    rms = np.inf
    for it in range(args.iters):
        rms = calib.optimize_step()
        if it % 10 == 0 or it == args.iters - 1:
            print(f"iter {it:3d}: RMS reprojection {rms:.4f} px")
    fx, fy, cx, cy, wd = calib.params
    print(f"\ncalibrated over {added} views, final RMS {rms:.4f} px "
          f"(reference target < 0.3 px)")
    print(f"Camera.Parameters=[ {fx:.6f} {fy:.6f} {cx:.6f} {cy:.6f} "
          f"{abs(wd):.6f} ]")
    if args.synthetic:
        err = np.abs(np.array(calib.params[:4]) - np.array(gt_params[:4]))
        print(f"# synthetic GT {gt_params}; |err| fx/fy/cx/cy "
              f"{err.max():.4f}, |w| err "
              f"{abs(abs(wd) - gt_params[4]):.4f}")
    if args.out:
        with open(args.out, "w") as f:
            f.write("// saved by run_calib.py "
                    "(ref: CameraCalibrator::SaveCalibration)\n")
            f.write(f"Camera.Parameters=[ {fx:.6f} {fy:.6f} {cx:.6f} "
                    f"{cy:.6f} {abs(wd):.6f} ]\n")
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
