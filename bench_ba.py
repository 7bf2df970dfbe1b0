"""Secondary benchmark: bundle-adjustment LM-step throughput.

Prints one JSON line per problem size. The reference runs global BA on
one CPU core (ref: src/Bundle.cc); this measures the dense
Schur-complement step at local-BA and global-BA scales on the default
device.

``--northstar`` (VERDICT r3 #2) runs the BASELINE.json scale target —
C=500 keyframes / P=50k points / M=500k measurements:
  (a) the point-sharded LM chunk on an 8-virtual-device CPU mesh
      (correctness: finite + error decreases; per-host memory), plus an
      equal-results check vs the single-device step at C=500/P=5k/M=50k;
  (b) the single-device LM step on the default device, a GPU (step
      latency, peak device memory; ``--device-only`` runs just this)
      — the analytic accounting in BASELINE.md says W blocks are 1.8 GB
      dense (225 MB/device sharded over 8) and the per-inner-iteration
      collective is 36C^2 floats = 36 MB.
"""

import json
import os
import sys
import time

# Must be set before jax initializes: gives the in-process CPU backend 8
# virtual devices for the north-star mesh run alongside the GPU.
if "--northstar" in sys.argv:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import numpy as np


def make_problem(n_cams, n_pts, n_meas, seed=0,
                 motion=(0.08, 0.015), depth=(3.0, 6.0), noise_px=0.3):
    import jax.numpy as jnp

    from ptam_cg_tpu.camera import atan
    from ptam_cg_tpu.models import bundle
    from ptam_cg_tpu.utils import se3 as se3lib

    rng = np.random.default_rng(seed)
    cam = atan.make_camera((1.0803, 1.43987, 0.519983, 0.548655,
                            0.244943), (640, 480))
    z0, z1r = depth
    pts = rng.uniform([-2, -1.5, z0], [2, 1.5, z1r],
                      (n_pts, 3)).astype(np.float32)
    tm, rm = motion
    poses = [se3lib.se3_exp(jnp.asarray(np.array(
        [tm * j, tm * 0.125 * j, 0, 0, -rm * j, 0], np.float32)))
        for j in range(n_cams)]
    R = np.stack([np.asarray(p.R) for p in poses])
    t = np.stack([np.asarray(p.t) for p in poses])
    mc = rng.integers(0, n_cams, n_meas).astype(np.int32)
    mp = rng.integers(0, n_pts, n_meas).astype(np.int32)
    p_cam = np.einsum("mij,mj->mi", R[mc], pts[mp]) + t[mc]
    z1 = p_cam[:, :2] / p_cam[:, 2:3]
    pix = np.array(atan.project(jnp.asarray(z1), cam))
    pix += rng.normal(0, noise_px, pix.shape)
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True
    prob = bundle.BundleProblem(
        cam_R=jnp.asarray(R), cam_t=jnp.asarray(t),
        cam_fixed=jnp.asarray(fixed), cam_valid=jnp.ones(n_cams, bool),
        pt_pos=jnp.asarray(pts + rng.normal(0, 0.02, pts.shape)
                           .astype(np.float32)),
        pt_valid=jnp.ones(n_pts, bool),
        meas_cam=jnp.asarray(mc), meas_pt=jnp.asarray(mp),
        meas_pos=jnp.asarray(pix.astype(np.float32)),
        meas_sqrt_inv_noise=jnp.ones(n_meas, jnp.float32),
        meas_valid=jnp.ones(n_meas, bool),
        meas_bad=jnp.zeros(n_meas, bool))
    return prob, cam


def northstar():
    """The 500-KF scale target: sharded chunk on the 8-device CPU mesh +
    single-device step on the default device. See module docstring."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from ptam_cg_tpu.config import BundleConfig
    from ptam_cg_tpu.models import bundle
    from ptam_cg_tpu.parallel import sharded_ba
    from ptam_cg_tpu.utils import mest

    C, P, M = 500, 50000, 500000
    cfg = BundleConfig()
    kind = mest.estimator_id(cfg.mestimator)
    motion = (0.002, 0.0005)   # keep a 500-camera trajectory sane

    if "--device-only" in sys.argv:
        _northstar_device(C, P, M, cfg, motion)
        return

    # ---- (a0) equal-results: sharded vs single-device at C=500, 10x
    # smaller P/M (the at-scale equality is proven at C=128/P=16k/M=64k
    # by tests/test_sharded_ba.py; this adds the C=500 camera-system
    # shape on the CPU mesh).
    cpu = jax.devices("cpu")
    assert len(cpu) >= 8, cpu
    mesh = Mesh(np.array(cpu[:8]), ("mp",))
    with jax.default_device(cpu[0]):
        prob_s, cam = make_problem(C, 5000, 50000, seed=3, motion=motion)
        step1 = jax.jit(lambda s: bundle.lm_step(s, cam, cfg))
        s1 = step1(bundle.init_lm(prob_s, cfg))
        sp = sharded_ba.shard_problem(prob_s, mesh)
        sstep = sharded_ba.make_sharded_lm_step(mesh, cam, cfg)
        ss = sstep(bundle.init_lm(sp, cfg))
        err1, errs = float(s1.last_error), float(ss.last_error)
        cam_dt = float(jnp.max(jnp.abs(ss.problem.cam_t
                                       - s1.problem.cam_t)))
        assert abs(err1 - errs) / max(err1, 1.0) < 1e-3, (err1, errs)
        assert cam_dt < 2e-4, cam_dt
        print(f"# northstar C=500 equal-results (P=5k): err "
              f"{errs:.1f}=={err1:.1f}, cam max|dt|={cam_dt:.1e}",
              file=sys.stderr)

        # ---- (a) full north-star shapes on the 8-device CPU mesh ----
        prob, cam = make_problem(C, P, M, seed=4, motion=motion)
        rms0 = float(bundle.residual_rms(prob, cam))
        chunkf = sharded_ba.cached_sharded_lm_chunk(mesh, cfg, kind)
        sprob = sharded_ba.shard_problem(prob, mesh)
        state = bundle.init_lm(sprob, cfg)
        t0 = time.perf_counter()
        state, flags = chunkf(state, cam, jnp.int32(2))
        state.problem.pt_pos.block_until_ready()
        dt_first = time.perf_counter() - t0
        conv, iters, failed, acc = (int(x) for x in np.asarray(flags))
        assert not failed and iters == 2, (conv, iters, failed)
        assert np.isfinite(float(state.last_error))
        t0 = time.perf_counter()
        state, flags = chunkf(state, cam, jnp.int32(4))
        state.problem.pt_pos.block_until_ready()
        dt_next = (time.perf_counter() - t0) / 2
        # Correctness signal: RAW reprojection RMS dropped (last_error is
        # a robust objective under a per-step sigma — not comparable
        # across steps).
        rms4 = float(bundle.residual_rms(state.problem, cam))
        assert np.isfinite(rms4) and rms4 < rms0, (rms0, rms4)
        import resource
        rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        print(json.dumps({
            "metric": "northstar_sharded_ba_cpu8_step_ms",
            "value": round(dt_next * 1000, 1),
            "unit": "ms/LM-step (8-dev CPU mesh, C=500 P=50k M=500k)",
            "vs_baseline": None,
            "first_2step_chunk_s": round(dt_first, 1),
            "rms_before": round(rms0, 3), "rms_after_4": round(rms4, 3),
            "host_rss_gb": round(rss_gb, 2),
        }))

    # ---- (b) single-device on the default device ---------------------
    if "--cpu-only" in sys.argv:
        return
    _northstar_device(C, P, M, cfg, motion)


def _northstar_device(C, P, M, cfg, motion):
    import jax
    import jax.numpy as jnp

    from ptam_cg_tpu.models import bundle, mapmaker
    from ptam_cg_tpu.utils import mest

    dev = jax.devices()[0]
    prob, cam = make_problem(C, P, M, seed=4, motion=motion)
    prob = jax.device_put(prob, dev)
    # Time PER INNER LM ITERATION with standalone jitted steps: one
    # lm_step CALL runs a variable number of inner lambda retries, so
    # per-call numbers can overstate arbitrarily. Above
    # BA_CHUNK_W_BYTES_LIMIT MapMaker._ba_dispatch_chunk dispatches
    # single steps — the PRODUCT program at this scale is
    # bundle._cached_lm_step_flags, measured below alongside the
    # standalone step. Timed windows end with a host read
    # (int(state.iters); bench_common.sync_read).
    step = jax.jit(lambda s: bundle.lm_step(s, cam, cfg))
    state = bundle.init_lm(prob, cfg)
    t0 = time.perf_counter()
    state = step(state)
    it0 = int(state.iters)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(5):
        state = step(state)
    n_inner = max(int(state.iters) - it0, 1)
    dt = time.perf_counter() - t0
    stats = {}
    try:
        stats = dev.memory_stats() or {}
    except Exception:
        pass
    peak_gb = stats.get("peak_bytes_in_use", 0) / 2**30
    rms4 = float(jax.jit(bundle.residual_rms)(state.problem, cam))

    # --- PRODUCT dispatch path at this scale: the per-step+flags
    # program MapMaker._ba_dispatch_chunk selects (the caps here are
    # C->512 / P->65536, far past BA_CHUNK_W_BYTES_LIMIT), in the
    # MEMORY-LEAN configuration the MapMaker applies at this tier.
    import dataclasses
    assert mapmaker.ba_use_single_step(512, 65536)
    kind = mest.estimator_id(cfg.mestimator)
    lean = dataclasses.replace(cfg, soff_tiles=8, u_chunks=8)
    stepf = bundle._cached_lm_step_flags(lean, kind)
    pstate = bundle.init_lm(jax.device_put(prob, dev), cfg)
    pstate, flags = stepf(pstate, cam)       # compile + first step
    pit0 = int(np.asarray(flags)[1])         # real host read
    t0 = time.perf_counter()
    for _ in range(5):
        pstate, flags = stepf(pstate, cam)
        flags.copy_to_host_async()           # what the scheduler does
    p_inner = max(int(np.asarray(flags)[1]) - pit0, 1)
    pdt = time.perf_counter() - t0
    product_ms = pdt / p_inner * 1000
    standalone_ms = dt / n_inner * 1000

    print(json.dumps({
        "metric": "northstar_ba_1dev_step_ms",
        "value": round(standalone_ms, 1),
        "unit": "ms/inner-LM-iteration (1 device, C=500 P=50k M=500k)",
        "device": {"platform": dev.platform, "kind": dev.device_kind},
        "vs_baseline": None,
        "inner_iters_timed": n_inner,
        "compile_plus_first_s": round(compile_s, 1),
        "peak_device_mem_gb": round(peak_gb, 2),
        "rms_after": round(rms4, 3),
        "converged": bool(state.converged),
        "failed": bool(state.failed),
        "product_path_step_ms": round(product_ms, 1),
        "product_vs_standalone": round(product_ms / standalone_ms, 2),
    }))
    print(f"# analytic: dense W blocks {P*C*18*4/2**30:.2f} GB; "
          f"sharded/8 {P*C*18*4/8/2**20:.0f} MB/device; psum "
          f"36C^2 = {36*C*C*4/2**20:.0f} MB/inner-iter", file=sys.stderr)


def main():
    import jax

    from ptam_cg_tpu.models import bundle
    from ptam_cg_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if "--northstar" in sys.argv:
        northstar()
        return

    results = []
    for name, (C, P, M) in {
        "local_ba_5kf": (5, 512, 2048),
        "global_ba_64kf": (64, 4096, 16384),
    }.items():
        from bench_common import read_rtt_s

        prob, cam = make_problem(C, P, M)
        step = jax.jit(lambda s: bundle.lm_step(s, cam))
        state = bundle.init_lm(prob)
        state = step(state)
        it0 = int(state.iters)               # real host read (see
        #                                      bench_common.sync_read)
        rtt = read_rtt_s()
        n = 20
        t0 = time.perf_counter()
        s = state
        for _ in range(n):
            s = step(s)
        # Divide by INNER iterations actually advanced (early
        # convergence turns trailing steps into cheap no-ops).
        n_done = max(int(s.iters) - it0, 1)
        dt = (time.perf_counter() - t0 - rtt) / n_done
        results.append({
            "metric": f"ba_lm_steps_per_s_{name}",
            "value": round(1.0 / dt, 2),
            "unit": "steps/s",
            "vs_baseline": None,
        })
        print(json.dumps(results[-1]))
        print(f"# {name}: C={C} P={P} M={M} step={dt*1000:.1f}ms",
              file=sys.stderr)


if __name__ == "__main__":
    main()
