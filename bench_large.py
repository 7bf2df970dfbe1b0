"""Benchmark: engine throughput + mapping-job latency at LARGE map scale
on the default device — 640x480, map capacity 64 keyframes / 8192 points, a
slow monotonic sweep that drives the map to keyframe capacity
(VERDICT r2 #2: nothing had ever run e2e beyond 16 KFs; the reference
runs global BA over all keyframes as the map grows,
ref: src/MapMaker.cc:768-783, src/Bundle.cc:116-158).

Prints ONE JSON line (engine FPS at 64-KF scale, frames measured after
the map is full-size) plus a latency table on stderr:
  - keyframe integration (one jitted dispatch, K=64 shapes)
  - refind-all scan over 64 KF slots
  - global BA: LM steps/s at the live problem size, full convergence time

Tier floors are pinned to the run's peak so the timed window contains no
tier-crossing recompiles.
"""

import json
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from ptam_cg_tpu.config import (CameraConfig, EngineConfig,
                                    MapMakerConfig, TrackerConfig)
    from ptam_cg_tpu.io import synth
    from ptam_cg_tpu.models import engine as engine_lib
    from ptam_cg_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    size = (640, 480)
    params = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)
    # --kf128 (round 5, VERDICT r4 #4): full MAX_KEYFRAMES=128 capacity
    # on the real chip — halved KF spacing (wiggle 0.05) over a slower
    # traversal of the same sweep, like the CPU capacity e2e
    # (tests/test_slam_large_map.py). Reports the reached KF count
    # explicitly; if growth hits a wall short of 128, the wall is the
    # result, not a silent downgrade.
    kf128 = "--kf128" in sys.argv
    max_kfs = 128 if kf128 else 64
    n_frames = 660 if kf128 else 330
    warm = 600 if kf128 else 280   # ~4.3 frames/KF through the pipeline
    seq = synth.SyntheticSequence(params, image_size=size,
                                  n_frames=n_frames, seed=11, height=1.5,
                                  radius=1.0, sweep=1.5)
    frames = [np.asarray(seq.frame(i)).astype(np.uint8)
              for i in range(n_frames)]

    cfg = EngineConfig(
        camera=CameraConfig(params=params, image_size=size),
        tracker=TrackerConfig(min_frames_between_kfs=2),
        mapmaker=MapMakerConfig(
            candidate_min_shi_tomasi_score=100.0,
            max_kf_dist_wiggle_mult=0.05 if kf128 else 0.12))
    # Growth phase runs with per-frame decisions (a keyframe can be
    # added at most once per decision read, so interval=8 caps growth
    # at 1 KF / 8 frames and the map stalls near 28 KFs; at the 30 Hz
    # paced feed the async-copied info lands during the inter-frame
    # idle, so interval=1 reads are ~free). The timed window switches
    # to the pipelined interval=8.
    eng = engine_lib.SLAMEngine(cfg, image_size=size, max_points=8192,
                                max_kfs=max_kfs, auto_init_frames=6,
                                seed=0, decision_interval=1)
    mm = eng.mapmaker
    # Pin BA tiers at the peak so the whole run uses ONE compiled shape
    # per job (see README "Performance notes").
    mm._tier_c_floor = max_kfs
    mm._tier_p_floor = 8192 if kf128 else 4096
    mm._tier_m_floor = 65536 if kf128 else 32768

    def prefetched():
        nxt = jax.device_put(frames[0])
        for i in range(n_frames):
            cur = nxt
            if i + 1 < n_frames:
                nxt = jax.device_put(frames[i + 1])
            yield i, cur

    # GROWTH phase runs at the camera's 30 Hz (the product scenario):
    # at an unthrottled feed the engine's decision reads land only at
    # pipeline-drain cadence (~1 per 32 frames, by design — see
    # engine._inflight), so the map would grow an order of magnitude
    # slower than at real-time rates and the bench would no longer
    # measure a 64-KF map (round-4 measurement: 9 KFs after 230
    # max-rate frames vs 49+ paced). The MEASURED window after warmup
    # stays max-rate (throughput + latency percentiles).
    times = []
    t0 = None
    period = 1.0 / 30.0
    next_tick = time.perf_counter()
    t_warm0 = time.perf_counter()
    for i, frame in prefetched():
        if i < warm:
            now = time.perf_counter()
            if now < next_tick:
                time.sleep(next_tick - now)
            next_tick = max(next_tick + period, time.perf_counter())
        t1 = time.perf_counter()
        info = eng.process_frame(frame)
        if i == warm - 1:
            print(f"# warmup: {warm} frames in "
                  f"{time.perf_counter() - t_warm0:.1f}s, "
                  f"stage={info.stage} pts={info.n_points} "
                  f"kfs={info.n_kfs}", file=sys.stderr)
            assert info.stage == "TRACKING", info
            eng.decision_interval = 8
            t0 = time.perf_counter()
        elif i >= warm:
            times.append(time.perf_counter() - t1)
    total = time.perf_counter() - t0
    fps = len(times) / total
    from bench_common import fmt_stats, frame_stats
    stats = frame_stats(times)
    print(f"# engine at 64-KF scale: frame time {fmt_stats(stats)} "
          f"pts={info.n_points} kfs={info.n_kfs} quality={info.quality} "
          f"n_sel={mm._last_n_sel}", file=sys.stderr)

    # ---- mapping-job latencies at the 64-KF map ------------------------
    # Land any in-flight work first.
    mm.drain_all()
    mm.map = eng.map

    # Timed windows end with a host read, subtract the read RTT, and
    # CHAIN each call on the previous call's output
    # (bench_common.sync_read).
    from bench_common import read_rtt_s, sync_read
    rtt = read_rtt_s()

    def timeit(step, init, n=10):
        x = step(init)                         # warm (already compiled)
        sync_read(x[0].point_pos[0] if hasattr(x[0], "point_pos")
                  else x[0])
        t = time.perf_counter()
        for _ in range(n):
            x = step(x)
        sync_read(x[0].point_pos[0] if hasattr(x[0], "point_pos")
                  else x[0])
        return (time.perf_counter() - t - rtt) / n * 1000

    K = mm.map.kf_valid.shape[0]
    mask2d = jnp.ones_like(mm.failure_mask)
    # Refind re-runs on the SAME base map each iteration (chaining its
    # output map would turn later passes into never-retry no-ops); the
    # jitted feedback injects a zero dependency on the previous output
    # so every iteration provably executes (hazard #2).
    feed = jax.jit(lambda pp, q: pp + 0.0 * q[0, 0])
    base = mm.map

    def refind_step(x):
        m_in = base._replace(point_pos=feed(base.point_pos,
                                            x[0].point_pos))
        return mm._jit_refind_all(m_in, mask2d)

    t_refind = timeit(refind_step, (base,))
    # The PRODUCT refind dispatch is a 16-slot span (one per scheduler
    # pass); its latency is the per-pass bound that matters.

    def span_step(x):
        m_in = base._replace(point_pos=feed(base.point_pos,
                                            x[0].point_pos))
        return mm._jit_refind_span(m_in, mask2d, mm._span_ks[0])

    t_span = timeit(span_step, (base,))

    caps = mm._ba_caps()

    # Chain extract on its own output: the shared jitted feedback makes
    # the next call's map depend on the previous problem.
    def ex_chain(x):
        m_, prob = x
        m_ = m_._replace(point_pos=feed(m_.point_pos, prob.pt_pos))
        prob2 = mm._jit_extract(m_, m_.kf_valid,
                                jnp.zeros(K, bool) | m_.kf_fixed,
                                m_.point_valid, *caps)[0]
        return m_, prob2

    ex = lambda: mm._jit_extract(mm.map, mm.map.kf_valid,
                                 jnp.zeros(K, bool) | mm.map.kf_fixed,
                                 mm.map.point_valid, *caps)
    t_extract = timeit(ex_chain, (mm.map, ex()[0]))

    # Global BA to convergence (fresh jitted chunks, already compiled).
    from ptam_cg_tpu.models import bundle as bundlelib
    prob = ex()[0]
    state = bundlelib.init_lm(prob, mm.ba_cfg)
    kind = bundlelib.mest.estimator_id(mm.ba_cfg.mestimator)
    chunkf = bundlelib._cached_lm_chunk(mm.ba_cfg, kind)
    # One product-size chunk dispatch (what a scheduler pass costs).
    st0 = bundlelib.init_lm(prob, mm.ba_cfg)
    st0, f0 = chunkf(st0, mm.cam, jnp.int32(mm.cfg.ba_steps_per_pass))
    sync_read(f0)
    t = time.perf_counter()
    # Perturbed lam: the timed call is not value-identical to the warm
    # call, so no layer can serve it from a result cache.
    st1, f1 = chunkf(
        bundlelib.init_lm(prob, mm.ba_cfg)._replace(
            lam=jnp.float32(1.0001e-4)),
        mm.cam, jnp.int32(mm.cfg.ba_steps_per_pass))
    chunk_iters = int(np.asarray(f1)[1])      # real host read
    t_chunk = (time.perf_counter() - t - rtt) * 1000

    t = time.perf_counter()
    state, flags = chunkf(state, mm.cam, jnp.int32(mm.ba_cfg.max_iterations))
    conv, iters, failed, acc = (int(x) for x in np.asarray(flags))
    t_ba = time.perf_counter() - t
    print(f"# mapping-job latency at K={max_kfs}: "
          f"refind_all={t_refind:.1f}ms refind_span16={t_span:.1f}ms "
          f"extract={t_extract:.1f}ms "
          f"ba_chunk[{chunk_iters} iters]={t_chunk:.1f}ms "
          f"globalBA: {iters} LM iters in {t_ba*1000:.0f}ms "
          f"({iters/max(t_ba,1e-9):.1f} steps/s, caps={caps}, "
          f"conv={conv} failed={failed})", file=sys.stderr)

    baseline_fps = 30.0
    print(json.dumps({
        "metric": f"engine_fps_640x480_{max_kfs}kf_map",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / baseline_fps, 2),
        "n_kfs_reached": int(info.n_kfs),
        "kf_capacity": max_kfs,
        "n_points": int(info.n_points),
        "refind_span16_ms": round(t_span, 1),
        "refind_all_ms": round(t_refind, 1),
        "extract_ms": round(t_extract, 1),
        "ba_chunk_ms": round(t_chunk, 1),
        "ba_full_iters": iters,
        "ba_full_ms": round(t_ba * 1000, 0),
        **stats,
    }))
    eng.close()


if __name__ == "__main__":
    main()
