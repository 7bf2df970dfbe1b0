"""Benchmark: END-TO-END engine throughput on real hardware.

Unlike bench.py (raw build+track loop), this measures the actual product
path — ``SLAMEngine.process_frame`` with mapping active (keyframe
integration, re-find, local/global BA interleaved per the MapMaker
priority loop), i.e. what a user of the framework gets.

The engine pipeline defers its per-frame decision read by one frame, so
steady-state cost per frame = 2 async dispatches + one small int-vector
read; mapping jobs add periodic spikes (KF integration, BA steps).

Prints ONE JSON line with stall-annotated stats (median/p95/ex-stall
mean, see bench_common.py) plus spike attribution on stderr.

``run_engine_bench()`` is importable: bench.py embeds the engine-level
numbers alongside the raw tracking loop.

Scenario matches bench.py: 640x480 synthetic sequence; map grows to a
few thousand points across up to 16 keyframes.
"""

import json
import sys
import time

import numpy as np

from bench_common import fmt_stats, frame_stats


def run_engine_bench(use_async: bool = False, n_frames: int = 240,
                     log=lambda msg: print(msg, file=sys.stderr)) -> dict:
    """Run the engine bench; returns a stall-annotated stats dict."""
    import jax

    from bench_common import REF_PARAMS as params
    from ptam_cg_tpu.config import (CameraConfig, EngineConfig,
                                    MapMakerConfig)
    from ptam_cg_tpu.io import synth
    from ptam_cg_tpu.models import engine as engine_lib
    from ptam_cg_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    size = (640, 480)
    seq = synth.SyntheticSequence(params, image_size=size,
                                  n_frames=n_frames, seed=7, height=1.5,
                                  radius=0.35, sweep=1.3)
    # Frames live on the HOST as uint8 (the realistic input: a camera /
    # dataset decoder produces bytes in host memory) and are prefetched
    # one ahead with an async device_put so the ~0.3 MB transfer hides
    # behind the previous frame's device compute.
    frames = [np.asarray(seq.frame(i)).astype(np.uint8)
              for i in range(n_frames)]

    cfg = EngineConfig(
        camera=CameraConfig(params=params, image_size=size),
        mapmaker=MapMakerConfig(candidate_min_shi_tomasi_score=100.0))
    # Default is the single-thread interleaved mode; --async runs the
    # reference's two-thread split (tests/test_async_mapping.py).
    # Growth with per-frame decisions (KF adds are capped at one per
    # decision read); the timed max-rate window switches to the
    # pipelined decision_interval=8, whose decisions lag <= 8 frames.
    eng = engine_lib.SLAMEngine(cfg, image_size=size, max_points=4096,
                                max_kfs=16, auto_init_frames=6, seed=0,
                                decision_interval=1,
                                async_mapping=use_async)
    # Pin the BA size tiers to this run's peak (16 KFs / <2048 pts /
    # <8192 meas): tier floors ratchet, so pinning them up front means
    # ONE compiled BA shape for the whole run — a tier crossing inside
    # the timed window would otherwise compile there. (The adaptive
    # tiers still govern correctness; this is the warm-start knob for
    # latency-critical runs.)
    eng.mapmaker._tier_c_floor = 16
    eng.mapmaker._tier_p_floor = 2048
    eng.mapmaker._tier_m_floor = 8192

    def prefetched(seq=None):
        seq = frames if seq is None else seq
        nxt = jax.device_put(seq[0])
        for i in range(len(seq)):
            cur = nxt
            if i + 1 < len(seq):
                nxt = jax.device_put(seq[i + 1])   # async
            yield i, cur

    def precompile_mapping_jobs():
        """Force-compile every mapping job type before the timed window.

        The priority loop fires some jobs lazily (local BA only at >= 8
        keyframes, failure-queue refind on a 1/20 draw), so a short
        warmup pass leaves first-time compiles to land INSIDE the
        measured window. Every program here is shape-static, so one
        forced call each makes the timed window pure steady-state
        execution."""
        # This warmup mutates shared MapMaker/engine state without
        # eng._map_lock; with --async the mapping thread would race it.
        assert not use_async, "precompile warmup requires sync mapping"
        mm = eng.mapmaker
        mm.map = eng.map
        # Land in-flight async work (phased integrations, deferred
        # reads, BA chunks, queued KFs, span-refind tasks).
        slot = mm.drain_all()
        if slot is not None:
            eng.newest_kf = slot
        # One synchronous run of each job program.
        newest = 1 if eng.newest_kf is None else eng.newest_kf
        mm._jit_local_masks(mm.map, newest)              # local-BA masks
        mm.bundle_adjust_recent(newest)
        mm.bundle_adjust_all(full=False)                 # extract/chunk/apply
        mm.mark_dirty()
        mm.handle_bad_points()                           # GC
        mm._failures_pending = True
        mm.refind_from_failure_queue()                   # all-KF refind scan
        jax.block_until_ready(mm.map.point_pos)
        eng.map = mm.map
        # Relocalizer (only fires when lost — compile it up front too).
        ff = eng._build_track(jax.device_put(frames[0]))
        jax.block_until_ready(eng._reloc(eng.map, ff.sbi).pose.t)

    def mapping_busy():
        mm = eng.mapmaker
        return (mm._ba_job is not None or mm._integrate_job is not None
                or mm._refind_task is not None
                or mm._last_dispatch is not None or bool(mm.kf_queue)
                or mm._pending_integrate is not None)

    def hitch_fields(events):
        """Sub-second hitch accounting: frames over 50 ms are HITCHES
        (they sail under the 5 s stall threshold); ones with NO mapping
        work in flight at frame start are not mapping compute."""
        h = [(d, busy) for _, d, _, _, busy in events if 0.05 < d < 5.0]
        return {
            "hitches_over_50ms": len(h),
            "hitches_no_mapping_inflight": sum(1 for _, b in h if not b),
            "hitch_total_ms": round(sum(d for d, _ in h) * 1e3, 1),
        }

    # Warmup, paced by PROGRESS rather than frame index (a fixed-length
    # warmup spent inside compiles would silently measure a 2-keyframe
    # map while claiming the 16-KF scenario):
    #   A. half a sequence at the camera's 30 Hz (init + first KFs,
    #      first-touch compiles land here),
    #   B. force-compile every remaining mapping job type,
    #   C. keep feeding at 30 Hz — ping-ponging the sequence so the
    #      camera path stays continuous — until the map reaches the
    #      growth target (or a bounded number of extra passes, in which
    #      case the shortfall is REPORTED, never silent).
    growth_target = 12          # of max_kfs=16; the sweep revisits
    #                             covered ground so 16/16 is not assured
    warm = n_frames // 2
    t_warm0 = time.perf_counter()
    period = 1.0 / 30.0

    def feed_paced(seq_frames):
        next_tick = time.perf_counter()
        for i, frame in prefetched(seq_frames):
            now = time.perf_counter()
            if now < next_tick:
                time.sleep(next_tick - now)
            next_tick = max(next_tick + period, time.perf_counter())
            yield eng.process_frame(frame)

    for info in feed_paced(frames[:warm]):
        pass
    assert info.stage == "TRACKING", info
    precompile_mapping_jobs()
    # Finish the first pass (compiles are done, so 30 Hz pacing is
    # real), then ping-pong FULL passes — growth loops always end at a
    # sequence endpoint, keeping the camera path continuous.
    for info in feed_paced(frames[warm:]):
        pass
    at_end = True
    for _pass in range(3):
        if eng.mapmaker.n_kfs() >= growth_target:
            break
        for info in feed_paced(frames[::-1] if at_end else frames):
            pass
        at_end = not at_end
    n_kfs_start = eng.mapmaker.n_kfs()
    log(f"# warmup: {time.perf_counter() - t_warm0:.1f}s, "
        f"stage={info.stage} pts={info.n_points} kfs={n_kfs_start} "
        f"(target {growth_target})")

    # ---- measured window: max-rate feed over one sequence pass ------
    eng.decision_interval = 8
    times = []
    events = []   # (i, dt, added_kf, kfs, mapping_busy) for attribution
    seq_frames = frames[::-1] if at_end else frames
    t0 = time.perf_counter()
    for i, frame in prefetched(seq_frames):
        busy = mapping_busy()
        t1 = time.perf_counter()
        info = eng.process_frame(frame)
        dt = time.perf_counter() - t1
        times.append(dt)
        events.append((i, dt, info.added_kf, info.n_kfs, busy))
    total = time.perf_counter() - t0
    fps = len(times) / total

    stats = frame_stats(times)
    stats.update(hitch_fields(events))
    stats.update({
        "fps_as_printed": round(fps, 2),
        "n_points": int(info.n_points),
        "n_kfs": int(info.n_kfs),
        "n_kfs_at_measure_start": int(n_kfs_start),
        "growth_target": growth_target,
        "growth_shortfall": max(0, growth_target - int(n_kfs_start)),
        "quality": int(info.quality),
    })
    log("# engine frame time " + fmt_stats(stats))
    for i, dt, akf, kfs, busy in sorted(events, key=lambda e: -e[1])[:8]:
        log(f"#   spike f{i} {dt*1000:.1f}ms added_kf={akf} kfs={kfs} "
            f"mapping_busy={busy}")

    # ---- REAL-TIME latency pass (the reference's operating point) ----
    # Frames arrive on a 30 Hz tick like a camera; per-frame latency is
    # process_frame's return time. This is the mode the reference's
    # video-rate envelope defines (doc/PTAM.txt:50-53) and the one the
    # KF-latency target (p95 <= one 33 ms envelope frame) is judged at —
    # the max-rate loop above measures THROUGHPUT, where queue-bound
    # waits are inevitable by construction.
    # Reversed-direction sequence: the camera retraces its path, so the
    # RT pass continues smoothly from the engine's current pose (a plain
    # restart would teleport the camera back and force a reloc).
    rt_times = []
    rt_events = []
    next_tick = time.perf_counter()
    for i, frame in prefetched(seq_frames[::-1]):
        now = time.perf_counter()
        if now < next_tick:
            time.sleep(next_tick - now)
        next_tick = max(next_tick + period, time.perf_counter())
        busy = mapping_busy()
        t1 = time.perf_counter()
        info = eng.process_frame(frame)
        dt = time.perf_counter() - t1
        rt_times.append(dt)
        rt_events.append((i, dt, info.added_kf, info.n_kfs, busy))
    rt = frame_stats(rt_times)
    rt.update(hitch_fields(rt_events))
    rt["n_kfs"] = int(info.n_kfs)
    rt["worst_kf_adjacent_ms"] = round(max(
        (d for i, d, akf, k, b in rt_events if akf), default=0.0) * 1e3, 2)
    # Same metric with >1 s frames (stalls, not mapping work: mapping
    # dispatches are latency-bounded) excluded.
    rt["worst_kf_adjacent_ex_stall_ms"] = round(max(
        (d for i, d, akf, k, b in rt_events
         if akf and d < 1.0), default=0.0) * 1e3, 2)
    stats["realtime_30hz"] = rt
    log("# engine RT-30Hz latency " + fmt_stats(rt))
    for i, dt, akf, kfs, busy in sorted(rt_events, key=lambda e: -e[1])[:6]:
        log(f"#   rt spike f{i} {dt*1000:.1f}ms added_kf={akf} kfs={kfs} "
            f"mapping_busy={busy}")
    eng.close()
    return stats


def main():
    use_async = "--async" in sys.argv
    stats = run_engine_bench(use_async=use_async)
    baseline_fps = 30.0   # reference video-rate envelope per CPU core
    fps = stats["fps_as_printed"]
    print(json.dumps({
        "metric": "engine_fps_640x480_mapping_active",
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": round(fps / baseline_fps, 2),
        **{k: v for k, v in stats.items() if k != "fps_as_printed"},
    }))


if __name__ == "__main__":
    main()
