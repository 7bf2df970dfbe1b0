"""One-off: per-stage device timing (build vs track) on the GPU.

Reuses bench.py's setup, but times the two jitted programs separately
with per-call blocking (latency, not pipelined throughput).
"""

import time


def main():
    import jax
    import jax.numpy as jnp

    from bench_common import REF_PARAMS as params, make_tracking_scene
    from ptam_cg_tpu.config import EngineConfig
    from ptam_cg_tpu.models import keyframe, tracker

    scene = make_tracking_scene()
    seq, size, m = scene.seq, scene.size, scene.map
    cam, ff0, pose0 = seq.cam, scene.frame0, scene.pose0

    cfg = EngineConfig()
    cam_params = jnp.asarray(params, jnp.float32)

    build_step = jax.jit(
        lambda im: keyframe.build_frame_tracking(im, cfg.frontend))
    track_step = jax.jit(
        lambda s, m_, ff, ps, k: tracker.track_frame(
            s, m_, ff, ps, cam, size, cam_params, k, cfg.tracker))

    state = tracker.init_tracker_state(pose0)
    frames = [seq.frame(i) for i in range(1, 8)]
    frames = [jax.device_put(f) for f in frames]
    prev_sbi = ff0.sbi_track

    ffw = build_step(frames[0])
    outw = track_step(state, m, ffw, prev_sbi, jax.random.PRNGKey(0))
    outw2 = track_step(outw.state, m, ffw, ffw.sbi_track,
                       jax.random.PRNGKey(1))
    jax.block_until_ready(outw2)
    state = outw.state

    # Per-stage PIPELINED device throughput.
    iters = 30
    ffs = [build_step(f) for f in frames]
    jax.block_until_ready(ffs)

    t0 = time.perf_counter()
    out = None
    for i in range(iters):
        out = build_step(frames[i % len(frames)])
    jax.block_until_ready(out)
    t_build = (time.perf_counter() - t0) / iters

    st = state
    t0 = time.perf_counter()
    for i in range(iters):
        o = track_step(st, m, ffs[i % len(ffs)], prev_sbi,
                       jax.random.PRNGKey(i))
        st = o.state
    st.pose.t.block_until_ready()
    t_track = (time.perf_counter() - t0) / iters

    # Pipelined total (bench.py style).
    st = state
    sbi = prev_sbi
    t0 = time.perf_counter()
    for i in range(iters):
        ff = build_step(frames[i % len(frames)])
        out = track_step(st, m, ff, sbi, jax.random.PRNGKey(i))
        st = out.state
        sbi = ff.sbi_track
    st.pose.t.block_until_ready()
    t_total = (time.perf_counter() - t0) / iters

    print(f"build  {t_build*1000:.2f} ms (blocking)")
    print(f"track  {t_track*1000:.2f} ms (blocking)")
    print(f"total  {t_total*1000:.2f} ms pipelined -> {1/t_total:.1f} FPS")

    # Fused single-dispatch variant: one dispatch per frame, not two.
    def fused(s, m_, im, ps, k):
        ff = keyframe.build_frame_tracking(im, cfg.frontend)
        return tracker.track_frame(s, m_, ff, ps, cam, size, cam_params,
                                   k, cfg.tracker), ff.sbi_track
    fused_step = jax.jit(fused)
    outf, sbif = fused_step(state, m, frames[0], prev_sbi,
                            jax.random.PRNGKey(0))
    outf, sbif = fused_step(outf.state, m, frames[0], sbif,
                            jax.random.PRNGKey(1))
    jax.block_until_ready(outf)
    st = outf.state
    sbi = sbif
    t0 = time.perf_counter()
    for i in range(iters):
        out, sbi = fused_step(st, m, frames[i % len(frames)], sbi,
                              jax.random.PRNGKey(i))
        st = out.state
    st.pose.t.block_until_ready()
    t_fused = (time.perf_counter() - t0) / iters
    print(f"fused  {t_fused*1000:.2f} ms pipelined -> {1/t_fused:.1f} FPS")


if __name__ == "__main__":
    main()
