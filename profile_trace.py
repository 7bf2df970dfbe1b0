"""One-off: capture a profiler trace of the tracking step and print the
top device ops by total time. ``python profile_trace.py [report]``; the
trace is written under ``.traces/track`` in the checkout."""

import glob
import gzip
import json
import os
import sys
from collections import defaultdict

LOGDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      ".traces", "track")


def capture():
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
    frames = [jax.device_put(seq.frame(i)) for i in range(1, 8)]
    ffs = [build_step(f) for f in frames]
    jax.block_until_ready(ffs)
    prev_sbi = ff0.sbi_track
    out = track_step(state, m, ffs[0], prev_sbi, jax.random.PRNGKey(0))
    out = track_step(out.state, m, ffs[0], prev_sbi, jax.random.PRNGKey(1))
    jax.block_until_ready(out)
    st = out.state

    jax.profiler.start_trace(LOGDIR)
    for i in range(10):
        ff = build_step(frames[i % len(frames)])
        o = track_step(st, m, ff, prev_sbi, jax.random.PRNGKey(i))
        st = o.state
    st.pose.t.block_until_ready()
    jax.profiler.stop_trace()
    print("trace captured")


def report():
    files = sorted(glob.glob(LOGDIR + "/**/*.trace.json.gz",
                             recursive=True))
    if not files:
        print("no trace files under", LOGDIR)
        return
    with gzip.open(files[-1], "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", [])
    # Device lanes: one process per device, named "/device:GPU:<n>"
    # (host threads live under "/host:CPU").
    pid_names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_names[e["pid"]] = e["args"].get("name", "")
    dev_pids = {p for p, nm in pid_names.items()
                if nm.startswith("/device:")}
    tot = defaultdict(float)
    cnt = defaultdict(int)
    total = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("pid") not in dev_pids:
            continue
        name = e.get("name", "?")
        dur = float(e.get("dur", 0.0))
        tot[name] += dur
        cnt[name] += 1
        total += dur
    print(f"device lanes: {[pid_names[p] for p in dev_pids]}")
    print(f"total device time: {total/1e3:.2f} ms over 10 frames")
    for name, d in sorted(tot.items(), key=lambda kv: -kv[1])[:45]:
        print(f"{d/1e3:9.3f} ms  x{cnt[name]:5d}  {name[:110]}")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "report":
        report()
    else:
        capture()
        report()
