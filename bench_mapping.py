"""Benchmark: mapping-backend latency on real hardware.

Measures the two jitted mapping programs that run per keyframe in the
MapMaker priority loop (ref behavior: the reference's mapping thread must
keep up with video rate, src/MapMaker.cc:57-114):

- ``integrate``: whole keyframe integration — insert + tracker
  measurements + re-find of all points + epipolar expansion at 4 levels —
  as ONE device program (MapMaker._jit_integrate).
- ``refind_all``: ReFindNewlyMade over every keyframe slot as one
  lax.scan program (MapMaker._jit_refind_all).

Prints ONE JSON line with the KF-integration latency, plus a duty-cycle
estimate: fraction of a 20-frame @30FPS keyframe period spent on these
mapping jobs (BA step cost is benchmarked separately in bench_ba.py).

Run on the CPU for logic (fast), on the GPU for the recorded numbers.
"""

import json
import sys
import time

import numpy as np


def build_scene(size=(640, 480), P=2048, K=8):
    """bench.py's synthetic planar scene (bench_common.make_tracking_scene)
    with ``K`` keyframe slots + dense measurements for KF0."""
    import jax
    import jax.numpy as jnp

    from bench_common import make_tracking_scene
    from ptam_cg_tpu.models import keyframe, map_state

    scene = make_tracking_scene(P, size, n_frames=4, max_kfs=K)
    seq, m = scene.seq, scene.map
    cam = seq.cam
    build_full = jax.jit(lambda x: keyframe.build_frame(
        x, candidate_min_score=50.0))
    ctr = np.asarray(m.point_center)
    lv = np.asarray(m.point_src_level)

    # Dense KF0 measurements at the points' root positions.
    lvl0 = (ctr + 0.5) * (1 << lv)[:, None].astype(np.float32) - 0.5
    m = map_state.set_measurements(
        m, 0, jnp.arange(P), jnp.asarray(lvl0), jnp.asarray(lv),
        jnp.ones(P, bool), jnp.full(P, map_state.SRC_ROOT, jnp.int32),
        m.point_valid)
    return seq, cam, m, build_full


def main():
    import jax
    import jax.numpy as jnp

    from ptam_cg_tpu.models import mapmaker as mmlib
    from ptam_cg_tpu.models import map_state
    from ptam_cg_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    size = (640, 480)
    seq, cam, m, build_full = build_scene(size)
    P = m.point_pos.shape[0]
    K = m.kf_valid.shape[0]

    maker = mmlib.MapMaker(m, cam, size)
    ff1 = build_full(seq.frame(1))
    pose1 = seq.pose(1)

    # Tracker-style measurements for the new KF: the map's points at
    # their reprojected positions.
    from ptam_cg_tpu.camera import atan
    p_cam = m.point_pos @ pose1.R.T + pose1.t
    z1 = p_cam[:, :2] / p_cam[:, 2:3]
    pix = atan.project(z1, cam)
    meas_valid = m.point_valid & (p_cam[:, 2] > 0.1)
    meas_point = jnp.arange(P)
    meas_level = m.point_src_level

    dm = jnp.float32(1.5)
    ds = jnp.float32(0.1)
    npm = jnp.zeros(P, bool)

    def integrate(mm_in):
        return maker._jit_integrate(mm_in, ff1, pose1, meas_point, pix,
                                    meas_level, meas_valid, meas_valid,
                                    dm, ds, npm)

    # Warmup / compile. Timed windows end with a host read, subtract
    # the read RTT, and CHAIN each call on the previous output (see
    # bench_common.sync_read).
    from bench_common import read_rtt_s, sync_read

    # Chain by feeding the integrated map's state back in via a tiny
    # jitted feedback (the integrate itself must keep inserting into a
    # map with a free slot, so the INPUT map stays `m` shifted by a
    # zero-valued dependency on the previous output).
    feed = jax.jit(lambda pp, q: pp + 0.0 * q[0, 0])

    out_m, new_mask, slot_n = integrate(m)
    sync_read(slot_n)
    rtt = read_rtt_s()
    t0 = time.perf_counter()
    iters = 20
    for _ in range(iters):
        m_in = m._replace(point_pos=feed(m.point_pos, out_m.point_pos))
        out_m, new_mask, slot_n = integrate(m_in)
    sync_read(slot_n)
    integrate_ms = (time.perf_counter() - t0 - rtt) / iters * 1000

    # Refind must re-run on the SAME map each iteration (chaining the
    # output map turns later passes into never-retry no-ops): the
    # feedback re-injects a zero dependency on the previous output into
    # an otherwise identical input.
    mask2d = jnp.broadcast_to(new_mask, (K, P))
    m2, nf = maker._jit_refind_all(out_m, mask2d)
    sync_read(nf)
    t0 = time.perf_counter()
    for _ in range(iters):
        m_in = out_m._replace(point_pos=feed(out_m.point_pos,
                                             m2.point_pos))
        m2, nf = maker._jit_refind_all(m_in, mask2d)
    sync_read(nf)
    refind_ms = (time.perf_counter() - t0 - rtt) / iters * 1000

    # Duty cycle: mapping work per keyframe period (20 frames @ 30 FPS,
    # ref: src/Tracker.cc:163) spent in integrate + one refind-all pass.
    period_ms = 20 * (1000.0 / 30.0)
    duty = (integrate_ms + refind_ms) / period_ms

    print(json.dumps({
        "metric": "kf_integration_ms_640x480_2048pts",
        "value": round(integrate_ms, 2),
        "unit": "ms",
        "vs_baseline": round(duty, 4),
    }))
    print(f"# integrate={integrate_ms:.1f}ms refind_all({K}kf)="
          f"{refind_ms:.1f}ms n_added={int(slot_n[1])} "
          f"refound={int(nf)} duty={duty*100:.1f}% of a "
          f"20-frame KF period", file=sys.stderr)


if __name__ == "__main__":
    main()
