"""SLAMEngine: the top-level orchestrator (System + Tracker state machine).

Capability parity with the reference's System frame loop + the Tracker's
initialization/relocalization state machine (ref: src/System.cc:54-110,
src/Tracker.cc:86-307). The reference runs tracking on the main thread
and mapping on a second CPU thread; here both are jitted device programs
and a host loop interleaves them: one tracking step per frame plus one
mapping priority-step (``MapMaker.step``) — the pending-KF queue aborts
long BA runs between LM steps exactly like the reference's abort flag.

The reference's spacebar-driven init is exposed both as an API
(``request_init``) and an automatic policy for dataset runs
(``auto_init_frames``).
"""

from __future__ import annotations

import enum
import os
import threading
import time
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ptam_cg_tpu.camera import atan
from ptam_cg_tpu.config import EngineConfig
from ptam_cg_tpu.models import initializer as initlib
from ptam_cg_tpu.models import keyframe as kflib
from ptam_cg_tpu.models import map_state as ms
from ptam_cg_tpu.models import mapmaker as mmlib
from ptam_cg_tpu.models import relocalizer as reloclib
from ptam_cg_tpu.models import tracker as trklib
from ptam_cg_tpu.utils import se3 as se3lib
from ptam_cg_tpu.utils.se3 import SE3


_DBG = bool(os.environ.get("PTAM_DEBUG_TIMING"))


class Stage(enum.Enum):
    NOT_STARTED = 0          # waiting for first "spacebar"
    TRAIL_TRACKING = 1       # between the two init keyframes
    TRACKING = 2             # map good, normal operation


class FrameInfo(NamedTuple):
    pose: SE3
    stage: str
    quality: int
    n_found: int
    n_points: int
    n_kfs: int
    added_kf: bool
    relocalized: bool


class SLAMEngine:
    """Frame-loop orchestrator.

    ``async_mapping=True`` restores the reference's two-thread
    parallelism (ref: CVD::Thread mapmaker, include/MapMaker.h:37-38):
    mapping jobs run on a Python worker thread while tracking continues
    against the latest published map snapshot. MapState is an immutable
    pytree, so the snapshot swap is an atomic reference assignment — the
    no-lock shared-map design without its races.
    """

    def __init__(self, cfg: EngineConfig = EngineConfig(),
                 image_size=None, max_points: int = 2048,
                 max_kfs: int = 16, seed: int = 0,
                 auto_init_frames: Optional[int] = 6,
                 async_mapping: bool = False,
                 decision_interval: int = 1,
                 mesh=None, deterministic: Optional[bool] = None):
        """``decision_interval``: read the per-frame decision scalars
        (quality / lost / KF-need) back from the device every N frames
        instead of every frame. N > 1 lets a max-rate feed keep the
        device pipeline full, with decisions lagging <= N frames; N=1
        (the default) decides every frame like the reference. Whether
        N > 1 still pays on the GPU is re-measured under ROADMAP C2.

        ``mesh``: optional ``jax.sharding.Mesh`` — with >1 device,
        global bundle adjustment runs point-sharded over it (the
        framework's multi-chip scale path; see parallel/sharded_ba.py).
        Tracking stays single-device (one frame is far below one chip's
        capacity).

        ``deterministic``: with True, engine + mapping scheduling is a
        pure function of the frame sequence and seed — every readiness
        gate blocks and BA chunks are fixed-size, so the same replay
        produces the same map regardless of host load (the reference's
        deterministic dataset harness, ref: src/VideoSource.cc:59-151;
        VERDICT r4 #2). None auto-selects by backend: deterministic on
        CPU, latency mode (non-blocking gates, EMA-fitted BA chunks) on
        accelerators."""
        self.cfg = cfg
        self.mesh = mesh
        self._seed = seed
        if deterministic is None:
            deterministic = jax.default_backend() == "cpu"
        self._deterministic = deterministic
        trklib.validate_config(cfg.tracker)
        self.image_size = image_size or cfg.camera.image_size
        self.cam = atan.make_camera(cfg.camera.params, self.image_size)
        self.cam_params = jnp.asarray(cfg.camera.params, jnp.float32)
        atlas_dtype = (jnp.bfloat16 if cfg.frontend.atlas_bf16
                       else jnp.float32)
        self._atlas_dtype = atlas_dtype
        self.map = ms.empty_map(self.image_size, max_points, max_kfs,
                                atlas_dtype)
        self.mapmaker = mmlib.MapMaker(self.map, self.cam, self.image_size,
                                       cfg.mapmaker, cfg.bundle, seed=seed,
                                       mesh=mesh,
                                       deterministic=deterministic)
        self.stage = Stage.NOT_STARTED
        self.tracker_state = trklib.init_tracker_state(seed=seed + 1)
        self.trails: Optional[initlib.TrailState] = None
        self.first_features = None
        self.prev_features = None
        self.frame_idx = 0
        self.frames_since_kf = 0
        self.newest_kf = None
        self.auto_init_frames = auto_init_frames
        self._init_requested = auto_init_frames is not None
        self._trail_start_idx = None
        self.key = jax.random.PRNGKey(seed)

        cand_thresh = float(cfg.mapmaker.candidate_min_shi_tomasi_score)
        # The float cast happens ON DEVICE so callers can ship uint8
        # frames (4x less host->device traffic, hidden entirely when the
        # caller prefetches with device_put).
        self._build = jax.jit(lambda im: kflib.build_frame(
            im.astype(jnp.float32), cfg.frontend, cand_thresh))
        # Per-frame tracking build skips nonmax/candidates (the reference
        # runs MakeKeyFrame_Rest only on keyframes).
        self._build_track = jax.jit(
            lambda im: kflib.build_frame_tracking(im.astype(jnp.float32),
                                                  cfg.frontend))
        #: Cached device scalar for the KF-need check (a fresh
        #: jnp.float32(x) per frame would be an eager device_put).
        self._wiggle_val = None
        self._wiggle_dev = None
        # Per-frame TRACKING-stage program: frontend build + track +
        # inlier/outlier accounting + every per-frame decision scalar in
        # ONE dispatch. The decision scalars are read back DEFERRED, one
        # tiny int-vector per frame, so no blocking host sync stalls the
        # dispatch pipeline.
        wig_mult = cfg.mapmaker.max_kf_dist_wiggle_mult

        def _track_and_decide(st, mv, im, prev_sbi_track,
                              wiggle_depth_norm):
            # ``mv`` is a slim TrackView, not the full MapState: host
            # dispatch cost grows with the argument pytree's leaf count,
            # and tracking reads only 14 of MapState's ~36 leaves
            # (tracker.TrackView).
            fo = trklib.track_frame_from_image(
                st, mv, im.astype(jnp.float32), prev_sbi_track, self.cam,
                self.image_size, self.cam_params, cfg.tracker,
                cfg.frontend, cfg.mapmaker.wiggle_scale)
            res = fo.result
            new_inl = mv.point_inlier + res.inlier_delta
            new_outl = mv.point_outlier + res.outlier_delta
            need_kf = mmlib.need_new_kf(mv, fo.state.pose,
                                        fo.state.depth_mean,
                                        wiggle_depth_norm, wig_mult)
            info = jnp.stack([
                fo.state.quality, fo.state.lost_frames,
                jnp.sum(res.meas_valid.astype(jnp.int32)),
                need_kf.astype(jnp.int32),
                jnp.sum(mv.point_valid.astype(jnp.int32))])
            return fo, new_inl, new_outl, info

        self._step_track = jax.jit(_track_and_decide)
        #: Deferred per-frame decision state: the previous TRACKING
        #: frame's (image, FusedFrameOutput, info vector). Decisions for
        #: frame N-1 are made at frame N so the info read overlaps with
        #: device compute instead of stalling it.
        self._pending = None
        #: Decision candidate awaiting readiness (see process_frame's
        #: readiness-gated decision read).
        self._decision_pending = None
        #: Force the next decision read: set when the chunky pipeline
        #: drain has just paid a blocking wait anyway (round 5 — couples
        #: the two sync points, so max-rate feeds land decisions at
        #: drain cadence instead of only at the staleness cap).
        self._force_decision = False
        #: Loosely-bounded dispatch pipeline: info vectors of recent
        #: dispatched frames, completed entries popped for free each
        #: frame. A caller feeding frames faster than the device rate
        #: (max-rate benches, batch replay) grows the dispatch queue;
        #: past the depth bound ONE blocking wait drains the backlog
        #: (a chunky drain: one wait per ~30 frames at max feed, and
        #: none at camera rates, where the device keeps up and the deque
        #: stays empty). Whether per-frame pacing is cheaper on the GPU
        #: is re-measured under ROADMAP C2.
        self._inflight = __import__("collections").deque()
        self._pipeline_depth = 32
        self._prev_sbi_track = None
        self._n_points_host = 0
        self.decision_interval = max(1, int(decision_interval))
        self._frames_since_decision = 0
        #: Last decision-read values, re-reported between reads.
        self._last_quality = trklib.QUALITY_GOOD
        self._last_n_found = 0
        W, H = self.image_size
        self._sbi_size = ((H >> 3) // 2, (W >> 3) // 2)
        self._reloc = jax.jit(lambda m, sbi: reloclib.attempt_recovery(
            m, sbi, self.cam_params, self._sbi_size,
            cfg.reloc.max_score, cfg.reloc.esm_iterations))

        # --- async mapping thread state ---
        self.async_mapping = async_mapping
        self._map_lock = threading.Lock()
        self._pending_deltas = []          # [(inlier_delta, outlier_delta)]
        self._map_thread = None
        self._stop_mapping = threading.Event()
        self._mapping_wake = threading.Event()
        if async_mapping:
            self._map_thread = threading.Thread(
                target=self._mapping_worker, daemon=True)
            self._map_thread.start()

    # ------------------------------------------------------------------
    def _mapping_worker(self):
        """Background mapping loop (ref: MapMaker::run,
        src/MapMaker.cc:57-114, minus the flag-polling races)."""
        while not self._stop_mapping.is_set():
            if not self._mapping_wake.wait(timeout=0.05):
                continue
            self._mapping_wake.clear()
            try:
                self._run_mapping_pass()
            except Exception as e:      # pragma: no cover - diagnostics
                import traceback
                traceback.print_exc()

    def _run_mapping_pass(self):
        mm = self.mapmaker
        # Merge tracker deltas into the worker's map copy.
        with self._map_lock:
            deltas = self._pending_deltas
            self._pending_deltas = []
            mm.map = self.map
        for inl, outl in deltas:
            mm.map = mm.map._replace(
                point_inlier=mm.map.point_inlier + inl,
                point_outlier=mm.map.point_outlier + outl)
        slot = mm.step(self.newest_kf)
        # Publish the updated snapshot atomically.
        with self._map_lock:
            self.map = mm.map
            if slot is not None:
                self.newest_kf = slot

    def close(self):
        """Stop the mapping thread. MUST be called before interpreter
        shutdown in async mode: a daemon thread killed mid-XLA-dispatch
        aborts the process."""
        if self._map_thread is not None:
            self._stop_mapping.set()
            self._map_thread.join(timeout=10.0)
            self._map_thread = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------------------------
    def _next_key(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def request_init(self):
        """Equivalent of the reference's spacebar press
        (ref: src/Tracker.cc:311-347)."""
        self._init_requested = True

    def reset(self):
        """Full reset (ref: Tracker::Reset + MapMaker reset handshake,
        src/Tracker.cc:55-77)."""
        P, K = self.map.point_pos.shape[0], self.map.kf_R.shape[0]
        self.map = ms.empty_map(self.image_size, P, K, self._atlas_dtype)
        self.mapmaker = mmlib.MapMaker(
            self.map, self.cam, self.image_size, self.cfg.mapmaker,
            self.cfg.bundle, seed=self._seed, mesh=self.mesh,
            deterministic=self._deterministic)
        self.stage = Stage.NOT_STARTED
        self.tracker_state = trklib.init_tracker_state(
            key=self._next_key())
        self.trails = None
        self.first_features = None
        self.frames_since_kf = 0
        self.newest_kf = None
        self._pending = None
        self._decision_pending = None
        self._force_decision = False
        self._inflight.clear()
        self._prev_sbi_track = None
        self._n_points_host = 0
        self._frames_since_decision = 0
        self._last_quality = trklib.QUALITY_GOOD
        self._last_n_found = 0
        self._init_requested = self.auto_init_frames is not None

    # ------------------------------------------------------------------
    def process_frame(self, im) -> FrameInfo:
        """Per-frame entry point (ref: System::UpdateFrame ->
        Tracker::TrackFrame, src/System.cc:72-110, src/Tracker.cc:86-188).

        TRACKING-stage pipelining: each frame dispatches ONE fused
        build+track program and defers its decision scalars (quality,
        lost count, found count, KF-need) to the NEXT frame, so the only
        per-frame host<->device sync is a tiny int-vector read that
        overlaps with device compute. Keyframe adds and relocalization
        therefore fire one frame late — behaviorally negligible at video
        rate, and it keeps the device pipeline full (the reference's
        equivalent decisions are same-frame but it pays no dispatch
        latency; ref: src/Tracker.cc:146-207).
        """
        # Keep the caller's dtype (uint8 ships 4x less data over the
        # host->device link); the build jits cast to float32 on device.
        im = jnp.asarray(im)
        # Full build (with candidates) only where a keyframe may be made;
        # the TRACKING stage builds inside its fused program.
        features = None
        if self.stage != Stage.TRACKING:
            features = self._build(im)
        added_kf = False
        relocalized = False
        n_found = 0
        quality = None   # set by the TRACKING branch (deferred read)

        if self.stage == Stage.NOT_STARTED:
            if self._init_requested:
                self.trails = initlib.trail_start(
                    features, self.image_size,
                    self.cfg.tracker.max_initial_trails)
                self.first_features = features
                self._trail_start_idx = self.frame_idx
                self.stage = Stage.TRAIL_TRACKING
                self._init_requested = False   # auto mode fires by count

        elif self.stage == Stage.TRAIL_TRACKING:
            self.trails, n_good = initlib.trail_advance(
                self.trails, self.prev_features, features, self.image_size)
            n_found = int(n_good)
            if n_found < self.cfg.tracker.min_trails:
                self.reset()
            else:
                auto_fire = (self.auto_init_frames is not None
                             and self.frame_idx - self._trail_start_idx
                             >= self.auto_init_frames)
                if self._init_requested or auto_fire:
                    self.mapmaker.map = self.map
                    pose2 = initlib.init_from_stereo(
                        self.mapmaker, self.first_features, features,
                        self.trails, self._next_key(), self.cfg.init)
                    self.map = self.mapmaker.map
                    self._init_requested = False
                    if pose2 is None:
                        self.reset()
                    else:
                        self.stage = Stage.TRACKING
                        self.tracker_state = trklib.init_tracker_state(
                            pose2, key=self._next_key())
                        self.newest_kf = 1
                        self.frames_since_kf = 0
                        self._prev_sbi_track = features.sbi_track
                        self._pending = None
                        self._n_points_host = int(self.map.n_points())
                        self.mapmaker._n_points_hint = \
                            self._n_points_host

        elif self.stage == Stage.TRACKING:
            # BA numerical failure -> map is probably corrupt: ditch it
            # (ref: src/MapMaker.cc:887-892 + reset handshake
            # src/Tracker.cc:67-77).
            if self.mapmaker.reset_requested:
                self.reset()
                self.frame_idx += 1
                return FrameInfo(
                    pose=se3lib.identity(), stage=self.stage.name,
                    quality=trklib.QUALITY_BAD, n_found=0, n_points=0,
                    n_kfs=0,
                    added_kf=False, relocalized=False)
            st = self.tracker_state

            # ---- deferred decisions -----------------------------------
            # A blocking device read pays the whole accumulated dispatch
            # backlog when mapping jobs are in flight. So with
            # decision_interval > 1 the read is READINESS-GATED (ROADMAP
            # C2 re-measures whether that still pays): when a decision
            # is due, the
            # newest pending frame becomes the decision CANDIDATE and is
            # read once its info vector has landed (it ages while newer
            # frames keep dispatching), blocking only past a hard
            # staleness cap of 4 intervals. decision_interval == 1 keeps
            # the strict same-cadence blocking read (CPU / local
            # backends).
            p = self._pending
            self.frames_since_kf += 1
            self._frames_since_decision += 1
            if (self._decision_pending is None and p is not None
                    and self._frames_since_decision
                    >= self.decision_interval):
                self._decision_pending = p
            dp = self._decision_pending
            # Forced (blocking) read when: strict per-frame cadence;
            # deterministic replay (readiness gates are banned there);
            # the chunky drain just paid a blocking wait anyway; the
            # staleness cap (2 intervals — ADVICE r4 tightened from 4:
            # a lost-tracking signal must not act on a ~1 s-old pose);
            # or quality was already degraded at the last read (reloc
            # latency matters most exactly then). Otherwise the read is
            # readiness-gated — and the is_ready poll itself runs only
            # every 2nd frame while the candidate is PENDING.
            force = (self.decision_interval == 1
                     or self._deterministic
                     or self._force_decision
                     or self._frames_since_decision
                     >= 2 * self.decision_interval
                     or (self._last_quality != trklib.QUALITY_GOOD
                         and self._frames_since_decision
                         >= self.decision_interval))
            ready = (dp is not None and not force
                     and self._frames_since_decision % 2 == 0
                     and dp["info"].is_ready())
            if dp is not None and (force or ready):
                self._force_decision = False
                self._decision_pending = None
                p = dp
                self._frames_since_decision = 0
                _t0 = time.perf_counter()
                pinfo = np.asarray(p["info"])   # the one blocking read
                if _DBG:
                    print(f"#dbg f{self.frame_idx} read={1e3*(time.perf_counter()-_t0):.1f}ms forced={force}",
                          file=__import__('sys').stderr)
                (quality, lost, n_found, need_kf,
                 self._n_points_host) = (int(x) for x in pinfo)
                self._last_quality = quality
                self._last_n_found = n_found
                # Keep the MapMaker's BA size tiers fed with the live
                # point count (see MapMaker._ba_caps).
                self.mapmaker._n_points_hint = self._n_points_host

                # Relocalize if lost (ref: src/Tracker.cc:168-207).
                # The SBI is the PENDING frame's (the one whose quality
                # said lost) — the fused build means this frame's SBI
                # does not exist yet at decision time.
                if lost > self.cfg.tracker.max_lost_frames:
                    rr = self._reloc(self.map, p["out"].sbi)
                    if bool(rr.success):
                        st = st._replace(
                            pose=SE3(rr.pose.R, rr.pose.t),
                            velocity=jnp.zeros(6, jnp.float32),
                            just_recovered=jnp.asarray(True),
                            lost_frames=jnp.int32(0))
                        self.tracker_state = st
                        relocalized = True

                # Keyframe-add heuristics for the pending frame
                # (ref: src/Tracker.cc:146-166).
                if (quality == trklib.QUALITY_GOOD and need_kf
                        and self.frames_since_kf
                        > self.cfg.tracker.min_frames_between_kfs
                        and self.mapmaker.queue_size()
                        < self.cfg.mapmaker.max_queue_size
                        and self.mapmaker.n_kfs()
                        + self.mapmaker.queue_size()
                        < self.map.kf_R.shape[0]):
                    res = p["out"].result
                    meas = dict(point=res.meas_point, pos=res.meas_pos,
                                level=res.meas_level,
                                subpix=res.meas_subpix,
                                valid=res.meas_valid)
                    if not self.async_mapping:
                        self.mapmaker.map = self.map
                    # Keyframes need the full build (nonmax + candidates
                    # for epipolar expansion) — MakeKeyFrame_Rest.
                    _t1 = time.perf_counter()
                    kf_features = self._build(p["im"])
                    _t2 = time.perf_counter()
                    pst = p["out"].state
                    self.mapmaker.add_keyframe(
                        kf_features, pst.pose, meas,
                        pst.depth_mean, pst.depth_sigma)
                    self.frames_since_kf = 0
                    added_kf = True
                    if _DBG:
                        print(f"#dbg f{self.frame_idx} build={1e3*(_t2-_t1):.1f}ms addkf={1e3*(time.perf_counter()-_t2):.1f}ms",
                              file=__import__('sys').stderr)

            # ---- dispatch THIS frame (build+track fused, no sync) ------
            if self._wiggle_val != self.mapmaker.wiggle_depth_norm:
                self._wiggle_val = self.mapmaker.wiggle_depth_norm
                self._wiggle_dev = jnp.float32(self._wiggle_val)
            _t3 = time.perf_counter()
            fo, new_inl, new_outl, info = self._step_track(
                st, trklib.make_track_view(self.map), im,
                self._prev_sbi_track, self._wiggle_dev)
            if _DBG and time.perf_counter() - _t3 > 0.01:
                print(f"#dbg f{self.frame_idx} track_dispatch={1e3*(time.perf_counter()-_t3):.1f}ms",
                      file=__import__('sys').stderr)
            self.tracker_state = fo.state
            self._prev_sbi_track = fo.sbi_track

            # Tracker -> map point inlier/outlier accounting.
            if self.async_mapping:
                with self._map_lock:
                    self._pending_deltas.append(
                        (fo.result.inlier_delta, fo.result.outlier_delta))
            else:
                self.map = self.map._replace(point_inlier=new_inl,
                                             point_outlier=new_outl)
            # Periodically let bad-point GC look at the new counts.
            if self.frame_idx % 20 == 0:
                self.mapmaker.mark_dirty()

            if p is None:
                # First tracked frame after init: report its own stats
                # (one synchronous read, once).
                pinfo = np.asarray(info)
                (self._last_quality, _, self._last_n_found, _,
                 self._n_points_host) = (int(x) for x in pinfo)
                self.mapmaker._n_points_hint = self._n_points_host
                self._frames_since_decision = 0
            quality = self._last_quality
            n_found = self._last_n_found
            # Start the host copy NOW: by decision time (>= 1 frame
            # later) the scalars are usually already local, making the
            # blocking read ~free.
            info.copy_to_host_async()
            self._pending = dict(im=im, out=fo, info=info)
            self._inflight.append(info)
            if len(self._inflight) > self._pipeline_depth:
                # Chunky drain: ONE wait on the oldest entry (at camera
                # rates it has long since landed — the wait is free),
                # then forget the rest; no per-frame is_ready polls.
                old = self._inflight.popleft()
                self._inflight.clear()
                # A host READ of the 5-int info vector is the designed
                # once-per-drain bounded wait (bench_common.sync_read
                # explains the read fence; ROADMAP C2).
                np.asarray(old)
                # Having just paid a blocking wait, land the pending
                # decision at the next frame too (its info is mostly
                # executed by now) — max-rate feeds then make decisions
                # at drain cadence, not only at the staleness cap.
                self._force_decision = True

            if self.async_mapping:
                # Nudge the mapping thread; tracking continues on the
                # latest published snapshot.
                self._mapping_wake.set()
            else:
                # Synchronous: one mapping priority step per frame.
                _t4 = time.perf_counter()
                self.mapmaker.map = self.map
                slot = self.mapmaker.step(self.newest_kf)
                self.map = self.mapmaker.map
                if _DBG and time.perf_counter() - _t4 > 0.01:
                    print(f"#dbg f{self.frame_idx} mapstep={1e3*(time.perf_counter()-_t4):.1f}ms",
                          file=__import__('sys').stderr)
                if slot is not None:
                    self.newest_kf = slot

        if features is not None:
            self.prev_features = features
        self.frame_idx += 1
        if quality is not None:
            n_points, n_kfs = self._n_points_host, self.mapmaker.n_kfs()
            q = quality
        else:
            # Non-steady-state frames (init/trail/just-initialized).
            n_points = int(self.map.n_points())
            n_kfs = self.mapmaker.n_kfs()
            q = int(self.tracker_state.quality)
        return FrameInfo(
            pose=SE3(self.tracker_state.pose.R, self.tracker_state.pose.t),
            stage=self.stage.name,
            quality=q, n_found=n_found,
            n_points=n_points, n_kfs=n_kfs,
            added_kf=added_kf, relocalized=relocalized)
