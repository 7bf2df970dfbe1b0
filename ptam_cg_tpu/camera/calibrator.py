"""Checkerboard camera calibration (the reference's second executable).

Capability parity with CameraCalibrator / CalibImage / CalibCornerPatch
(ref: src/CameraCalibrator.cc, src/CalibImage.cc, src/CalibCornerPatch.cc):

- ``find_calib_corners``: the ring-transition checkerboard-corner test on
  a blurred image (ref: IsCorner, src/CalibImage.cc:30-71), dense and
  vectorized over every pixel at once
- ``refine_corner_batch``: the 6-DoF (pos, 2 angles, mean, gain)
  corner-patch alignment (ref: src/CalibCornerPatch.cc:106-177). The
  reference warps/blurs a shared raster template and differentiates the
  angles numerically; here the blurred checkerboard corner is an analytic
  model (product of Gaussian CDFs in warped coords) so the full 6-DoF
  jacobian comes from autodiff and the whole refinement is one batched
  jitted GN loop
- ``grow_grid``: iterative grid growth from a central corner by angle
  then by step prediction (ref: MakeFromImage/ExpandByAngle/ExpandByStep,
  src/CalibImage.cc:123-436) — host loop (offline tool) driving the
  batched refiner
- ``guess_initial_pose``: grid->image-plane DLT + conditioning fix +
  Gram-Schmidt (ref: src/CalibImage.cc:514-606)
- ``CameraCalibrator``: joint (6N+5)-dim Gauss-Newton over poses + ATAN
  params with 0.1 step damping (ref: OptimizeOneStep,
  src/CameraCalibrator.cc:215-269); target RMS < 0.3 px
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ptam_cg_tpu.camera import atan
from ptam_cg_tpu.ops import fast as fastops
from ptam_cg_tpu.ops import image as imops
from ptam_cg_tpu.utils import se3 as se3lib
from ptam_cg_tpu.utils.se3 import SE3

Array = jax.Array


# ---------------------------------------------------------------------------
# Corner candidate detection (ring-transition test)
# ---------------------------------------------------------------------------

def find_calib_corners(im: Array, gate: float = 10.0,
                       blur_sigma: float = 1.0,
                       max_corners: int = 2048) -> fastops.Corners:
    """Dense IsCorner over every pixel (ref: src/CalibImage.cc:30-71,
    blur at :135-141): center differs from the 16-ring mean by > gate and
    the ring makes exactly 4 hysteresis transitions."""
    imb = imops.gaussian_blur(im.astype(jnp.float32), blur_sigma)
    ring = jnp.stack([
        jnp.roll(imb, (-dy, -dx), axis=(0, 1))
        for dx, dy in fastops.CIRCLE], axis=0)           # (16, H, W)
    mean = jnp.mean(ring, axis=0)
    hi = mean + gate
    lo = mean - gate
    center_ok = (imb > lo) & (imb < hi)

    # Hysteresis transition count, vectorized over pixels; the 16-step
    # state recursion is tiny.
    state = ring[15] > mean
    swaps = jnp.zeros_like(mean)
    for i in range(16):
        go_low = state & (ring[i] < lo)
        go_high = (~state) & (ring[i] > hi)
        swaps = swaps + (go_low | go_high).astype(jnp.float32)
        state = jnp.where(go_low, False, jnp.where(go_high, True, state))
    is_corner = center_ok & (swaps == 4)
    H, W = im.shape
    border = jnp.zeros((H, W), bool).at[5:-5, 5:-5].set(True)
    is_corner = is_corner & border
    # Score by |center - mean| so capacity overflow keeps crisp corners.
    return fastops.corners_from_mask(is_corner, jnp.abs(imb - mean),
                                     max_corners)


# ---------------------------------------------------------------------------
# 6-DoF corner-patch refinement (analytic template + autodiff GN)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CornerParams:
    """(ref: CalibCornerPatch::Params) pos, angles, mean, gain."""
    pos: np.ndarray
    angles: np.ndarray
    mean: float = 120.0
    gain: float = 80.0


def _template_model(offsets: Array, angles: Array, blur: float = 1.0):
    """Analytic blurred checkerboard-corner value in [0, 1] at patch
    offsets, for axis directions given by ``angles`` (the reference
    rasterizes+warps+blurs a shared template; this is its closed form)."""
    c0, s0 = jnp.cos(angles[0]), jnp.sin(angles[0])
    c1, s1 = jnp.cos(angles[1]), jnp.sin(angles[1])
    W = jnp.array([[c0, c1], [s0, s1]])
    det = W[0, 0] * W[1, 1] - W[0, 1] * W[1, 0]
    det = jnp.where(jnp.abs(det) < 1e-6,
                    jnp.where(det < 0, -1e-6, 1e-6), det)
    Winv = jnp.array([[W[1, 1], -W[0, 1]], [-W[1, 0], W[0, 0]]]) / det
    uv = offsets @ Winv.T                                  # (Q, 2)
    g = 0.5 * (1.0 + jax.scipy.special.erf(uv / (blur * jnp.sqrt(2.0))))
    return g[:, 0] * g[:, 1] + (1 - g[:, 0]) * (1 - g[:, 1])


def make_corner_refiner(im_shape: Tuple[int, int], patch_size: int = 20,
                        iterations: int = 30, model_blur: float = 1.0):
    """Build a jitted batched corner-patch GN refiner over one image.

    Returns refine(im, pos0 (N,2), angles0 (N,2), mean0, gain0) ->
    (pos, angles, mean, gain, ok).
    Acceptance gates follow the reference (src/CalibCornerPatch.cc:
    106-130): step < 1e-3, angle separation, |gain| > 20, error < 25.
    """
    half = (patch_size - 1) / 2.0
    ys, xs = np.mgrid[0:patch_size, 0:patch_size]
    offsets = jnp.asarray(
        np.stack([xs - half, ys - half], -1).reshape(-1, 2), jnp.float32)
    H, W = im_shape

    def residuals(theta, im):
        pos, angles, mean, gain = (theta[:2], theta[2:4], theta[4],
                                   theta[5])
        pts = pos[None] + offsets
        vals, _ = imops.bilinear_sample(im, pts)
        model = gain * _template_model(offsets, angles, model_blur) + mean
        return vals - model

    def refine_one(im, pos0, angles0, mean0, gain0):
        theta0 = jnp.concatenate([pos0, angles0,
                                  jnp.array([mean0, gain0])])

        def gn_step(carry, _):
            theta, last_step = carry
            r = residuals(theta, im)
            J = jax.jacfwd(lambda t: residuals(t, im))(theta)  # (Q, 6)
            # Pinned f32: reduced-precision normal equations (TF32 on
            # the GPU) visibly bias the subpixel corner fit.
            hi = jax.lax.Precision.HIGHEST
            JTJ = jnp.dot(J.T, J, precision=hi) + 1e-6 * jnp.eye(6)
            upd = -0.7 * jnp.linalg.solve(JTJ,
                                          jnp.dot(J.T, r, precision=hi))
            theta = theta + upd
            return (theta, jnp.linalg.norm(upd[:2])), None

        (theta, last_step), _ = jax.lax.scan(
            gn_step, (theta0, jnp.float32(1.0)), None, length=iterations)
        r = residuals(theta, im)
        err = jnp.mean(jnp.abs(r))
        pos, angles, mean, gain = (theta[:2], theta[2:4], theta[4],
                                   theta[5])
        in_im = ((pos[0] > half) & (pos[1] > half)
                 & (pos[0] < W - half - 1) & (pos[1] < H - half - 1))
        ok = (in_im
              & (last_step < 1e-2)
              & (jnp.abs(jnp.sin(angles[0] - angles[1]))
                 >= jnp.sin(jnp.pi / 6.0))
              & (jnp.abs(gain) > 20.0)
              & (err < 25.0))
        return pos, angles, mean, gain, ok

    batched = jax.vmap(refine_one, in_axes=(None, 0, 0, 0, 0))
    return jax.jit(batched)


def guess_initial_angles(im: Array, pos: Array) -> Array:
    """Strongest-gradient axis guess (ref: GuessInitialAngles,
    src/CalibImage.cc:83-121)."""
    angles = jnp.arange(0.0, np.pi, 0.1)
    d = jnp.stack([jnp.cos(angles), jnp.sin(angles)], -1)      # (A, 2)
    p = jnp.stack([d[:, 1], -d[:, 0]], -1)                     # perp
    pts = jnp.stack([pos + d * 3.0 + p * 0.1,
                     pos + d * 3.0 - p * 0.1,
                     pos - d * 3.0 - p * 0.1,
                     pos - d * 3.0 + p * 0.1])                 # (4, A, 2)
    v, _ = imops.bilinear_sample(im, pts.reshape(-1, 2))
    v = v.reshape(4, -1)
    g = v[0] - v[1] + v[2] - v[3]
    best = jnp.argmax(jnp.abs(g))
    a = angles[best]
    return jnp.where(g[best] < 0,
                     jnp.stack([a, a + np.pi / 2]),
                     jnp.stack([a - np.pi / 2, a]))


# ---------------------------------------------------------------------------
# Grid growth (host loop; offline tool)
# ---------------------------------------------------------------------------

N_NOT_TRIED, N_FAILED = -1, -2

_DIRS = [(1, 0), (0, 1), (-1, 0), (0, -1)]


@dataclasses.dataclass
class GridCorner:
    params: CornerParams
    grid_pos: Tuple[int, int] = (0, 0)
    neighbors: Optional[list] = None
    inherited_steps: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.neighbors is None:
            self.neighbors = [N_NOT_TRIED] * 4

    def warp(self) -> np.ndarray:
        a = self.params.angles
        return np.array([[np.cos(a[0]), np.cos(a[1])],
                         [np.sin(a[0]), np.sin(a[1])]])

    def expansion_potential(self) -> float:
        missing = sum(1 for v in self.neighbors if v == N_NOT_TRIED)
        if missing == 0:
            return 0.0
        if missing == 1:
            return 100.0
        if missing == 3:
            return 1.0
        first = next(i for i, v in enumerate(self.neighbors)
                     if v == N_NOT_TRIED)
        return 10.0 if self.neighbors[(first + 2) % 4] == N_NOT_TRIED \
            else 20.0

    def get_steps(self, corners: list) -> np.ndarray:
        steps = np.zeros((2, 2))
        for dirn in range(2):
            acc = np.zeros(2)
            found = 0
            if self.neighbors[dirn] >= 0:
                acc += (corners[self.neighbors[dirn]].params.pos
                        - self.params.pos)
                found += 1
            if self.neighbors[dirn + 2] >= 0:
                acc -= (corners[self.neighbors[dirn + 2]].params.pos
                        - self.params.pos)
                found += 1
            steps[dirn] = (self.inherited_steps[dirn] if found == 0
                           else acc / found)
        return steps


class CalibImage:
    """One grabbed calibration view (ref: CalibImage)."""

    def __init__(self, im, gate: float = 10.0, min_corners: int = 20,
                 max_step_frac: float = 0.3):
        self.im = jnp.asarray(im, jnp.float32)
        self.pose = se3lib.identity()
        self.grid: List[GridCorner] = []
        self._refine = make_corner_refiner(self.im.shape)
        c = find_calib_corners(self.im, gate)
        n = int(c.count)
        self.corners = np.asarray(c.xy[:max(n, 1)])[:n].astype(np.float64)
        self.ok = n >= min_corners
        self.max_step_frac = max_step_frac

    # -- single-corner refinement through the batched kernel -------------
    def _refine_corner(self, params: CornerParams):
        pos, ang, mean, gain, ok = self._refine(
            self.im, jnp.asarray(params.pos, jnp.float32)[None],
            jnp.asarray(params.angles, jnp.float32)[None],
            jnp.asarray([params.mean], jnp.float32),
            jnp.asarray([params.gain], jnp.float32))
        out = CornerParams(np.asarray(pos[0], np.float64),
                           np.asarray(ang[0], np.float64),
                           float(mean[0]), float(gain[0]))
        return out, bool(ok[0])

    def make_grid(self) -> bool:
        """(ref: MakeFromImage, src/CalibImage.cc:123-214)."""
        if not self.ok:
            return False
        center = np.array(self.im.shape[::-1]) / 2.0
        d2 = np.sum((self.corners - center) ** 2, -1)
        start = self.corners[int(np.argmin(d2))]
        angles = np.asarray(guess_initial_angles(self.im,
                                                 jnp.asarray(start)))
        p0, ok = self._refine_corner(
            CornerParams(start.copy(), angles.copy()))
        if not ok:
            return False
        self.grid = [GridCorner(p0)]
        if not (self._expand_by_angle(0, 0) or self._expand_by_angle(0, 2)):
            return False
        if not (self._expand_by_angle(0, 1) or self._expand_by_angle(0, 3)):
            return False
        steps = self.grid[0].get_steps(self.grid)
        self.grid[1].inherited_steps = steps.copy()
        self.grid[2].inherited_steps = steps.copy()
        for _ in range(500):
            nxt = self._next_to_expand()
            if nxt < 0:
                break
            self._expand_by_step(nxt)
        return len(self.grid) >= 4

    def _expand_by_angle(self, src: int, dirn: int) -> bool:
        g = self.grid[src]
        target_dirn = g.warp()[:, dirn % 2] * (1 if dirn < 2 else -1)
        diff = self.corners - g.params.pos
        d2 = np.sum(diff * diff, -1)
        with np.errstate(invalid="ignore", divide="ignore"):
            dirs = diff / np.sqrt(d2)[:, None]
        cosang = dirs @ target_dirn
        okm = (d2 >= 100) & (cosang >= np.cos(np.pi / 18))
        if not okm.any():
            g.neighbors[dirn] = N_FAILED
            return False
        cand = np.where(okm, d2, np.inf)
        best = self.corners[int(np.argmin(cand))]
        params = CornerParams(best.copy(), g.params.angles.copy(),
                              g.params.mean, -g.params.gain)
        refined, ok = self._refine_corner(params)
        if not ok:
            g.neighbors[dirn] = N_FAILED
            return False
        gp = list(g.grid_pos)
        gp[dirn % 2] += 1 if dirn < 2 else -1
        nc = GridCorner(refined, tuple(gp))
        nc.neighbors[(dirn + 2) % 4] = src
        self.grid.append(nc)
        g.neighbors[dirn] = len(self.grid) - 1
        return True

    def _next_to_expand(self) -> int:
        best, bd = -1, 0.0
        for i, g in enumerate(self.grid):
            d = g.expansion_potential()
            if d > bd:
                best, bd = i, d
        return best

    def _expand_by_step(self, n: int):
        """(ref: ExpandByStep, src/CalibImage.cc:363-436)."""
        g = self.grid[n]
        dirn = next((i for i in range(4)
                     if g.neighbors[i] == N_NOT_TRIED
                     and g.neighbors[(i + 2) % 4] >= 0), None)
        if dirn is None:
            dirn = next(i for i in range(4)
                        if g.neighbors[i] == N_NOT_TRIED)
        step_ir = np.array(_DIRS[dirn])
        step = g.get_steps(self.grid).T @ step_ir
        search = g.params.pos + step
        g.neighbors[dirn] = N_FAILED
        d2 = np.sum((self.corners - search) ** 2, -1)
        best = int(np.argmin(d2))
        if np.sqrt(d2[best]) > self.max_step_frac * np.linalg.norm(step):
            return
        params = CornerParams(self.corners[best].copy(),
                              g.params.angles.copy(), g.params.mean,
                              -g.params.gain)
        refined, ok = self._refine_corner(params)
        if not ok:
            return
        nc = GridCorner(refined,
                        (g.grid_pos[0] + step_ir[0],
                         g.grid_pos[1] + step_ir[1]))
        nc.inherited_steps = g.get_steps(self.grid)
        idx = len(self.grid)
        for d in range(4):
            want = (nc.grid_pos[0] + _DIRS[d][0],
                    nc.grid_pos[1] + _DIRS[d][1])
            for i, other in enumerate(self.grid):
                if tuple(other.grid_pos) == want:
                    nc.neighbors[d] = i
                    other.neighbors[(d + 2) % 4] = idx
        self.grid.append(nc)

    # -- pose init + reprojection jacobians -------------------------------
    def guess_initial_pose(self, cam: atan.Camera):
        """(ref: GuessInitialPose, src/CalibImage.cc:514-606)."""
        pts = np.array([g.grid_pos for g in self.grid], np.float64)
        pix = jnp.asarray(np.array([g.params.pos for g in self.grid]),
                          jnp.float32)
        unproj = np.asarray(atan.unproject(pix, cam), np.float64)
        rows = []
        for (x, y), (u, v) in zip(pts, unproj):
            rows.append([x, y, 1, 0, 0, 0, -x * u, -y * u, -u])
            rows.append([0, 0, 0, x, y, 1, -x * v, -y * v, -v])
        A = np.array(rows)
        _, _, Vt = np.linalg.svd(A)
        Hm = Vt[-1].reshape(3, 3)
        # Conditioning fix on the top-left 2x2 (ref: :560-580).
        U2, D2, Vt2 = np.linalg.svd(Hm[:2, :2])
        Hm = Hm / D2[0]
        lam2 = D2[1] / D2[0]
        v2b = np.array([0.0, np.sqrt(max(1.0 - lam2 * lam2, 0.0))])
        v2aprime = v2b @ Vt2
        v2a = Hm[2, :2]
        Hm[2, :2] = v2aprime if v2a @ v2aprime > 0 else -v2aprime
        # Gram-Schmidt -> rotation + translation (ref: :585-605).
        mag1 = np.linalg.norm(Hm[:, 0])
        Hm = Hm / mag1
        r0 = Hm[:, 0]
        r1 = Hm[:, 1] - r0 * (r0 @ Hm[:, 1])
        r1 /= np.linalg.norm(r1)
        r2 = np.cross(r0, r1)
        R = np.stack([r0, r1, r2], axis=1)
        self.pose = SE3(jnp.asarray(R, jnp.float32),
                        jnp.asarray(Hm[:, 2], jnp.float32))

    def reprojection_data(self):
        """Grid corners as (world (G,3) on z=0, measured pix (G,2))."""
        pts = np.array([[g.grid_pos[0], g.grid_pos[1], 0.0]
                        for g in self.grid], np.float32)
        pix = np.array([g.params.pos for g in self.grid], np.float32)
        return jnp.asarray(pts), jnp.asarray(pix)


# ---------------------------------------------------------------------------
# Joint optimization (poses + camera params)
# ---------------------------------------------------------------------------

def _view_terms(pose: SE3, pts_w: Array, pix_meas: Array,
                cam: atan.Camera):
    """Errors + pose jac (G,2,6) + cam-param jac (G,2,5) for one view
    (ref: CalibImage::Project, src/CalibImage.cc:608-648)."""
    p_cam = pts_w @ pose.R.T + pose.t
    z = p_cam[:, 2]
    ok = z > 0.001
    zs = jnp.where(ok, z, 1.0)
    z1 = p_cam[:, :2] / zs[:, None]
    pix = atan.project(z1, cam)
    ok = ok & atan.project_valid(z1, cam)
    err = pix_meas - pix
    derivs = atan.project_derivs(z1, cam)
    inv_z = 1.0 / zs
    gen = se3lib.motion_jacobian(p_cam)
    plane = (gen[..., :2] - p_cam[:, None, :2] * gen[..., 2:]
             * inv_z[:, None, None]) * inv_z[:, None, None]
    Jpose = jnp.einsum("nij,nmj->nim", derivs, plane)       # (G, 2, 6)
    Jcam = atan.param_derivs(z1, cam)                       # (G, 2, 5)
    w = ok.astype(jnp.float32)
    return err * w[:, None], Jpose * w[:, None, None], \
        Jcam * w[:, None, None], ok


class CameraCalibrator:
    """Joint GN over N view poses + 5 camera params
    (ref: CameraCalibrator::OptimizeOneStep, src/CameraCalibrator.cc:
    215-269; same identity prior and 0.1 step damping)."""

    def __init__(self, image_size,
                 init_params=(0.5, 0.75, 0.5, 0.5, 0.1)):
        self.image_size = image_size
        self.params = np.array(init_params, np.float64)
        self.views: List[CalibImage] = []

    def add_image(self, im, gate: float = 10.0) -> bool:
        view = CalibImage(im, gate)
        if not view.make_grid():
            return False
        cam = atan.make_camera(tuple(self.params), self.image_size)
        view.guess_initial_pose(cam)
        self.views.append(view)
        return True

    def optimize_step(self) -> float:
        cam = atan.make_camera(tuple(self.params), self.image_size)
        nv = len(self.views)
        dim = 6 * nv + 5
        JTJ = np.eye(dim)
        JTe = np.zeros(dim)
        sq_sum, n_meas = 0.0, 0
        for n, view in enumerate(self.views):
            pts, pix = view.reprojection_data()
            err, Jp, Jc, ok = _view_terms(view.pose, pts, pix, cam)
            err, Jp, Jc = (np.asarray(err, np.float64),
                           np.asarray(Jp, np.float64),
                           np.asarray(Jc, np.float64))
            base = 6 * n
            JTJ[base:base + 6, base:base + 6] += np.einsum(
                "nia,nib->ab", Jp, Jp)
            JTJ[-5:, -5:] += np.einsum("nia,nib->ab", Jc, Jc)
            cross = np.einsum("nia,nib->ab", Jp, Jc)
            JTJ[base:base + 6, -5:] += cross
            JTJ[-5:, base:base + 6] += cross.T
            JTe[base:base + 6] += np.einsum("nia,ni->a", Jp, err)
            JTe[-5:] += np.einsum("nia,ni->a", Jc, err)
            sq_sum += float(np.sum(err * err))
            n_meas += int(np.asarray(ok).sum())
        upd = 0.1 * np.linalg.lstsq(JTJ, JTe, rcond=None)[0]
        for n, view in enumerate(self.views):
            d = se3lib.se3_exp(jnp.asarray(upd[6 * n: 6 * n + 6],
                                           jnp.float32))
            view.pose = se3lib.mul(d, view.pose)
        self.params = self.params + upd[-5:]
        return float(np.sqrt(sq_sum / max(n_meas, 1)))

    def optimize(self, iterations: int = 30) -> float:
        rms = np.inf
        for _ in range(iterations):
            rms = self.optimize_step()
        return rms
