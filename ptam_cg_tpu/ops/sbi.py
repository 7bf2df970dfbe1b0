"""SmallBlurryImage (SBI): construction, ESM SE2 alignment, SE3-from-SE2.

Capability parity with the reference's SmallBlurryImage
(ref: src/ImageProcess.cc:262-495): a 40x30 zero-mean blurred thumbnail of
the frame, aligned between frames with a 4-DoF (x, y, theta, mean-diff)
ESM loop a la Benhimane & Malis, then converted to a pure camera rotation.
Used by the tracker's rotation-estimator seed (blur 0.75) and the
relocalizer (blur 2.5).

The reference's per-pixel do/while loops become whole-image ops; the
fixed ``n_iterations`` loop runs under ``lax.fori_loop`` so the whole
aligner jits into one XLA program.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ptam_cg_tpu.camera import atan
from ptam_cg_tpu.ops import image as imops
from ptam_cg_tpu.utils import geometry as geomlib
from ptam_cg_tpu.utils import se3 as se3lib
from ptam_cg_tpu.utils.se3 import SE3

Array = jax.Array


class SBI(NamedTuple):
    template: Array   # (h, w) zero-mean blurred float32
    jac: Array        # (h, w, 2) gradient image (no 0.5 factor)


def make_sbi(level3: Array, blur: float = 2.5) -> SBI:
    """Build an SBI from pyramid level 3 (ref: MakeFromKF,
    src/ImageProcess.cc:279-304 — half-sample, subtract mean, blur)."""
    small = imops.half_sample(level3)
    zm = small - jnp.mean(small)
    tmpl = imops.gaussian_blur(zm, blur)
    gx, gy = imops.central_gradients(tmpl)
    return SBI(template=tmpl, jac=jnp.stack([gx, gy], axis=-1))


class SE2(NamedTuple):
    R: Array  # (2, 2)
    t: Array  # (2,)


def se2_identity() -> SE2:
    return SE2(jnp.eye(2, dtype=jnp.float32), jnp.zeros(2, jnp.float32))


def se2_mul(a: SE2, b: SE2) -> SE2:
    return SE2(a.R @ b.R, a.R @ b.t + a.t)


def so2_exp(theta: Array) -> Array:
    c, s = jnp.cos(theta), jnp.sin(theta)
    return jnp.stack([jnp.stack([c, -s]), jnp.stack([s, c])])


def iterate_pos_rel_to_target(moving: SBI, target: SBI,
                              n_iterations: int = 10) -> Tuple[SE2, Array]:
    """ESM alignment: find the SE2 warping ``moving`` onto ``target``
    (ref: IteratePosRelToTarget, src/ImageProcess.cc:313-417).

    Returns (se2_c_to_c, final_score).
    """
    h, w = moving.template.shape
    cx, cy = w // 2, h // 2   # irCenter = mirSize/2, (x, y)

    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    interior = jnp.zeros((h, w), bool).at[1:-1, 1:-1].set(True)

    tmpl_flat = moving.template.reshape(-1)

    def warp(_template_unused, R, t):
        """warped[p] = template(R p + t), bilinear; invalid -> big negative
        (mirrors CVD::transform's -9e20 fill).

        Sampling is one (hw, hw) one-hot interpolation dot instead of four
        image gathers (whether a native gather is cheaper on the GPU is
        ROADMAP C7)."""
        px = R[0, 0] * xs + R[0, 1] * ys + t[0]
        py = R[1, 0] * xs + R[1, 1] * ys + t[1]
        x0 = jnp.floor(px).astype(jnp.int32)
        y0 = jnp.floor(py).astype(jnp.int32)
        fx, fy = px - x0, py - y0
        valid = (x0 >= 0) & (y0 >= 0) & (x0 < w - 1) & (y0 < h - 1)
        x0c = jnp.clip(x0, 0, w - 2).reshape(-1)
        y0c = jnp.clip(y0, 0, h - 2).reshape(-1)
        fxf = fx.reshape(-1, 1)
        fyf = fy.reshape(-1, 1)
        base = (y0c * w + x0c)[:, None]                     # (hw, 1)
        src = jnp.arange(h * w, dtype=jnp.int32)[None, :]   # (1, hw)
        wmat = ((src == base) * (1 - fxf) * (1 - fyf)
                + (src == base + 1) * fxf * (1 - fyf)
                + (src == base + w) * (1 - fxf) * fyf
                + (src == base + w + 1) * fxf * fyf)
        vals = (wmat @ tmpl_flat).reshape(h, w)
        return jnp.where(valid, vals, -9e20), valid

    center = jnp.array([cx, cy], jnp.float32)

    def body(_, state):
        R_cc, t_cc, mean_off, _score = state
        # se2XForm = W * CtoC * W^-1  (warp about image center).
        R_x = R_cc
        t_x = center + t_cc - R_cc @ center
        warped, wvalid = warp(moving.template, R_x, t_x)
        # Neighbor validity: every pixel of the 3x3 cross must be in-image.
        ok = interior & wvalid
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            ok = ok & jnp.roll(wvalid, (-dy, -dx), axis=(0, 1))
        gx = jnp.roll(warped, -1, axis=1) - jnp.roll(warped, 1, axis=1)
        gy = jnp.roll(warped, -1, axis=0) - jnp.roll(warped, 1, axis=0)
        sum_gx = 0.25 * (gx + target.jac[..., 0])
        sum_gy = 0.25 * (gy + target.jac[..., 1])
        j2 = -(ys - cy) * sum_gx + (xs - cx) * sum_gy
        ones = jnp.ones_like(sum_gx)
        diff = warped - target.template + mean_off
        m = ok.astype(jnp.float32)
        J = jnp.stack([sum_gx, sum_gy, j2, ones], axis=-1) * m[..., None]
        d = diff * m
        score = jnp.sum(d * d)
        # Pinned f32: the 4x4 normal equations must not run at a
        # reduced default matmul precision (TF32 on the GPU); the warp
        # dot above deliberately stays at the default.
        JTd = jnp.einsum("hwk,hw->k", J, d,
                         precision=jax.lax.Precision.HIGHEST)
        JTJ = jnp.einsum("hwi,hwj->ij", J, J,
                         precision=jax.lax.Precision.HIGHEST)
        upd = geomlib.spd_solve(JTJ + 1e-8 * jnp.eye(4), JTd)
        R_u = so2_exp(-upd[2])
        t_u = -upd[:2]
        R_new = R_cc @ R_u
        t_new = R_cc @ t_u + t_cc
        return R_new, t_new, mean_off - upd[3], score

    init = (jnp.eye(2, dtype=jnp.float32), jnp.zeros(2, jnp.float32),
            jnp.float32(0.0), jnp.float32(0.0))
    R_cc, t_cc, _, score = jax.lax.fori_loop(0, n_iterations, body, init)
    return SE2(R_cc, t_cc), score


def se3_from_se2(se2: SE2, cam_params: Array,
                 sbi_size: Tuple[int, int]) -> SE3:
    """Pure-rotation SE3 that induces the given image SE2 on the SBI
    (ref: SE3fromSE2, src/ImageProcess.cc:427-476): project two points
    through an SBI-sized ATAN camera and Gauss-Newton a 3-DoF SO3."""
    h, w = sbi_size
    cam = atan.make_camera(cam_params, (w, h))
    center = jnp.array([w / 2, h / 2], jnp.float32)
    pix0 = jnp.stack([center + jnp.array([5.0, 0.0]),
                      center + jnp.array([-5.0, 0.0])])        # (2, 2)
    turned = (se2.R @ (pix0 - center).T).T + center + se2.t

    z1 = atan.unproject(pix0, cam)                              # (2, 2)
    orig = jnp.concatenate([z1, jnp.ones((2, 1), jnp.float32)], axis=-1)

    def gn_step(_, R):
        p_cam = orig @ R.T                                      # (2, 3)
        z = p_cam[:, 2]
        implane = p_cam[:, :2] / z[:, None]
        pix = atan.project(implane, cam)
        err = turned - pix                                      # (2, 2)
        cam_d = atan.project_derivs(implane, cam)               # (2, 2, 2)
        inv_z = 1.0 / z
        # SO3 generators at p_cam -> in-plane motion -> pixel motion.
        gen = se3lib.motion_jacobian(p_cam)[:, 3:, :]           # (2, 3, 3)
        plane_motion = (gen[..., :2]
                        - p_cam[:, None, :2] * gen[..., 2:]
                        * inv_z[:, None, None]) * inv_z[:, None, None]
        Jpix = jnp.einsum("nij,nmj->nmi", cam_d, plane_motion)  # (2, 3, 2)
        J = Jpix.transpose(0, 2, 1).reshape(-1, 3)              # (4, 3)
        r = err.reshape(-1)
        JTJ = J.T @ J + 10.0 * jnp.eye(3)   # wls.add_prior(10.0)
        upd = geomlib.spd_solve(JTJ, J.T @ r)
        return se3lib.so3_exp(upd) @ R

    with jax.default_matmul_precision("float32"):
        R = jax.lax.fori_loop(0, 3, gn_step,
                              jnp.eye(3, dtype=jnp.float32))
    return SE3(R, jnp.zeros(3, jnp.float32))


def calc_sbi_rotation(moving: SBI, target: SBI, cam_params: Array,
                      sbi_size: Tuple[int, int],
                      n_iterations: int = 10) -> Tuple[SE3, Array]:
    """ESM + SE2->SE3 glue (ref: CalcSBIRotation,
    src/ImageProcess.cc:485-495). Returns (rotation-only SE3, score)."""
    se2, score = iterate_pos_rel_to_target(moving, target, n_iterations)
    return se3_from_se2(se2, cam_params, sbi_size), score
