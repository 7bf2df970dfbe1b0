"""Bundle adjustment: sparse Levenberg-Marquardt with Schur complement,
re-architected as dense blocked tensor algebra.

Capability parity with the reference Bundle (ref: src/Bundle.cc, Hartley &
Zisserman Algo A6.4). The reference walks measurement lists accumulating
triangle-packed U/V/W blocks and assembles the reduced camera system S via
per-point "off-diagonal scripts" (ref: src/Bundle.cc:364-446, 572-599).
Here:

- measurements are a fixed-capacity masked table; per-measurement 2x6/2x3
  jacobians are one batched einsum (ref jac math: src/Bundle.cc:290-313)
- U/V/W accumulate via segment-sums; W is scattered into a dense
  (P, C, 6, 3) block tensor so S = U* - W V*^-1 W^T is two einsums — the
  off-diag scripts disappear entirely
- the inner lambda-retry loop (ref: src/Bundle.cc:337-521) is a
  jax.lax.while_loop with functional state
- robust Tukey reweighting with the reference's sigma floor
  (min 0.4 px, ref: src/Bundle.cc:230-237) and weight-zero outlier
  pruning with provenance reporting (ref: src/Bundle.cc:535-549)

One ``lm_step`` is one XLA program; ``compute`` loops steps on the host so
a pending keyframe can abort between steps exactly like the reference's
abort-flag polling (ref: src/Bundle.cc:134, 338; src/MapMaker.cc:486-487).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ptam_cg_tpu.camera import atan
from ptam_cg_tpu.ops import patch as patchops
from ptam_cg_tpu.config import BundleConfig
from ptam_cg_tpu.utils import mest
from ptam_cg_tpu.utils import se3 as se3lib
from ptam_cg_tpu.utils.se3 import SE3

Array = jax.Array


class BundleProblem(NamedTuple):
    """Static-shape BA problem (capacities carried by shapes)."""

    cam_R: Array        # (C, 3, 3) world->cam
    cam_t: Array        # (C, 3)
    cam_fixed: Array    # (C,) bool — pose held constant (ref: Bundle.cc:46-63)
    cam_valid: Array    # (C,) bool
    pt_pos: Array       # (P, 3)
    pt_valid: Array     # (P,) bool
    meas_cam: Array     # (M,) int32
    meas_pt: Array      # (M,) int32
    meas_pos: Array     # (M, 2) found level-0 pixel position
    meas_sqrt_inv_noise: Array  # (M,) = 1 / 2^level
    meas_valid: Array   # (M,) bool — still-active measurement
    meas_bad: Array     # (M,) bool — pruned outlier


class LMState(NamedTuple):
    problem: BundleProblem
    lam: Array            # () LM lambda
    lam_factor: Array     # ()
    converged: Array      # () bool
    accepted: Array       # () int32 — number of accepted steps
    iters: Array          # () int32 — inner iterations consumed
    last_error: Array     # ()
    failed: Array         # () bool — numerical failure; map likely corrupt
    #                       (ref: Bundle::Compute returning -1,
    #                       src/Bundle.cc:149-150 + solve NaN guards
    #                       src/Bundle.cc:478-482)


def init_lm(problem: BundleProblem, cfg: BundleConfig = BundleConfig()
            ) -> LMState:
    return LMState(problem=problem,
                   lam=jnp.float32(cfg.lambda_initial),
                   lam_factor=jnp.float32(cfg.lambda_factor_initial),
                   converged=jnp.asarray(False),
                   accepted=jnp.int32(0), iters=jnp.int32(0),
                   last_error=jnp.float32(jnp.inf),
                   failed=jnp.asarray(False))


def _project_meas(cam_R, cam_t, pt_pos, prob: BundleProblem, cam: atan.Camera):
    """Project every measurement; returns (p_cam, eps, err_sq, bad_proj)
    (ref: Bundle::ProjectAndFindSquaredError, src/Bundle.cc:66-88)."""
    R = cam_R[prob.meas_cam]                     # (M, 3, 3)
    t = cam_t[prob.meas_cam]
    p = pt_pos[prob.meas_pt]
    p_cam = jnp.einsum("mij,mj->mi", R, p) + t
    z = p_cam[..., 2]
    bad_proj = z <= 1e-6
    safe_z = jnp.where(bad_proj, 1.0, z)
    z1 = p_cam[..., :2] / safe_z[..., None]
    pix = atan.project(z1, cam)
    eps = prob.meas_sqrt_inv_noise[:, None] * (prob.meas_pos - pix)
    err_sq = jnp.sum(eps * eps, axis=-1)
    # Non-finite residuals (NaN point/measurement poisoning) are treated
    # as failed projections so they get pruned instead of corrupting the
    # accumulator sums (ref NaN guards: src/Bundle.cc:70-74, 478-482).
    bad_proj = bad_proj | ~jnp.isfinite(err_sq)
    err_sq = jnp.where(bad_proj, 0.0, err_sq)
    return p_cam, z1, eps, err_sq, bad_proj


def _jacobians(p_cam, z1, cam_R_meas, cam: atan.Camera, scale):
    """(A (M,2,6), B (M,2,3)) with per-measurement scaling folded in
    (ref: src/Bundle.cc:286-313: sqrt-weight * sqrt-inv-noise applied via
    the camera-derivative matrix)."""
    derivs = atan.project_derivs(z1, cam) * scale[:, None, None]
    z = p_cam[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)

    gen = se3lib.motion_jacobian(p_cam)          # (M, 6, 3)
    plane_a = (gen[..., :2] - p_cam[..., None, :2] * gen[..., 2:]
               * inv_z[..., None, None]) * inv_z[..., None, None]
    A = jnp.einsum("mij,mnj->min", derivs, plane_a)      # (M, 2, 6)

    # B: motion of p_cam per unit world-point motion = columns of R.
    cols = jnp.swapaxes(cam_R_meas, -1, -2)               # (M, 3(col), 3)
    plane_b = (cols[..., :2] - p_cam[..., None, :2] * cols[..., 2:]
               * inv_z[..., None, None]) * inv_z[..., None, None]
    B = jnp.einsum("mij,mnj->min", derivs, plane_b)       # (M, 2, 3)
    return A, B


def _accumulators(prob: BundleProblem, cam: atan.Camera, sigma_sq: Array,
                  cfg: BundleConfig, mest_kind: int):
    """Project + robustly weight every measurement and build the LM
    normal-equation blocks (ref: Do_LM_Step parts (i)-(ii),
    src/Bundle.cc:218-332). Shared by the single-chip and sharded steps
    (the sharded step psums the returns over its mesh axis).

    Layout choices:
    - U/ea accumulate as ONE (C, M) one-hot matmul instead of a
      scatter-add (out-of-range indices give all-zero one-hot rows =
      scatter mode="drop"); which of the two is faster on the GPU is
      ROADMAP C7.
    - V/eb stay a scatter (a (M, P) one-hot would be 256 MB) but merge
      into a single (P, 12) scatter.
    - W is scattered P-minormost (see below), so the per-iteration WV
      product needs no transposes and XLA hoists the one
      loop-invariant re-layout of W out of the lambda loop.

    Returns (U, ea, V, eb, Wfull (P, C, 6, 3), err, new_bad, good).
    """
    C = prob.cam_R.shape[0]
    P = prob.pt_pos.shape[0]
    M = prob.meas_cam.shape[0]
    active = prob.meas_valid & ~prob.meas_bad

    p_cam, z1, eps, err_sq, bad_proj = _project_meas(
        prob.cam_R, prob.cam_t, prob.pt_pos, prob, cam)
    ok = active & ~bad_proj
    w_sqrt = jnp.where(ok, mest.sqrt_weight(err_sq, sigma_sq, mest_kind),
                       0.0)
    new_bad = active & (bad_proj | (w_sqrt == 0.0))
    good = active & ~new_bad
    err = (jnp.sum(jnp.where(
        good, mest.objective(err_sq, sigma_sq, mest_kind), 0.0))
        + jnp.sum(new_bad.astype(jnp.float32)))

    # Mask with where(), not multiplication: a pruned NaN measurement
    # (bad projection / NaN point) times weight 0 is still NaN and would
    # poison every accumulator sum.
    eps_w = jnp.where(good[:, None], eps * w_sqrt[:, None], 0.0)
    scale = prob.meas_sqrt_inv_noise * w_sqrt
    A, B = _jacobians(p_cam, z1, prob.cam_R[prob.meas_cam], cam, scale)
    A = jnp.where((good & ~prob.cam_fixed[prob.meas_cam])[:, None, None],
                  A, 0.0)
    B = jnp.where(good[:, None, None], B, 0.0)

    AtA = jnp.einsum("mia,mib->mab", A, A).reshape(M, 36)
    Aeps = jnp.einsum("mia,mi->ma", A, eps_w)                    # (M, 6)
    AtAeps = jnp.concatenate([AtA, Aeps], axis=-1)               # (M, 42)
    if cfg.u_chunks > 1 and M % cfg.u_chunks == 0:
        # Memory-lean U: the (M, C) one-hot is 1.0 GB at the north star
        # — accumulate in M-chunks so only an (M/chunks, C) slice is
        # ever live (config.BundleConfig.soff_tiles docstring).
        Mc = M // cfg.u_chunks

        def _u_body(acc, xs):
            mc_c, a_c = xs
            oh = jax.nn.one_hot(mc_c, C, dtype=jnp.float32)
            return acc + oh.T @ a_c, None

        Uea, _ = jax.lax.scan(
            _u_body, jnp.zeros((C, 42)),
            (prob.meas_cam.reshape(cfg.u_chunks, Mc),
             AtAeps.reshape(cfg.u_chunks, Mc, 42)))
    else:
        oh_c = jax.nn.one_hot(prob.meas_cam, C,
                              dtype=jnp.float32)                 # (M, C)
        Uea = oh_c.T @ AtAeps                                    # (C, 42)
    U = Uea[:, :36].reshape(C, 6, 6)
    ea = Uea[:, 36:]

    BtB = jnp.einsum("mia,mib->mab", B, B).reshape(M, 9)
    Beps = jnp.einsum("mia,mi->ma", B, eps_w)                    # (M, 3)
    Veb = jnp.zeros((P, 12)).at[prob.meas_pt].add(
        jnp.concatenate([BtB, Beps], axis=-1), mode="drop")
    V9 = Veb[:, :9]                                              # (P, 9)
    eb = Veb[:, 9:]

    # Dense per-(point, cam) W blocks: the off-diag scripts, vectorized
    # (ref: src/Bundle.cc:328-331, 572-599), stored P-MINORMOST as a
    # flat (18C, P) matrix (row = (cam, a, b)): P, the long axis, is
    # the minor one, so no W-chain buffer has a tiny trailing (6, 3)
    # dimension for a tiled memory layout to pad.
    Wm = jnp.einsum("mia,mib->mab", A, B)                        # (M, 6, 3)
    rows = (prob.meas_cam[:, None] * 18
            + jnp.arange(18, dtype=prob.meas_cam.dtype)[None])  # (M, 18)
    if lean_tiles(cfg, P) > 1:
        # Memory-lean layout: scatter W directly into P-tiles
        # (nT, 18C, T) so the Schur accumulation can lax.scan over
        # tiles without ever materializing the full (C6, 3P) WV
        # product (1.8 GB at the north star; see
        # config.BundleConfig.soff_tiles). Same pad-free P-minormost
        # property per tile.
        nT = cfg.soff_tiles
        T = P // nT
        W2d = jnp.zeros((nT, C * 18, T)).at[
            (prob.meas_pt // T)[:, None], rows,
            (prob.meas_pt % T)[:, None]].add(
            Wm.reshape(M, 18), mode="drop")
    else:
        W2d = jnp.zeros((C * 18, P)).at[
            rows, prob.meas_pt[:, None]].add(
            Wm.reshape(M, 18), mode="drop")
    return U, ea, V9, eb, W2d, err, new_bad, good


def lean_tiles(cfg: BundleConfig, P: int) -> int:
    """Number of Schur tiles the lean path uses (1 = dense path).
    Falls back to dense unless P divides exactly."""
    if cfg.soff_tiles > 1 and P % cfg.soff_tiles == 0:
        return cfg.soff_tiles
    return 1


def _vinv_cols(V9: Array, lam) -> Array:
    """Per-point inverse of Vstar = V with the lambda-augmented diagonal
    (ref: src/Bundle.cc:341-359), computed column-wise with P minormost.

    ``V9``: (P, 9) row-major 3x3 blocks. Returns (3, 3, P) indexed
    [row a, col b, p], zeroed where V is rank-deficient (any zero
    diagonal product — same guard as the (P,3,3) path)."""
    d = 1.0 + lam
    a = [V9[:, k] for k in range(9)]
    diag_prod = a[0] * a[4] * a[8]
    a00 = a[0] * d + 1e-12
    a01, a02 = a[1], a[2]
    a10 = a[3]
    a11 = a[4] * d + 1e-12
    a12 = a[5]
    a20, a21 = a[6], a[7]
    a22 = a[8] * d + 1e-12
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    inv_det = jnp.where((jnp.abs(det) < 1e-30) | (diag_prod == 0.0),
                        0.0, 1.0 / jnp.where(det == 0.0, 1.0, det))
    return jnp.stack([jnp.stack([c00, c01, c02]),
                      jnp.stack([c10, c11, c12]),
                      jnp.stack([c20, c21, c22])]) * inv_det


def _wv_product(W2d: Array, Vi: Array, C6: int, P: int) -> Array:
    """WV = W @ V^-1 per point, all P-minormost: (C6, 3P) from the flat
    (18C, P) W and the (3, 3, P) Vinv — nine (C6, P) fused
    multiply-adds, no transposes, no padded intermediates."""
    W3 = W2d.reshape(C6, 3, P)
    cols = []
    for dcol in range(3):
        acc = W3[:, 0, :] * Vi[0, dcol][None]
        acc = acc + W3[:, 1, :] * Vi[1, dcol][None]
        acc = acc + W3[:, 2, :] * Vi[2, dcol][None]
        cols.append(acc)
    return jnp.concatenate(cols, axis=1)                  # (C6, 3P)


def lm_step(state: LMState, cam: atan.Camera,
            cfg: BundleConfig = BundleConfig(),
            mest_kind: int = mest.TUKEY) -> LMState:
    """One full LM step (ref: Bundle::Do_LM_Step, src/Bundle.cc:209-551):
    robust sigma, U/V/W accumulation, inner lambda-retry loop, accept,
    outlier pruning. Jittable.

    All matmuls in the step run at pinned float32 precision: at a
    reduced default matmul precision (TF32 on the GPU) the U/V/W
    accumulation and Schur products corrupt the normal equations, which
    in the engine shows up as BA passes progressively shrinking the
    tracked-point count until tracking dies."""
    with jax.default_matmul_precision("float32"):
        return _lm_step_impl(state, cam, cfg, mest_kind)


def _lm_step_impl(state: LMState, cam: atan.Camera,
                  cfg: BundleConfig = BundleConfig(),
                  mest_kind: int = mest.TUKEY) -> LMState:
    prob = state.problem
    C = prob.cam_R.shape[0]
    P = prob.pt_pos.shape[0]

    active = prob.meas_valid & ~prob.meas_bad

    # ---- (i) robust sigma ------------------------------------------------
    _, _, _, err_sq, bad_proj = _project_meas(
        prob.cam_R, prob.cam_t, prob.pt_pos, prob, cam)
    ok = active & ~bad_proj
    sigma_sq = mest.find_sigma_squared(err_sq, ok, mest_kind,
                                       min_sigma=cfg.min_sigma)

    # ---- (ii) jacobians + accumulators ----------------------------------
    U, ea, V9, eb, W2d, current_error, new_bad, good = _accumulators(
        prob, cam, sigma_sq, cfg, mest_kind)
    nT = lean_tiles(cfg, P)
    if nT > 1:
        W_m = None            # lean: W2d is (nT, 18C, P/nT) — see below
    else:
        # Loop-invariant (C6, 3P) matrix view of the flat W (free
        # reshape — P-minormost, see _accumulators' layout note).
        W_m = W2d.reshape(C * 6, 3 * P)
    ebT = eb.T                                            # (3, P)

    free = prob.cam_valid & ~prob.cam_fixed               # (C,)
    free_f = free.astype(jnp.float32)

    # ---- inner lambda loop ----------------------------------------------
    def try_lambda(carry):
        lam, lam_factor, _, _, _, n_inner, _conv, _upd = carry

        # V* inverse with lambda-augmented diagonal, P-minormost
        # (ref: src/Bundle.cc:341-359; zero if V is rank-deficient).
        Vi = _vinv_cols(V9, lam)                          # (3, 3, P)

        if nT > 1:
            # Memory-lean Schur: scan P-tiles, accumulating
            # S_off = sum_t WV_t @ W_t^T — the full (C6, 3P) WV (1.8 GB
            # at the north star) never materializes; per-tile temps are
            # 1/nT the size (config.BundleConfig.soff_tiles).
            T = P // nT
            Vi_t = jnp.moveaxis(Vi.reshape(3, 3, nT, T), 2, 0)
            eb_t = jnp.moveaxis(ebT.reshape(3, nT, T), 1, 0)

            def _tile(carry, xs):
                S_acc, r_acc = carry
                Wt, Vit, ebt = xs
                WVt = _wv_product(Wt, Vit, C * 6, T)      # (C6, 3T)
                Wt_m = Wt.reshape(C * 6, 3 * T)
                return (S_acc + WVt @ Wt_m.T,
                        r_acc + WVt @ ebt.reshape(-1)), None

            (S_off_m, rcorr), _ = jax.lax.scan(
                _tile, (jnp.zeros((C * 6, C * 6)), jnp.zeros(C * 6)),
                (W2d, Vi_t, eb_t))
            S_off = S_off_m.reshape(C, 6, C, 6)
            rhs = ea - rcorr.reshape(C, 6)
        else:
            # S diag + off-diag in one shot: S = U* - sum_p W V^-1 W^T.
            # WV is nine (C6, P) FMAs; the (p, d) contraction runs as
            # ONE dot on the flat matrix views.
            WV_m = _wv_product(W2d, Vi, C * 6, P)         # (C6, 3P)
            S_off = (WV_m @ W_m.T).reshape(C, 6, C, 6)    # (C,6,C,6)
            rhs = ea - (WV_m @ ebT.reshape(-1)).reshape(C, 6)
        Ustar = U * (jnp.ones((6, 6)) + lam * jnp.eye(6))
        S = -S_off
        S = S + jnp.einsum("jab,jk->jakb", Ustar,
                           jnp.eye(C))                    # add diag blocks

        # Fixed/invalid cameras: identity block, zero rhs.
        blk = free_f[:, None, None, None] * free_f[None, None, :, None]
        S = S * blk + jnp.einsum(
            "jab,jk->jakb", jnp.eye(6)[None].repeat(C, 0),
            jnp.eye(C)) * (1.0 - free_f)[:, None, None, None]
        rhs = rhs * free_f[:, None]

        Sm = S.reshape(C * 6, C * 6)
        # Solve via Cholesky (S is SPD for lam > 0).
        delta_cam = jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(
                Sm + 1e-8 * jnp.eye(C * 6), lower=True),
            rhs.reshape(-1)).reshape(C, 6)
        delta_cam = delta_cam * free_f[:, None]

        # Back-substitute point updates (ref: src/Bundle.cc:461-483);
        # one (C*6) @ (C*6, 3P) vec-mat in the shared flat W layout
        # (lean: per-tile batched vec-mats, re-interleaved to (3, P)).
        if nT > 1:
            Wr = W2d.reshape(nT, C * 6, 3 * (P // nT))
            corr_t = jnp.einsum("a,nab->nb", delta_cam.reshape(-1), Wr)
            corr = jnp.moveaxis(
                corr_t.reshape(nT, 3, P // nT), 0, 1).reshape(3, P)
        else:
            corr = (delta_cam.reshape(-1) @ W_m).reshape(3, P)
        rb = ebT - corr                                   # (3, P)
        delta_pt = jnp.stack(
            [Vi[a, 0] * rb[0] + Vi[a, 1] * rb[1] + Vi[a, 2] * rb[2]
             for a in range(3)], axis=1)                  # (P, 3)
        delta_pt = delta_pt * prob.pt_valid[:, None]

        upd_sq = jnp.sum(delta_cam ** 2) + jnp.sum(delta_pt ** 2)
        conv = upd_sq < cfg.update_squared_convergence_limit

        # Trial state + new error (ref: FindNewError, src/Bundle.cc:174-203).
        d_pose = se3lib.se3_exp(delta_cam)                # batched SE3
        new_R = jnp.einsum("cij,cjk->cik", d_pose.R, prob.cam_R)
        new_t = (jnp.einsum("cij,cj->ci", d_pose.R, prob.cam_t)
                 + d_pose.t)
        new_pt = prob.pt_pos + delta_pt
        _, _, _, new_err_sq, nb = _project_meas(new_R, new_t, new_pt,
                                                prob, cam)
        new_error = (jnp.sum(jnp.where(
            good & ~nb, mest.objective(new_err_sq, sigma_sq, mest_kind),
            0.0)) + jnp.sum((new_bad | (active & nb)).astype(jnp.float32)))

        return (lam, lam_factor, new_R, new_t, new_pt, n_inner + 1,
                conv, upd_sq), new_error

    def cond_fn(full):
        carry, new_error = full
        lam, lam_factor, _, _, _, n_inner, conv, _upd = carry
        hit_max = (state.iters + n_inner) >= cfg.max_iterations
        # NaN/inf trial errors count as "not improved" so the lambda-raise
        # retry path also recovers from a numerically blown solve.
        improved = new_error < current_error
        return ~improved & ~conv & ~hit_max

    def body_fn(full):
        carry, _ = full
        lam, lam_factor, R_, t_, p_, n_inner, conv, upd = carry
        # Bad step: raise lambda (ref: ModifyLambda_BadStep,
        # src/Bundle.cc:606-611) and retry.
        lam_factor = lam_factor * 2.0
        lam = lam * lam_factor
        return try_lambda((lam, lam_factor, R_, t_, p_, n_inner, conv,
                           upd))

    first = try_lambda((state.lam, state.lam_factor, prob.cam_R,
                        prob.cam_t, prob.pt_pos, jnp.int32(0),
                        jnp.asarray(False), jnp.float32(0.0)))
    ((lam, lam_factor, new_R, new_t, new_pt, n_inner, conv, upd_sq),
     new_error) = jax.lax.while_loop(cond_fn, body_fn, first)

    # Numerical failure: the step never produced a finite error even after
    # lambda escalation, or the baseline error itself is non-finite — the
    # map is probably corrupt (ref: Bundle::Compute -> -1 on Cholesky
    # failure, src/Bundle.cc:149-150; MapMaker ditches the map,
    # src/MapMaker.cc:887-892).
    failed = (~jnp.isfinite(new_error) | ~jnp.isfinite(current_error)
              | ~jnp.isfinite(upd_sq))

    accept = (new_error < current_error) & ~failed
    # Good step: lambda *= 0.3, factor reset (ref: ModifyLambda_GoodStep).
    lam = jnp.where(accept, jnp.maximum(lam * cfg.lambda_good_mult, 1e-10),
                    lam)
    lam_factor = jnp.where(accept, jnp.float32(cfg.lambda_factor_initial),
                           lam_factor)

    sel = accept
    out_R = jnp.where(sel, new_R, prob.cam_R)
    out_t = jnp.where(sel, new_t, prob.cam_t)
    out_pt = jnp.where(sel, new_pt, prob.pt_pos)

    new_prob = prob._replace(
        cam_R=out_R, cam_t=out_t, pt_pos=out_pt,
        meas_bad=prob.meas_bad | new_bad)
    return LMState(problem=new_prob, lam=lam, lam_factor=lam_factor,
                   converged=state.converged | conv,
                   accepted=state.accepted + accept.astype(jnp.int32),
                   iters=state.iters + n_inner,
                   last_error=new_error,
                   failed=state.failed | failed)


@functools.lru_cache(maxsize=None)
def _cached_lm_step(cfg: BundleConfig, mest_kind: int):
    """One jitted LM step per (cfg, estimator), with the camera passed as
    a traced ARGUMENT: re-jitting a fresh lambda per ``compute`` call
    would retrace and recompile on every BA invocation.
    """
    return jax.jit(lambda s, cam: lm_step(s, cam, cfg, mest_kind))


@functools.lru_cache(maxsize=None)
def _cached_lm_step_flags(cfg: BundleConfig, mest_kind: int):
    """ONE LM step + the packed control-flag vector as one dispatch —
    the product BA program at LARGE problem sizes.

    At the C=500/P=50k scale the while_loop-of-steps CHUNK program
    carries a GB-scale LMState through its loop; at product 64-KF scales
    the chunk saves per-step dispatches. ``MapMaker._ba_dispatch_chunk``
    therefore switches to this per-step
    program above ``mapmaker.BA_CHUNK_W_BYTES_LIMIT``; the non-blocking
    abort poll still works (one step per poll, flags read deferred).
    No buffer donation: LMState holds only the problem tables (~25 MB
    at the north star — the GB-scale W blocks are internal to the step
    program), and donating it would delete the MapMaker's reused
    LM-template scalars and any aliased problem arrays out from under
    later runs.

    (Ref: the reference's global BA is one code path at any scale,
    src/Bundle.cc:116-158.)"""
    def stepf(state: LMState, cam):
        out = lm_step(state, cam, cfg, mest_kind)
        flags = jnp.stack([out.converged.astype(jnp.int32), out.iters,
                           out.failed.astype(jnp.int32), out.accepted])
        return out, flags

    return jax.jit(stepf)


@functools.lru_cache(maxsize=None)
def _cached_lm_chunk(cfg: BundleConfig, mest_kind: int):
    """A device-side LM loop: run steps until converged/failed or
    ``iter_limit`` inner iterations, as ONE dispatch (a lax.while_loop of
    lm_step). Replaces K sequential dispatch+sync round trips per BA
    run."""
    def chunk(state: LMState, cam, iter_limit):
        def cond(s):
            return (~s.converged) & (~s.failed) & (s.iters < iter_limit)

        def body(s):
            return lm_step(s, cam, cfg, mest_kind)

        out = jax.lax.while_loop(cond, body, state)
        # Control scalars packed into ONE int32 vector: each separate
        # bool()/int() read would be a blocking round trip; the loop
        # needs exactly one read per chunk.
        flags = jnp.stack([out.converged.astype(jnp.int32), out.iters,
                           out.failed.astype(jnp.int32), out.accepted])
        return out, flags

    return jax.jit(chunk)


def compute(problem: BundleProblem, cam: atan.Camera,
            cfg: BundleConfig = BundleConfig(),
            mest_kind: int = mest.TUKEY,
            abort_check=None, max_steps: int | None = None,
            steps_per_dispatch: int = 5,
            return_flags: bool = False):
    """Run LM to convergence (ref: Bundle::Compute, src/Bundle.cc:116-158).

    LM steps execute in device-side chunks of ``steps_per_dispatch``;
    ``abort_check`` is polled between chunks — the jitted-chunk
    equivalent of the reference's abort-flag polling
    (ref: src/Bundle.cc:134, 338). ``max_steps`` bounds the inner
    iterations of THIS call below cfg.max_iterations (the MapMaker's
    per-pass BA budget).

    Returns (final LMState, n_dispatches); with ``return_flags=True``
    also the host-read (converged, iters, failed, accepted) ints so
    callers don't pay extra blocking device reads.
    """
    chunkf = _cached_lm_chunk(cfg, mest_kind)
    state = init_lm(problem, cfg)
    limit = cfg.max_iterations if max_steps is None \
        else min(max_steps, cfg.max_iterations)
    n = 0
    conv, iters, failed, accepted = 0, 0, 0, 0
    while iters < limit:
        target = jnp.int32(min(iters + steps_per_dispatch, limit))
        state, dev_flags = chunkf(state, cam, target)
        n += 1
        # ONE blocking read per chunk.
        conv, iters, failed, accepted = (
            int(x) for x in np.asarray(dev_flags))
        if conv or failed:
            # failed: numerical blow-up — the caller must ditch the map
            # (ref: src/Bundle.cc:149-150, src/MapMaker.cc:887-892).
            break
        if abort_check is not None and abort_check():
            break
    if return_flags:
        return state, n, (bool(conv), iters, bool(failed), accepted)
    return state, n


def residual_rms(problem: BundleProblem, cam: atan.Camera) -> Array:
    """RMS reprojection error (pixels, noise-scaled) of active meas."""
    _, _, eps, err_sq, bad = _project_meas(
        problem.cam_R, problem.cam_t, problem.pt_pos, problem, cam)
    ok = problem.meas_valid & ~problem.meas_bad & ~bad
    n = jnp.maximum(jnp.sum(ok.astype(jnp.float32)), 1.0)
    return jnp.sqrt(jnp.sum(jnp.where(ok, err_sq, 0.0)) / n)
