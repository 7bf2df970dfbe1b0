"""Homography-based two-view initialization, fully batched/jittable.

Capability parity with HomographyInit (ref: src/HomographyInit.cc):
MLESAC over 4-point DLT homographies, Tukey-weighted WLS refinement,
Faugeras-Lustman decomposition into 8 (R, t, n, d) candidates, and
two-round visibility scoring with a Sampson-error tiebreak.

Batched shifts: the 300 MLESAC trials run as one batched 9x9
eigendecomposition instead of a serial rand() loop (seeded jax.random for
reproducibility); inlier sets are masks over a fixed-capacity match
table; the 8-way decomposition selection is branchless.

Matches use z=1-plane coordinates in both views plus a 2x2 pixel
projection jacobian for error scaling (ref: include/HomographyInit.h:23-30).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ptam_cg_tpu.utils import mest
from ptam_cg_tpu.utils import se3 as se3lib
from ptam_cg_tpu.utils.se3 import SE3

Array = jax.Array


class Matches(NamedTuple):
    first: Array      # (N, 2) z=1-plane coords in view 1
    second: Array     # (N, 2) z=1-plane coords in view 2
    pixel_jac: Array  # (N, 2, 2) d(pixel)/d(plane) at the match
    valid: Array      # (N,) bool


class HomographyResult(NamedTuple):
    se3_second_from_first: SE3
    H: Array          # (3, 3) refined homography (second = H @ first)
    n_inliers: Array  # () int32
    success: Array    # () bool


def _unproj(v: Array) -> Array:
    return jnp.concatenate([v, jnp.ones_like(v[..., :1])], axis=-1)


def _dlt_rows(first: Array, second: Array) -> Array:
    """Two DLT rows per correspondence (ref: HomographyFromMatches,
    src/HomographyInit.cc:65-115). first/second: (..., 2) -> (..., 2, 9)."""
    x, y = first[..., 0], first[..., 1]
    u, v = second[..., 0], second[..., 1]
    one = jnp.ones_like(x)
    zero = jnp.zeros_like(x)
    r0 = jnp.stack([x, y, one, zero, zero, zero, -x * u, -y * u, -u],
                   axis=-1)
    r1 = jnp.stack([zero, zero, zero, x, y, one, -x * v, -y * v, -v],
                   axis=-1)
    return jnp.stack([r0, r1], axis=-2)


def _h_from_rows(rows: Array) -> Array:
    """Null space of stacked DLT rows (..., R, 9) -> (..., 3, 3)."""
    AtA = jnp.einsum("...ri,...rj->...ij", rows, rows)
    _, vecs = jnp.linalg.eigh(AtA)
    h = vecs[..., :, 0]
    return h.reshape(*h.shape[:-1], 3, 3)


def homography_from_matches(m: Matches) -> Array:
    """All-inlier DLT homography (masked)."""
    rows = _dlt_rows(m.first, m.second)              # (N, 2, 9)
    rows = rows * m.valid[:, None, None].astype(rows.dtype)
    return _h_from_rows(rows.reshape(-1, 9))


def _pixel_errors(H: Array, m: Matches) -> Array:
    """Squared pixel-scaled transfer error per match
    (ref: MLESACScore/IsHomographyInlier, src/HomographyInit.cc:14-33)."""
    proj = _unproj(m.first) @ H.T                    # (N, 3)
    z = proj[..., 2]
    z = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
    v2 = proj[..., :2] / z[..., None]
    err = m.second - v2
    pix_err = jnp.einsum("nij,nj->ni", m.pixel_jac, err)
    return jnp.sum(pix_err * pix_err, axis=-1)


def mlesac_homography(m: Matches, key: Array, max_pixel_error: float = 5.0,
                      trials: int = 300) -> Array:
    """Batched MLESAC (ref: BestHomographyFromMatches_MLESAC,
    src/HomographyInit.cc:179-230)."""
    N = m.first.shape[0]
    err_cap = max_pixel_error * max_pixel_error
    n_valid = jnp.maximum(jnp.sum(m.valid.astype(jnp.int32)), 1)

    # Sample 4 indices per trial among valid matches: random keys ranked.
    gumbel = jax.random.uniform(key, (trials, N))
    gumbel = jnp.where(m.valid[None, :], gumbel, -1.0)
    _, idx4 = jax.lax.top_k(gumbel, 4)               # (trials, 4) distinct

    f4 = m.first[idx4]                               # (trials, 4, 2)
    s4 = m.second[idx4]
    rows = _dlt_rows(f4, s4).reshape(trials, 8, 9)
    Hs = _h_from_rows(rows)                          # (trials, 3, 3)

    # MLESAC score against all matches (capped squared error).
    proj = jnp.einsum("tij,nj->tni", Hs, _unproj(m.first))
    z = proj[..., 2]
    z = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
    v2 = proj[..., :2] / z[..., None]
    err = m.second[None] - v2
    pix = jnp.einsum("nij,tnj->tni", m.pixel_jac, err)
    sq = jnp.sum(pix * pix, axis=-1)
    score = jnp.sum(jnp.where(m.valid[None], jnp.minimum(sq, err_cap),
                              0.0), axis=-1)
    best = jnp.argmin(score)
    H_ransac = Hs[best]

    # Few matches -> plain DLT on everything (ref: :182-186).
    H_all = homography_from_matches(m)
    return jnp.where(n_valid < 10, H_all, H_ransac)


def refine_homography(H: Array, m: Matches, inlier: Array) -> Array:
    """One Tukey-WLS<9> refinement iteration
    (ref: RefineHomographyWithInliers, src/HomographyInit.cc:120-177)."""
    up = _unproj(m.first)                            # (N, 3)
    proj = up @ H.T
    denom = proj[..., 2]
    denom = jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    v2 = proj[..., :2] / denom[..., None]
    err = jnp.einsum("nij,nj->ni", m.pixel_jac, m.second - v2)  # (N, 2)
    err_sq = jnp.sum(err * err, axis=-1)

    # d(v2)/d(H elements): rows built exactly like the reference.
    zero = jnp.zeros_like(up)
    jx = jnp.concatenate(
        [up / denom[..., None], zero,
         -up * (proj[..., 0] / (denom * denom))[..., None]], axis=-1)
    jy = jnp.concatenate(
        [zero, up / denom[..., None],
         -up * (proj[..., 1] / (denom * denom))[..., None]], axis=-1)
    J = jnp.stack([jx, jy], axis=-2)                  # (N, 2, 9)
    J = jnp.einsum("nij,njk->nik", m.pixel_jac, J)

    sigma_sq = mest.find_sigma_squared(err_sq, inlier, mest.TUKEY)
    w = jnp.where(inlier, mest.weight(err_sq, sigma_sq, mest.TUKEY), 0.0)
    JTJ = jnp.einsum("n,nij,nik->jk", w, J, J)
    rhs = jnp.einsum("n,nij,ni->j", w, J, err)
    # The reference adds a unit prior and solves in double (WLS<9>,
    # src/HomographyInit.cc:121-122). In f32 the homography's scale gauge
    # leaves JTJ numerically singular, so the ridge must scale with the
    # problem: it damps only the H-scale null direction, which transfer
    # error ignores.
    ridge = 1.0 + 1e-5 * jnp.trace(JTJ) / 9.0
    upd = jnp.linalg.solve(JTJ + ridge * jnp.eye(9), rhs)
    return H + upd.reshape(3, 3)


def decompose_homography(H: Array):
    """Faugeras-Lustman decomposition to 8 candidates
    (ref: DecomposeHomography, src/HomographyInit.cc:232-339).

    Returns (R (8,3,3), t (8,3), n (8,3), d (8,), ok ()).
    """
    U, diag, Vt = jnp.linalg.svd(H)
    V = Vt.T
    d1, d2, d3 = jnp.abs(diag[0]), jnp.abs(diag[1]), jnp.abs(diag[2])
    s = jnp.linalg.det(U) * jnp.linalg.det(V)
    # Degenerate case (equal singular values) -> fail like the reference.
    ok = (jnp.abs(d1 - d2) > 1e-6 * d1) & (jnp.abs(d2 - d3) > 1e-6 * d1)

    denom = jnp.maximum(d1 * d1 - d3 * d3, 1e-12)
    x1 = jnp.sqrt(jnp.maximum(d1 * d1 - d2 * d2, 0.0) / denom)
    x3 = jnp.sqrt(jnp.maximum(d2 * d2 - d3 * d3, 0.0) / denom)
    e1 = jnp.array([1.0, -1.0, 1.0, -1.0])
    e3 = jnp.array([1.0, 1.0, -1.0, -1.0])

    d2s = jnp.maximum(d2, 1e-12)

    def prime_pos():
        sin_t = (d1 - d3) * x1 * x3 * e1 * e3 / d2s          # (4,)
        cos_t = (d1 * x3 * x3 + d3 * x1 * x1) / d2s
        Rp = jnp.zeros((4, 3, 3))
        Rp = Rp.at[:, 0, 0].set(cos_t).at[:, 0, 2].set(-sin_t)
        Rp = Rp.at[:, 1, 1].set(1.0)
        Rp = Rp.at[:, 2, 0].set(sin_t).at[:, 2, 2].set(cos_t)
        tp = jnp.stack([(d1 - d3) * x1 * e1, jnp.zeros(4),
                        (d1 - d3) * -x3 * e3], axis=-1)
        np_ = jnp.stack([x1 * e1, jnp.zeros(4), x3 * e3], axis=-1)
        d = jnp.full(4, s * d2)
        return Rp, tp, np_, d

    def prime_neg():
        sin_p = (d1 + d3) * x1 * x3 * e1 * e3 / d2s
        cos_p = (d3 * x1 * x1 - d1 * x3 * x3) / d2s
        Rp = jnp.zeros((4, 3, 3))
        Rp = Rp.at[:, 0, 0].set(cos_p).at[:, 0, 2].set(sin_p)
        Rp = Rp.at[:, 1, 1].set(-1.0)
        Rp = Rp.at[:, 2, 0].set(sin_p).at[:, 2, 2].set(-cos_p)
        tp = jnp.stack([(d1 + d3) * x1 * e1, jnp.zeros(4),
                        (d1 + d3) * x3 * e3], axis=-1)
        np_ = jnp.stack([x1 * e1, jnp.zeros(4), x3 * e3], axis=-1)
        d = jnp.full(4, -s * d2)
        return Rp, tp, np_, d

    Rp_a, tp_a, n_a, d_a = prime_pos()
    Rp_b, tp_b, n_b, d_b = prime_neg()
    Rp = jnp.concatenate([Rp_a, Rp_b])
    tp = jnp.concatenate([tp_a, tp_b])
    np_all = jnp.concatenate([n_a, n_b])
    dd = jnp.concatenate([d_a, d_b])

    R = s * jnp.einsum("ij,kjl,ml->kim", U, Rp, V)
    t = jnp.einsum("ij,kj->ki", U, tp)
    n = jnp.einsum("ij,kj->ki", V, np_all)
    return R, t, n, dd, ok


def choose_best_decomposition(H: Array, R: Array, t: Array, n: Array,
                              d: Array, m: Matches, inlier: Array,
                              max_pixel_error: float = 5.0):
    """Two-round visibility scoring + Sampson tiebreak
    (ref: ChooseBestDecomposition, src/HomographyInit.cc:363-435).
    Returns index into the 8 candidates."""
    up = _unproj(m.first)                                 # (N, 3)
    inl = inlier.astype(jnp.float32)

    # Round 1: homography third row / d positive.
    third = up @ H[2]                                     # (N,)
    vis1 = third[None, :] / d[:, None]                    # (8, N)
    score1 = -jnp.sum((vis1 > 0) * inl[None], axis=-1)    # (8,)

    # Keep best 4 (emulate sort+resize with a rank mask).
    rank1 = jnp.argsort(score1)
    in_top4 = jnp.zeros(8, bool).at[rank1[:4]].set(True)

    # Round 2: point-plane visibility n.x / d > 0.
    vis2 = jnp.einsum("ki,ni->kn", n, up) / d[:, None]
    score2 = -jnp.sum((vis2 > 0) * inl[None], axis=-1)
    score2 = jnp.where(in_top4, score2, 1.0)             # exclude non-top4
    rank2 = jnp.argsort(score2)
    i0, i1 = rank2[0], rank2[1]

    # Ambiguity ratio (both scores negative; ratio of counts).
    s0 = jnp.minimum(score2[i0], -1e-9)
    ratio = score2[i1] / s0

    # Sampson scores for the two finalists.
    def sampson_sum(idx):
        E = se3lib.hat(t[idx]) @ R[idx]
        x1 = _unproj(m.first)
        x2 = _unproj(m.second)
        Ex1 = x1 @ E.T
        Etx2 = x2 @ E
        num = jnp.sum(x2 * Ex1, axis=-1) ** 2
        den = (Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2
               + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2)
        val = num / jnp.maximum(den, 1e-12)
        cap = 4.0 * max_pixel_error * max_pixel_error
        return jnp.sum(jnp.where(m.valid, jnp.minimum(val, cap), 0.0))

    samp0 = sampson_sum(i0)
    samp1 = sampson_sum(i1)
    pick_second = (ratio >= 0.9) & (samp1 < samp0)
    return jnp.where(pick_second, i1, i0)


def compute(m: Matches, key: Array, max_pixel_error: float = 5.0,
            trials: int = 300, refine_iters: int = 5) -> HomographyResult:
    """Full pipeline (ref: HomographyInit::Compute,
    src/HomographyInit.cc:35-63). Jittable.

    Pinned float32 matmul precision throughout: the 9x9 DLT normal
    matrices, WLS refinements, and decomposition products are exactly
    the kind of small ill-conditioned systems that a reduced default
    matmul precision (TF32 on the GPU) corrupts, which shows up as flaky
    stereo init."""
    with jax.default_matmul_precision("float32"):
        H = mlesac_homography(m, key, max_pixel_error, trials)
        err_sq = _pixel_errors(H, m)
        inlier = m.valid & (err_sq < max_pixel_error * max_pixel_error)
        for _ in range(refine_iters):
            H = refine_homography(H, m, inlier)

        R, t, n, d, ok = decompose_homography(H)
        idx = choose_best_decomposition(H, R, t, n, d, m, inlier,
                                        max_pixel_error)
    n_inl = jnp.sum(inlier.astype(jnp.int32))
    return HomographyResult(
        se3_second_from_first=SE3(R[idx], t[idx]), H=H,
        n_inliers=n_inl, success=ok & (n_inl >= 4))
