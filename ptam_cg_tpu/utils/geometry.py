"""Geometry utilities: triangulation, ICP pose-from-correspondences.

Capability parity with the reference's MapMaker::Triangulate /
TriangulateNew (ref: src/MapMaker.cc:171-258) and cg::Tools ICP solvers
(ref: src/Tools.cc:307-431), vectorized over batches of correspondences.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ptam_cg_tpu.utils import se3 as se3lib
from ptam_cg_tpu.utils.se3 import SE3, _pinned_f32

Array = jax.Array


def _smallest_right_singular(A: Array) -> Array:
    """Right-singular vector for the smallest singular value of (..., m, n).

    Uses eigh of AᵀA — exactly what a DLT null-space needs. AᵀA is
    formed at pinned f32 precision: a reduced-precision product visibly
    perturbs the null space (DLT
    triangulation feeds map-point positions).
    """
    AtA = jnp.einsum("...mi,...mj->...ij", A, A,
                     precision=jax.lax.Precision.HIGHEST)
    _, vecs = jnp.linalg.eigh(AtA)   # ascending eigenvalues
    return vecs[..., :, 0]


@_pinned_f32
def triangulate(se3_a_from_b: SE3, v2a: Array, v2b: Array) -> Array:
    """DLT triangulation in frame B from two z=1-plane observations.

    ref: MapMaker::Triangulate (src/MapMaker.cc:171-188). Same 4x4 DLT
    system; null space via eigh(AᵀA). Broadcasts over leading dims.
    """
    R, t = se3_a_from_b.R, se3_a_from_b.t
    PDash = jnp.concatenate([R, t[..., :, None]], axis=-1)  # (...,3,4)
    xa, ya = v2a[..., 0], v2a[..., 1]
    xb, yb = v2b[..., 0], v2b[..., 1]
    zeros = jnp.zeros_like(xb)
    row0 = jnp.stack([-jnp.ones_like(xb), zeros, xb, zeros], axis=-1)
    row1 = jnp.stack([zeros, -jnp.ones_like(yb), yb, zeros], axis=-1)
    row2 = xa[..., None] * PDash[..., 2, :] - PDash[..., 0, :]
    row3 = ya[..., None] * PDash[..., 2, :] - PDash[..., 1, :]
    A = jnp.stack([row0, row1, row2, row3], axis=-2)
    v4 = _smallest_right_singular(A)
    w = v4[..., 3]
    w = jnp.where(jnp.abs(w) < 1e-5, jnp.where(w < 0, -1e-5, 1e-5), w)
    return v4[..., :3] / w[..., None]


def _cross_matrix(v3: Array) -> Array:
    """Skew-symmetric cross-product matrix, batched (..., 3) -> (..., 3, 3)."""
    x, y, z = v3[..., 0], v3[..., 1], v3[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack([
        jnp.stack([zero, -z, y], axis=-1),
        jnp.stack([z, zero, -x], axis=-1),
        jnp.stack([-y, x, zero], axis=-1)], axis=-2)


@_pinned_f32
def triangulate_new(se3_a_from_b: SE3, v2a: Array, v2b: Array) -> Array:
    """Cross-product-matrix DLT triangulation — the reference's
    alternative triangulator (ref: MapMaker::TriangulateNew,
    src/MapMaker.cc:216-258): stack [v3a]x * P_A over [v3b]x * I and take
    the null space of the 6x4 system. Returns the point in frame B;
    broadcasts over leading dims."""
    R, t = se3_a_from_b.R, se3_a_from_b.t
    one = jnp.ones_like(v2a[..., :1])
    v3a = jnp.concatenate([v2a, one], axis=-1)
    v3b = jnp.concatenate([v2b, one], axis=-1)
    PA = jnp.concatenate([R, t[..., :, None]], axis=-1)     # (..., 3, 4)
    eye34 = jnp.concatenate(
        [jnp.eye(3), jnp.zeros((3, 1))], axis=-1)
    PDashA = _cross_matrix(v3a) @ PA
    PDashB = _cross_matrix(v3b) @ eye34
    A = jnp.concatenate([PDashA, PDashB], axis=-2)          # (..., 6, 4)
    v4 = _smallest_right_singular(A)
    w = v4[..., 3]
    w = jnp.where(jnp.abs(w) < 1e-5, jnp.where(w < 0, -1e-5, 1e-5), w)
    return v4[..., :3] / w[..., None]


@_pinned_f32
def triangulate_depths(se3_a_from_b: SE3, v2a: Array, v2b: Array):
    """Triangulate + return (point_in_B, depth_in_A, depth_in_B)."""
    p_b = triangulate(se3_a_from_b, v2a, v2b)
    p_a = se3lib.apply(se3_a_from_b, p_b)
    return p_b, p_a[..., 2], p_b[..., 2]


@_pinned_f32
def umeyama_icp(src: Array, dst: Array, mask: Array | None = None) -> SE3:
    """Rigid alignment dst ≈ R @ src + t via SVD of the cross-covariance.

    Capability parity with cg::Tools::ComputeRtBySVD
    (ref: src/Tools.cc:307-340). ``mask`` selects valid correspondences.
    """
    if mask is None:
        mask = jnp.ones(src.shape[:-1], bool)
    wsum = jnp.maximum(jnp.sum(mask.astype(src.dtype)), 1.0)
    m = mask[..., None].astype(src.dtype)
    mu_s = jnp.sum(src * m, axis=-2) / wsum
    mu_d = jnp.sum(dst * m, axis=-2) / wsum
    cs = (src - mu_s) * m
    cd = (dst - mu_d) * m
    H = jnp.einsum("...ni,...nj->...ij", cs, cd,
                   precision=jax.lax.Precision.HIGHEST)
    U, _, Vt = jnp.linalg.svd(H)
    d = jnp.linalg.det(jnp.swapaxes(Vt, -1, -2) @ jnp.swapaxes(U, -1, -2))
    S = jnp.diag(jnp.array([1.0, 1.0, 1.0], src.dtype))
    S = S.at[2, 2].set(d)
    R = jnp.swapaxes(Vt, -1, -2) @ S @ jnp.swapaxes(U, -1, -2)
    t = mu_d - R @ mu_s
    return SE3(R, t)


@_pinned_f32
def horn_icp(src: Array, dst: Array, mask: Array | None = None) -> SE3:
    """Rigid alignment dst ≈ R @ src + t via Horn's quaternion method.

    Capability parity with cg::Tools::ICP_QD (ref: src/Tools.cc:349-431):
    build the 4x4 quaternion matrix Q from the cross-covariance
    M = (1/n) Σ d sᵀ, take the max-eigenvalue eigenvector as the rotation
    quaternion. eigh replaces the reference's SymEigen+SVD null-space
    two-step. (The reference returns t = centerA − centerB without
    rotating centerB — we return the standard t = μ_dst − R μ_src so the
    result actually minimizes ‖dst − (R src + t)‖².)
    """
    if mask is None:
        mask = jnp.ones(src.shape[:-1], bool)
    wsum = jnp.maximum(jnp.sum(mask.astype(src.dtype)), 1.0)
    m = mask[..., None].astype(src.dtype)
    mu_s = jnp.sum(src * m, axis=-2) / wsum
    mu_d = jnp.sum(dst * m, axis=-2) / wsum
    cs = (src - mu_s) * m
    cd = (dst - mu_d) * m
    M = jnp.einsum("...ni,...nj->...ij", cs, cd,
                   precision=jax.lax.Precision.HIGHEST) / wsum
    delta = jnp.stack([M[..., 1, 2] - M[..., 2, 1],
                       M[..., 2, 0] - M[..., 0, 2],
                       M[..., 0, 1] - M[..., 1, 0]], axis=-1)
    tr = jnp.trace(M, axis1=-2, axis2=-1)
    sym = M + jnp.swapaxes(M, -1, -2) - tr[..., None, None] * jnp.eye(3)
    top = jnp.concatenate([tr[..., None, None], delta[..., None, :]],
                          axis=-1)
    bottom = jnp.concatenate([delta[..., :, None], sym], axis=-1)
    Q = jnp.concatenate([top, bottom], axis=-2)            # (..., 4, 4)
    _, vecs = jnp.linalg.eigh(Q)                           # ascending
    q = vecs[..., :, 3]                                    # (w, x, y, z)
    R = se3lib.rot_from_quat(q)
    t = mu_d - jnp.einsum("...ij,...j->...i", R, mu_s)
    return SE3(R, t)


@_pinned_f32
def sampson_error(essential: Array, v2a: Array, v2b: Array) -> Array:
    """First-order geometric (Sampson) error for an essential matrix.

    ref: HomographyInit SampsonusError (src/HomographyInit.cc:346-360).
    v2a/v2b are z=1-plane coords; broadcasts over batches.
    """
    def unproj(v):
        return jnp.concatenate([v, jnp.ones_like(v[..., :1])], axis=-1)

    x1 = unproj(v2b)   # "Dash" frame in reference naming
    x2 = unproj(v2a)
    Ex1 = jnp.einsum("...ij,...j->...i", essential, x1)
    Etx2 = jnp.einsum("...ji,...j->...i", essential, x2)
    err = jnp.einsum("...i,...i->...", x2, Ex1)
    denom = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
             + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)
    return err * err / jnp.maximum(denom, 1e-12)


def spd_solve(A: Array, b: Array) -> Array:
    """Solve A x = b for small SPD A (..., n, n) by a fully unrolled
    Cholesky — pure fusable elementwise ops, no solver library call
    inside the chained 10-iteration GN loops. The reference's TooN
    ``Cholesky<6>``/``WLS<N>`` solves are this size (ref:
    src/Tracker.cc:976 WLS<6>, src/PatchFinder.cc:240 M3Inverse,
    src/ImageProcess.cc:383 Cholesky<4>). Static n (unrolled) — intended
    for n <= 9."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)
