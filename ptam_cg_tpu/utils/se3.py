"""SO3/SE3 Lie-group operations as pure jittable functions.

Capability parity with TooN's SE3<>/SO3<> as used by the reference
(ref: include/Tracker.h:125-136 TrackerData::CalcJacobian uses
SE3::generator_field; src/Bundle.cc:290-313 uses SE3::exp updates;
src/Tools.cc:6-281 conversions).

Conventions (matching TooN, so reference tunables transfer):
- A pose is a pair ``(R, t)`` stored as a ``SE3`` NamedTuple with
  ``R: (..., 3, 3)`` and ``t: (..., 3)``; maps world -> camera like the
  reference's ``se3CfromW``.
- A twist ``xi`` is a 6-vector ``[u, w]`` with translation part first
  (TooN SE3::exp ordering), rotation part ``w`` last.
- All trig uses Taylor fallbacks near theta=0 chosen to be exact to f32.

Everything broadcasts over leading batch dims and is vmap/jit-safe.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

Array = jax.Array

_EPS = 1e-8


def _pinned_f32(fn):
    """Run every matmul in ``fn`` at pinned float32 precision.

    A reduced default matmul precision (TF32 on the GPU) is
    catastrophic for POSE COMPOSITION: the per-frame chain
    R' = exp(upd) @ R (20+ GN/motion compositions per frame, no
    re-orthonormalization) compounds the rounding multiplicatively —
    rotations creep off SO(3), the map inflates, and tracking collapses
    within ~100 frames while the same run at full float32 holds.
    Pinning here makes that drift impossible regardless of caller."""
    @functools.wraps(fn)
    def wrapper(*a, **k):
        with jax.default_matmul_precision("float32"):
            return fn(*a, **k)
    return wrapper


class SE3(NamedTuple):
    """Rigid transform: x_out = R @ x + t."""

    R: Array  # (..., 3, 3)
    t: Array  # (..., 3)

    def apply(self, x: Array) -> Array:
        return apply(self, x)

    def __matmul__(self, other: "SE3") -> "SE3":
        return mul(self, other)


def identity(batch_shape=()) -> SE3:
    R = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (*batch_shape, 3, 3))
    t = jnp.zeros((*batch_shape, 3), dtype=jnp.float32)
    return SE3(R, t)


def hat(w: Array) -> Array:
    """Skew-symmetric matrix of w: hat(w) @ v == cross(w, v)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack([
        jnp.stack([z, -wz, wy], axis=-1),
        jnp.stack([wz, z, -wx], axis=-1),
        jnp.stack([-wy, wx, z], axis=-1),
    ], axis=-2)


def _sinc_coeffs(theta_sq: Array):
    """Return (A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3).

    Taylor fallback below theta^2 < 1e-4 keeps f32 exactness and avoids
    0/0 under jit (branchless, uses jnp.where with safe operands).

    The threshold must cover the whole f32 cancellation zone: for
    theta^2 just above 1e-8, cos(theta) rounds to exactly 1.0f so the
    closed form gives B = 0 and downstream A/(2B) = inf (this produced
    NaN velocities in se3_log mid-sequence). (1 - cos) keeps <=0.1%
    relative error only once theta^2 >= ~1e-4; the Taylor truncation
    error at theta^2 = 1e-4 is ~1e-11, so 1e-4 is safe on both sides.
    """
    small = theta_sq < 1e-4
    # Safe theta for the non-small branch.
    safe_sq = jnp.where(small, 1.0, theta_sq)
    theta = jnp.sqrt(safe_sq)
    sin_t, cos_t = jnp.sin(theta), jnp.cos(theta)
    A = jnp.where(small, 1.0 - theta_sq / 6.0, sin_t / theta)
    B = jnp.where(small, 0.5 - theta_sq / 24.0, (1.0 - cos_t) / safe_sq)
    C = jnp.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                  (theta - sin_t) / (safe_sq * theta))
    return A, B, C


@_pinned_f32
def so3_exp(w: Array) -> Array:
    """Rodrigues: exp of a rotation 3-vector -> (...,3,3) rotation matrix."""
    w = jnp.asarray(w, jnp.float32)
    theta_sq = jnp.sum(w * w, axis=-1)
    A, B, _ = _sinc_coeffs(theta_sq)
    K = hat(w)
    KK = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), K.shape)
    return eye + A[..., None, None] * K + B[..., None, None] * KK


def so3_log(R: Array) -> Array:
    """Rotation matrix -> rotation vector. Handles theta in [0, pi]."""
    R = jnp.asarray(R, jnp.float32)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    # Antisymmetric part gives axis*sin(theta).
    v = jnp.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], axis=-1) * 0.5
    # sin(theta) from the antisymmetric part (exact, no cancellation);
    # theta via atan2 stays accurate near cos ~= 1 where arccos(cos_t)
    # loses ~eps/theta relative precision in f32. Near pi the dedicated
    # branch below takes over before ||v|| itself degrades.
    sin_t = jnp.linalg.norm(v, axis=-1)
    theta = jnp.arctan2(sin_t, cos_t)
    small = theta < 1e-4
    near_pi = theta > jnp.pi - 1e-3
    # Generic: w = theta/sin(theta) * v ; small: w ~= v * (1 + theta^2/6).
    scale = jnp.where(small, 1.0 + theta * theta / 6.0,
                      theta / jnp.where(sin_t < _EPS, 1.0, sin_t))
    w_generic = scale[..., None] * v
    # Near pi: use diagonal of (R + I)/2 = axis axis^T (1-cos)/... route.
    # R = I + sin*K + (1-cos)K^2 ; R+R^T = 2I + 2(1-cos)K^2
    # diag(K^2) = -(w_j^2 + w_k^2)/theta^2 -> axis_i^2 = (R_ii+1)/2 rescaled.
    axis_sq = jnp.stack([
        (R[..., 0, 0] + 1.0), (R[..., 1, 1] + 1.0), (R[..., 2, 2] + 1.0)
    ], axis=-1) / 2.0
    axis_abs = jnp.sqrt(jnp.maximum(axis_sq, 0.0))
    # Signs from the off-diagonal symmetric part; pin the largest positive.
    sym = jnp.stack([
        R[..., 2, 1] + R[..., 1, 2],   # 2 a_y a_z (1-cos)
        R[..., 0, 2] + R[..., 2, 0],   # 2 a_x a_z
        R[..., 1, 0] + R[..., 0, 1],   # 2 a_x a_y
    ], axis=-1)
    k = jnp.argmax(axis_abs, axis=-1)
    one_hot = jax.nn.one_hot(k, 3, dtype=R.dtype)
    # sign of a_i relative to a_k: a_i a_k sign from sym entries.
    # Build pairwise product matrix index: prod[i] = a_i * a_k.
    def pair(i, j):
        # sym index holding a_i*a_j term: {(1,2):0,(0,2):1,(0,1):2}
        idx = 3 - i - j
        return sym[..., idx]
    prods = jnp.stack([
        jnp.where(k == 0, axis_sq[..., 0] * 2.0,
                  jnp.where(k == 1, pair(0, 1), pair(0, 2))),
        jnp.where(k == 1, axis_sq[..., 1] * 2.0,
                  jnp.where(k == 0, pair(0, 1), pair(1, 2))),
        jnp.where(k == 2, axis_sq[..., 2] * 2.0,
                  jnp.where(k == 0, pair(0, 2), pair(1, 2))),
    ], axis=-1)
    axis_pi = jnp.sign(prods) * axis_abs
    # Keep chosen component positive magnitude (sign convention irrelevant
    # at pi since exp(pi a)=exp(-pi a)).
    norm = jnp.linalg.norm(axis_pi, axis=-1, keepdims=True)
    axis_pi = axis_pi / jnp.where(norm < _EPS, 1.0, norm)
    w_pi = axis_pi * theta[..., None]
    del one_hot
    return jnp.where(near_pi[..., None], w_pi, w_generic)


@_pinned_f32
def se3_exp(xi: Array) -> SE3:
    """TooN-ordered twist [u(3), w(3)] -> SE3. t = V(w) @ u."""
    xi = jnp.asarray(xi, jnp.float32)
    u, w = xi[..., :3], xi[..., 3:]
    theta_sq = jnp.sum(w * w, axis=-1)
    A, B, C = _sinc_coeffs(theta_sq)
    K = hat(w)
    KK = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), K.shape)
    R = eye + A[..., None, None] * K + B[..., None, None] * KK
    V = eye + B[..., None, None] * K + C[..., None, None] * KK
    t = jnp.einsum("...ij,...j->...i", V, u)
    return SE3(R, t)


@_pinned_f32
def se3_log(T: SE3) -> Array:
    """SE3 -> TooN-ordered twist [u, w]."""
    w = so3_log(T.R)
    theta_sq = jnp.sum(w * w, axis=-1)
    A, B, _ = _sinc_coeffs(theta_sq)
    K = hat(w)
    KK = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), K.shape)
    # V^{-1} = I - K/2 + coef * K^2 with coef = (1 - A/(2B))/theta^2.
    # The closed form cancels catastrophically in f32: 1 - A/(2B) ~
    # theta^2/12, and relErr(B) ~ 2eps/theta^2 blows it up unless
    # theta^4 >> 24 eps. Use the series of (x/2)cot(x/2) = 1 - x^2/12 -
    # x^4/720 - x^6/30240 up to theta^2 < 0.1 (truncation < 4e-7 there);
    # the safe_b guard is belt-and-braces against B underflowing to 0.
    small = theta_sq < 0.1
    safe_sq = jnp.where(small, 1.0, theta_sq)
    safe_b = jnp.where(jnp.abs(B) < 1e-12, 1.0, B)
    coef = jnp.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0 + theta_sq * theta_sq / 30240.0,
        (1.0 - A / (2.0 * safe_b)) / safe_sq)
    Vinv = eye - 0.5 * K + coef[..., None, None] * KK
    u = jnp.einsum("...ij,...j->...i", Vinv, T.t)
    return jnp.concatenate([u, w], axis=-1)


@_pinned_f32
def mul(a: SE3, b: SE3) -> SE3:
    """Compose: (a*b)(x) = a(b(x))."""
    R = a.R @ b.R
    t = jnp.einsum("...ij,...j->...i", a.R, b.t) + a.t
    return SE3(R, t)


@_pinned_f32
def inv(T: SE3) -> SE3:
    Rt = jnp.swapaxes(T.R, -1, -2)
    return SE3(Rt, -jnp.einsum("...ij,...j->...i", Rt, T.t))


@_pinned_f32
def apply(T: SE3, x: Array) -> Array:
    """Transform points x (..., 3)."""
    return jnp.einsum("...ij,...j->...i", T.R, x) + T.t


def generator_field(i: int, p: Array) -> Array:
    """TooN SE3::generator_field on homogeneous 4-vectors, for tracker /
    bundle jacobians (ref: include/Tracker.h:125-136, src/Bundle.cc:296-307).

    ``p`` is (..., 4) homogeneous; returns (..., 4) with zero w-component.
    i in 0..2: translation; 3..5: rotation about axis i-3.
    """
    out = jnp.zeros_like(p)
    if i < 3:
        return out.at[..., i].set(p[..., 3])
    j = i - 3
    a, b = (j + 1) % 3, (j + 2) % 3
    out = out.at[..., a].set(-p[..., b])
    out = out.at[..., b].set(p[..., a])
    return out


def motion_jacobian(p_cam: Array) -> Array:
    """All-6-generator motion field at camera-frame points.

    p_cam: (..., 3) (w=1 implied). Returns (..., 6, 3): d p_cam / d xi_m
    for each of the 6 SE3 generators (left multiplication update
    ``exp(xi) * T`` as the tracker uses).
    """
    p = jnp.asarray(p_cam, jnp.float32)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    zeros = jnp.zeros_like(x)
    ones = jnp.ones_like(x)
    rows = [
        jnp.stack([ones, zeros, zeros], axis=-1),    # d/du_x
        jnp.stack([zeros, ones, zeros], axis=-1),    # d/du_y
        jnp.stack([zeros, zeros, ones], axis=-1),    # d/du_z
        jnp.stack([zeros, -z, y], axis=-1),          # rot about x
        jnp.stack([z, zeros, -x], axis=-1),          # rot about y
        jnp.stack([-y, x, zeros], axis=-1),          # rot about z
    ]
    return jnp.stack(rows, axis=-2)


# ---------------------------------------------------------------------------
# Conversions (ref: src/Tools.cc:6-281) — quaternion / euler / arrays.
# ---------------------------------------------------------------------------

def quat_from_rot(R: Array) -> Array:
    """Rotation matrix -> quaternion [w, x, y, z] (Shepperd's method)."""
    R = jnp.asarray(R, jnp.float32)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def branch(vals):
        qw, qx, qy, qz = vals
        q = jnp.stack([qw, qx, qy, qz], axis=-1)
        return q / jnp.linalg.norm(q, axis=-1, keepdims=True)

    q0 = branch((1.0 + tr, m21 - m12, m02 - m20, m10 - m01))
    q1 = branch((m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20))
    q2 = branch((m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21))
    q3 = branch((m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11))
    case = jnp.where(
        tr > 0.0, 0,
        jnp.where((m00 > m11) & (m00 > m22), 1, jnp.where(m11 > m22, 2, 3)))
    qs = jnp.stack([q0, q1, q2, q3], axis=-2)
    q = jnp.take_along_axis(qs, case[..., None, None].astype(jnp.int32)
                            .repeat(4, axis=-1), axis=-2)[..., 0, :]
    # Canonical sign: w >= 0.
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def rot_from_quat(q: Array) -> Array:
    """Quaternion [w, x, y, z] -> rotation matrix."""
    q = jnp.asarray(q, jnp.float32)
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                   2 * (x * z + w * y)], axis=-1),
        jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                   2 * (y * z - w * x)], axis=-1),
        jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                   1 - 2 * (x * x + y * y)], axis=-1),
    ], axis=-2)


def euler_from_rot(R: Array) -> Array:
    """Rotation matrix -> XYZ euler angles [roll, pitch, yaw]
    (ref: src/Tools.cc RotMatToEulerAngles-style)."""
    R = jnp.asarray(R, jnp.float32)
    sy = jnp.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    roll = jnp.where(singular,
                     jnp.arctan2(-R[..., 1, 2], R[..., 1, 1]),
                     jnp.arctan2(R[..., 2, 1], R[..., 2, 2]))
    pitch = jnp.arctan2(-R[..., 2, 0], sy)
    yaw = jnp.where(singular, jnp.zeros_like(sy),
                    jnp.arctan2(R[..., 1, 0], R[..., 0, 0]))
    return jnp.stack([roll, pitch, yaw], axis=-1)


def rot_from_euler(rpy: Array) -> Array:
    """XYZ euler [roll, pitch, yaw] -> rotation matrix (Rz @ Ry @ Rx)."""
    rpy = jnp.asarray(rpy, jnp.float32)
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = jnp.cos(r), jnp.sin(r)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cy, sy = jnp.cos(y), jnp.sin(y)
    return jnp.stack([
        jnp.stack([cy * cp, cy * sp * sr - sy * cr,
                   cy * sp * cr + sy * sr], axis=-1),
        jnp.stack([sy * cp, sy * sp * sr + cy * cr,
                   sy * sp * cr - cy * sr], axis=-1),
        jnp.stack([-sp, cp * sr, cp * cr], axis=-1),
    ], axis=-2)


def lh_from_rh(T: SE3) -> SE3:
    """Right-handed -> left-handed coordinate flip (negate the z axis).

    ref: cg::Tools::LHFromRH (src/Tools.cc:6-21): negate R[2,0:2],
    R[0:2,2] and t[2] — i.e. conjugate by diag(1, 1, -1). Involutive, so
    it is also the LH->RH transform. Broadcasts over batched SE3s.
    """
    flip = jnp.array([1.0, 1.0, -1.0], jnp.float32)
    R = T.R * flip[:, None] * flip[None, :]
    return SE3(R, T.t * flip)
