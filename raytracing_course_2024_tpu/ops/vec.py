"""Struct-of-arrays 3-vector math.

Struct-of-arrays layout: a ``Vec3`` is a NamedTuple of three same-shaped
arrays (x, y, z). For a batch of B rays each component is a contiguous
``(B,)`` array -- no ``(..., 3)`` trailing axis that would force strided
access or relayouts.

Replaces the reference's nalgebra ``Vector3<f64>`` usage throughout
(reference: src/geometry.rs:9, everywhere). All math is f32 (the reference is
f64 -- src/geometry.rs:5 -- but f64 is slow or emulated on accelerators; see
SURVEY.md section 7).
"""

from __future__ import annotations

from typing import NamedTuple, Union

import jax.numpy as jnp

Scalar = Union[float, jnp.ndarray]


class Vec3(NamedTuple):
    """Three same-shaped arrays; broadcasting rules follow jnp."""

    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def __mul__(self, s: Scalar) -> "Vec3":
        return Vec3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __truediv__(self, s: Scalar) -> "Vec3":
        return Vec3(self.x / s, self.y / s, self.z / s)

    # -- products -----------------------------------------------------------
    def dot(self, o: "Vec3") -> jnp.ndarray:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def mul(self, o: "Vec3") -> "Vec3":
        """Component-wise (Hadamard) product."""
        return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)

    def div(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)

    # -- norms --------------------------------------------------------------
    def norm_squared(self) -> jnp.ndarray:
        return self.dot(self)

    def norm(self) -> jnp.ndarray:
        return jnp.sqrt(self.norm_squared())

    def normalize(self, eps: float = 0.0) -> "Vec3":
        inv = jax_rsqrt(jnp.maximum(self.norm_squared(), eps if eps else 1e-30))
        return self * inv

    # -- elementwise helpers --------------------------------------------------
    def abs(self) -> "Vec3":
        return Vec3(jnp.abs(self.x), jnp.abs(self.y), jnp.abs(self.z))

    def min_elem(self) -> jnp.ndarray:
        return jnp.minimum(self.x, jnp.minimum(self.y, self.z))

    def max_elem(self) -> jnp.ndarray:
        return jnp.maximum(self.x, jnp.maximum(self.y, self.z))

    def clip(self, lo: Scalar, hi: Scalar) -> "Vec3":
        return Vec3(
            jnp.clip(self.x, lo, hi), jnp.clip(self.y, lo, hi), jnp.clip(self.z, lo, hi)
        )

    def astype(self, dt) -> "Vec3":
        return Vec3(self.x.astype(dt), self.y.astype(dt), self.z.astype(dt))

    # -- construction ---------------------------------------------------------
    @staticmethod
    def full(v: Scalar, like: "Vec3" = None) -> "Vec3":
        if like is None:
            a = jnp.asarray(v, jnp.float32)
            return Vec3(a, a, a)
        a = jnp.full_like(like.x, v)
        return Vec3(a, a, a)

    @staticmethod
    def from_array(a: jnp.ndarray, axis: int = -1) -> "Vec3":
        """Split an ``(..., 3)`` (or axis-specified) array into components."""
        xs = jnp.moveaxis(a, axis, 0)
        return Vec3(xs[0], xs[1], xs[2])

    def to_array(self, axis: int = -1) -> jnp.ndarray:
        return jnp.moveaxis(jnp.stack([self.x, self.y, self.z], axis=0), 0, axis)

    @property
    def shape(self):
        return jnp.shape(self.x)


def jax_rsqrt(x: jnp.ndarray) -> jnp.ndarray:
    import jax.lax as lax

    return lax.rsqrt(x)


def where3(cond: jnp.ndarray, a: Vec3, b: Vec3) -> Vec3:
    """Per-lane select between two Vec3 (cond broadcasts over components)."""
    return Vec3(
        jnp.where(cond, a.x, b.x),
        jnp.where(cond, a.y, b.y),
        jnp.where(cond, a.z, b.z),
    )


def lerp3(a: Vec3, b: Vec3, t: Scalar) -> Vec3:
    return a * (1.0 - t) + b * t


def reflect(v: Vec3, n: Vec3) -> Vec3:
    """Mirror direction: reflect *outgoing* v about n (reference
    src/geometry.rs:65-69 ``reflect_vec``): returns ``-v + 2 (v.n) n``."""
    return n * (2.0 * v.dot(n)) - v


# ---------------------------------------------------------------------------
# Quaternions, stored as 4 same-shaped arrays (x, y, z, w).
# Replaces nalgebra UnitQuaternion (reference src/geometry.rs:45,
# src/geometry.rs:196-223 world<->local transforms).
# ---------------------------------------------------------------------------


class Quat(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray
    w: jnp.ndarray

    def conjugate(self) -> "Quat":
        return Quat(-self.x, -self.y, -self.z, self.w)

    def rotate(self, v: Vec3) -> Vec3:
        """Rotate vector by quaternion: v' = v + 2 q_v x (q_v x v + w v)."""
        qv = Vec3(self.x, self.y, self.z)
        t = qv.cross(v) * 2.0
        return v + t * self.w + qv.cross(t)

    def inverse_rotate(self, v: Vec3) -> Vec3:
        return self.conjugate().rotate(v)

    @staticmethod
    def identity_like(shape=()) -> "Quat":
        z = jnp.zeros(shape, jnp.float32)
        return Quat(z, z, z, jnp.ones(shape, jnp.float32))

    @staticmethod
    def from_array(a: jnp.ndarray, axis: int = -1) -> "Quat":
        xs = jnp.moveaxis(a, axis, 0)
        return Quat(xs[0], xs[1], xs[2], xs[3])


def quat_mul(a: Quat, b: Quat) -> Quat:
    """Hamilton product a*b (apply b's rotation, then a's)."""
    return Quat(
        a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
        a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
        a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w,
        a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
    )
