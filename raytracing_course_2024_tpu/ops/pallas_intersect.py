"""Pallas kernel (Triton route): fused dense nearest-hit for small
all-triangle scenes.

The XLA dense sweep (ops/scene_intersect.py) evaluates a (B, N) t-matrix
and reduces it with a min and an argmin. This kernel runs one program per
block of ``BLK`` rays: the (9, N) [a, e1, e2] triangle table is read once
per program as scalars, the Moller-Trumbore test is unrolled statically
over the triangles, the running min and argmin stay in registers, and each
ray stores one (t, idx) pair.

Used for every all-triangle scene of at most ``MAX_PRIMS`` triangles when
the program is compiled for the GPU; every other scene, and every CPU
program, takes the XLA sweep. Triangles are pre-processed to (a, e1, e2) on
the host so the kernel skips two vertex subtractions. ``interpret=True``
runs the kernel in the Pallas interpreter; only tests pass it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .vec import Vec3

# rays per program (a power of two, as Triton requires) and warps per
# program: the fastest of blocks 128-1024 x warps 2-8 on an H100 (PERF.md)
BLK = 256
NUM_WARPS = 8
MAX_PRIMS = 128


def _kernel(n_prims: int, tmin: float, rox, roy, roz, rdx, rdy, rdz, tri,
            t_ref, i_ref):
    ox, oy, oz = rox[...], roy[...], roz[...]
    dx, dy, dz = rdx[...], rdy[...], rdz[...]
    best_t = jnp.full(ox.shape, jnp.inf, jnp.float32)
    best_i = jnp.zeros(ox.shape, jnp.int32)

    for i in range(n_prims):  # static unroll; scalar loads of the table
        ax, ay, az = tri[0, i], tri[1, i], tri[2, i]
        e1x, e1y, e1z = tri[3, i], tri[4, i], tri[5, i]
        e2x, e2y, e2z = tri[6, i], tri[7, i], tri[8, i]
        # pv = rd x e2
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
        # tv = ro - a
        tvx, tvy, tvz = ox - ax, oy - ay, oz - az
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
        # qv = tv x e1
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
        t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
        ok = (
            (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (jnp.abs(det) > 1e-30)
            & (t > tmin)
            & (t < best_t)
        )
        best_t = jnp.where(ok, t, best_t)
        best_i = jnp.where(ok, i, best_i)

    t_ref[...] = best_t
    i_ref[...] = best_i


def vma_union(*xs) -> frozenset:
    """Union of the inputs' varying-manual-axes: pallas_call outputs carry
    no vma inference, so under shard_map(check_vma=True) the out_shape must
    declare how results vary (they vary exactly as the inputs do)."""
    out = frozenset()
    for x in xs:
        out = out | jax.typeof(x).vma
    return out


def cast_to_vma(x, vma: frozenset):
    """Mark ``x`` varying over every axis in ``vma`` it isn't already, so
    the replicated triangle table carries the same vma as the rays."""
    missing = tuple(sorted(vma - jax.typeof(x).vma))
    return jax.lax.pcast(x, missing, to="varying") if missing else x


@functools.partial(jax.jit, static_argnames=("tmin", "interpret"))
def _run(ro_x, ro_y, ro_z, rd_x, rd_y, rd_z, tri, tmin: float,
         interpret: bool):
    b = ro_x.shape[0]
    n = tri.shape[1]
    vma = vma_union(ro_x, ro_y, ro_z, rd_x, rd_y, rd_z, tri)
    tri = cast_to_vma(tri, vma)
    ray_spec = pl.BlockSpec((BLK,), lambda i: (i,))
    return pl.pallas_call(
        functools.partial(_kernel, n, tmin),
        grid=(b // BLK,),
        in_specs=[ray_spec] * 6 + [pl.BlockSpec((9, n), lambda i: (0, 0))],
        out_specs=[ray_spec, ray_spec],
        out_shape=[
            jax.ShapeDtypeStruct((b,), jnp.float32, vma=vma),
            jax.ShapeDtypeStruct((b,), jnp.int32, vma=vma),
        ],
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        interpret=interpret,
        name="dense_nearest_hit",
    )(ro_x, ro_y, ro_z, rd_x, rd_y, rd_z, tri)


def prepare_tri_pack(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """(N,3) verts -> (9, N) [a, e1, e2] kernel pack (host side)."""
    a = np.asarray(p0, np.float32)
    e1 = np.asarray(p1, np.float32) - a
    e2 = np.asarray(p2, np.float32) - a
    return np.ascontiguousarray(
        np.stack([a[:, 0], a[:, 1], a[:, 2],
                  e1[:, 0], e1[:, 1], e1[:, 2],
                  e2[:, 0], e2[:, 1], e2[:, 2]])
    )


def pallas_dense_nearest(ro: Vec3, rd: Vec3, tri_pack: jnp.ndarray, tmin=0.0,
                         interpret: bool = False):
    """(best_t (B,), best_idx (B,)); B is padded to a ``BLK`` multiple
    inside. ``best_t`` is +inf where no triangle is hit."""
    b = ro.x.shape[0]
    pad = (-b) % BLK
    comps = [ro.x, ro.y, ro.z, rd.x, rd.y, rd.z]
    if pad:
        comps = [jnp.pad(c, (0, pad)) for c in comps]
    t, idx = _run(*comps, tri_pack, float(tmin), interpret)
    return t[:b], idx[:b]
