"""Counter-based per-work-item RNG for the regeneration wavefront.

The batch renderer keys its threefry stream by *lane position* (one
``uniform_rows`` sweep per bounce, integrator/path.py): deterministic, but
tied to which lane a sample occupies. The wavefront engine
(integrator/wavefront.py) refills dead lanes with fresh (pixel, sample)
work items mid-flight, so a work item's lane -- and therefore its threefry
position -- would depend on the batch size and on every other path's
lifetime. Determinism there needs a stream keyed by the *work item*:

    bits = mix(seed, work_id, draw_counter)

implemented as two rounds of a 32-bit finalizer ("lowbias32", Wellons'
exhaustively-searched avalanche constants; same construction family as
splitmix/murmur3 fmix). ~12 u32 ops per draw, no cross-lane state -- pure
elementwise work that fuses into its consumers. Statistical quality is
pinned by tests/test_wavefront.py (moments + lag correlations) and by the
physics tests that run through the wavefront engine (furnace, mirror).

This stream intentionally differs from the batch path's threefry stream:
estimates agree statistically (same estimator), not bitwise. The reference
itself has per-row Xoshiro streams (src/rendering.rs:50-51) -- any seeded
deterministic stream is parity.
"""

from __future__ import annotations

import jax.numpy as jnp

_GOLD = 0x9E3779B9  # 2^32 / phi: Weyl increment decorrelating sequential ids


def _fmix(x: jnp.ndarray) -> jnp.ndarray:
    """lowbias32: bijective u32 finalizer with near-ideal avalanche."""
    x = x ^ (x >> jnp.uint32(16))
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> jnp.uint32(15))
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> jnp.uint32(16))
    return x


def work_key(seed: jnp.ndarray, wid: jnp.ndarray) -> jnp.ndarray:
    """Per-work-item u32 key from a u32 seed and an integer work id.

    ``wid`` may be any integer dtype (negative ids are fine -- dead lanes
    carry -1; their draws are never consumed)."""
    w = wid.astype(jnp.uint32) * jnp.uint32(_GOLD)
    return _fmix(w ^ jnp.asarray(seed, jnp.uint32))


def uniform_ctr(key_lane: jnp.ndarray, ctr) -> jnp.ndarray:
    """One U[0,1) f32 draw per lane at integer counter ``ctr``.

    ``ctr`` broadcasts against ``key_lane`` -- it can be a python int (same
    counter every lane) or a per-lane (B,) array (the wavefront's per-lane
    bounce depth). 24-bit mantissa draws, exactly like jax.random.uniform."""
    c = jnp.asarray(ctr).astype(jnp.uint32)
    bits = _fmix(key_lane ^ (c * jnp.uint32(0x85EBCA77) + jnp.uint32(0x165667B1)))
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(
        1.0 / (1 << 24)
    )
