"""take_packed returns table values bit-exactly, at every table size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracing_course_2024_tpu.ops.gather import SELECT_MAX, take_packed


def _table(rng, c, n):
    """Values a TF32 (10-bit mantissa) or bf16 product would round: full
    24-bit mantissas, and integers up to 2^24 as the packs carry ids."""
    vals = rng.uniform(-4.0, 4.0, (c, n)).astype(np.float32)
    vals[0] = 1.0 + np.float32(2.0 ** -20) * np.arange(n)
    vals[1] = (2 ** 24 - 1) - np.arange(n)
    return vals


@pytest.mark.parametrize("n", [SELECT_MAX, SELECT_MAX + 28, 1024, 4096])
def test_take_packed_bit_exact(rng, n):
    packed = _table(rng, 36, n)
    idx = rng.integers(0, n, (3, 700)).astype(np.int32)
    got = jax.jit(take_packed)(jnp.asarray(packed), jnp.asarray(idx))
    assert len(got) == 36
    for ci, row in enumerate(got):
        assert row.shape == idx.shape
        assert np.array_equal(
            np.asarray(row).view(np.uint32), packed[ci][idx].view(np.uint32)
        ), ci
