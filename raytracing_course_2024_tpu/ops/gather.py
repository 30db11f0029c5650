"""Packed-table gathers for the hot loop.

Gatherable tables are stored TRANSPOSED and PACKED: one ``(C, N)`` f32
array whose rows are scalar attribute columns, so one gather serves every
attribute of a primitive and each gathered row is a contiguous (B,) array.

Integer attributes ride in the f32 pack (exact up to 2^24; prim ids, type
ids and counts all fit). Every path below returns the table's values
bit-exactly: selects and takes move values, they do no arithmetic on them.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

SELECT_MAX = 64  # per-row unrolled where-chains up to this table size


def pack_rows_host(*cols) -> np.ndarray:
    """Host-side: stack scalar columns (each (N,)) into a (C, N) f32 pack."""
    return np.ascontiguousarray(np.stack([np.asarray(c, np.float32) for c in cols]))


def take_packed(packed: jnp.ndarray, idx: jnp.ndarray):
    """Gather columns of a (C, N) pack at ``idx`` (any shape).

    Returns a TUPLE of C arrays shaped like ``idx`` -- independent (B,)
    values that fuse straight into their consumers.

      n <= SELECT_MAX   per-row compare-select chains against constants
                        (the table folds into the fused consumer)
      else              axis-1 take, then row unpack
    """
    n = packed.shape[1]
    c = packed.shape[0]
    flat = idx.reshape(-1)
    if n <= SELECT_MAX:
        rows = []
        for ci in range(c):
            col = packed[ci]  # scalar reads below fold to constants
            out = jnp.broadcast_to(col[0], flat.shape)
            for j in range(1, n):
                out = jnp.where(flat == j, col[j], out)
            rows.append(out.reshape(idx.shape))
        return tuple(rows)
    out = packed[:, flat]
    return tuple(out[ci].reshape(idx.shape) for ci in range(c))
