"""Validity-mask algebra.

The reference stores validity as packed bit buffers with word-at-a-time
kernels (arrow-buffer/src/buffer/{null.rs,ops.rs}).  On the device the
natural representation is a dense bool tensor: XLA fuses mask algebra into
the consuming kernel for free, so bit-packing would only add unpack
traffic.  `None` means "all valid"
(the reference's elided null buffer).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

Mask = Optional[jnp.ndarray]  # dense bool tensor or None (= all valid)


def union(a: Mask, b: Mask) -> Mask:
    """Validity of a binary kernel's output: valid iff both inputs valid.

    Semantics of NullBuffer::union (arrow-buffer/src/buffer/null.rs:78).
    """
    if a is None:
        return b
    if b is None:
        return a
    return jnp.logical_and(a, b)


def intersect_all(*masks: Mask) -> Mask:
    out: Mask = None
    for m in masks:
        out = union(out, m)
    return out


def null_count(mask: Mask, length: int):
    """Number of null slots (traced scalar when mask is a tracer)."""
    if mask is None:
        return 0
    return length - jnp.sum(mask, dtype=jnp.int64)


def valid_count(mask: Mask, length: int):
    if mask is None:
        return length
    return jnp.sum(mask, dtype=jnp.int64)


def is_all_valid_host(mask: Mask) -> bool:
    """Host-synced check; eager API only."""
    return mask is None or bool(jnp.all(mask))


def canonicalize(values: jnp.ndarray, mask: Mask) -> jnp.ndarray:
    """Zero values under null slots.

    The reference leaves null slots unspecified; we canonicalize to the
    dtype's zero so that (values, validity) pairs are bitwise-deterministic
    — required for exact golden comparison and for hash kernels that fold
    the validity into the value lanes.
    """
    if mask is None:
        return values
    zero = jnp.zeros((), dtype=values.dtype)
    return jnp.where(mask, values, zero)


def make_mask(length: int, mask: Mask) -> jnp.ndarray:
    """Materialize an explicit mask (all-True when None)."""
    if mask is None:
        return jnp.ones((length,), dtype=jnp.bool_)
    return mask
