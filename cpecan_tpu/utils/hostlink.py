"""Batched device->host fetches.

`jax.device_get` fetches a pytree's leaves one after another, so a
17-leaf fetch pays the device->host round-trip latency 17 times.
Starting every leaf's copy with `copy_to_host_async()` before the
blocking fetch overlaps the round trips, so a whole tree costs about one
latency plus the largest transfer (the reference has no equivalent; its
engine and decode share one address space).
"""

from __future__ import annotations

import jax


def device_get_pipelined(tree):
    """jax.device_get with all leaf transfers started asynchronously
    first, so the round trips overlap instead of serializing."""
    for leaf in jax.tree_util.tree_leaves(tree):
        if isinstance(leaf, jax.Array):
            try:
                leaf.copy_to_host_async()
            except Exception:
                pass  # committed-to-host or donated arrays: fall through
    return jax.device_get(tree)
