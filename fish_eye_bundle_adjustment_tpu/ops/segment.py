"""Scatter-free segment reductions for sorted observation streams.

Scatter-add serializes conflicting row updates.  For a SORTED id
stream, a segment sum is expressible instead as differences of prefix
sums: two row-gathers of n_segments rows (n_seg << n_obs) plus a
cumulative sum (fully vectorized).  Whether this beats
``jax.ops.segment_sum(..., indices_are_sorted=True)`` on the GPU is yet
to be measured.

The prefix sum is hierarchical (per-chunk inclusive scan + a second-level
scan of chunk totals) so float32 cancellation error stays bounded by the
chunk length (~sqrt(4096)*eps), independent of the total stream length.

A secondary axis (images, in the tie-sorted stream) is handled by a static
permutation into its own sorted order followed by the same reduction —
one gather (cheap) instead of one scatter (expensive).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

CHUNK = 4096


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SegmentLayout:
    """Static boundary structure of one sorted id stream.

    begs/ends are row offsets per segment (exclusive end); empty segments
    have begs == ends and reduce to zero."""

    begs: jax.Array  # (n_seg,) int32 — or (1, n_seg) inside a shard_map
    ends: jax.Array  # shard (leading axis = shard slot, see build_sharded)

    @staticmethod
    def from_sorted_ids(ids: np.ndarray, n_seg: int) -> "SegmentLayout":
        starts = np.searchsorted(ids, np.arange(n_seg + 1)).astype(np.int32)
        return SegmentLayout(
            begs=jnp.asarray(starts[:-1]), ends=jnp.asarray(starts[1:])
        )

    def rows(self):
        """(begs, ends) squeezed of a per-shard leading axis."""
        if self.begs.ndim == 2:
            return self.begs[0], self.ends[0]
        return self.begs, self.ends


def _exclusive_prefix_at(vals, rows):
    """ex(r) = sum of vals[:r] for each r in `rows`, hierarchical prefix.

    vals: (N, D) with N a multiple of CHUNK (pad with zeros upstream).
    rows: (S,) int32 in [0, N].
    """
    n, d = vals.shape
    nc = n // CHUNK
    v = vals.reshape(nc, CHUNK, d)
    local = jnp.cumsum(v, axis=1)  # within-chunk inclusive prefix
    chunk_tot = local[:, -1]  # (nc, D)
    offs = jnp.concatenate(
        [jnp.zeros((1, d), vals.dtype), jnp.cumsum(chunk_tot, axis=0)], axis=0
    )  # (nc+1, D) exclusive chunk offsets
    q = rows // CHUNK
    m = rows % CHUNK
    local_flat = local.reshape(n, d)
    # ex(r) = offs[q] + (local[q, m-1] if m > 0 else 0)
    inner = jnp.where(
        (m > 0)[:, None], local_flat[jnp.maximum(rows - 1, 0)], 0.0
    )
    return offs[q] + inner


def sorted_segment_sum(vals, layout: SegmentLayout):
    """Segment sum of a sorted stream. vals (N, D) -> (n_seg, D).

    N is padded to a multiple of CHUNK; rows past the last segment's end
    are ignored (pad ids beyond n_seg).  Pure jnp: XLA's cumsum plus two
    boundary gathers."""
    begs, ends = layout.rows()
    n, d = vals.shape
    if n % CHUNK != 0:
        pad = CHUNK - n % CHUNK
        vals = jnp.concatenate([vals, jnp.zeros((pad, d), vals.dtype)], axis=0)
    hi = _exclusive_prefix_at(vals, ends)
    lo = _exclusive_prefix_at(vals, begs)
    return hi - lo


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DualAxisPlan:
    """Segment layouts for a stream sorted on a primary axis, plus the
    static permutation that re-sorts it on a secondary axis.

    primary: reductions use sorted_segment_sum directly.
    secondary: vals[perm] is sorted on the secondary axis; one gather
    replaces one scatter."""

    primary: SegmentLayout
    perm: jax.Array  # (N,) int32: secondary-sorted position -> primary row
    secondary: SegmentLayout

    @staticmethod
    def build(primary_ids: np.ndarray, n_primary: int,
              secondary_ids: np.ndarray, n_secondary: int) -> "DualAxisPlan":
        perm = np.argsort(secondary_ids, kind="stable").astype(np.int32)
        return DualAxisPlan(
            primary=SegmentLayout.from_sorted_ids(primary_ids, n_primary),
            perm=jnp.asarray(perm),
            secondary=SegmentLayout.from_sorted_ids(
                secondary_ids[perm], n_secondary
            ),
        )

    @staticmethod
    def build_sharded(primary_ids: np.ndarray, n_primary: int,
                      secondary_ids: np.ndarray, n_secondary: int,
                      n_shards: int) -> "DualAxisPlan":
        """Per-shard plans stacked on a leading axis, for shard_map over
        an observation axis split into `n_shards` equal contiguous slices.

        The global stream is sorted on the primary axis, so each slice is
        too; segments straddling a shard boundary are partially reduced in
        each shard and completed by the caller's cross-shard psum.  All
        row offsets are LOCAL to the shard.  Inside shard_map each leaf
        arrives with a leading axis of 1, squeezed by rows()/perm."""
        n = primary_ids.shape[0]
        assert n % n_shards == 0, (n, n_shards)
        m = n // n_shards
        parts = []
        for d in range(n_shards):
            sl = slice(d * m, (d + 1) * m)
            parts.append(DualAxisPlan.build(
                primary_ids[sl], n_primary, secondary_ids[sl], n_secondary
            ))
        stack = lambda xs: jnp.stack(xs, axis=0)
        return DualAxisPlan(
            primary=SegmentLayout(
                begs=stack([p.primary.begs for p in parts]),
                ends=stack([p.primary.ends for p in parts]),
            ),
            perm=stack([p.perm for p in parts]),
            secondary=SegmentLayout(
                begs=stack([p.secondary.begs for p in parts]),
                ends=stack([p.secondary.ends for p in parts]),
            ),
        )

    def _perm_rows(self):
        return self.perm[0] if self.perm.ndim == 2 else self.perm

    def secondary_sum(self, vals):
        return sorted_segment_sum(vals[self._perm_rows()], self.secondary)

    def primary_sum(self, vals):
        return sorted_segment_sum(vals, self.primary)
