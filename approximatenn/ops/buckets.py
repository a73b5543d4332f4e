"""Bucket (hash-table) construction and multiprobe candidate gather.

Device-side replacement for the reference's host-side histogram + scatter
(``/root/reference/alg.c:252-266``) and the ``compute_which`` gather kernel
(``compute.cl:238-246``).  The table build is sort-based so it runs on-device
with static shapes; the only data-dependent quantity — the max bucket
occupancy ``tmax`` (``alg.c:257-260``) — is either read back to the host once
per build (mirroring the reference's host histogram phase) or pinned by an
explicit ``capacity`` for fully-jittable builds (overflow entries are
dropped; the recall impact is gated by tests).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import itype
from .hash import probe_codes


def bucket_counts(codes: jax.Array, n_buckets: int) -> jax.Array:
    """Occupancy of every bucket (role of ``counts``, ``alg.c:252-256``)."""
    return jnp.bincount(codes, length=n_buckets).astype(itype)


def build_table(codes: jax.Array, n_buckets: int, capacity: int, sentinel: int) -> jax.Array:
    """Build a padded bucket table ``(n_buckets, capacity)`` of point ids.

    Slots beyond a bucket's occupancy hold ``sentinel`` (= n, as in
    ``alg.c:262-264``); entries beyond ``capacity`` are dropped.  Performed
    as argsort-by-code + rank-within-bucket scatter — O(n log n) on device,
    replacing the reference's serial host loop (``alg.c:252-266``).
    """
    n = codes.shape[0]
    order = jnp.argsort(codes, stable=True).astype(itype)
    sorted_codes = codes[order]
    first = jnp.searchsorted(sorted_codes, sorted_codes, side="left")
    rank = jnp.arange(n, dtype=itype) - first.astype(itype)
    table = jnp.full((n_buckets, capacity), sentinel, itype)
    # mode='drop' discards rank >= capacity (bucket overflow) without
    # bleeding into neighbouring buckets.
    return table.at[sorted_codes, rank].set(order, mode="drop")


def build_tables(codes: jax.Array, n_buckets: int, capacity: int, sentinel: int) -> jax.Array:
    """Stacked per-table build: codes ``(tries, n)`` -> ``(tries, n_buckets,
    capacity)`` (role of the per-try ``second_half`` host phase,
    ``alg.c:412-416``), vmapped over tables.

    Above ~16M total codes the vmap becomes one program carrying ``tries``
    stable-sort workspaces at once (several GB at 10M x 10); large builds
    loop tables on the host, each completed before the next is queued,
    with identical results."""
    tries, n = codes.shape
    if tries * n <= (1 << 24):
        return jax.vmap(lambda c: build_table(c, n_buckets, capacity, sentinel))(codes)
    parts = []
    for t in range(tries):
        tbl = jax.block_until_ready(
            build_table(codes[t], n_buckets, capacity, sentinel))
        parts.append(tbl)
    out = jnp.stack(parts)
    parts.clear()
    del tbl
    return out


def pack_table(codes: jax.Array, n_buckets: int) -> tuple[jax.Array, jax.Array]:
    """CSR layout of one table: point ids sorted by bucket code, plus the
    start offset of every bucket in that order.

    Unlike :func:`build_table` (padded ``(n_buckets, capacity)``), this
    stores each table in exactly ``n`` slots with **no padding and no
    overflow drops** — the layout behind the packed fast-path gather
    (:meth:`approximatenn.index.ANNIndex.packed`).  Returns
    ``(order (n,), starts (n_buckets,))``: bucket ``b`` owns
    ``order[starts[b]:starts[b+1]]`` (``starts`` is monotone; the implicit
    final boundary is ``n``).
    """
    order = jnp.argsort(codes, stable=True).astype(itype)
    sorted_codes = codes[order]
    starts = jnp.searchsorted(
        sorted_codes, jnp.arange(n_buckets, dtype=sorted_codes.dtype), side="left"
    ).astype(itype)
    return order, starts


def pack_tables(codes: jax.Array, n_buckets: int) -> tuple[jax.Array, jax.Array]:
    """Stacked :func:`pack_table`: ``(tries, n)`` codes ->
    ``(order (tries, n), starts (tries, n_buckets))``."""
    return jax.vmap(lambda c: pack_table(c, n_buckets))(codes)


def multiprobe_gather(table: jax.Array, codes: jax.Array, d_short: int) -> jax.Array:
    """Gather multiprobe candidates for each code.

    ``table`` is ``(n_buckets, capacity)``; ``codes`` is ``(m,)``.  Returns
    ``(m, (d_short + 1) * capacity)`` candidate ids (sentinel-padded) — the
    own bucket plus every Hamming-1 bucket, exactly ``compute_which``
    (``compute.cl:238-246``).
    """
    probes = probe_codes(codes, d_short)  # (m, d_short+1)
    cand = table[probes]  # (m, d_short+1, capacity)
    return cand.reshape(codes.shape[0], -1)
