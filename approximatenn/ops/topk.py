"""Dedup-by-id + top-k selection.

Role of ``sort_and_uniq`` (``/root/reference/alg.c:224-230``): the reference
bitonic-sorts candidate rows by distance, infinities out *adjacent* duplicate
ids (``rdups``, ``compute.cl:212-217`` — safe because duplicates of one id
carry identical distances so they land adjacent), re-sorts, and the caller
keeps the first k.

Re-expression here (``dedup_topk``): k passes of masked argmin — find the
row minimum, emit it, then +inf out *every* entry carrying the winning id
(the dedup).  Each pass is one elementwise sweep plus a row reduction that
XLA fuses, with no sort.  Whether that beats a sort or ``lax.top_k`` on a
given device and k is a measurement still to make (the selection primitive
is open work).  The sort-based form is kept as :func:`dedup_topk_sort` (the oracle and the
large-k fallback); both produce identical results (the surviving copy of a
duplicate id is its minimum distance in either form).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import itype

# above this k the k-pass argmin loop (k VPU sweeps, unrolled) loses to one
# O(L log^2 L) sort; ANN k is typically 10-100.
_ITER_K_MAX = 128


def dedup_topk(
    ids: jax.Array, dists: jax.Array, k: int, sentinel: int
) -> tuple[jax.Array, jax.Array]:
    """Per-row dedup by id, then top-k ascending by distance.

    ids, dists: ``(..., L)``; entries with id == sentinel (or any masked
    entry) must already carry +inf distance.  Returns ``(ids_k, dists_k)``
    of shape ``(..., k)``; rows with fewer than k unique real candidates are
    padded with (sentinel, +inf), mirroring the reference's behaviour of
    returning sentinel-id entries when candidates run out.
    """
    if k > _ITER_K_MAX or k >= ids.shape[-1]:
        return dedup_topk_sort(ids, dists, k, sentinel)
    sent = jnp.asarray(sentinel, ids.dtype)
    out_i, out_d = [], []
    cur = dists
    for _ in range(k):
        j = jnp.argmin(cur, axis=-1)
        dmin = jnp.take_along_axis(cur, j[..., None], axis=-1)
        imin = jnp.take_along_axis(ids, j[..., None], axis=-1)
        # an +inf minimum means the row is exhausted -> sentinel padding
        imin = jnp.where(jnp.isinf(dmin), sent, imin)
        out_i.append(imin)
        out_d.append(dmin)
        # kill EVERY copy of the winning id: dedup and removal in one mask
        cur = jnp.where(ids == imin, jnp.asarray(jnp.inf, cur.dtype), cur)
    return jnp.concatenate(out_i, axis=-1), jnp.concatenate(out_d, axis=-1)


def dedup_topk_sort(
    ids: jax.Array, dists: jax.Array, k: int, sentinel: int
) -> tuple[jax.Array, jax.Array]:
    """Sort-based dedup + top-k — the oracle form and large-k fallback.

    Two sort keys (id, then distance) so the surviving copy of each id is its
    minimum distance; masked duplicates get (sentinel, +inf); one
    ``lax.top_k`` on negated distances picks the k nearest.  When k exceeds
    the candidate-list length the output is padded with (sentinel, +inf)
    columns so callers always get k columns.
    """
    pad = k - ids.shape[-1]
    if pad > 0:
        k = ids.shape[-1]
    sid, sdist = jax.lax.sort((ids, dists), dimension=-1, num_keys=2)
    prev = jnp.concatenate(
        [jnp.full(sid.shape[:-1] + (1,), -1, sid.dtype), sid[..., :-1]], axis=-1
    )
    dup = sid == prev
    sdist = jnp.where(dup, jnp.inf, sdist)
    sid = jnp.where(dup, jnp.asarray(sentinel, sid.dtype), sid)
    neg_top, idx = jax.lax.top_k(-sdist, k)
    out_i, out_d = jnp.take_along_axis(sid, idx, axis=-1), -neg_top
    if pad > 0:
        shape = out_i.shape[:-1] + (pad,)
        out_i = jnp.concatenate(
            [out_i, jnp.full(shape, sentinel, out_i.dtype)], axis=-1
        )
        out_d = jnp.concatenate(
            [out_d, jnp.full(shape, jnp.inf, out_d.dtype)], axis=-1
        )
    return out_i, out_d


def merge_topk(
    ids_a: jax.Array,
    dists_a: jax.Array,
    ids_b: jax.Array,
    dists_b: jax.Array,
    k: int,
    sentinel: int,
) -> tuple[jax.Array, jax.Array]:
    """Merge two candidate lists and keep the k nearest unique ids."""
    ids = jnp.concatenate([ids_a, ids_b], axis=-1)
    dists = jnp.concatenate([dists_a, dists_b], axis=-1)
    return dedup_topk(ids, dists, k, sentinel)


def topk_no_dedup(dists: jax.Array, ids: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """Plain top-k (ascending distance) without dedup, for merge stages
    where ids are guaranteed unique (e.g. cross-shard merges)."""
    if k <= _ITER_K_MAX and k < dists.shape[-1]:
        idx, d = topk_iter(dists, k)
        return jnp.take_along_axis(ids, idx, axis=-1), d
    neg_top, idx = jax.lax.top_k(-dists, min(k, dists.shape[-1]))
    out_i, out_d = jnp.take_along_axis(ids, idx, axis=-1), -neg_top
    pad = k - dists.shape[-1]
    if pad > 0:
        shape = out_i.shape[:-1] + (pad,)
        # +inf distance marks the padding; id value is a max-int poison
        out_i = jnp.concatenate(
            [out_i, jnp.full(shape, jnp.iinfo(jnp.int32).max, out_i.dtype)],
            axis=-1,
        )
        out_d = jnp.concatenate(
            [out_d, jnp.full(shape, jnp.inf, out_d.dtype)], axis=-1
        )
    return out_i, out_d


def topk_iter(dists: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """k smallest entries per row as (positions, values), ascending.

    k passes of argmin with positional masking — an alternative to
    ``lax.top_k`` with no sort (see module docstring).  Ties resolve to the
    lowest position, like ``lax.top_k``.

    Above ``_ITER_K_MAX`` the unrolled pass count bloats the program and
    its compile time, so large k falls back to ``lax.top_k`` — same
    contract, same lowest-position tie rule.
    """
    if k > _ITER_K_MAX:
        kk = min(k, dists.shape[-1])
        neg, j = jax.lax.top_k(-dists, kk)
        j, d = j.astype(jnp.int32), -neg
        if kk < k:
            pad = k - kk
            j = jnp.concatenate(
                [j, jnp.full(j.shape[:-1] + (pad,), dists.shape[-1],
                             jnp.int32)], axis=-1)
            d = jnp.concatenate(
                [d, jnp.full(d.shape[:-1] + (pad,), jnp.inf, d.dtype)],
                axis=-1)
        return j, d
    pos = jax.lax.broadcasted_iota(jnp.int32, dists.shape, dists.ndim - 1)
    out_j, out_d = [], []
    cur = dists
    for _ in range(k):
        j = jnp.argmin(cur, axis=-1)
        dmin = jnp.take_along_axis(cur, j[..., None], axis=-1)
        out_j.append(j[..., None].astype(jnp.int32))
        out_d.append(dmin)
        cur = jnp.where(pos == j[..., None], jnp.asarray(jnp.inf, cur.dtype), cur)
    return jnp.concatenate(out_j, axis=-1), jnp.concatenate(out_d, axis=-1)


def sentinel_pad(ids: jax.Array, dists: jax.Array, sentinel: int):
    """Force masked entries to (sentinel, +inf) — helper for callers."""
    mask = ids >= sentinel
    return (
        jnp.where(mask, jnp.asarray(sentinel, ids.dtype), ids),
        jnp.where(mask, jnp.inf, dists),
    )
