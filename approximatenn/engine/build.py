"""Index build — the ``precomp`` of this library.

Pipeline (role of ``precomp``, ``/root/reference/alg.c:342-434``):

1. mean-center points (``alg.c:360-369``) — one fused reduce + broadcast;
2. sample ``tries`` random orthogonal transforms (``alg.c:387-392``) from a
   JAX PRNG key and materialize their bases;
3. hash all points for all tables with ONE matmul
   ``(n, d) @ (d, tries*d_short)`` + sign packing — the reference instead
   replays the O(d log d) transform chain per try (``run_initial``,
   ``alg.c:154-183``); the two are equivalent (``save_vecs`` proves it) and
   the matmul form keeps the device's matrix units busy and makes build and query codes
   bitwise consistent;
4. bucket tables per try, multiprobe candidates, per-try top-k
   (``second_half``, ``alg.c:245-290``);
5. cross-try merge + supercharge graph refinement + final top-k
   (``det_results``, ``alg.c:303-337``).

The only host sync is reading the max bucket occupancy ``tmax``
(``alg.c:257-260``) unless an explicit static ``capacity`` is supplied, in
which case the whole build is a single jittable function.
"""

from __future__ import annotations

import warnings
from functools import partial

import jax
import jax.numpy as jnp

from .. import config
from ..config import itype
from ..index import ANNIndex
from ..ops.buckets import bucket_counts, build_tables, multiprobe_gather
from ..ops.distance import blocked_over_rows, candidate_dists, pick_block
from ..ops.hash import probe_codes_directed
from ..ops.topk import dedup_topk
from ..ops.transforms import (
    derive_dims,
    materialize_bases,
    sample_ortho_params_batch,
)
from ..utils.runtime import memory_budget


# Share of a device's memory limit that the bucket tables may fill at the
# default (exact-max) capacity, and the budget where a device reports no
# limit (the CPU backend).  Past it the build takes the "auto" capacity.
TABLE_SHARE = 0.25
TABLE_BYTES_NO_LIMIT = 4 << 30


def resolve_capacity(counts, capacity, device=None) -> int:
    """Bucket capacity from the occupancy histogram ``counts`` (...,
    tries, 2^d_short).

    None -> exact max (reference semantics, ``alg.c:257-260``) while its
    tables, (tries, 2^d_short, max) int32 per device, fit
    :data:`TABLE_SHARE` of ``device``'s memory limit, else "auto"; int ->
    pinned; "auto" -> min(max, 32x mean occupancy, floor 8).

    The exact max tracks the hottest bucket, which on clustered
    (real-world) corpora tracks the largest cluster — table memory and the
    multiprobe candidate-list length then explode (the reference shares
    this failure mode: on a clustered 1M x 128 corpus, 10 tries ask for
    ~51 GiB of tables).  Capacity is the quality/throughput knob: a low
    cap drops overflowing points from that table (less recall, less
    work), a high one reads mostly padding on skewed corpora; 32x mean is
    the balanced default.  Sweep it via ann_bench --capacity."""
    import numpy as np

    if capacity is None:
        tmax = max(1, int(counts.max()))
        tries, nb = counts.shape[-2:]
        table_bytes = tries * nb * tmax * np.dtype(itype).itemsize
        budget = memory_budget(TABLE_SHARE, TABLE_BYTES_NO_LIMIT, device)
        if table_bytes <= budget:
            return tmax
        warnings.warn(
            f"exact-max bucket capacity {tmax} needs {table_bytes} bytes of "
            f"tables, over the device budget of {budget}; building with "
            f'capacity="auto"', stacklevel=3)
        capacity = "auto"
    if isinstance(capacity, str):
        if capacity != "auto":
            raise ValueError(f"capacity must be an int, None, or 'auto'; got {capacity!r}")
        c = np.asarray(counts)
        cap = max(32.0 * c.mean(), 8.0)
        return max(1, int(min(c.max(), np.ceil(cap))))
    return max(1, int(capacity))


def sample_bases(key, d, d_short, tries, rb, rlb, ra, rla, dtype):
    """Sample `tries` transforms and materialize their bases
    (``alg.c:387-392`` + ``save_vecs``)."""
    _, d_max = derive_dims(2, 1, d)  # d_max depends only on d
    params = sample_ortho_params_batch(key, tries, d, d_max, rb, rlb, ra, rla, dtype)
    return materialize_bases(params, d, d_short, dtype)  # (tries, ds, d)


def hash_points(xc, bases):
    """Sign-hash PRE-centered points against all tables at once: one
    matmul + sign packing (convention: ``ops.hash.query_codes`` with zero
    means).  Returns codes (tries, n) int32."""
    from ..ops.hash import query_codes

    return query_codes(jnp.zeros((), xc.dtype), bases, xc)[0].T


def hash_stage(points, key, *, d_short, tries, rb, rlb, ra, rla, dtype):
    """Stage 1: center, sample transforms, materialize bases, hash.

    Returns (row_means, bases, codes (tries, n), counts (tries, 2^ds))."""
    points = points.astype(dtype)
    row_means = jnp.mean(points, axis=0)
    bases = sample_bases(key, points.shape[1], d_short, tries, rb, rlb, ra, rla, dtype)
    codes = hash_points(points - row_means, bases)
    counts = jax.vmap(lambda c: bucket_counts(c, 1 << d_short))(codes)
    return row_means, bases, codes, counts


_hash_stage = partial(jax.jit, static_argnames=("d_short", "tries", "rb", "rlb", "ra", "rla", "dtype"))(hash_stage)


def graph_stage(points, codes, counts, *, k, d_short, tmax, block_rows,
                n_probes=None, row_means=None, bases=None):
    """Stage 2 (static tmax): bucket tables, per-try candidates + top-k,
    merge, supercharge, final graph.  Distances are on raw coordinates
    (``alg.c:410-411``).

    ``n_probes``: None = the reference's blind Hamming-1 probe set; an int
    enables query-directed probing during the build (needs ``row_means`` +
    ``bases`` to recompute projections per block — cheaper than storing
    the (tries, n, d_short) projection tensor)."""
    n = points.shape[0]
    tries = codes.shape[0]
    nb = 1 << d_short
    tables = build_tables(codes, nb, tmax, n)
    rows_all = jnp.arange(n, dtype=itype)

    # --- per-try multiprobe + top-k (role of second_half, alg.c:245-290) ---
    def per_table(_, xs):
        table, tcodes, basis = xs

        def stage(qb, rows, cb):
            if n_probes is None:
                cand = multiprobe_gather(table, cb, d_short)
            else:
                proj = jnp.matmul(qb - row_means, basis.T,
                                  precision=jax.lax.Precision.HIGHEST)
                probes = probe_codes_directed(cb, proj, n_probes)
                cand = table[probes].reshape(qb.shape[0], -1)
            dd = candidate_dists(qb, points, cand, exclude_self=rows)
            return dedup_topk(cand, dd, k, n)

        ids_k, d_k = blocked_over_rows(
            stage, n, block_rows, points, rows_all, tcodes,
            pad_values=(0.0, -1, 0),
        )
        return None, (ids_k, d_k)

    if bases is None:
        bases = jnp.zeros((tries, d_short, points.shape[1]), points.dtype)
    _, (tids, tdists) = jax.lax.scan(per_table, None, (tables, codes, bases))

    # --- cross-try merge (det_results first half, alg.c:303-315) ---
    cand1 = jnp.moveaxis(tids, 0, 1).reshape(n, tries * k)
    d1 = jnp.moveaxis(tdists, 0, 1).reshape(n, tries * k)
    g1, gd1 = dedup_topk(cand1, d1, k, n)

    # --- supercharge (alg.c:316-327; kernel compute.cl:252-263) ---
    # During build the expansion source is the merged top-k itself
    # (pointers == graph branch, alg.c:316).
    def final_stage(g1b, gd1b, rows):
        safe = jnp.where(g1b < n, g1b, 0)
        exp = jnp.where((g1b < n)[..., None], g1[safe], n)  # (B, k, k)
        cand = jnp.concatenate([g1b, exp.reshape(-1, k * k)], axis=-1)
        dd_exp = candidate_dists(
            points[jnp.where(rows >= 0, rows, 0)],
            points,
            exp.reshape(-1, k * k),
            exclude_self=rows,
        )
        dd = jnp.concatenate([gd1b, dd_exp], axis=-1)
        return dedup_topk(cand, dd, k, n)

    graph, gdists = blocked_over_rows(
        final_stage, n, block_rows, g1, gd1, rows_all,
        pad_values=(0, jnp.inf, -1),
    )
    return tables, graph, gdists


_graph_stage = partial(
    jax.jit, static_argnames=("k", "d_short", "tmax", "block_rows", "n_probes")
)(graph_stage)


# ---------------------------------------------------------------------------
# Chunked build driver.  For large n x tmax the build is host-orchestrated:
# the same stage bodies, jitted per (table, row-chunk), each program bounded
# to ~_MAX_BLOCKS_PER_CALL blocks and completed before the next is queued,
# so device memory holds one program's workspace at a time.  Progress is
# observable and a failed chunk is retryable.
# ---------------------------------------------------------------------------

_MAX_BLOCKS_PER_CALL = 2048


@partial(jax.jit, static_argnames=("k", "d_short", "block_rows", "n_probes"))
def _probe_chunk(points, table, tcodes_chunk, row_lo, row_means, basis,
                 *, k, d_short, block_rows, n_probes=None):
    """Per-table per-row-chunk multiprobe + top-k (chunk of second_half).
    ``row_lo`` is traced so every chunk reuses one compilation."""
    n = points.shape[0]
    m = tcodes_chunk.shape[0]
    rows = row_lo + jnp.arange(m, dtype=itype)

    def stage(qb, rr, cb):
        if n_probes is None:
            cand = multiprobe_gather(table, cb, d_short)
        else:
            proj = jnp.matmul(qb - row_means, basis.T,
                              precision=jax.lax.Precision.HIGHEST)
            probes = probe_codes_directed(cb, proj, n_probes)
            cand = table[probes].reshape(qb.shape[0], -1)
        dd = candidate_dists(qb, points, cand, exclude_self=rr)
        return dedup_topk(cand, dd, k, n)

    qchunk = jax.lax.dynamic_slice_in_dim(points, row_lo, m)
    return blocked_over_rows(
        stage, m, min(block_rows, m), qchunk, rows, tcodes_chunk,
        pad_values=(0.0, -1, 0),
    )


def exact_graph_chunked(points, k, *, chunk_q: int = 8192, progress=None,
                        matmul_precision: str = "highest"):
    """The kNN graph by exhaustive search instead of the hash pipeline.

    The reference's ``precomp`` exists to compute the k-NN graph of the
    point set (``ann.h:24-27``); its hash+supercharge machinery is how a
    1-thread CPU/OpenCL device approximates that affordably.  The exact
    engine (:func:`~..ops.distance.exact_search`, self-excluded) returns
    the TRUE graph (recall 1.0), which also improves query-time
    supercharge.  Runs chunked over ``chunk_q`` query rows so each device
    program stays bounded.
    """
    from ..ops.distance import exact_search

    n = points.shape[0]
    parts_i, parts_d = [], []
    for i, lo in enumerate(range(0, n, chunk_q)):
        m = min(chunk_q, n - lo)
        q = jax.lax.dynamic_slice_in_dim(points, lo, m)
        ids_k, d_k = exact_search(points, q, k, exclude=lo + jnp.arange(m),
                                  matmul_precision=matmul_precision)
        parts_i.append(ids_k)
        parts_d.append(d_k)
        if i % 8 == 7:
            # bound enqueue-ahead: each queued program's outputs are
            # allocated when it is dispatched, so an occasional wait keeps
            # live memory at a handful of chunks
            jax.block_until_ready(ids_k)
        if progress:
            progress(f"exact graph rows {lo + m}/{n}")
    if len(parts_i) == 1:
        return parts_i[0], parts_d[0]
    return jnp.concatenate(parts_i), jnp.concatenate(parts_d)


def graph_stage_chunked(points, codes, counts, *, k, d_short, tmax, block_rows,
                        n_probes=None, row_means=None, bases=None,
                        progress=None):
    """Host-orchestrated graph build: identical results to
    :func:`graph_stage`, with every device program bounded."""
    n = points.shape[0]
    tries = codes.shape[0]
    nb = 1 << d_short
    tables = build_tables(codes, nb, tmax, n)
    # stage boundary: the vmapped per-table sorts carry multi-GB workspace
    # at 10M; waiting here keeps it from stacking on the probe chunks'
    jax.block_until_ready(tables)
    chunk = min(_MAX_BLOCKS_PER_CALL * block_rows, n)
    if row_means is None:
        row_means = jnp.zeros((points.shape[1],), points.dtype)
    if bases is None:
        bases = jnp.zeros((tries, d_short, points.shape[1]), points.dtype)

    # rows-outer, tries-inner, merging each row chunk immediately: holding
    # all tables' (n, k) results and stacking/reshaping them costs ~3
    # transient copies of (tries, n, k) x 8 bytes — ~10 GB at 10M x 10
    # tries next to the corpus.  Per-chunk state is
    # (chunk, tries*k); only the merged (n, k) graph accumulates.
    g1_parts, gd1_parts = [], []
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        per_t = []
        for t in range(tries):
            ids_k, d_k = _probe_chunk(
                points, tables[t],
                jax.lax.dynamic_slice_in_dim(codes[t], lo, m),
                jnp.asarray(lo, itype), row_means, bases[t],
                k=k, d_short=d_short, block_rows=block_rows,
                n_probes=n_probes,
            )
            per_t.append((ids_k, d_k))
            jax.block_until_ready(ids_k)  # one program's workspace live at a time
            if progress:
                progress(f"rows {lo}..{lo + m}/{n} table {t + 1}/{tries}")
        # t-major per row, identical to moveaxis(stack(...), 0, 1).reshape
        cand1 = jnp.concatenate([p[0] for p in per_t], axis=-1)
        d1 = jnp.concatenate([p[1] for p in per_t], axis=-1)
        gi, gd = _merge_tables(cand1, d1, k=k, n=n)
        g1_parts.append(gi)
        gd1_parts.append(gd)
        del per_t, cand1, d1  # (chunk, tries*k) x2 — ~0.9 GB at 10M
        jax.block_until_ready(gi)  # serialize chunks: enqueue-ahead would
        # stack every queued program's outputs on the device at once
    g1 = jnp.concatenate(g1_parts)
    gd1 = jnp.concatenate(gd1_parts)
    # free the per-chunk parts: at 10M they total 2x (n, k) x 8 B ~ 1.4 GB
    # still resident next to the concatenated copies
    g1_parts.clear()
    gd1_parts.clear()
    del gi, gd

    parts_i, parts_d = [], []
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        ids_k, d_k = _supercharge_chunk(
            points, g1,
            jax.lax.dynamic_slice_in_dim(g1, lo, m),
            jax.lax.dynamic_slice_in_dim(gd1, lo, m),
            jnp.asarray(lo, itype),
            k=k, block_rows=block_rows,
        )
        parts_i.append(ids_k)
        parts_d.append(d_k)
        jax.block_until_ready(ids_k)  # same enqueue-ahead cap as the probe loop
        if progress:
            progress(f"supercharge rows {lo + m}/{n}")
    # gd1 is dead once the last chunk's inputs are sliced; g1 must outlive
    # the loop (it is the gather source inside _supercharge_chunk)
    del gd1, g1
    return tables, jnp.concatenate(parts_i), jnp.concatenate(parts_d)


@partial(jax.jit, static_argnames=("k", "n"))
def _merge_tables(cand1, d1, *, k, n):
    return dedup_topk(cand1, d1, k, n)


@partial(jax.jit, static_argnames=("k", "block_rows"))
def _supercharge_chunk(points, g1_full, g1c, gd1c, row_lo, *, k, block_rows):
    n = points.shape[0]
    m = g1c.shape[0]
    rows = row_lo + jnp.arange(m, dtype=itype)

    def final_stage(g1b, gd1b, rr):
        safe = jnp.where(g1b < n, g1b, 0)
        exp = jnp.where((g1b < n)[..., None], g1_full[safe], n)  # (B, k, k)
        cand = jnp.concatenate([g1b, exp.reshape(-1, k * k)], axis=-1)
        dd_exp = candidate_dists(
            points[jnp.where(rr >= 0, rr, 0)],
            points,
            exp.reshape(-1, k * k),
            exclude_self=rr,
        )
        dd = jnp.concatenate([gd1b, dd_exp], axis=-1)
        return dedup_topk(cand, dd, k, n)

    return blocked_over_rows(
        final_stage, m, min(block_rows, m), g1c, gd1c, rows,
        pad_values=(0, jnp.inf, -1),
    )


def build(
    points,
    k: int,
    *,
    tries: int = 10,
    rots_before: int = 6,
    rot_len_before: int = 1,
    rots_after: int = 1,
    rot_len_after: int = 1,
    key=None,
    seed: int = 0,
    dtype=None,
    capacity: int | str | None = None,
    budget_bytes: int = 128 << 20,
    metric: str = "l2",
    store_points: bool | None = None,
    n_probes: int | None = None,
    graph_mode: str = "auto",
    graph_precision: str = "highest",
) -> tuple[ANNIndex, jax.Array, jax.Array]:
    """Build an index over ``points`` (n, d); returns (index, graph, dists).

    Mirrors ``precomp`` (``ann.h:46-49``) with the save always produced (the
    reference's save=NULL fast path is :func:`build_graph_only`).
    ``capacity`` pins the bucket capacity for a sync-free, fully-jittable
    build (overflow dropped); None reads the exact max occupancy back once,
    as the reference's host histogram does (``alg.c:252-266``), and falls
    back to "auto" (with a warning) when the exact-max tables outgrow a
    share of the device's memory; "auto" =
    ``min(exact max, 32x mean occupancy)`` with a floor of 8 — the single
    policy, defined in :func:`resolve_capacity`.
    Exact-max capacity — the reference's policy — makes table memory scale
    with the LARGEST bucket, which explodes on clustered (real-world) data:
    similar vectors hash together, so one hot bucket can hold a whole
    cluster.  "auto" keeps memory ~linear in n; overflowing points drop out
    of that one table but remain reachable through the other tries and the
    supercharge graph (recall impact gated in tests).

    ``n_probes``: None = the reference's blind Hamming-1 probe set for the
    graph build; an int uses query-directed probing
    (:func:`~..ops.hash.probe_codes_directed`) — a higher-quality kNN graph
    at the same candidate budget.

    ``metric``: 'l2' (the reference's only metric) or 'angular' — cosine
    via one up-front row normalization (``data.preprocess``).  For angular,
    the normalized points are stored in the index (``store_points`` defaults
    True there) and :func:`~..engine.search.search` runs against them.

    ``graph_mode``: how the kNN graph (the ``precomp`` output and the
    supercharge structure) is computed.  "exact" = exhaustive
    self-search (:func:`exact_graph_chunked`): the TRUE graph, which also
    lifts recall through serve-time supercharge; "hash" = the reference's
    multiprobe+supercharge approximation (``alg.c:395-422``); "auto"
    (default) = exact when n <= 16M and k <= 128, resolved identically on
    every backend so the accelerator-vs-CPU parity gate stays
    meaningful.  The 16M bound is set by cost, not quality: exact
    self-search is n^2, and past 16M the hash approximation is the
    affordable default; pass graph_mode="exact" to override either way.
    ``graph_precision`` is the exact engine's ``matmul_precision``:
    "highest" (default, exact f32 edge ranking), "split3" (three bf16
    passes, f32-faithful ranking) or "default" (the backend's fastest
    f32 product — TF32 on NVIDIA GPUs — which misranks near-tie edges).
    """
    n, d = points.shape
    if n >= 2**31:
        raise ValueError("n must fit in int32")
    dtype = dtype or config.ftype()
    if key is None:
        key = jax.random.key(seed)
    from ..data.preprocess import prepare_points

    points = prepare_points(jnp.asarray(points, dtype), metric)
    if store_points is None:
        store_points = metric != "l2"
    d_short, _ = derive_dims(n, k, d)
    if d_short > 28:
        raise ValueError(f"d_short={d_short} too large (bucket table 2^{d_short})")

    row_means, bases, codes, counts = _hash_stage(
        points, key,
        d_short=d_short, tries=tries, rb=rots_before, rlb=rot_len_before,
        ra=rots_after, rla=rot_len_after, dtype=dtype,
    )
    tmax = resolve_capacity(counts, capacity)
    n_per_probe = d_short + 1 if n_probes is None else n_probes
    block_rows = pick_block(
        n, n_per_probe * tmax, d, jnp.dtype(dtype).itemsize, budget_bytes
    )
    points_f = jnp.asarray(points, dtype)
    if graph_mode == "auto":
        graph_mode = "exact" if (n <= (1 << 24) and k <= 128) else "hash"
    if graph_mode not in ("exact", "hash"):
        raise ValueError(f"unknown graph_mode {graph_mode!r}")
    if graph_mode == "exact":
        tables = build_tables(codes, 1 << d_short, tmax, n)
        graph, gdists = exact_graph_chunked(
            points_f, k, matmul_precision=graph_precision
        )
        graph = graph.astype(itype)
        gdists = gdists.astype(dtype)
    else:
        # one monolithic program for small problems; host-chunked otherwise
        # so every device program and its workspace stay bounded (see
        # graph_stage_chunked)
        total_blocks = (tries + 1) * -(-n // block_rows)
        pkw = dict(n_probes=n_probes, row_means=row_means, bases=bases)
        if total_blocks <= 4096 and n <= (1 << 18):
            tables, graph, gdists = _graph_stage(
                points_f, codes, counts, k=k, d_short=d_short, tmax=tmax,
                block_rows=block_rows, **pkw,
            )
        else:
            tables, graph, gdists = graph_stage_chunked(
                points_f, codes, counts, k=k, d_short=d_short, tmax=tmax,
                block_rows=block_rows, **pkw,
            )
    del codes  # (tries, n) int32 — dead once the tables exist (0.4 GB @ 10M)
    index = ANNIndex(
        row_means=row_means, bases=bases, tables=tables, counts=counts,
        graph=graph, n=n, k=k, d=d, d_short=d_short, tries=tries, tmax=tmax,
        points=points_f if store_points else None, metric=metric,
    )
    return index, graph, gdists


def build_graph_only(points, k: int, **kw) -> tuple[jax.Array, jax.Array]:
    """kNN graph without keeping the index (reference save=NULL path,
    ``ann.c:13-23`` with ``save == NULL``)."""
    _, graph, gdists = build(points, k, **kw)
    return graph, gdists
