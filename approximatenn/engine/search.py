"""Batch query — the ``query`` of this library.

Pipeline (role of ``query``, ``/root/reference/alg.c:458-519``):

1. center queries by the stored row means (``alg.c:462-466``);
2. project against ALL tables' bases in one matmul
   ``(m, d) @ (d, tries*d_short)`` (the reference's ``prods`` +
   ``add_up_cols``, ``alg.c:468-481``) and pack sign codes;
3. multiprobe-gather candidates from every table (``shufcomp`` +
   ``compute_which``, ``alg.c:495-500``);
4. distances on raw coordinates, dedup, top-k, supercharge through the
   stored kNN graph, final top-k (``det_results``, ``alg.c:303-337``).

Everything after step 1 is a single jitted, row-blocked computation with
static shapes taken from the index.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import itype
from ..index import ANNIndex, PackedIndex
from ..ops.buckets import multiprobe_gather
from ..ops.distance import blocked_over_rows, candidate_dists, pick_block
from ..ops.hash import probe_codes, probe_codes_directed, query_codes
from ..ops.topk import dedup_topk


def search_impl(index: ANNIndex, points, queries, block_rows: int,
                n_probes: int | None = None, supercharge_rounds: int = 1,
                rerank_width: int | None = None):
    n, k, d_short, tries, tmax = (
        index.n, index.k, index.d_short, index.tries, index.tmax,
    )
    # widened intermediate pool: keep kk >= k candidates through the merge
    # and supercharge stages (their true distances are already computed),
    # reduce to k only at the end — recall lever at ~(kk/k)x supercharge
    # cost and zero extra bucket reads
    kk = k if rerank_width is None else max(int(rerank_width), k)
    dtype = index.bases.dtype
    m, d = queries.shape
    q = queries.astype(dtype)
    codes, proj = query_codes(index.row_means, index.bases, q)  # (m, tries)

    table_idx = jnp.arange(tries, dtype=itype)[None, :, None]

    def stage(qb, cb, pb):
        # multiprobe gather across all tables: (B, tries, P, tmax).
        # n_probes=None is the reference's blind Hamming-1 set
        # (compute_which, compute.cl:238-246); an int selects that many
        # query-directed probes (own + cheapest 1/2-bit flips).
        if n_probes is None:
            probes = probe_codes(cb, d_short)  # (B, tries, ds+1)
        else:
            probes = probe_codes_directed(cb, pb, n_probes)
        cand = index.tables[table_idx, probes]
        cand = cand.reshape(cand.shape[0], -1)  # (B, tries*P*tmax)
        dd = candidate_dists(qb, points, cand)
        t1, td1 = dedup_topk(cand, dd, kk, n)
        # supercharge via the stored graph (alg.c:507-512); the reference
        # runs exactly one round — extra rounds walk the graph further
        # (each costs one kk*k gather + distance pass), a cheap recall
        # knob now that the stored graph is exact
        for _ in range(supercharge_rounds):
            safe = jnp.where(t1 < n, t1, 0)
            exp = jnp.where((t1 < n)[..., None], index.graph[safe], n)
            cand2 = jnp.concatenate([t1, exp.reshape(-1, kk * k)], axis=-1)
            dd2 = candidate_dists(qb, points, exp.reshape(-1, kk * k))
            dd2 = jnp.concatenate([td1, dd2], axis=-1)
            t1, td1 = dedup_topk(cand2, dd2, kk, n)
        if kk != k:
            t1, td1 = t1[:, :k], td1[:, :k]
        return t1, td1

    return blocked_over_rows(
        stage, m, block_rows, q, codes, proj, pad_values=(0.0, 0, 0.0)
    )


_search_jit = partial(
    jax.jit,
    static_argnames=(
        "block_rows", "n_probes", "supercharge_rounds", "rerank_width"
    ),
)(search_impl)


# ---------------------------------------------------------------------------
# Host-chunked query driver for huge corpora.  One monolithic search program
# taking points + ALL tables + graph as loop-invariant lax.map arguments
# can make XLA's rematerializer insert layout copies of each of them, many
# GB of temporaries at 10M points.  The chunked driver mirrors the build's
# solution (`engine/build.py:graph_stage_chunked`): one device program per
# (table, query batch) holding a single table, a host-side merge, then a
# supercharge program holding only the graph — each completed before the
# next is queued, so only one program's workspace is live.  Identical
# results to `search_impl`: per-table top-kk followed
# by a dedup merge selects exactly the union top-kk (distances are a
# function of id alone, and dedup keeps the min-distance copy).
# ---------------------------------------------------------------------------

_ONE_SHOT_MAX_BYTES = 5 << 30  # points+tables+graph above this -> chunked


@jax.jit
def _query_codes(row_means, bases, queries):
    """Bucket codes of each query under every table: (m, tries) int."""
    return query_codes(row_means, bases, queries)[0]


@partial(jax.jit, static_argnames=("k", "d_short", "block_rows", "n_probes"))
def _probe_table_q(points, table, queries, codes_t, row_means, basis,
                   *, k, d_short, block_rows, n_probes=None):
    """One table's multiprobe candidates + top-k for a query batch (query
    counterpart of the build's `_probe_chunk`)."""
    n = points.shape[0]
    m = queries.shape[0]

    def stage(qb, cb):
        if n_probes is None:
            cand = multiprobe_gather(table, cb, d_short)
        else:
            proj = jnp.matmul(qb - row_means, basis.T,
                              precision=jax.lax.Precision.HIGHEST)
            probes = probe_codes_directed(cb, proj, n_probes)
            cand = table[probes].reshape(qb.shape[0], -1)
        dd = candidate_dists(qb, points, cand)
        return dedup_topk(cand, dd, k, n)

    return blocked_over_rows(
        stage, m, min(block_rows, m), queries, codes_t, pad_values=(0.0, 0)
    )


@partial(jax.jit, static_argnames=("block_rows",))
def _supercharge_q(points, graph, queries, t1, td1, *, block_rows):
    """One graph-expansion round over current top-kk (query counterpart of
    the build's `_supercharge_chunk`; `alg.c:507-512`)."""
    n = points.shape[0]
    m = queries.shape[0]
    kk = t1.shape[1]
    k = graph.shape[1]

    def stage(qb, t1b, td1b):
        safe = jnp.where(t1b < n, t1b, 0)
        exp = jnp.where((t1b < n)[..., None], graph[safe], n)
        cand2 = jnp.concatenate([t1b, exp.reshape(-1, kk * k)], axis=-1)
        dd2 = candidate_dists(qb, points, exp.reshape(-1, kk * k))
        dd2 = jnp.concatenate([td1b, dd2], axis=-1)
        return dedup_topk(cand2, dd2, kk, n)

    return blocked_over_rows(
        stage, m, min(block_rows, m), queries, t1, td1,
        pad_values=(0.0, 0, jnp.inf),
    )


@partial(jax.jit, static_argnames=("k", "n"))
def _merge_q(cand, dd, *, k, n):
    return dedup_topk(cand, dd, k, n)


def _search_chunked(index: ANNIndex, points, queries, *, block_rows,
                    n_probes=None, supercharge_rounds=1, rerank_width=None):
    n, k, d_short, tries = index.n, index.k, index.d_short, index.tries
    kk = k if rerank_width is None else max(int(rerank_width), k)
    codes = jax.block_until_ready(
        _query_codes(index.row_means, index.bases, queries))
    parts_i, parts_d = [], []
    for t in range(tries):
        ids_k, d_k = _probe_table_q(
            points, index.tables[t], queries, codes[:, t],
            index.row_means, index.bases[t],
            k=kk, d_short=d_short, block_rows=block_rows, n_probes=n_probes,
        )
        jax.block_until_ready(ids_k)  # one program's workspace live at a time
        parts_i.append(ids_k)
        parts_d.append(d_k)
    t1, td1 = _merge_q(
        jnp.concatenate(parts_i, axis=-1), jnp.concatenate(parts_d, axis=-1),
        k=kk, n=n,
    )
    parts_i.clear()
    parts_d.clear()
    jax.block_until_ready(t1)
    for _ in range(supercharge_rounds):
        t1, td1 = jax.block_until_ready(_supercharge_q(
            points, index.graph, queries, t1, td1, block_rows=block_rows
        ))
    return t1[:, :k], td1[:, :k]


def search_packed_impl(pi: PackedIndex, points, queries, block_rows: int,
                       n_probes: int | None = None,
                       supercharge_rounds: int = 1,
                       rerank_width: int | None = None):
    """Query pipeline over the packed (bucket-CSR wide-row) layout.

    Same algorithm as :func:`search_impl`; the candidate stage differs:

    - each probe gathers the ``rows_per_probe`` lane-aligned super-rows
      covering ``[starts[t, probe], +window)`` from ``point_rows`` — the
      candidate *vectors* arrive in the gather itself (no table lookup,
      no per-candidate gather through point ids);
    - the per-table top-k dedups by packed *position* (a point occupies
      exactly one slot per table, so slot index is a free within-table
      id — overlapping probe windows carry the same slot at equal
      distance and are masked just like id duplicates);
    - original ids are gathered only for the ``tries * k`` per-table
      winners (tiny), then the cross-table merge dedups by real id.

    Alignment spillover admits extra real candidates (superset semantics;
    see ``ANNIndex.packed``).
    """
    n, k, d_short, tries = pi.n, pi.k, pi.d_short, pi.tries
    # same widened-pool lever as search_impl: per-table and merged top-k
    # run at kk >= k, cut to k after the last supercharge round
    kk = k if rerank_width is None else max(int(rerank_width), k)
    w, d = pi.super_width, pi.d
    dp = pi.lane_dim  # stored lane dim (d zero-padded to a 128 multiple)
    nrows = pi.n_rows
    n_pad = nrows * w
    rpp = pi.rows_per_probe()
    dtype = pi.bases.dtype
    cdtype = pi.point_rows.dtype  # candidate/compute dtype (may be bf16)
    m = queries.shape[0]
    q = queries.astype(dtype)
    codes, proj = query_codes(pi.row_means, pi.bases, q)

    table_idx = jnp.arange(tries, dtype=itype)[None, :, None]
    slot_off = (jnp.arange(tries, dtype=itype) * n_pad)[None, :, None]
    step = jnp.arange(rpp, dtype=itype)
    ids_flat = pi.ids.reshape(-1)  # (tries * n_pad,)
    lane = jnp.arange(w, dtype=itype)

    def stage(qb, cb, pb):
        B = qb.shape[0]
        if n_probes is None:
            probes = probe_codes(cb, d_short)  # (B, tries, P)
        else:
            probes = probe_codes_directed(cb, pb, n_probes)
        start = pi.starts[table_idx, probes]  # (B, tries, P)
        # aligned super-row window covering [start, start+window), then
        # the w slot rows inside each super-row (storage is flat — one
        # point per row; the grouping is purely index arithmetic)
        rows = jnp.minimum(start[..., None] // w + step, nrows - 1)
        pos = (rows[..., None] * w + lane).reshape(B, tries, -1)  # (B,T,Lt)
        flat = (pos + slot_off).reshape(B, -1)  # (B, tries*P*rpp*w)
        pc = pi.point_rows[flat].reshape(B, tries, -1, dp)  # (B, T, Lt, dp)
        if pi.scale is not None:
            # int8 tier: rank in the quantized domain (q / scale vs the
            # stored int8 rows, which promote to f32 in the subtract),
            # then restore the true scale
            qbp = qb.astype(jnp.float32) / pi.scale
        else:
            qbp = qb.astype(cdtype)
        if dp != d:  # zero pad lanes contribute 0 to the distance
            qbp = jnp.pad(qbp, [(0, 0), (0, dp - d)])
        diff = qbp[:, None, None, :] - pc
        dd = jnp.sum(diff * diff, axis=-1).astype(dtype)  # (B, T, Lt)
        if pi.scale is not None:
            dd = dd * (pi.scale * pi.scale).astype(dd.dtype)
        # slots >= live_bound are sentinels (tail padding AND relocated
        # tombstones — packed() sorts dead points past every bucket), so
        # the sentinel mask is purely positional.  Masking BEFORE the
        # per-table top-k matters for the int8 tier: its dead slots are
        # zero rows at finite distance and would otherwise displace real
        # candidates (near-origin queries) before the id map caught them.
        live = pi.live_bound
        dd = jnp.where(pos < live, dd, jnp.asarray(jnp.inf, dd.dtype))
        tpos, tdist = dedup_topk(pos, dd, kk, n_pad)  # (B, T, kk) positional
        # real ids for the T*k winners only
        gpos = tpos + (jnp.arange(tries, dtype=itype) * n_pad)[None, :, None]
        wids = ids_flat[jnp.minimum(gpos, ids_flat.shape[0] - 1)]
        wids = jnp.where(jnp.isinf(tdist), n, wids)
        # belt-and-braces: any sentinel-id slot that slipped through at a
        # finite distance (none should — the positional live_bound mask
        # runs before the top-k) is re-asserted to +inf
        tdist = jnp.where(wids == n, jnp.asarray(jnp.inf, tdist.dtype), tdist)
        t1, td1 = dedup_topk(
            wids.reshape(B, -1), tdist.reshape(B, -1), kk, n
        )
        if pi.scale is not None:
            # quantized ranking is ~7-bit: re-score the merged pool against
            # the float corpus so ordering and supercharge seeds are exact
            qd0 = qb if points.shape[1] == d else jnp.pad(
                qb, [(0, 0), (0, points.shape[1] - d)])
            t1, td1 = dedup_topk(t1, candidate_dists(qd0, points, t1), kk, n)
        for _ in range(supercharge_rounds):
            safe = jnp.where(t1 < n, t1, 0)
            exp = jnp.where((t1 < n)[..., None], pi.graph[safe], n)
            cand2 = jnp.concatenate([t1, exp.reshape(-1, kk * k)], axis=-1)
            # the corpus may be a stage_points buffer ((n+1, lane_dim) with
            # a +inf sentinel row): zero query lanes add 0, and its extra
            # row only widens candidate_dists' validity bound to admit the
            # sentinel id — whose +inf row yields +inf anyway
            qd = qb if points.shape[1] == d else jnp.pad(
                qb, [(0, 0), (0, points.shape[1] - d)])
            dd2 = candidate_dists(qd, points, exp.reshape(-1, kk * k))
            dd2 = jnp.concatenate([td1, dd2], axis=-1)
            t1, td1 = dedup_topk(cand2, dd2, kk, n)
        if kk != k:
            t1, td1 = t1[:, :k], td1[:, :k]
        return t1, td1

    return blocked_over_rows(
        stage, m, block_rows, q, codes, proj, pad_values=(0.0, 0, 0.0)
    )


_search_packed_jit = partial(
    jax.jit,
    static_argnames=(
        "block_rows", "n_probes", "supercharge_rounds", "rerank_width"
    ),
)(search_packed_impl)


def _as_corpus(points, dtype):
    """Corpus array for the candidate-distance gathers.

    A low-precision float corpus (bf16/f16) is kept as stored: the
    distance passes gather small candidate blocks and upcast them via type
    promotion (f32 query - bf16 candidates -> f32 math), so the corpus
    never materializes at full width.  Everything else is cast to the
    index dtype."""
    points = jnp.asarray(points)
    if points.dtype in (jnp.bfloat16, jnp.float16):
        return points
    return points.astype(dtype)


def search_packed(
    pindex: PackedIndex,
    points=None,
    queries=None,
    *,
    budget_bytes: int = 128 << 20,
    block_rows: int | None = None,
    n_probes: int | None = None,
    supercharge_rounds: int = 1,
    rerank_width: int | None = None,
) -> tuple[jax.Array, jax.Array]:
    """High-throughput search over a packed view (``index.packed()``).

    Same contract as :func:`search` — (ids, squared dists), sentinel n
    padding — with the packed candidate superset semantics.  ``points`` is
    only needed for the supercharge distance pass; the view stores it by
    default.  The serve-time knobs: ``pindex.with_window(w)`` (read depth),
    ``n_probes`` (probe count, None = blind Hamming-1 set), and
    ``rerank_width`` (widened candidate pool, see :func:`search`).
    """
    if queries is None:
        points, queries = None, points
    if points is None:
        if pindex.points is None:
            raise ValueError(
                "packed view does not store points; pass the build-time "
                "point matrix or pack with store_points=True"
            )
        points = pindex.points
    if pindex.metric != "l2":
        from ..data.preprocess import prepare_points

        queries = prepare_points(
            jnp.asarray(queries, pindex.bases.dtype), pindex.metric
        )
    m = queries.shape[0]
    if block_rows is None:
        P = pindex.d_short + 1 if n_probes is None else n_probes
        ltot = pindex.tries * P * pindex.rows_per_probe() * pindex.super_width
        block_rows = pick_block(
            m, ltot, pindex.d, jnp.dtype(pindex.bases.dtype).itemsize,
            budget_bytes,
        )
    points = _as_corpus(points, pindex.bases.dtype)
    queries = jnp.asarray(queries, pindex.bases.dtype)
    return _search_packed_jit(pindex, points, queries, block_rows=block_rows,
                              n_probes=n_probes,
                              supercharge_rounds=supercharge_rounds,
                              rerank_width=rerank_width)


def search(
    index: ANNIndex,
    points=None,
    queries=None,
    *,
    budget_bytes: int = 128 << 20,
    block_rows: int | None = None,
    n_probes: int | None = None,
    supercharge_rounds: int = 1,
    rerank_width: int | None = None,
    chunked: bool | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Find the k approximate nearest neighbors of each query.

    ``chunked``: None (default) auto-selects the host-chunked driver when
    points+tables+graph exceed ~5 GB (one monolithic program over those
    arguments OOMs at compile time from rematerializer layout copies —
    see `_search_chunked`); True/False forces.  Results are identical.

    ``rerank_width``: keep this many candidates (>= k) through the merge
    and supercharge stages instead of k, reducing to k only at the very
    end.  The wider pool feeds supercharge more seeds (graph rows of the
    top ``rerank_width``), buying recall for ~(width/k)x supercharge cost
    with zero extra bucket reads; None = k (reference behavior).

    ``supercharge_rounds``: graph-expansion rounds after the bucket
    candidates (the reference runs exactly 1, ``alg.c:507-512``); more
    rounds walk the kNN graph further — a cheap recall knob now that the
    stored graph is exact (each round costs one k*k gather + distance
    pass).  0 disables supercharge entirely.

    Mirrors ``query`` (``ann.h:61-62``): ``points`` must be the same array
    the index was built over (the index stores ids, not vectors), or None
    to use points stored in the index (``build(store_points=True)``; always
    the case for metric='angular').  Queries are metric-preprocessed to
    match the build.  Returns (ids (m, k) int32 with sentinel n padding,
    squared distances (m, k) — on normalized vectors for angular).

    ``n_probes``: None = the reference's probe set (own bucket + every
    Hamming-1 bucket per table); an int enables query-directed multiprobe
    (own + that many cheapest 1/2-bit flips) — more recall per probe, or
    fewer probes at equal recall (quality/throughput knob).
    """
    if queries is None:  # search(index, queries) convenience form
        points, queries = None, points
    if index.tables is None:
        raise ValueError(
            "tables dropped (drop_tables): this index serves through its "
            "packed view only (search_packed)"
        )
    if points is None:
        if index.points is None:
            raise ValueError(
                "index does not store points; pass the build-time point "
                "matrix or build with store_points=True"
            )
        points = index.points
    if index.metric != "l2":
        from ..data.preprocess import prepare_points

        queries = prepare_points(jnp.asarray(queries, index.bases.dtype), index.metric)
    m = queries.shape[0]
    P = index.d_short + 1 if n_probes is None else n_probes
    if chunked is None:
        big = (
            index.n * index.d * jnp.dtype(index.bases.dtype).itemsize
            + index.tables.size * 4 + index.graph.size * 4
        ) > _ONE_SHOT_MAX_BYTES
        chunked = bool(big) and index.d_short > 0
    if block_rows is None:
        ltot = (1 if chunked else index.tries) * P * index.tmax
        block_rows = pick_block(
            m, ltot, index.d, jnp.dtype(index.bases.dtype).itemsize, budget_bytes
        )
    points = _as_corpus(points, index.bases.dtype)
    queries = jnp.asarray(queries, index.bases.dtype)
    if chunked:
        return _search_chunked(
            index, points, queries, block_rows=block_rows, n_probes=n_probes,
            supercharge_rounds=supercharge_rounds, rerank_width=rerank_width,
        )
    return _search_jit(index, points, queries, block_rows=block_rows,
                       n_probes=n_probes,
                       supercharge_rounds=supercharge_rounds,
                       rerank_width=rerank_width)
