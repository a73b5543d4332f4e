"""The ANN index structure — the ``save_t`` of this library.

Mirrors ``save_t`` (``/root/reference/ann.h:8-12``) as a pytree of on-device
arrays so it can be jitted over, donated, and sharded:

    reference field          -> here
    ------------------------------------------------------------------
    tries, n, k, d_short,
    d_long                   -> static metadata (pytree aux data)
    row_means (d)            -> row_means (d,)
    bases (tries*ds*d)       -> bases (tries, d_short, d)
    which_par[i] (ragged,
      2^ds x par_maxes[i])   -> tables (tries, 2^d_short, tmax), common
                                tmax = max_i par_maxes[i]; counts keeps the
                                true per-bucket occupancy so the ragged form
                                (and true index memory) is recoverable
    par_maxes (tries)        -> derivable: counts.max(axis=1)
    graph (n, k)             -> graph (n, k) int32

Unlike the reference (in-memory only, ``ann.h`` has no serialization), the
index can be saved/loaded — a new capability, via ``.npz``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


from functools import partial


@jax.jit
def _codes_chunk(points_chunk, row_means, bases):
    """Hash codes for a row chunk — one jit so the centered copy and
    projection stay chunk-sized transients (convention: query_codes)."""
    from .ops.hash import query_codes

    return query_codes(row_means, bases, points_chunk)[0]


def stage_points(points, dtype=None) -> jax.Array:
    """Stage a corpus for :meth:`ANNIndex.packed(..., staged=True)`:
    (n, d) -> (n + 1, d_pad) in ``dtype`` (default: the corpus dtype),
    lane-padded to a 128 multiple with a +inf sentinel row at index n.
    Use when the raw corpus and the packed buffer cannot coexist in
    device memory: stage, free the raw corpus, then pack."""
    points = jnp.asarray(points)
    d = points.shape[1]
    dtype = jnp.dtype(points.dtype if dtype is None else dtype)
    return _storage_points(points, dtype, -(-d // 128) * 128)


@partial(jax.jit, static_argnames=("dtype", "d_pad"))
def _storage_points(points, dtype, d_pad):
    """(n, d) -> (n + 1, d_pad) storage-dtype copy of the corpus: lanes
    zero-padded to ``d_pad`` (a 128 multiple; zero pad lanes add zero to
    distances against zero-padded queries), plus a +inf sentinel row at
    index n.  Sentinel slots (CSR padding, tombstones — both carry id n)
    then *gather* their +inf vector directly, upholding the global
    sentinel invariant with no post-gather select (a select would
    materialize a second full-size packed copy)."""
    n, d = points.shape
    pts = points.astype(dtype)
    if d_pad != d:
        pts = jnp.pad(pts, [(0, 0), (0, d_pad - d)])
    return jnp.concatenate([pts, jnp.full((1, d_pad), jnp.inf, dtype)])


@partial(jax.jit, static_argnames=("d_pad",))
def _quantize_points(points, scale, d_pad):
    """(n, d) float -> (n + 1, d_pad) int8 storage copy: symmetric
    quantization ``round(x / scale)`` clipped to [-127, 127] (scale a ()
    f32 scalar, computed by the caller as max|x| / 127 so the grid covers
    the corpus).  int8 has no +inf, so the sentinel row stores zeros —
    sentinel slots are instead excluded by the positional ``live_bound``
    mask and the id map (id == n -> +inf), see ``search_packed_impl``.
    Lane padding is zero like the float form (distance-neutral)."""
    from .ops.distance import _quantize_block

    n, d = points.shape
    q = _quantize_block(points, scale)  # THE quantization convention
    if d_pad != d:
        q = jnp.pad(q, [(0, 0), (0, d_pad - d)])
    return jnp.concatenate([q, jnp.zeros((1, d_pad), jnp.int8)])


@jax.jit
def _packed_rows(pts_s, ids):
    """Gather packed rows: (tries, n_pad) slot ids -> (tries*n_pad, d_pad).

    Stored FLAT, one point per row: merging ``super_width`` points into one
    wide row can be a physical relayout, a second full-size copy.  The
    search gathers ``super_width`` consecutive slot rows per super-row
    instead of one wide row.  Peak memory = storage corpus + packed
    buffer."""
    n = pts_s.shape[0] - 1
    return pts_s[jnp.minimum(ids.reshape(-1), n)]


@partial(jax.jit, donate_argnums=(0,))
def _fill_rows(buf, pts_s, ids_t, row0):
    """One table's packed-row gather written in place (buf donated)."""
    n = pts_s.shape[0] - 1
    part = pts_s[jnp.minimum(ids_t, n)]
    return jax.lax.dynamic_update_slice(buf, part, (row0, jnp.int32(0)))


def _packed_rows_big(pts_s, ids, n_pad):
    """Huge-pack variant of :func:`_packed_rows`: one donated
    dynamic_update_slice per table, each completed before the next is
    queued, so the working set is ONE table's gather (a single
    whole-buffer gather stacks its full multi-GB output on top of
    everything live; per table the transient is tries-times smaller)."""
    tries = ids.shape[0]
    buf = jax.block_until_ready(
        jnp.zeros((tries * n_pad, pts_s.shape[1]), pts_s.dtype))
    for t in range(tries):
        buf = jax.block_until_ready(
            _fill_rows(buf, pts_s, ids[t], jnp.int32(t * n_pad)))
    return buf


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ANNIndex:
    # array leaves
    row_means: Any  # (d,) ftype
    bases: Any  # (tries, d_short, d) ftype
    tables: Any  # (tries, 2^d_short, tmax) int32, sentinel = n
    counts: Any  # (tries, 2^d_short) int32 true occupancy
    graph: Any  # (n, k) int32, sentinel = n
    # static metadata
    n: int = dataclasses.field(metadata=dict(static=True))
    k: int = dataclasses.field(metadata=dict(static=True))
    d: int = dataclasses.field(metadata=dict(static=True))
    d_short: int = dataclasses.field(metadata=dict(static=True))
    tries: int = dataclasses.field(metadata=dict(static=True))
    tmax: int = dataclasses.field(metadata=dict(static=True))
    # optional stored (preprocessed) point matrix: the reference never keeps
    # vectors in save_t (callers re-pass them, ann.h:61-62); storing them is
    # a new serving convenience and is REQUIRED for metric="angular", where
    # search must run against the normalized copy.
    points: Any = None  # (n, d) ftype or None
    # tombstone mask from remove_points: (n + 1,) bool, True = removed
    # (slot n is the sentinel, always False).  None = no removals.  Kept as
    # durable index state so derived views (packed()) and later add_points
    # calls keep excluding removed ids — without it a packed() rebuild or a
    # new point's graph row would resurrect them from the raw point matrix.
    dead: Any = None
    metric: str = dataclasses.field(default="l2", metadata=dict(static=True))

    @property
    def n_buckets(self) -> int:
        return 1 << self.d_short

    # ------------------------------------------------------------------
    # Streaming updates (new capability: the reference's save_t is
    # immutable — rebuilding is its only update path, ann.h:46-59).
    # Functional: each method returns a NEW index; the original is
    # untouched (pytrees are immutable).
    # ------------------------------------------------------------------

    def add_points(self, new_points, points=None, *,
                   repair_reverse_edges: bool = True) -> "ANNIndex":
        """Insert ``new_points`` (m, d) with ids n..n+m-1.

        Hash parameters (row_means, bases, d_short) stay frozen — new
        points are coded with the build-time transforms, appended to
        their buckets (first free slot; a FULL bucket drops the entry for
        that table only — it stays reachable via the other tables and the
        graph, the same overflow semantics as capacity-limited builds),
        and given exact graph rows against the grown corpus.

        ``repair_reverse_edges`` (default True): each old point
        that a new point claims as a near neighbor gets its graph row
        re-ranked over (current edges + all new points), so old rows can
        reach new points through supercharge without a rebuild.  This is
        the reverse-edge offer — it repairs exactly the rows some new
        point ranks among its own top-k; an old row whose true new
        neighbor is asymmetric (the new point is near u, but u is not in
        the new point's top-k) stays stale until rebuild, so recall still
        decays slowly with insert fraction.  Cost:
        one blocked (affected x m) distance pass; for very large insert
        batches pass False and rebuild instead.  Bucket sizing (d_short)
        is fixed at build time — rebuild when the corpus has grown past
        ~2x.  Requires stored points or ``points``.
        """
        from .ops.hash import query_codes

        if self.tables is None:
            raise ValueError(
                "tables dropped (drop_tables): updates need the padded "
                "tables — keep the original index for add/remove"
            )
        if points is None:
            points = self.points
        if points is None:
            raise ValueError(
                "add_points needs the current point matrix: pass it or "
                "build with store_points=True"
            )
        points = jnp.asarray(points)
        dtype = self.bases.dtype
        new_points = jnp.asarray(new_points, dtype)
        if self.metric != "l2":
            from .data.preprocess import prepare_points

            new_points = prepare_points(new_points, self.metric)
        m, d = new_points.shape
        n_old, n_new = self.n, self.n + m
        all_points = jnp.concatenate([points.astype(dtype), new_points])

        # sentinel rewrite: every n_old sentinel becomes n_new
        tables = jnp.where(self.tables == n_old, n_new, self.tables)
        graph = jnp.where(self.graph == n_old, n_new, self.graph)

        codes, _ = query_codes(self.row_means, self.bases, new_points)

        # device-side bulk append: per table, rank each new point within
        # its bucket (argsort + searchsorted, the build_table idiom) and
        # scatter to slot counts[b] + rank; slots >= tmax are dropped by
        # the out-of-bounds scatter (same overflow semantics as the
        # capacity-limited build), while counts keeps true occupancy.
        def _append(table_t, counts_t, codes_t):
            order = jnp.argsort(codes_t, stable=True).astype(jnp.int32)
            sc = codes_t[order]
            first = jnp.searchsorted(sc, sc, side="left").astype(jnp.int32)
            rank = jnp.arange(m, dtype=jnp.int32) - first
            slot = counts_t[sc].astype(jnp.int32) + rank
            table_t = table_t.at[sc, slot].set(
                (n_old + order).astype(table_t.dtype), mode="drop"
            )
            return table_t, counts_t.at[codes_t].add(1)

        tables, counts = jax.vmap(_append)(tables, self.counts, codes.T)

        # exact graph rows for the new points against the grown corpus:
        # ask for k+1, mask the self-match (dist 0, but a duplicate point
        # can displace it from slot 0 — mask by id, then re-sort), keep k
        from .ops.distance import exact_search

        # widen by the ACTUAL tombstone count (a new point landing inside
        # a removed cluster can see more than k dead rows among its
        # nearest; a fixed +k pads its graph row with sentinels while live
        # neighbors sit just outside the window).
        n_dead = 0 if self.dead is None else int(jnp.sum(self.dead))
        kk = min(self.k + 1 + n_dead, n_new)
        gnew, gd = exact_search(all_points, new_points, kk)
        gnew = jnp.asarray(gnew, jnp.int32)
        rows = (n_old + jnp.arange(m, dtype=jnp.int32))[:, None]
        drop = gnew == rows  # self-match
        if self.dead is not None:
            # removed points still sit in the raw matrix; keep them out of
            # the new points' graph rows (widened kk absorbs the holes)
            drop |= self.dead[jnp.clip(gnew, 0, n_old)] & (gnew < n_old)
        gd = jnp.where(drop, jnp.inf, jnp.asarray(gd, jnp.float32))
        gnew = jnp.where(drop, n_new, gnew)
        gd, gnew = jax.lax.sort((gd, gnew), dimension=-1, num_keys=1)
        gnew = gnew[:, : self.k]
        if gnew.shape[1] < self.k:
            pad = jnp.full((m, self.k - gnew.shape[1]), n_new, jnp.int32)
            gnew = jnp.concatenate([gnew, pad], axis=1)
        graph = jnp.concatenate([graph, gnew])

        if repair_reverse_edges:
            # reverse-edge offer: re-rank each AFFECTED old row (one some
            # new point ranks among its top-k) over its current edges +
            # every new point.  dedup_topk keeps the min-distance copy;
            # sentinel/dead ids in current rows are already >= n_old and
            # rank +inf through candidate_dists' validity bound.
            import numpy as np

            from .ops.distance import (
                blocked_over_rows,
                candidate_dists,
                pick_block,
            )
            from .ops.topk import dedup_topk

            aff = np.unique(np.asarray(gnew))
            aff = aff[aff < n_old]
            if self.dead is not None and aff.size:
                aff = aff[~np.asarray(self.dead)[aff]]
            if aff.size:
                aff_d = jnp.asarray(aff, jnp.int32)
                new_ids = n_old + jnp.arange(m, dtype=jnp.int32)

                def repair_stage(qb, curb, rr):
                    cand = jnp.concatenate(
                        [curb,
                         jnp.broadcast_to(new_ids[None], (qb.shape[0], m))],
                        axis=-1,
                    )
                    dd = candidate_dists(qb, all_points, cand,
                                         exclude_self=rr)
                    gi, _ = dedup_topk(cand, dd, self.k, n_new)
                    return gi

                block = pick_block(aff.size, self.k + m, d, 4)
                gi = blocked_over_rows(
                    repair_stage, aff.size, max(1, min(block, aff.size)),
                    all_points[aff_d], graph[aff_d], aff_d,
                    pad_values=(0.0, 0, -1),
                )
                graph = graph.at[aff_d].set(gi)

        dead = self.dead
        if dead is not None:  # extend: new points are live, slot n_new = sentinel
            dead = jnp.concatenate([dead[:n_old], jnp.zeros((m + 1,), bool)])
        return dataclasses.replace(
            self, tables=tables, counts=counts, graph=graph, n=n_new,
            points=all_points if self.points is not None else None, dead=dead,
        )

    def remove_points(self, ids) -> "ANNIndex":
        """Tombstone the given point ids: they are dropped from every
        bucket and graph edge and can never be returned again — including
        through later ``packed()`` views and ``add_points`` graph rows,
        which consult the stored ``dead`` mask.  Their rows in the point
        matrix become unreachable (memory is reclaimed at the next
        rebuild); n and live ids are unchanged.
        """
        if self.tables is None:
            raise ValueError(
                "tables dropped (drop_tables): updates need the padded "
                "tables — keep the original index for add/remove"
            )
        ids = jnp.asarray(ids, jnp.int32).reshape(-1)
        dead = self.dead
        if dead is None:
            dead = jnp.zeros((self.n + 1,), bool)
        dead = dead.at[jnp.clip(ids, 0, self.n)].set(True)
        dead = dead.at[self.n].set(False)  # slot n = sentinel, never dead
        sent = jnp.asarray(self.n, self.tables.dtype)
        tables = jnp.where(dead[self.tables], sent, self.tables)
        graph = jnp.where(dead[self.graph], sent, self.graph)
        # dead points' own graph rows are unreachable but cleared anyway
        graph = jnp.where(dead[: self.n, None], sent, graph)
        return dataclasses.replace(self, tables=tables, graph=graph, dead=dead)

    def packed(
        self,
        points=None,
        *,
        window: int | None = None,
        super_width: int = 2,
        dtype=None,
        store_points: bool = True,
        staged: bool = False,
    ) -> "PackedIndex":
        """Build the packed serving view — the high-throughput query layout.

        The table path gathers candidate ids and then their vectors, two
        dependent row gathers per candidate.  The packed view stores each
        table's points contiguously by bucket (CSR, exactly n slots per
        table — no capacity padding, no overflow drops), one point per
        lane-aligned row; serve-time reads group slots into *logical*
        super-rows of ``super_width`` points (alignment granularity — the
        storage stays flat, see :func:`_packed_rows`).  A probe gathers
        the aligned slots covering ``[start, start + window)`` and gets
        the candidate *vectors* directly — skipping the padded table
        path's second gather through point ids.
        Super-rows swept in by alignment spill across bucket boundaries;
        the extra entries are real points and simply join the candidate
        pool (dedup keeps min-distance copies), so the packed path's
        candidate set is a superset of the padded table's at
        ``window >= tmax``.

        ``window``: per-probe read depth in points (default: this view's
        ``tmax``) — the serve-time speed/recall knob, like ``with_depth``.
        ``dtype``: storage dtype of the packed vectors (default: the index
        float dtype; ``jnp.bfloat16`` halves gather bandwidth, distances are
        then bf16-accurate — rerank externally if that matters).
        ``jnp.int8`` quantizes symmetrically (scale = max|x| / 127, kept on
        the view) — a quarter of f32 bytes per slot, so at a
        bandwidth-bound operating point it buys fewer bytes per candidate
        or twice the ``tries`` replication; candidate ranking is then
        ~7-bit accurate, so pair it with ``rerank_width`` + a float corpus
        (``points``/staged buffer) to restore exact top-k ordering.
        ``points``: the build-time point matrix (or None to use stored).
        ``store_points`` keeps the raw points on the view for supercharge +
        serving convenience.
        ``staged``: ``points`` is already a staging buffer from
        :func:`stage_points` — (n + 1, d_pad) in the storage dtype with a
        +inf sentinel row.  Where the f32 corpus cannot coexist with the
        packed buffer on one device: stage first, free the f32 corpus,
        then pack.  Hash codes are then recomputed from the
        storage-dtype values (sign flips on near-zero projections are
        possible but self-consistent — the CSR starts match the packed
        order, and query-side codes come from the query pipeline).
        With ``store_points=True`` the staging buffer itself is kept as the
        view's corpus: the packed search paths lane-pad queries and treat
        the +inf sentinel row correctly, so supercharge/rerank run against
        it directly — no second corpus resident (the 10M serving budget).
        """
        if points is None:
            points = self.points
        if points is None:
            raise ValueError(
                "packed() needs the build-time points: pass them or build "
                "with store_points=True"
            )
        points = jnp.asarray(points)
        if window is None:
            window = self.tmax
        window = max(1, int(window))
        w = max(1, int(super_width))
        d = int(self.bases.shape[2]) if staged else points.shape[1]
        quantize = dtype is not None and jnp.dtype(dtype) == jnp.int8
        if staged:
            if points.dtype == jnp.int8:
                raise ValueError(
                    "staged int8 buffers cannot be re-packed (hash codes "
                    "need the float values); stage to bf16/f32 and pass "
                    "dtype=jnp.int8"
                )
            dtype = jnp.dtype(jnp.int8) if quantize else points.dtype
            n = points.shape[0] - 1
        else:
            dtype = jnp.dtype(points.dtype if dtype is None else dtype)
            n = points.shape[0]
        # ceil over n+1 (slot for sentinel id n), rounded up to whole
        # super-rows of w slots
        n_pad = -(-(n + 1) // w) * w
        from .ops.buckets import pack_tables

        # codes are recomputed from the stored bases (cheap: one matmul);
        # avoids persisting build-time codes on the index.  Chunked over
        # rows: eagerly the centered copy (n x d) + projection (n x
        # tries*d_short) each materialize — 6+ GB at 10M next to the
        # corpus; per-chunk transients are
        # ~1/10th and the codes output is tiny (n x tries int32)
        d_pad = -(-d // 128) * 128
        big = self.tries * n_pad * d_pad * jnp.dtype(dtype).itemsize > (2 << 30)
        if self.d_short:
            chunk = 1 << 20
            parts = []
            for lo in range(0, n, chunk):
                c = _codes_chunk(points[lo: min(lo + chunk, n), :d],
                                 self.row_means, self.bases)
                if big:
                    # unbounded enqueue-ahead would stack ~1 GB of
                    # transients per queued chunk ON TOP of the rows
                    # buffer allocated below
                    jax.block_until_ready(c)
                parts.append(c)
            codes = jnp.concatenate(parts)
        else:
            codes = jnp.zeros((n, self.tries), jnp.int32)
        n_live = n
        if self.dead is not None:
            # Relocate tombstoned points to the packed TAIL: give them a
            # past-the-end bucket code so the stable sort in pack_tables
            # places every dead slot after every live one.  Their packed
            # positions are then all >= n_live, and the purely positional
            # sentinel mask of the packed search (`pos < live`) excludes
            # them BEFORE the per-table top-k — which is the only correct
            # place for the int8 tier, whose zero sentinel rows otherwise
            # score a finite ||q/s||^2 and can displace real candidates
            # for near-origin queries.
            # Float tiers get the same treatment (their +inf rows were
            # already correct; tail relocation additionally stops most
            # windows from wasting read slots on dead entries — the LAST
            # bucket's CSR slice still extends to the implicit final
            # boundary n, so its probe windows can read into the relocated
            # tail: correctly masked, but those slots are spent).
            dead_rows = self.dead[:n]
            n_live = n - int(jnp.sum(dead_rows))
            codes = jnp.where(dead_rows[:, None], self.n_buckets, codes)
        order, starts = pack_tables(codes.T, self.n_buckets)
        pad = jnp.full((self.tries, n_pad - n), n, order.dtype)
        ids = jnp.concatenate([order, pad], axis=1)  # (tries, n_pad)
        if big:
            jax.block_until_ready((ids, starts))
        del codes, order, pad  # 0.5+ GB of dead int32 at 10M
        if self.dead is not None:
            # removed points keep their CSR slots (positions are the free
            # within-table ids) but can never be returned: sentinel id +
            # +inf vector makes their distance +inf in the diff^2 pass
            is_dead = self.dead[jnp.clip(ids, 0, n)]
            ids = jnp.where(is_dead, n, ids)
        scale = None
        if quantize:
            src = points[:-1] if staged else points
            scale = jnp.max(jnp.abs(src.astype(jnp.float32))) / 127.0
            pts_s = _quantize_points(src, scale, d_pad)
        else:
            pts_s = points if staged else _storage_points(points, dtype, d_pad)
        if big:
            jax.block_until_ready(pts_s)
            rows = _packed_rows_big(pts_s, ids, n_pad)
        else:
            rows = _packed_rows(pts_s, ids)
        del pts_s  # free the (n+1, d_pad) staging copy before returning
        return PackedIndex(
            row_means=self.row_means,
            bases=self.bases,
            point_rows=rows,
            ids=ids,
            starts=starts,
            graph=self.graph,
            points=points if store_points else None,
            scale=scale,
            n=n, k=self.k, d=d, d_short=self.d_short,
            tries=self.tries, window=window, super_width=w,
            metric=self.metric, d_pad=d_pad, n_live=n_live,
        )

    def with_depth(self, depth: int) -> "ANNIndex":
        """A view of this index whose bucket reads stop at ``depth`` slots.

        At query time the candidate gather reads ``P * tmax`` rows per
        table whether the buckets are full or not; on skewed corpora most
        of that is sentinel padding (e.g. capacity 245 vs mean occupancy
        7.6 at 1M points = ~97% waste).  Slicing the tables once yields a
        shallower index that searches proportionally faster at some recall
        cost — the cheap side of the capacity/recall knob, without a
        rebuild.  The slice materializes one new tables array; build once,
        reuse across searches.
        """
        if depth >= self.tmax:
            return self
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        return dataclasses.replace(
            self, tables=self.tables[:, :, :depth], tmax=depth
        )

    def drop_tables(self) -> "ANNIndex":
        """Free the padded probe tables for packed-serving-only flows.

        The padded tables are the big build artifact (tries * 2^d_short *
        capacity ids — 1.2 GB at 10M/tries=6/cap=48) and the packed view
        never reads them (:meth:`packed` recomputes the CSR from codes).
        When a corpus serves exclusively through ``search_packed``,
        dropping them first reclaims that device memory for the packed
        buffer.  The returned copy cannot run the table path (``search``)
        or be saved; build again (or keep the original) if you need both.
        """
        return dataclasses.replace(self, tables=None, counts=None)

    def par_maxes(self) -> np.ndarray:
        """Per-table max occupancy (reference ``save->par_maxes``,
        ``ann.h:10``), capped by the table capacity actually stored."""
        if self.counts is None:
            raise ValueError("tables dropped (drop_tables); par_maxes "
                             "needs the build-time occupancy counts")
        return np.minimum(np.asarray(self.counts).max(axis=1), self.tmax)

    def memory_bytes(self, ragged: bool = True) -> int:
        """Index memory. ragged=True prices tables at the reference's ragged
        layout (sum over tables of 2^d_short * par_maxes[i] ids) for
        equal-memory comparisons; ragged=False prices the padded on-device
        layout actually held in device memory."""
        f = np.dtype(self.row_means.dtype).itemsize
        base = self.row_means.size * f + self.bases.size * f + self.graph.size * 4
        if self.tables is None:
            tables = 0
        elif ragged:
            tables = int(self.par_maxes().sum()) * self.n_buckets * 4
        else:
            tables = self.tables.size * 4
        pts = 0 if self.points is None else self.points.size * f
        return int(base + tables + pts)

    def save(self, path: str) -> None:
        if self.tables is None:
            raise ValueError("tables dropped (drop_tables); a serving-only "
                             "index is not saveable — save before dropping")
        arrays = dict(
            tables=np.asarray(self.tables),
            counts=np.asarray(self.counts),
            graph=np.asarray(self.graph),
            meta=np.array([self.n, self.k, self.d, self.d_short, self.tries, self.tmax]),
            metric=np.array(self.metric),
        )
        _stash(arrays, "row_means", self.row_means)
        _stash(arrays, "bases", self.bases)
        if self.points is not None:
            _stash(arrays, "points", self.points)
        if self.dead is not None:
            arrays["dead"] = np.asarray(self.dead)
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path: str) -> "ANNIndex":
        return _load_annindex(cls, path)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PackedIndex:
    """The packed serving view of an :class:`ANNIndex` — see
    :meth:`ANNIndex.packed` for the layout rationale.

    Array leaves: ``point_rows (tries * n_pad, d_pad)`` packed candidate
    vectors in bucket-CSR order, stored FLAT — one point per lane-aligned
    row (see :func:`_packed_rows`; super-rows are a *logical* grouping the
    gather applies at serve time).  No
    id lanes — scoring dedups by packed *position*, which is free, and
    the real ids are gathered only for the few per-table winners.  ``ids
    (tries, n_pad)`` is the packed-slot -> original-id map (sentinel n
    pads the tail); ``starts (tries, 2^d_short)`` CSR bucket offsets into
    each table's n_pad-slot segment; plus the query-side fields shared
    with the padded index (``row_means``, ``bases``, ``graph``, optional
    raw ``points`` for supercharge).
    """

    row_means: Any
    bases: Any  # (tries, d_short, d)
    point_rows: Any  # (tries * n_pad, d_pad), float dtype, flat rows
    ids: Any  # (tries, n_pad) int32, sentinel n in padding slots
    starts: Any  # (tries, 2^d_short) int32
    graph: Any  # (n, k) int32
    points: Any  # (n, d) or None — needed at search time for supercharge
    n: int = dataclasses.field(metadata=dict(static=True))
    k: int = dataclasses.field(metadata=dict(static=True))
    d: int = dataclasses.field(metadata=dict(static=True))
    d_short: int = dataclasses.field(metadata=dict(static=True))
    tries: int = dataclasses.field(metadata=dict(static=True))
    window: int = dataclasses.field(metadata=dict(static=True))
    super_width: int = dataclasses.field(metadata=dict(static=True))
    metric: str = dataclasses.field(default="l2", metadata=dict(static=True))
    # stored vector lane dim: d zero-padded to a 128 multiple (zero pad
    # lanes are distance-neutral against zero-padded queries).  0 = views
    # packed before lane padding existed (lane dim == d).
    d_pad: int = dataclasses.field(default=0, metadata=dict(static=True))
    # live (non-tombstoned) point count: packed() relocates dead slots to
    # the tail of each table's CSR order, so positions >= n_live are
    # sentinels — the positional masks in every packed search path use
    # this bound, which is what keeps int8 dead slots (zero rows, finite
    # distance) from ever entering a per-table top-k.  0 = no tombstones
    # (live bound == n; also the value in legacy saved views).
    n_live: int = dataclasses.field(default=0, metadata=dict(static=True))
    # int8 storage tier: () f32 dequantization scale — stored rows are
    # round(x / scale) in [-127, 127], so true squared distances =
    # kernel-domain distances * scale^2 (queries enter as q / scale).
    # None for float tiers.
    scale: Any = None

    @property
    def live_bound(self) -> int:
        """Positions >= this are sentinel slots (tail padding and
        relocated tombstones)."""
        return self.n_live or self.n

    @property
    def lane_dim(self) -> int:
        return self.d_pad or self.d

    @property
    def n_buckets(self) -> int:
        return 1 << self.d_short

    @property
    def n_pad(self) -> int:
        """Slots per table (n+1 rounded up to lcm(super_width, 8))."""
        return self.point_rows.shape[0] // self.tries

    @property
    def n_rows(self) -> int:
        """Logical super-rows per table (the XLA gather grouping)."""
        return self.n_pad // self.super_width

    def rows_per_probe(self, window: int | None = None) -> int:
        """Aligned super-rows needed to cover ``[start, start + window)``
        for any start: ceil(window / w) + 1 (start can sit anywhere inside
        its first super-row)."""
        window = self.window if window is None else window
        return min(-(-window // self.super_width) + 1, self.n_rows)

    def with_window(self, window: int) -> "PackedIndex":
        """Same view, different per-probe read depth (free — the knob is
        how many aligned super-rows the query gathers per probe)."""
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        return dataclasses.replace(self, window=window)

    def memory_bytes(self) -> int:
        # read dtypes off the array objects — np.asarray would pull the
        # (multi-GB at 1M+) buffers device->host just to inspect them
        f = np.dtype(self.row_means.dtype).itemsize
        base = self.row_means.size * f + self.bases.size * f + self.graph.size * 4
        packed = (
            self.point_rows.size * np.dtype(self.point_rows.dtype).itemsize
            + self.ids.size * 4 + self.starts.size * 4
        )
        pts = 0 if self.points is None else self.points.size * f
        return int(base + packed + pts)

    def save(self, path: str) -> None:
        """Persist the packed view (npz) so serving restarts skip the
        re-pack.  bf16/f16 rows are stored as raw uint16 words plus a
        dtype tag (npz has no half-precision float support)."""
        rows = np.asarray(self.point_rows)
        row_dt = str(jnp.dtype(self.point_rows.dtype))
        if rows.dtype.itemsize == 2:
            rows = rows.view(np.uint16)
        arrays = dict(
            point_rows=rows,
            row_dtype=np.array(row_dt),
            ids=np.asarray(self.ids),
            starts=np.asarray(self.starts),
            graph=np.asarray(self.graph),
            meta=np.array([self.n, self.k, self.d, self.d_short, self.tries,
                           self.window, self.super_width, self.d_pad,
                           self.n_live]),
            metric=np.array(self.metric),
        )
        _stash(arrays, "row_means", self.row_means)
        _stash(arrays, "bases", self.bases)
        if self.points is not None:
            # the staged-serving corpus is bf16 in the 10M budget — stash
            # handles the npz-unrepresentable half dtypes
            _stash(arrays, "points", self.points)
        if self.scale is not None:
            arrays["scale"] = np.asarray(self.scale, np.float32)
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path: str) -> "PackedIndex":
        z = np.load(path)
        meta = [int(v) for v in z["meta"]]
        if len(meta) == 8:  # legacy views predate the n_live field
            meta.append(0)
        n, k, d, d_short, tries, window, w, d_pad, n_live = meta
        rows = jnp.asarray(z["point_rows"])
        row_dt = jnp.dtype(str(z["row_dtype"]))
        if rows.dtype == jnp.uint16:
            rows = jax.lax.bitcast_convert_type(rows, row_dt)
        return cls(
            row_means=_unstash(z, "row_means"),
            bases=_unstash(z, "bases"),
            point_rows=rows,
            ids=jnp.asarray(z["ids"]),
            starts=jnp.asarray(z["starts"]),
            graph=jnp.asarray(z["graph"]),
            points=_unstash(z, "points"),
            scale=jnp.asarray(z["scale"]) if "scale" in z else None,
            n=n, k=k, d=d, d_short=d_short, tries=tries, window=window,
            super_width=w, metric=str(z["metric"]), d_pad=d_pad,
            n_live=n_live,
        )


def _stash(arrays: dict, key: str, arr) -> None:
    """npz-safe array store: 2-byte float dtypes go as raw uint16 words +
    a '<key>_dtype' tag (numpy silently writes ml_dtypes bfloat16 as void
    'V2', which jnp.asarray then rejects at load — measured on the bf16
    staged-corpus tier)."""
    tag = str(jnp.dtype(arr.dtype))
    a = np.asarray(arr)
    if a.dtype.itemsize == 2:
        arrays[key] = a.view(np.uint16)
        arrays[key + "_dtype"] = np.array(tag)
    else:
        arrays[key] = a


def _unstash(z, key: str, default=None):
    """Inverse of :func:`_stash`; raw (untagged) arrays load unchanged."""
    if key not in z:
        return default
    a = jnp.asarray(z[key])
    tk = key + "_dtype"
    if tk in z and a.dtype == jnp.uint16:
        a = jax.lax.bitcast_convert_type(a, jnp.dtype(str(z[tk])))
    return a


def _load_annindex(cls, path: str) -> "ANNIndex":
    z = np.load(path)
    n, k, d, d_short, tries, tmax = (int(v) for v in z["meta"])
    return cls(
        row_means=_unstash(z, "row_means"),
        bases=_unstash(z, "bases"),
        tables=jnp.asarray(z["tables"]),
        counts=jnp.asarray(z["counts"]),
        graph=jnp.asarray(z["graph"]),
        n=n, k=k, d=d, d_short=d_short, tries=tries, tmax=tmax,
        points=_unstash(z, "points"),
        dead=jnp.asarray(z["dead"]) if "dead" in z else None,
        metric=str(z["metric"]) if "metric" in z else "l2",
    )
