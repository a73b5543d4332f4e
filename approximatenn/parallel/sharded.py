"""Distributed (multi-device) index build and query.

The reference has no distributed layer at all (SURVEY.md §2.3); its scale
axis — dataset size n — caps out at single-device memory.  This module is
the replacement: points, bucket tables, and the kNN graph are row-sharded
over a ``jax.sharding.Mesh``; queries are replicated; each shard searches
its local sub-index and the per-shard top-k are merged with one
``all_gather`` (NCCL on NVIDIA GPUs) followed by a final top-k.  Because every
point lives on exactly one shard, global ids are unique across shards and
the merge needs no dedup.

Design (SURVEY.md §7.4): shard points, build fully independent per-shard
tables/graphs (local bucket statistics — tmax/recall differ slightly from a
global build; gated by tests), fan queries out, merge.  The exact-merge
property holds for the final k-NN of whatever candidates each shard
produces: distributed recall ≈ single-device recall, and distributed
*exact* search (``search_exact_sharded``) equals global brute force
bit-for-bit in id-set terms.

The sharded layer carries the FULL single-device engine: exact kNN graph
per shard (``graph_mode="exact"``), ``metric="angular"``, directed
probing, ``rerank_width``/``supercharge_rounds`` on every query path, and
host-chunked per-shard drivers so shard sizes in the millions keep every
device program and its workspace bounded (same thresholds as the
single-device ``engine/build.py`` drivers).  n that does not divide the shard count is
zero-padded internally (pad rows are masked out of every result; the
reference's ``precomp`` accepts any n, ``ann.h:46-49``).

All functions also run unsharded on a 1-device mesh, and on a CPU mesh via
``--xla_force_host_platform_device_count`` (how the tests and the driver's
``dryrun_multichip`` validate them without accelerators).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import itype
from ..engine.build import graph_stage, hash_points, sample_bases
from ..engine.search import search_impl
from ..index import ANNIndex
from ..ops.buckets import bucket_counts
from ..ops.distance import pick_block
from ..ops.topk import topk_no_dedup

AXIS = "shards"


def make_mesh(n_devices: int | None = None, axis: str = AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedIndex:
    """Per-shard sub-indexes, stacked on a leading shard axis.

    ``tables``/``graph`` hold *local* ids in [0, n_local] with sentinel
    n_local; ``offsets[s] = s * n_local`` maps them to global ids.  ``n``
    is the TRUE corpus size; ``n_local * n_shards`` may exceed it by up to
    ``n_shards - 1`` zero pad rows (their global ids >= n are masked to
    the sentinel in every search path)."""

    row_means: Any  # (d,) replicated
    bases: Any  # (tries, d_short, d) replicated
    tables: Any  # (S, tries, 2^ds, tmax) sharded on axis 0
    counts: Any  # (S, tries, 2^ds)
    graph: Any  # (S, n_local, k) local ids
    n: int = dataclasses.field(metadata=dict(static=True))
    n_local: int = dataclasses.field(metadata=dict(static=True))
    k: int = dataclasses.field(metadata=dict(static=True))
    d: int = dataclasses.field(metadata=dict(static=True))
    d_short: int = dataclasses.field(metadata=dict(static=True))
    tries: int = dataclasses.field(metadata=dict(static=True))
    tmax: int = dataclasses.field(metadata=dict(static=True))
    n_shards: int = dataclasses.field(metadata=dict(static=True))
    # the sharded layer carries the full single-device surface
    points: Any = None  # (S*n_local, d) row-sharded, metric-preprocessed
    metric: str = dataclasses.field(
        default="l2", metadata=dict(static=True)
    )

    def local_index(self, tables, counts, graph) -> ANNIndex:
        """View one shard's arrays as a standalone ANNIndex over its slice."""
        return ANNIndex(
            row_means=self.row_means, bases=self.bases, tables=tables,
            counts=counts, graph=graph, n=self.n_local, k=self.k, d=self.d,
            d_short=self.d_short, tries=self.tries, tmax=self.tmax,
        )

    @property
    def n_padded(self) -> int:
        return self.n_local * self.n_shards


def _shard_points(points, mesh, n_local: int | None = None):
    """Row-shard ``points`` over the mesh, zero-padding n up to a multiple
    of the shard count (to ``n_local * S`` when the index's ``n_local`` is
    given, so search-time corpora always match the build layout).  Pad
    rows are masked to the sentinel in ``_to_global``."""
    s = mesh.shape[AXIS]
    n = points.shape[0]
    if isinstance(points, jax.Array) and not points.is_fully_addressable:
        # already a global (multi-host) array: device_put can't cross
        # processes; the caller assembled it (process_local_array) and it
        # is row-sharded (and pre-padded) by construction
        if n % s:
            raise ValueError(
                f"multi-host corpus n={n} must be pre-padded to the shard "
                f"count {s} (see multihost.process_local_array)"
            )
        return points
    n_pad = -(-n // s) * s if n_local is None else n_local * s
    if n_pad < n:
        raise ValueError(
            f"corpus has {n} rows but the index was built over {n_pad}"
        )
    if n_pad != n:
        z = (np if isinstance(points, np.ndarray) else jnp)
        points = z.concatenate(
            [points, z.zeros((n_pad - n, points.shape[1]), points.dtype)]
        )
    return jax.device_put(points, NamedSharding(mesh, P(AXIS, None)))


@jax.jit
def _normalize_rows(x):
    """Row-normalize a sharded corpus in place (sharding propagates —
    elementwise + row reduce keep the row sharding).  Zero pad rows stay
    zero (eps guard in ``data.preprocess.normalize``)."""
    from ..data.preprocess import normalize

    return normalize(x)


def _replicate(arr, mesh, dtype=None):
    """Replicate an array over every device of `mesh`, including
    non-addressable ones (multi-host): each process contributes its
    identical local copy.  Single-process, an already-device-resident
    array is placed directly — forcing it through np.asarray would add a
    blocking device->host pull per call."""
    sharding = NamedSharding(mesh, P())
    if jax.process_count() > 1:
        arr = np.asarray(arr) if dtype is None else np.asarray(arr, dtype)
        return jax.make_array_from_process_local_data(sharding, arr, arr.shape)
    arr = jnp.asarray(arr) if dtype is None else jnp.asarray(arr, dtype)
    return jax.device_put(arr, sharding)


def build_sharded(
    points,
    k: int,
    *,
    mesh: Mesh,
    tries: int = 10,
    rots_before: int = 6,
    rot_len_before: int = 1,
    rots_after: int = 1,
    rot_len_after: int = 1,
    key=None,
    seed: int = 0,
    dtype=jnp.float32,
    capacity: int | str | None = None,
    budget_bytes: int = 128 << 20,
    metric: str = "l2",
    n_probes: int | None = None,
    store_points: bool | None = None,
    graph_mode: str = "auto",
    graph_precision: str = "highest",
    chunked: bool | None = None,
    chunk_rows: int | None = None,
    progress=None,
) -> ShardedIndex:
    """Distributed index build (``precomp`` over a mesh; role of
    ``/root/reference/alg.c:342-434`` at SURVEY §2.3's scale).

    Points are row-sharded (n auto-padded to the shard count with masked
    zero rows); the mean is a global ``psum``; transform parameters are
    sampled once from ``key`` and replicated so all shards hash
    consistently; each shard builds tables + its kNN graph over its slice.

    Parity with the single-device :func:`~..engine.build.build`:

    - ``graph_mode``: "exact" computes each shard's TRUE local kNN graph
      by chunked exhaustive self-search (embarrassingly parallel — no
      collectives; lifts recall through serve-time supercharge).  "hash"
      is the reference's multiprobe approximation; "auto" = exact when
      n_local <= 16M and k <= 128 (the single-device policy applied at
      shard granularity).
    - ``graph_precision``: the exact engine's ``matmul_precision`` —
      "highest" (true f32 edge ranking) | "split3" (three bf16 passes,
      f32-faithful) | "default" (TF32 on NVIDIA GPUs) — exact mode only.
    - ``metric``: 'l2' | 'angular' (one row normalization up front; the
      normalized sharded corpus is stored on the index by default).
    - ``n_probes``: directed probing for the hash-graph build.
    - ``chunked``: None auto-selects host-chunked per-shard drivers above
      the same thresholds the single-device build trusts a monolithic
      program for (>4096 blocks or n_local > 2^18); True/False forces.
      Every chunk is one bounded program over ALL shards at once,
      completed before the next is queued.
    - ``chunk_rows``: rows per chunk (tests force tiny chunks with it).
    """
    from ..data.preprocess import METRICS
    from ..ops.transforms import derive_dims

    s = mesh.shape[AXIS]
    n, d = points.shape
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; want one of {METRICS}")
    if graph_mode not in ("auto", "exact", "hash"):
        raise ValueError(f"unknown graph_mode {graph_mode!r}")
    points = _shard_points(jnp.asarray(points, dtype), mesh)
    if metric == "angular":
        points = _normalize_rows(points)
    if store_points is None:
        store_points = metric != "l2"
    n_pad = points.shape[0]
    n_local = n_pad // s
    # bucket statistics follow the *local* slice size (per-shard tables)
    d_short, _ = derive_dims(n_local, k, d)
    if key is None:
        key = jax.random.key(seed)
    bases = sample_bases(
        key, d, d_short, tries, rots_before, rot_len_before,
        rots_after, rot_len_after, dtype,
    )

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(AXIS, None), P(None, None, None)),
        out_specs=(P(None), P(AXIS, None), P(AXIS, None, None)),
    )
    def stage_a(pts_l, bases_r):
        # divide by the TRUE n: pad rows are zero and don't move the sum
        mu = jax.lax.psum(jnp.sum(pts_l, axis=0), AXIS) / n
        codes = hash_points(pts_l - mu, bases_r)  # (tries, n_local)
        counts = jax.vmap(lambda c: bucket_counts(c, 1 << d_short))(codes)
        return mu, codes.T, counts[None]

    row_means, codes_g, counts = stage_a(points, bases)
    from ..engine.build import resolve_capacity

    tmax = resolve_capacity(counts, capacity)
    n_per_probe = d_short + 1 if n_probes is None else n_probes
    block_rows = pick_block(
        n_local, n_per_probe * tmax, d, jnp.dtype(dtype).itemsize,
        budget_bytes,
    )
    if graph_mode == "auto":
        graph_mode = "exact" if (n_local <= (1 << 24) and k <= 128) else "hash"

    if graph_mode == "exact":
        tables = _stage_tables(
            codes_g, mesh, d_short=d_short, tmax=tmax, n_local=n_local
        )
        graph = _exact_graph_sharded(
            points, k, mesh=mesh, n_local=n_local,
            chunk=chunk_rows or min(8192, n_local),
            precision=graph_precision, progress=progress,
        )
    else:
        total_blocks = (tries + 1) * -(-n_local // block_rows)
        use_chunked = (
            chunked if chunked is not None
            else (total_blocks > 4096 or n_local > (1 << 18))
        )
        if not use_chunked:
            @partial(
                jax.shard_map, mesh=mesh,
                in_specs=(P(AXIS, None), P(AXIS, None), P(AXIS, None, None),
                          P(None), P(None, None, None)),
                out_specs=(P(AXIS, None, None, None), P(AXIS, None, None)),
            )
            def stage_b(pts_l, codes_l, counts_l, mu, bases_r):
                tables, graph, _ = graph_stage(
                    pts_l, codes_l.T, counts_l[0], k=k, d_short=d_short,
                    tmax=tmax, block_rows=block_rows, n_probes=n_probes,
                    row_means=mu, bases=bases_r,
                )
                return tables[None], graph[None]

            tables, graph = stage_b(points, codes_g, counts, row_means, bases)
        else:
            tables = _stage_tables(
                codes_g, mesh, d_short=d_short, tmax=tmax, n_local=n_local
            )
            graph = _hash_graph_sharded_chunked(
                points, codes_g, tables, mesh=mesh, k=k, d_short=d_short,
                tmax=tmax, block_rows=block_rows, n_probes=n_probes,
                row_means=row_means, bases=bases, n_local=n_local,
                tries=tries,
                chunk=chunk_rows or min(_MAX_BLOCKS_PER_CALL * block_rows,
                                        n_local),
                progress=progress,
            )
    if n_pad != n:
        # pad rows out of every candidate source (see _mask_pad_locals)
        tables, graph = _mask_pad_locals(
            tables, graph, mesh, n=n, n_local=n_local
        )
    return ShardedIndex(
        row_means=row_means, bases=bases, tables=tables, counts=counts,
        graph=graph, n=n, n_local=n_local, k=k, d=d, d_short=d_short,
        tries=tries, tmax=tmax, n_shards=s,
        points=points if store_points else None, metric=metric,
    )


def _mask_pad_locals(tables, graph, mesh, *, n: int, n_local: int):
    """Exclude zero pad rows from every candidate source: local ids >= the shard's
    true row count become the local sentinel in BOTH the bucket tables
    and the graph edges.  Without this, a pad row — the zero vector,
    near the data on mean-centered corpora — can win per-shard top-k
    slots (or re-enter via supercharge's ``graph[cand]`` expansion)
    before ``_to_global`` masks it, silently shrinking results below k.
    Masked at the source, the approximate sharded paths need no local-k
    widening; ``_to_global`` stays as belt-and-braces.  (Pad rows may
    still occupy up to n_shards-1 capacity slots of the zero-vector's
    bucket at table build; with < n_shards pads this is noise.)"""

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS, None, None, None), P(AXIS, None, None)),
             out_specs=(P(AXIS, None, None, None), P(AXIS, None, None)))
    def go(tables_l, graph_l):
        s_i = jax.lax.axis_index(AXIS)
        # only the LAST shard can hold pads (< n_shards of them), so the
        # clip keeps the arithmetic safely in int32 at any pod scale
        valid = jnp.clip(n - s_i.astype(itype) * n_local, 0, n_local)
        valid = valid.astype(tables_l.dtype)
        t = jnp.where(tables_l >= valid, n_local, tables_l)
        g = jnp.where(graph_l >= valid.astype(graph_l.dtype), n_local,
                      graph_l)
        return t, g

    return go(tables, graph)


def _stage_tables(codes_g, mesh, *, d_short, tmax, n_local):
    """Per-shard bucket tables from the sharded (n_pad, tries) code
    matrix — shard-local sorts, no collectives."""
    from ..ops.buckets import build_tables

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(AXIS, None),),
             out_specs=P(AXIS, None, None, None))
    def go(codes_l):
        return build_tables(codes_l.T, 1 << d_short, tmax, n_local)[None]

    tables = go(codes_g)
    jax.block_until_ready(tables)  # stage boundary: vmapped sorts carry
    # multi-GB workspace at large shard sizes; cap live memory before the
    # graph chunks start enqueueing
    return tables


def _exact_graph_sharded(points, k, *, mesh, n_local, chunk, precision,
                         progress=None):
    """Each shard's TRUE local kNN graph by chunked exhaustive self-search
    (the sharded form of ``engine/build.py:exact_graph_chunked``): one
    bounded program per row chunk across all shards, each completed
    before the next is queued; per shard the XLA exact engine
    (self-excluded, ``precision``-tier ranking)."""
    from ..ops.distance import exact_search

    chunk = max(1, min(chunk, n_local))

    def make(mc):
        def body(pts_l, lo):
            q = jax.lax.dynamic_slice_in_dim(pts_l, lo, mc)
            rows = lo + jnp.arange(mc, dtype=itype)
            ids, dd = exact_search(pts_l, q, k, exclude=rows,
                                   matmul_precision=precision)
            return ids.astype(itype)[None], dd[None]

        return jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(P(AXIS, None), P()),
            out_specs=(P(AXIS, None, None), P(AXIS, None, None)),
        ))

    run = make(chunk)
    parts = []
    lo = 0
    while lo < n_local:
        m = min(chunk, n_local - lo)
        if m == chunk:
            ids, _ = run(points, jnp.asarray(lo, itype))
        else:
            # tail: recompute an overlapping full-sized chunk ending at
            # n_local and keep only the new rows (one compilation total)
            ids, _ = run(points, jnp.asarray(n_local - chunk, itype))
            ids = ids[:, chunk - m:]
        parts.append(ids)
        jax.block_until_ready(ids)  # one chunk's workspace live at a time
        if progress:
            progress(f"sharded exact graph rows {lo + m}/{n_local}")
        lo += m
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1)


def _hash_graph_sharded_chunked(points, codes_g, tables, *, mesh, k,
                                d_short, tmax, block_rows, n_probes,
                                row_means, bases, n_local, tries, chunk,
                                progress=None):
    """Host-orchestrated sharded hash-graph build: the sharded form of
    ``engine/build.py:graph_stage_chunked`` — identical per-shard results
    to the monolithic ``graph_stage``, with every device program bounded
    to one (row-chunk, table) and completed across all shards before the
    next is queued, so large shards never hold more than one program's
    workspace."""
    from ..ops.buckets import multiprobe_gather
    from ..ops.distance import blocked_over_rows, candidate_dists
    from ..ops.hash import probe_codes_directed
    from ..ops.topk import dedup_topk

    chunk = max(1, min(chunk, n_local))

    def make_probe(mc):
        def body(pts_l, tables_l, codes_l, t, lo, mu, bases_r):
            table = jax.lax.dynamic_index_in_dim(
                tables_l[0], t, keepdims=False
            )
            basis = jax.lax.dynamic_index_in_dim(bases_r, t, keepdims=False)
            codes_c = jax.lax.dynamic_index_in_dim(
                jax.lax.dynamic_slice_in_dim(codes_l, lo, mc), t,
                axis=1, keepdims=False,
            )
            rows = lo.astype(itype) + jnp.arange(mc, dtype=itype)

            def stage(qb, rr, cb):
                if n_probes is None:
                    cand = multiprobe_gather(table, cb, d_short)
                else:
                    proj = jnp.matmul(qb - mu, basis.T,
                                      precision=jax.lax.Precision.HIGHEST)
                    probes = probe_codes_directed(cb, proj, n_probes)
                    cand = table[probes].reshape(qb.shape[0], -1)
                dd = candidate_dists(qb, pts_l, cand, exclude_self=rr)
                return dedup_topk(cand, dd, k, n_local)

            qchunk = jax.lax.dynamic_slice_in_dim(pts_l, lo, mc)
            ids, dd = blocked_over_rows(
                stage, mc, min(block_rows, mc), qchunk, rows, codes_c,
                pad_values=(0.0, -1, 0),
            )
            return ids[None], dd[None]

        return jax.jit(jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(AXIS, None), P(AXIS, None, None, None),
                      P(AXIS, None), P(), P(), P(None), P(None, None, None)),
            out_specs=(P(AXIS, None, None), P(AXIS, None, None)),
        ))

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS, None, None), P(AXIS, None, None)),
             out_specs=(P(AXIS, None, None), P(AXIS, None, None)))
    def merge(cand_l, dd_l):
        gi, gd = dedup_topk(cand_l[0], dd_l[0], k, n_local)
        return gi[None], gd[None]

    merge_j = jax.jit(merge)

    def make_super(mc):
        def body(pts_l, g1_l, g1c_l, gd1c_l, lo):
            g1_full = g1_l[0]
            rows0 = lo.astype(itype) + jnp.arange(mc, dtype=itype)

            def final_stage(g1b, gd1b, rr):
                safe = jnp.where(g1b < n_local, g1b, 0)
                exp = jnp.where(
                    (g1b < n_local)[..., None], g1_full[safe], n_local
                )
                cand = jnp.concatenate(
                    [g1b, exp.reshape(-1, k * k)], axis=-1
                )
                dd_exp = candidate_dists(
                    pts_l[jnp.where(rr >= 0, rr, 0)], pts_l,
                    exp.reshape(-1, k * k), exclude_self=rr,
                )
                dd = jnp.concatenate([gd1b, dd_exp], axis=-1)
                return dedup_topk(cand, dd, k, n_local)

            ids, dd = blocked_over_rows(
                final_stage, mc, min(block_rows, mc), g1c_l[0], gd1c_l[0],
                rows0, pad_values=(0, jnp.inf, -1),
            )
            return ids[None], dd[None]

        return jax.jit(jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(AXIS, None), P(AXIS, None, None),
                      P(AXIS, None, None), P(AXIS, None, None), P()),
            out_specs=(P(AXIS, None, None), P(AXIS, None, None)),
        ))

    probe = make_probe(chunk)
    g1_parts, gd1_parts = [], []
    lo = 0
    while lo < n_local:
        m = min(chunk, n_local - lo)
        lo_eff = lo if m == chunk else n_local - chunk  # overlapping tail
        per_t = []
        for t in range(tries):
            ids, dd = probe(
                points, tables, codes_g, jnp.asarray(t, itype),
                jnp.asarray(lo_eff, itype), row_means, bases,
            )
            per_t.append((ids, dd))
            jax.block_until_ready(ids)  # one program's workspace live at a time
            if progress:
                progress(
                    f"sharded hash graph rows {lo}..{lo + m}/{n_local} "
                    f"table {t + 1}/{tries}"
                )
        cand1 = jnp.concatenate([p[0] for p in per_t], axis=-1)
        d1 = jnp.concatenate([p[1] for p in per_t], axis=-1)
        gi, gd = merge_j(cand1, d1)
        if m != chunk:
            gi, gd = gi[:, chunk - m:], gd[:, chunk - m:]
        g1_parts.append(gi)
        gd1_parts.append(gd)
        del per_t, cand1, d1
        jax.block_until_ready(gi)  # serialize chunks (enqueue-time workspace)
        lo += m
    g1 = (g1_parts[0] if len(g1_parts) == 1
          else jnp.concatenate(g1_parts, axis=1))
    gd1 = (gd1_parts[0] if len(gd1_parts) == 1
           else jnp.concatenate(gd1_parts, axis=1))
    g1_parts.clear()
    gd1_parts.clear()

    super_run = make_super(chunk)
    parts = []
    lo = 0
    while lo < n_local:
        m = min(chunk, n_local - lo)
        lo_eff = lo if m == chunk else n_local - chunk
        lo_t = jnp.asarray(lo_eff, itype)
        g1c = jax.lax.dynamic_slice_in_dim(g1, lo_eff, chunk, axis=1)
        gd1c = jax.lax.dynamic_slice_in_dim(gd1, lo_eff, chunk, axis=1)
        ids, _ = super_run(points, g1, g1c, gd1c, lo_t)
        if m != chunk:
            ids = ids[:, chunk - m:]
        parts.append(ids)
        jax.block_until_ready(ids)
        if progress:
            progress(f"sharded supercharge rows {lo + m}/{n_local}")
        lo += m
    del gd1, g1
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1)


def _to_global(ids_l, dists, n_local, n, offset):
    """Local ids -> global ids.  Masks BOTH the local sentinel (n_local)
    and zero pad rows (global id >= true n) to the global sentinel n with
    +inf distance."""
    g = ids_l + offset
    valid = (ids_l < n_local) & (g < n)
    return (jnp.where(valid, g, n).astype(itype),
            jnp.where(valid, dists, jnp.inf))


def _resolve_corpus(sidx: ShardedIndex, points, mesh):
    """The search-time corpus: the stored (metric-preprocessed, padded)
    sharded points when available / when None is passed, else the caller's
    matrix — sharded, padded to the build layout, normalized for angular."""
    if points is None:
        if sidx.points is None:
            raise ValueError(
                "index does not store points; pass the build-time point "
                "matrix or build with store_points=True"
            )
        return sidx.points
    points = _shard_points(points, mesh, n_local=sidx.n_local)
    if points.dtype != sidx.bases.dtype:
        points = points.astype(sidx.bases.dtype)
    if sidx.metric != "l2":
        points = _normalize_rows(points)
    return points


def _prep_queries(sidx: ShardedIndex, queries):
    from ..data.preprocess import prepare_points

    queries = jnp.asarray(queries, sidx.bases.dtype)
    if sidx.metric != "l2":
        queries = prepare_points(queries, sidx.metric)
    return queries


def search_sharded(
    sidx: ShardedIndex,
    points=None,
    queries=None,
    *,
    mesh: Mesh,
    budget_bytes: int = 128 << 20,
    block_rows: int | None = None,
    n_probes: int | None = None,
    supercharge_rounds: int = 1,
    rerank_width: int | None = None,
    chunked: bool | None = None,
):
    """Distributed batch query: replicate queries, per-shard local search,
    ``all_gather`` the per-shard top-k, final merge top-k
    (SURVEY.md §2.3 mandated collective pattern).  Returns global ids.

    ``n_probes`` / ``supercharge_rounds`` / ``rerank_width`` as in
    :func:`~..engine.search.search` (applied per shard).  ``points=None``
    uses the corpus stored on the index (always set for angular).
    ``chunked``: None auto-selects the host-chunked per-shard driver when
    one shard's points+tables+graph exceed the monolithic-program budget
    (the single-chip ``_ONE_SHOT_MAX_BYTES`` rule — XLA's rematerializer
    copies those operands at compile time); True/False forces.  Results
    are identical."""
    if queries is None:  # search_sharded(sidx, queries) convenience form
        points, queries = None, points
    n_local = sidx.n_local
    queries = _prep_queries(sidx, queries)
    m = queries.shape[0]
    if block_rows is None:
        nprb = sidx.d_short + 1 if n_probes is None else n_probes
        ltot = sidx.tries * nprb * sidx.tmax
        block_rows = pick_block(m, ltot, sidx.d, 4, budget_bytes)
    points = _resolve_corpus(sidx, points, mesh)
    queries = _replicate(queries, mesh)
    if chunked is None:
        from ..engine.search import _ONE_SHOT_MAX_BYTES

        per_shard = (
            n_local * sidx.d * jnp.dtype(sidx.bases.dtype).itemsize
            + sidx.tables.size * 4 // sidx.n_shards
            + sidx.graph.size * 4 // sidx.n_shards
        )
        chunked = per_shard > _ONE_SHOT_MAX_BYTES and sidx.d_short > 0
    if chunked:
        return _search_sharded_chunked(
            sidx, points, queries, mesh=mesh, block_rows=block_rows,
            n_probes=n_probes, supercharge_rounds=supercharge_rounds,
            rerank_width=rerank_width,
        )
    return _search_sharded_jit(
        sidx, points, queries, mesh=mesh, block_rows=block_rows,
        n_probes=n_probes, supercharge_rounds=supercharge_rounds,
        rerank_width=rerank_width,
    )


# Per-call sharded searches run as jitted programs with their knobs static:
# an un-jitted shard_map executes eagerly, one dispatch per primitive per
# shard (exact search over 4M x 128 on four H100s at 700 W: 3.42 s per
# 1,000-query batch eager, 0.026 s jitted).
_SEARCH_STATICS = ("mesh", "block_rows", "n_probes", "supercharge_rounds",
                   "rerank_width")


@partial(jax.jit, static_argnames=_SEARCH_STATICS)
def _search_sharded_jit(sidx, points, queries, *, mesh, block_rows, n_probes,
                        supercharge_rounds, rerank_width):
    k, n_local, n = sidx.k, sidx.n_local, sidx.n
    m = queries.shape[0]

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(
            P(AXIS, None), P(),
            P(AXIS, None, None, None), P(AXIS, None, None), P(AXIS, None, None),
            P(None), P(None, None, None),
        ),
        out_specs=(P(), P()),
        check_vma=False,  # outputs are replicated via all_gather+identical
    )
    def go(pts_l, y, tables_l, counts_l, graph_l, row_means, bases):
        local = ANNIndex(
            row_means=row_means, bases=bases, tables=tables_l[0],
            counts=counts_l[0], graph=graph_l[0], n=n_local, k=k, d=sidx.d,
            d_short=sidx.d_short, tries=sidx.tries, tmax=sidx.tmax,
        )
        ids_l, dd = search_impl(
            local, pts_l, y, block_rows, n_probes,
            supercharge_rounds=supercharge_rounds,
            rerank_width=rerank_width,
        )
        offset = jax.lax.axis_index(AXIS).astype(itype) * n_local
        gids, dd = _to_global(ids_l, dd, n_local, n, offset)
        all_ids = jax.lax.all_gather(gids, AXIS)  # (S, m, k)
        all_dd = jax.lax.all_gather(dd, AXIS)
        s = all_ids.shape[0]
        all_ids = jnp.moveaxis(all_ids, 0, 1).reshape(m, s * k)
        all_dd = jnp.moveaxis(all_dd, 0, 1).reshape(m, s * k)
        return topk_no_dedup(all_dd, all_ids, k)

    return go(
        points, queries, sidx.tables, sidx.counts, sidx.graph,
        sidx.row_means, sidx.bases,
    )


def _search_sharded_chunked(sidx: ShardedIndex, points, queries, *, mesh,
                            block_rows, n_probes=None,
                            supercharge_rounds=1, rerank_width=None):
    """Host-chunked sharded query (sharded form of the single-chip
    ``engine/search.py:_search_chunked``): one bounded program per table
    holding a single per-shard bucket table, then per-shard merge,
    supercharge programs holding only the graph, and one final
    all_gather+merge program — each completion-fenced.  Identical results
    to the monolithic path (per-table top-kk + dedup merge selects the
    union top-kk)."""
    from ..ops.buckets import multiprobe_gather
    from ..ops.distance import blocked_over_rows, candidate_dists
    from ..ops.hash import probe_codes_directed, query_codes
    from ..ops.topk import dedup_topk

    k, n_local, n = sidx.k, sidx.n_local, sidx.n
    d_short, tries = sidx.d_short, sidx.tries
    kk = k if rerank_width is None else max(int(rerank_width), k)
    m = queries.shape[0]

    def probe_body(pts_l, tables_l, y, codes, t, mu, bases_r):
        table = jax.lax.dynamic_index_in_dim(tables_l[0], t, keepdims=False)
        basis = jax.lax.dynamic_index_in_dim(bases_r, t, keepdims=False)
        codes_t = jax.lax.dynamic_index_in_dim(
            codes, t, axis=1, keepdims=False
        )

        def stage(qb, cb):
            if n_probes is None:
                cand = multiprobe_gather(table, cb, d_short)
            else:
                proj = jnp.matmul(qb - mu, basis.T,
                                  precision=jax.lax.Precision.HIGHEST)
                probes = probe_codes_directed(cb, proj, n_probes)
                cand = table[probes].reshape(qb.shape[0], -1)
            dd = candidate_dists(qb, pts_l, cand)
            return dedup_topk(cand, dd, kk, n_local)

        ids, dd = blocked_over_rows(
            stage, m, min(block_rows, m), y, codes_t, pad_values=(0.0, 0)
        )
        return ids[None], dd[None]

    probe = jax.jit(jax.shard_map(
        probe_body, mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS, None, None, None), P(), P(),
                  P(), P(None), P(None, None, None)),
        out_specs=(P(AXIS, None, None), P(AXIS, None, None)),
    ))

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS, None, None), P(AXIS, None, None)),
             out_specs=(P(AXIS, None, None), P(AXIS, None, None)))
    def merge(cand_l, dd_l):
        gi, gd = dedup_topk(cand_l[0], dd_l[0], kk, n_local)
        return gi[None], gd[None]

    def super_body(pts_l, graph_l, y, t1_l, td1_l):
        graph = graph_l[0]
        t1b, td1b = t1_l[0], td1_l[0]

        def stage(qb, t1c, td1c):
            safe = jnp.where(t1c < n_local, t1c, 0)
            exp = jnp.where((t1c < n_local)[..., None], graph[safe], n_local)
            cand2 = jnp.concatenate(
                [t1c, exp.reshape(-1, kk * k)], axis=-1
            )
            dd2 = candidate_dists(qb, pts_l, exp.reshape(-1, kk * k))
            dd2 = jnp.concatenate([td1c, dd2], axis=-1)
            return dedup_topk(cand2, dd2, kk, n_local)

        ids, dd = blocked_over_rows(
            stage, m, min(block_rows, m), y, t1b, td1b,
            pad_values=(0.0, 0, jnp.inf),
        )
        return ids[None], dd[None]

    supercharge = jax.jit(jax.shard_map(
        super_body, mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS, None, None), P(),
                  P(AXIS, None, None), P(AXIS, None, None)),
        out_specs=(P(AXIS, None, None), P(AXIS, None, None)),
    ))

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS, None, None), P(AXIS, None, None)),
             out_specs=(P(), P()), check_vma=False)
    def tail(t1_l, td1_l):
        offset = jax.lax.axis_index(AXIS).astype(itype) * n_local
        gids, dd = _to_global(
            t1_l[0][:, :k], td1_l[0][:, :k], n_local, n, offset
        )
        all_ids = jnp.moveaxis(jax.lax.all_gather(gids, AXIS), 0, 1)
        all_dd = jnp.moveaxis(jax.lax.all_gather(dd, AXIS), 0, 1)
        s = all_ids.shape[1]
        return topk_no_dedup(
            all_dd.reshape(m, s * k), all_ids.reshape(m, s * k), k
        )

    codes = jax.jit(lambda mu, b, y: query_codes(mu, b, y)[0])(
        sidx.row_means, sidx.bases, queries
    )
    parts_i, parts_d = [], []
    for t in range(tries):
        ids, dd = probe(
            points, sidx.tables, queries, codes, jnp.asarray(t, itype),
            sidx.row_means, sidx.bases,
        )
        jax.block_until_ready(ids)  # one table program's workspace live at a time
        parts_i.append(ids)
        parts_d.append(dd)
    t1, td1 = jax.jit(merge)(
        jnp.concatenate(parts_i, axis=-1), jnp.concatenate(parts_d, axis=-1)
    )
    parts_i.clear()
    parts_d.clear()
    jax.block_until_ready(t1)
    for _ in range(supercharge_rounds):
        t1, td1 = supercharge(points, sidx.graph, queries, t1, td1)
        jax.block_until_ready(t1)
    return jax.jit(tail)(t1, td1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedPacked:
    """Per-shard packed (bucket-CSR) serving views, stacked on a leading
    shard axis — the packed layout's scale-out form (single-chip rationale:
    :meth:`~..index.ANNIndex.packed`).  ``point_rows`` stores each shard's
    candidate vectors FLAT (one point per lane-aligned row, same layout as
    the single-chip view); ``ids``/``starts`` are local CSR maps.  Local
    slot ids map to global ids via ``shard * n_local`` offsets at merge."""

    point_rows: Any  # (S, tries * n_pad_l, d_pad) storage dtype
    ids: Any  # (S, tries, n_pad_l) local ids, sentinel n_local
    starts: Any  # (S, tries, 2^d_short)
    # int8 tier: ONE replicated quantization scale covers every shard so
    # per-shard quantized-domain distances stay globally comparable
    scale: Any = None
    n_pad_l: int = dataclasses.field(default=0, metadata=dict(static=True))
    d_pad: int = dataclasses.field(default=0, metadata=dict(static=True))
    window: int = dataclasses.field(default=0, metadata=dict(static=True))
    super_width: int = dataclasses.field(default=1, metadata=dict(static=True))

    def memory_bytes(self) -> int:
        return int(
            self.point_rows.size
            * np.dtype(self.point_rows.dtype).itemsize
            + self.ids.size * 4 + self.starts.size * 4
        )


def packed_sharded(
    sidx: ShardedIndex,
    points=None,
    *,
    mesh: Mesh,
    window: int | None = None,
    super_width: int = 2,
    dtype=None,
) -> ShardedPacked:
    """Build per-shard packed views from a sharded index: each shard packs
    its local slice into bucket-CSR order (exactly n_local slots per table,
    no capacity padding, no overflow drops) entirely shard-locally — no
    collectives; the pack is embarrassingly parallel over the mesh.

    ``dtype=jnp.int8`` builds the quantized tier sharded: one global scale
    (max|x| over the whole sharded corpus — the only cross-shard value)
    keeps quantized distances comparable across shards; rows follow the
    single-chip convention (``index._quantize_points``: zero sentinel row,
    sentinel exclusion via the id map, 32-aligned strides)."""
    import math as _math

    from ..ops.buckets import pack_tables

    w = max(1, int(super_width))
    n_local, d_short, tries = sidx.n_local, sidx.d_short, sidx.tries
    dtype = jnp.dtype(sidx.bases.dtype if dtype is None else dtype)
    quantize = dtype == jnp.int8
    lcm8 = _math.lcm(w, 32 if quantize else 8)
    n_pad_l = -(-(n_local + 1) // lcm8) * lcm8
    d = sidx.d
    d_pad = -(-d // 128) * 128
    points = _resolve_corpus(sidx, points, mesh)
    scale = None
    if quantize:
        # global max over the sharded corpus (XLA inserts the collective)
        scale = jnp.max(jnp.abs(points.astype(jnp.float32))) / 127.0

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(AXIS, None), P(None, None, None), P(None), P()),
        out_specs=(P(AXIS, None, None), P(AXIS, None, None),
                   P(AXIS, None, None)),
    )
    def pack_l(pts_l, bases, row_means, sc):
        codes = hash_points(
            pts_l.astype(bases.dtype) - row_means, bases
        )  # (tries, n_local)
        order, starts = pack_tables(codes, 1 << d_short)
        pad = jnp.full((tries, n_pad_l - n_local), n_local, order.dtype)
        ids = jnp.concatenate([order, pad], axis=1)  # (tries, n_pad_l)
        if sidx.n_padded != sidx.n:
            # zero pad rows (auto-padded indivisible n) must not become
            # candidates: their slots read the sentinel row instead
            # (see _mask_pad_locals)
            s_i = jax.lax.axis_index(AXIS)
            valid = jnp.clip(sidx.n - s_i.astype(itype) * n_local, 0,
                             n_local).astype(ids.dtype)
            ids = jnp.where(ids >= valid, n_local, ids)
        if quantize:
            from ..index import _quantize_points

            pts_s = _quantize_points(pts_l, sc, d_pad)
        else:
            pts_s = pts_l.astype(dtype)
            if d_pad != d:
                pts_s = jnp.pad(pts_s, [(0, 0), (0, d_pad - d)])
            pts_s = jnp.concatenate(
                [pts_s, jnp.full((1, d_pad), jnp.inf, dtype)]
            )
        rows = pts_s[jnp.minimum(ids.reshape(-1), n_local)]
        return rows[None], ids[None], starts[None]

    sc = _replicate(np.float32(1.0), mesh) if scale is None else scale
    rows, ids, starts = pack_l(points, sidx.bases, sidx.row_means, sc)
    return ShardedPacked(
        point_rows=rows, ids=ids, starts=starts, scale=scale,
        n_pad_l=n_pad_l,
        d_pad=d_pad, window=int(window) if window else sidx.tmax,
        super_width=w,
    )


def search_packed_sharded(
    sidx: ShardedIndex,
    spk: ShardedPacked,
    points=None,
    queries=None,
    *,
    mesh: Mesh,
    budget_bytes: int = 128 << 20,
    block_rows: int | None = None,
    n_probes: int | None = None,
    supercharge_rounds: int = 1,
    rerank_width: int | None = None,
    window: int | None = None,
):
    """Distributed packed-layout query: replicate queries, per-shard
    :func:`~..engine.search.search_packed_impl` over the local CSR view,
    ``all_gather`` + merge — same collective pattern as
    :func:`search_sharded`, with the packed candidate superset semantics
    per shard.  ``supercharge_rounds``/``rerank_width`` as in the
    single-chip :func:`~..engine.search.search_packed`; ``window``
    overrides the view's read depth per call (the free query-time knob,
    as the single-device ``with_window``)."""
    if queries is None:  # (sidx, spk, queries) convenience form
        points, queries = None, points
    if window is not None:
        spk = dataclasses.replace(spk, window=int(window))
    queries = _prep_queries(sidx, queries)
    m = queries.shape[0]
    rpp = min(-(-spk.window // spk.super_width) + 1,
              spk.n_pad_l // spk.super_width)
    if block_rows is None:
        nprb = sidx.d_short + 1 if n_probes is None else n_probes
        ltot = sidx.tries * nprb * rpp * spk.super_width
        block_rows = pick_block(m, ltot, sidx.d, 4, budget_bytes)
    points = _resolve_corpus(sidx, points, mesh)
    queries = _replicate(queries, mesh)
    sc = (spk.scale if spk.scale is not None
          else _replicate(np.float32(1.0), mesh))
    return _search_packed_sharded_jit(
        sidx, spk, points, queries, sc, mesh=mesh, block_rows=block_rows,
        n_probes=n_probes, supercharge_rounds=supercharge_rounds,
        rerank_width=rerank_width,
    )


@partial(jax.jit, static_argnames=_SEARCH_STATICS)
def _search_packed_sharded_jit(sidx, spk, points, queries, sc, *, mesh,
                               block_rows, n_probes, supercharge_rounds,
                               rerank_width):
    from ..engine.search import search_packed_impl
    from ..index import PackedIndex

    k, n_local, n = sidx.k, sidx.n_local, sidx.n
    m = queries.shape[0]
    has_scale = spk.scale is not None

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(
            P(AXIS, None), P(),
            P(AXIS, None, None), P(AXIS, None, None), P(AXIS, None, None),
            P(AXIS, None, None), P(None), P(None, None, None), P(),
        ),
        out_specs=(P(), P()),
        check_vma=False,  # outputs replicated via all_gather+identical
    )
    def go(pts_l, y, rows_l, ids_l, starts_l, graph_l, row_means, bases, sc_l):
        local = PackedIndex(
            row_means=row_means, bases=bases, point_rows=rows_l[0],
            ids=ids_l[0], starts=starts_l[0], graph=graph_l[0],
            points=None, scale=sc_l if has_scale else None,
            n=n_local, k=k, d=sidx.d, d_short=sidx.d_short,
            tries=sidx.tries, window=spk.window,
            super_width=spk.super_width, d_pad=spk.d_pad,
        )
        lids, dd = search_packed_impl(
            local, pts_l, y, block_rows, n_probes,
            supercharge_rounds=supercharge_rounds,
            rerank_width=rerank_width,
        )
        offset = jax.lax.axis_index(AXIS).astype(itype) * n_local
        gids, dd = _to_global(lids, dd, n_local, n, offset)
        all_ids = jnp.moveaxis(jax.lax.all_gather(gids, AXIS), 0, 1)
        all_dd = jnp.moveaxis(jax.lax.all_gather(dd, AXIS), 0, 1)
        s = all_ids.shape[1]
        return topk_no_dedup(
            all_dd.reshape(m, s * k), all_ids.reshape(m, s * k), k
        )

    return go(
        points, queries, spk.point_rows, spk.ids, spk.starts,
        sidx.graph, sidx.row_means, sidx.bases, sc,
    )


def search_exact_sharded(points, queries, k: int, *, mesh: Mesh,
                         scale=None, matmul_precision: str = "highest",
                         n_true: int | None = None):
    """Distributed exact kNN: per-shard exact search + all_gather merge.
    Equals global brute force exactly (each shard's local top-k contains
    every true global top-k member residing on that shard).  Per-shard
    engine: the XLA exact engine (:func:`~..ops.distance.exact_search`),
    so n scales linearly with the shard count.

    Storage tiers shard too: a bf16/f16 corpus is multiplied at storage
    width, and an int8 corpus (``quantize_corpus``; pass its ``scale``)
    runs the quantized-domain distance per shard — distances are globally
    comparable because one scale covers every shard, so the merge is
    unchanged."""
    points = points if isinstance(points, jax.Array) else jnp.asarray(points)
    quant = points.dtype == jnp.int8
    if quant and scale is None:
        raise ValueError("int8 corpus requires its quantization scale "
                         "(see quantize_corpus)")
    # n_true: the corpus's real row count when the caller passes an
    # ALREADY-padded sharded corpus (ShardedServer stores one) — its
    # trailing zero rows must be masked like internal padding, not
    # served as real points
    n = points.shape[0] if n_true is None else n_true
    s = mesh.shape[AXIS]
    f64 = points.dtype == jnp.float64
    points = _shard_points(points, mesh)
    n_local = points.shape[0] // s
    q = jnp.asarray(queries)
    queries = _replicate(
        q if f64 and q.dtype == jnp.float64 else q.astype(jnp.float32),
        mesh)
    # one global scale -> per-shard quantized distances share the unit;
    # replicated as an array arg (never close over device arrays in jit)
    sc = _replicate(np.float32(1.0 if scale is None else scale), mesh)
    # exactness under padding: up to n_local*s - n zero pad rows live on
    # the last shard and could displace true neighbors from its local
    # top-k before the merge masks them; widening the local k by the pad
    # count guarantees the true top-k always survive to the merge
    kk = min(k + (n_local * s - n), n_local)
    return _exact_sharded_jit(points, queries, sc, mesh=mesh, k=k, kk=kk,
                              n=n, quant=quant,
                              matmul_precision=matmul_precision)


@partial(jax.jit, static_argnames=("mesh", "k", "kk", "n", "quant",
                                   "matmul_precision"))
def _exact_sharded_jit(points, queries, sc, *, mesh, k, kk, n, quant,
                       matmul_precision):
    from ..ops.distance import exact_search

    n_local = points.shape[0] // mesh.shape[AXIS]

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(AXIS, None), P(), P()),
             out_specs=(P(), P()), check_vma=False)
    def go(pts_l, y, sc_l):
        ids_l, dd = exact_search(pts_l, y, kk, scale=sc_l if quant else None,
                                 matmul_precision=matmul_precision)
        offset = jax.lax.axis_index(AXIS).astype(itype) * n_local
        gids, dd = _to_global(ids_l.astype(itype), dd, n_local, n, offset)
        all_ids = jnp.moveaxis(jax.lax.all_gather(gids, AXIS), 0, 1).reshape(y.shape[0], -1)
        all_dd = jnp.moveaxis(jax.lax.all_gather(dd, AXIS), 0, 1).reshape(y.shape[0], -1)
        return topk_no_dedup(all_dd, all_ids, k)

    return go(points, queries, sc)


def global_graph_sharded(sidx: ShardedIndex, points, *, mesh: Mesh, **kw):
    """Approximate global kNN graph from a sharded index: query all points
    against every shard and merge — the distributed analogue of the
    reference's precomp output (its graph is single-device only)."""
    ids, dd = search_sharded(sidx, points, points, mesh=mesh, **kw)
    # drop self-matches (distance 0 to itself always wins otherwise)
    n = sidx.n
    m = points.shape[0]
    self_mask = ids == jnp.arange(m, dtype=itype)[:, None]
    dd = jnp.where(self_mask, jnp.inf, dd)
    ids = jnp.where(self_mask, n, ids)
    return topk_no_dedup(dd, ids, sidx.k)
