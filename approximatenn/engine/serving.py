"""Serving facade: pick the engine for a corpus automatically.

Role in the reference: none — its only serving surface is ``query``
(``/root/reference/ann.h:61-62``) over the one algorithm it has.  Two
engines serve here:

- **exact** — the XLA exact engine (:func:`~..ops.distance.exact_search`):
  one cross-term GEMM per query block plus top-k selection, recall 1.0
  against the true neighbors in the float32 tier; bf16/int8 storage tiers
  halve/quarter the corpus bytes and are exact over the stored grid
  values.
- **hash** — the reference's algorithm (`build`/`search`): sub-linear
  candidate work; pays off when n outgrows what brute force serves, and
  when sharded past one device.  ``layout="packed"`` serves through the
  bucket-CSR view (`search_packed`): no overflow drops, superset
  candidates, `window` depth knob.

``Server`` wraps the choice; ``mode="auto"`` picks exact while the corpus
fits :func:`default_exact_max_n` and hash beyond.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp

# Share of a device's memory limit that an exact-served corpus may fill in
# mode="auto": the rest holds the queries, the engine's per-block distance
# matrices (ops/distance.DIST_BLOCK_BYTES) and anything else the process
# keeps resident.
EXACT_CORPUS_SHARE = 0.25
# Corpus budget on devices that report no memory limit (the CPU backend).
EXACT_CORPUS_BYTES_NO_LIMIT = 4 << 30


def default_exact_max_n(d: int, itemsize: int, device=None) -> int:
    """Largest corpus (rows of ``d`` values of ``itemsize`` bytes) that
    ``mode="auto"`` serves with the exact engine on ``device`` (default:
    the first device): :data:`EXACT_CORPUS_SHARE` of the device's
    ``memory_stats()["bytes_limit"]``, or
    :data:`EXACT_CORPUS_BYTES_NO_LIMIT` where the device reports none.
    Narrower storage tiers fit proportionally more rows."""
    from ..utils.runtime import memory_budget

    budget = memory_budget(EXACT_CORPUS_SHARE, EXACT_CORPUS_BYTES_NO_LIMIT, device)
    return budget // (d * itemsize)


@dataclass
class Server:
    """One-stop serving handle over a point corpus.

    >>> srv = Server.build(points, k=10)          # picks engine by size
    >>> ids, dists = srv.search(queries)
    >>> srv.mode, srv.describe()

    ``mode``: "exact", "hash", or "auto" (default).  Hash-specific build
    options pass through ``**build_kw`` (tries, capacity, seed, n_probes,
    layout="table"|"packed", window, ...).
    """

    points: Any
    k: int
    mode: str
    metric: str = "l2"
    index: Any = None  # ANNIndex when mode == "hash"
    packed: Any = None  # PackedIndex when layout == "packed"
    n_probes: int | None = None
    _search_kw: dict = field(default_factory=dict)

    @classmethod
    def build(
        cls,
        points,
        k: int,
        *,
        mode: str = "auto",
        metric: str = "l2",
        exact_max_n: int | None = None,
        layout: str = "table",
        window: int | None = None,
        n_probes: int | None = None,
        storage_dtype=None,
        packed_dtype=None,
        **build_kw,
    ) -> "Server":
        """``storage_dtype=jnp.bfloat16`` stores the corpus at half width:
        the exact engine multiplies it as stored (no f32 copy, factors
        bf16-rounded, f32 accumulation — near-identical neighbor sets,
        tests/test_exact.py) and :func:`default_exact_max_n` doubles, so
        ``mode="auto"`` keeps exact serving to twice the f32 corpus.
        ``storage_dtype=jnp.int8`` quantizes symmetrically (scale kept on
        the server; exact-mode only) for 1/4 the f32 bytes, ranked with
        int8 x int8 -> int32 products."""
        points = jnp.asarray(points)
        scale = None
        quantized = (storage_dtype is not None
                     and jnp.dtype(storage_dtype) == jnp.int8)
        if metric != "l2" and quantized:
            # normalize BEFORE quantizing (the int8 grid must cover the
            # unit sphere, not the raw magnitudes)
            from ..data.preprocess import prepare_points

            points = prepare_points(points, metric)
        if quantized:
            from ..ops.distance import quantize_corpus

            points, scale = quantize_corpus(points)
        elif storage_dtype is not None:
            points = points.astype(storage_dtype)
        n, d = points.shape
        if exact_max_n is None:
            exact_max_n = default_exact_max_n(
                d, jnp.dtype(points.dtype).itemsize,
                next(iter(points.devices())),
            )
        if mode == "auto":
            # a quantized corpus has no hash path (the build needs floats):
            # auto always resolves it to exact rather than erroring
            mode = "exact" if quantized or n <= exact_max_n else "hash"
        if mode not in ("exact", "hash"):
            raise ValueError(f"unknown mode {mode!r}")
        if quantized and mode != "exact":
            raise ValueError(
                "storage_dtype=int8 serves the exact engine only (the "
                "hash build needs the float corpus); pass mode='exact' "
                "or quantize via index.packed(dtype=jnp.int8) instead"
            )
        srv = cls(points=points, k=k, mode=mode, metric=metric,
                  n_probes=n_probes)
        if scale is not None:
            srv._search_kw["scale"] = scale
        if metric != "l2" and not quantized:
            from ..data.preprocess import prepare_points

            srv.points = prepare_points(points, metric)
        if mode == "hash":
            from .build import build

            srv.index, _, _ = build(
                points, k, metric=metric, store_points=True, **build_kw
            )
            if layout == "packed":
                # packed_dtype: storage width of the packed rows (bf16
                # halves them, int8 quarters + quantized ranking with
                # float re-score — see ANNIndex.packed)
                srv.packed = srv.index.packed(window=window,
                                              dtype=packed_dtype)
        return srv

    def search(self, queries, k: int | None = None, **kw):
        """k approximate (hash) or exact nearest neighbors per query row.
        Returns (ids, squared distances) with the library's standard
        sentinel conventions."""
        k = self.k if k is None else k
        if self.mode == "exact":
            from ..ops.distance import exact_search

            if self.metric != "l2":
                from ..data.preprocess import prepare_points

                # int8 storage: queries stay float (the engine quantizes
                # them itself with the stored scale)
                qdt = (jnp.float32 if self.points.dtype == jnp.int8
                       else self.points.dtype)
                queries = prepare_points(
                    jnp.asarray(queries, qdt), self.metric
                )
            return exact_search(self.points, queries, k,
                                **{**self._search_kw, **kw})
        kw = {**self._search_kw, **kw}  # pinned knobs (e.g. tuned rerank)
        kw.setdefault("n_probes", self.n_probes)
        if self.packed is not None:
            from .search import search_packed

            window = kw.pop("window", None)
            pv = (self.packed if window is None
                  else self.packed.with_window(window))
            return search_packed(pv, queries=jnp.asarray(queries), **kw)
        from .search import search

        return search(self.index, queries=queries, **kw)

    def add_points(self, new_points) -> "Server":
        """Append rows with ids n..n+m-1, in place (returns self).

        Exact mode: rows are metric-prepared, tier-converted with the
        SERVER'S existing quantization scale (int8 values outside the
        original grid clip — re-quantize via a rebuild if the data
        distribution moved), and concatenated.  Hash mode delegates to
        :meth:`~..index.ANNIndex.add_points` (frozen transforms,
        bucket append, reverse-edge repair) and re-packs the packed
        view at its current window/width."""
        new_points = jnp.asarray(new_points)
        if self.mode == "exact":
            if self.metric != "l2":
                from ..data.preprocess import prepare_points

                new_points = prepare_points(
                    new_points.astype(jnp.float32), self.metric
                )
            if self.points.dtype == jnp.int8:
                scale = self._search_kw["scale"]
                new_points = jnp.clip(
                    jnp.round(new_points.astype(jnp.float32) / scale),
                    -127, 127,
                ).astype(jnp.int8)
            else:
                new_points = new_points.astype(self.points.dtype)
            self.points = jnp.concatenate([self.points, new_points])
            return self
        self.index = self.index.add_points(new_points)
        if self.packed is not None:
            self.packed = self.index.packed(
                window=self.packed.window,
                dtype=self.packed.point_rows.dtype,
            )
        return self

    def remove_points(self, ids) -> "Server":
        """Remove rows by id, in place (returns self).

        Exact mode: the corpus is compacted (one gather copy; remaining
        rows KEEP their original relative order but ids above removed
        rows shift down — the exact engine has no tombstones, its ids
        are row positions).  Hash mode delegates to the index's
        tombstoning ``remove_points`` (ids stay stable) and re-packs."""
        import numpy as np

        if self.mode == "exact":
            # host-side unique: duplicate ids would make the static
            # nonzero size overcount and silently duplicate row 0
            uids = np.unique(np.asarray(ids).astype(np.int64))
            n = self.points.shape[0]
            keep = jnp.ones((n,), bool).at[jnp.asarray(uids)].set(False)
            (kept,) = jnp.nonzero(keep, size=int(n - len(uids)))
            self.points = jnp.take(self.points, kept, axis=0)
            return self
        self.index = self.index.remove_points(ids)
        if self.packed is not None:
            self.packed = self.index.packed(
                window=self.packed.window,
                dtype=self.packed.point_rows.dtype,
            )
        return self

    def describe(self) -> dict:
        d = {
            "mode": self.mode,
            "n": int(self.points.shape[0]),
            "d": int(self.points.shape[1]),
            "k": self.k,
            "metric": self.metric,
            # recall vs the TRUE neighbors: 1.0 only for full-precision
            # exact; a rounded/quantized stored corpus is exact over the
            # grid values, not the originals — report None rather than a
            # number this handle cannot know
            "recall": (1.0 if self.mode == "exact"
                       and jnp.dtype(self.points.dtype).itemsize >= 4
                       else None),
            "storage_dtype": str(jnp.dtype(self.points.dtype)),
        }
        if self.index is not None:
            d["layout"] = "packed" if self.packed is not None else "table"
            d["index_mb"] = round(
                (self.packed or self.index).memory_bytes() / 2**20, 1
            )
        return d
