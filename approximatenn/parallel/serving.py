"""Multi-device serving facade: the one serving surface over a mesh.

Role in the reference: ``query`` is its single serving entry point
(``/root/reference/ann.h:61-62``); at SURVEY §2.3's multi-device scale
this framework's equivalent is :class:`ShardedServer`.  It applies the
single-device :class:`~..engine.serving.Server`'s decisions at per-shard
granularity:

- **engine choice**: exact vs hash by per-shard corpus size (the
  single-device ``exact_max_n`` bound applies to n_local — each shard
  runs the single-device engine on its slice);
- **storage tiers**: bf16/int8 sharded corpora with ONE global
  quantization scale (per-shard quantized distances stay globally
  comparable, so the cross-shard merge is unchanged).

``tune_sharded`` walks the same knob grid as the single-device
``engine.tuning.tune`` through ``ShardedServer.search`` dispatch, so
every measured trial is the production path.

Everything also runs on a CPU mesh via
``--xla_force_host_platform_device_count`` (tests, ``dryrun_multichip``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import jax.numpy as jnp
import numpy as np

from ..engine.serving import default_exact_max_n
from ..utils.runtime import on_accelerator
from .sharded import (
    AXIS,
    ShardedIndex,
    ShardedPacked,
    _normalize_rows,
    _shard_points,
    build_sharded,
    packed_sharded,
    search_exact_sharded,
    search_packed_sharded,
    search_sharded,
)


@dataclass
class ShardedServer:
    """One-stop serving handle over a mesh-sharded corpus.

    >>> srv = ShardedServer.build(points, k=10, mesh=mesh)
    >>> ids, dists = srv.search(queries)      # global ids
    >>> srv.describe()

    ``mode``: "exact", "hash", or "auto" (per-shard size decides).  Hash
    build options pass through ``**build_kw`` (tries, capacity, seed,
    graph_mode, ...); ``layout="packed"`` (default for hash) serves the
    per-shard bucket-CSR views.
    """

    mesh: Any
    k: int
    mode: str
    metric: str = "l2"
    n: int = 0
    d_logical: int = 0
    points: Any = None  # sharded corpus (exact mode)
    scale: Any = None  # replicated () f32 for the int8 exact tier
    sidx: ShardedIndex | None = None
    spk: ShardedPacked | None = None
    _search_kw: dict = field(default_factory=dict)

    # ------------------------------------------------------------- build
    @classmethod
    def build(
        cls,
        points,
        k: int,
        *,
        mesh,
        mode: str = "auto",
        metric: str = "l2",
        storage_dtype=None,
        layout: str = "packed",
        window: int | None = None,
        packed_dtype=None,
        n_probes: int | None = None,
        exact_max_n: int | None = None,
        **build_kw,
    ) -> "ShardedServer":
        """Shard, pick the per-shard engine, and stage the serving state.

        ``storage_dtype`` (exact mode): ``jnp.bfloat16`` halves /
        ``jnp.int8`` quarters each shard's corpus bytes exactly as on one
        device — the per-device capacity bound scales, and the mesh's
        capacity is that times the shard count.  ``packed_dtype`` is the
        hash path's packed-row width.
        """
        s = mesh.shape[AXIS]
        points = jnp.asarray(points)
        n, d = points.shape
        n_local = -(-n // s)
        if exact_max_n is None:
            iz = jnp.dtype(storage_dtype or jnp.float32).itemsize
            exact_max_n = default_exact_max_n(d, iz, mesh.devices.flat[0])
        quantized = (storage_dtype is not None
                     and jnp.dtype(storage_dtype) == jnp.int8)
        if mode == "auto":
            mode = ("exact" if quantized
                    or (n_local <= exact_max_n and k <= 128) else "hash")
        if mode not in ("exact", "hash"):
            raise ValueError(f"unknown mode {mode!r}")
        if quantized and mode != "exact":
            raise ValueError("storage_dtype=int8 serves the exact engine "
                             "only (as on one device); pass mode='exact'")
        srv = cls(mesh=mesh, k=k, mode=mode, metric=metric, n=n,
                  d_logical=d)
        if mode == "hash":
            srv.sidx = build_sharded(
                points, k, mesh=mesh, metric=metric, store_points=True,
                n_probes=n_probes, **build_kw,
            )
            if n_probes is not None:
                srv._search_kw["n_probes"] = n_probes
            if layout == "packed":
                srv.spk = packed_sharded(
                    srv.sidx, mesh=mesh, window=window, dtype=packed_dtype
                )
            return srv

        # ---- exact mode: shard + tier ----
        pts = _shard_points(points.astype(jnp.float32), mesh)
        if metric == "angular":
            pts = _normalize_rows(pts)
        if quantized:
            # ONE global scale over the sharded corpus (XLA inserts the
            # collective); elementwise quantization preserves the row
            # sharding.  NOTE: quantizing materializes one f32-sized
            # transient per shard — at >8M rows/shard synthesize or
            # quantize host-side instead (quantize_corpus's chunked form)
            srv.scale = jnp.max(jnp.abs(pts)) / 127.0
            pts = jnp.clip(jnp.round(pts / srv.scale), -127, 127).astype(
                jnp.int8
            )
            srv._search_kw["scale"] = srv.scale
        elif storage_dtype is not None:
            pts = pts.astype(storage_dtype)
        srv.points = pts
        return srv

    # ------------------------------------------------------------ search
    def search(self, queries, k: int | None = None, **kw):
        """k nearest neighbors per query row, global ids — the
        multi-device ``query`` (``/root/reference/ann.c:6-12``).

        Per-call knobs: hash paths take ``n_probes`` / ``window`` /
        ``rerank_width`` / ``supercharge_rounds``; exact takes
        ``matmul_precision``."""
        k = self.k if k is None else k
        queries = jnp.asarray(queries)
        skw = {**self._search_kw, **kw}
        if self.mode == "exact":
            if self.metric != "l2":
                from ..data.preprocess import prepare_points

                queries = prepare_points(queries.astype(jnp.float32),
                                         self.metric)
            scale = skw.pop("scale", self.scale)
            return search_exact_sharded(
                self.points, queries, k, mesh=self.mesh, scale=scale,
                n_true=self.n, **skw,
            )
        if self.spk is not None:
            window = skw.pop("window", None)
            return search_packed_sharded(
                self.sidx, self.spk, None, queries, mesh=self.mesh,
                window=window, **skw,
            )
        return search_sharded(self.sidx, None, queries, mesh=self.mesh,
                              **skw)

    # -------------------------------------------------------- persistence
    def save(self, path) -> None:
        """Persist the serving state (the multi-device counterpart of
        ``ANNIndex.save`` — without it every serving restart rebuilds or
        re-packs).  Hash mode delegates to the sharded-index/packed
        checkpoints; exact mode saves the sharded corpus + scale.  Orbax
        when available (multi-host capable), npz otherwise."""
        import json
        from pathlib import Path

        from .checkpoint import save_sharded_index, save_sharded_packed

        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        meta = {
            "mode": self.mode, "k": self.k, "metric": self.metric,
            "n": self.n, "d_logical": self.d_logical,
            "search_kw": {k_: v for k_, v in self._search_kw.items()
                          if not hasattr(v, "shape")},
        }
        if self.mode == "exact":
            import jax

            from ..index import _stash

            meta["points_shape"] = list(self.points.shape)
            meta["points_dtype"] = str(jnp.dtype(self.points.dtype))
            meta["has_scale"] = self.scale is not None
            arrays = {"points": self.points}
            if self.scale is not None:
                arrays["scale"] = self.scale
            try:
                import orbax.checkpoint as ocp

                ckptr = ocp.StandardCheckpointer()
                ckptr.save((path / "arrays").absolute(), arrays,
                           force=True)
                ckptr.wait_until_finished()
                meta["format"] = "orbax"
            except ImportError:
                if jax.process_count() > 1:
                    raise RuntimeError(
                        "multi-host checkpointing requires orbax"
                    )
                out = {}
                for f, v in arrays.items():
                    _stash(out, f, v)
                np.savez(path / "arrays.npz", **out)
                meta["format"] = "npz"
        else:
            save_sharded_index(self.sidx, path / "index")
            meta["has_packed"] = self.spk is not None
            if self.spk is not None:
                save_sharded_packed(self.spk, path / "packed")
        (path / "server.json").write_text(json.dumps(meta))

    @classmethod
    def load(cls, path, *, mesh) -> "ShardedServer":
        """Restore onto ``mesh`` (same shard count as at save time),
        ready to serve."""
        import json
        from pathlib import Path

        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P_

        from .checkpoint import load_sharded_index, load_sharded_packed

        path = Path(path)
        meta = json.loads((path / "server.json").read_text())
        srv = cls(mesh=mesh, k=meta["k"], mode=meta["mode"],
                  metric=meta["metric"], n=meta["n"],
                  d_logical=meta["d_logical"],
                  _search_kw=dict(meta.get("search_kw") or {}))
        if srv.mode == "exact":
            from ..index import _unstash

            specs = {"points": P_(AXIS, None), "scale": P_()}
            fields = ["points"] + (["scale"] if meta["has_scale"] else [])
            if meta["format"] == "orbax":
                import orbax.checkpoint as ocp

                target = {
                    "points": jax.ShapeDtypeStruct(
                        tuple(meta["points_shape"]),
                        jnp.dtype(meta["points_dtype"]),
                        sharding=NamedSharding(mesh, specs["points"]),
                    ),
                }
                if meta["has_scale"]:
                    target["scale"] = jax.ShapeDtypeStruct(
                        (), jnp.float32,
                        sharding=NamedSharding(mesh, specs["scale"]),
                    )
                arrays = ocp.StandardCheckpointer().restore(
                    (path / "arrays").absolute(), target
                )
            else:
                z = np.load(path / "arrays.npz")
                arrays = {
                    f: jax.device_put(_unstash(z, f),
                                      NamedSharding(mesh, specs[f]))
                    for f in fields
                }
            srv.points = arrays["points"]
            if meta["has_scale"]:
                srv.scale = arrays["scale"]
                srv._search_kw["scale"] = srv.scale
            return srv
        srv.sidx = load_sharded_index(path / "index", mesh)
        if meta["has_packed"]:
            srv.spk = load_sharded_packed(path / "packed", mesh)
        return srv

    # ---------------------------------------------------------- describe
    def describe(self) -> dict:
        d = {
            "mode": self.mode,
            "n": self.n,
            "d": self.d_logical,
            "k": self.k,
            "metric": self.metric,
            "n_shards": int(self.mesh.shape[AXIS]),
        }
        if self.mode == "exact":
            d["n_local"] = self.points.shape[0] // d["n_shards"]
            d["storage_dtype"] = str(jnp.dtype(self.points.dtype))
            d["recall"] = (1.0
                           if jnp.dtype(self.points.dtype).itemsize >= 4
                           else None)
        else:
            d["n_local"] = self.sidx.n_local
            d["layout"] = "packed" if self.spk is not None else "table"
            if self.spk is not None:
                d["index_mb"] = round(self.spk.memory_bytes() / 2**20, 1)
                d["packed_dtype"] = str(
                    jnp.dtype(self.spk.point_rows.dtype)
                )
        return d


# --------------------------------------------------------------- tuning
@dataclass
class ShardedTuneReport:
    """What ``tune_sharded`` learned; ``server()`` is the pinned
    production handle (nothing is rebuilt)."""

    best: Any  # engine.tuning.Trial
    trials: list
    k: int
    metric: str
    target_recall: float
    measured: bool
    batch: int
    _srv_hash: ShardedServer | None = field(repr=False, default=None)
    _srv_exact: dict = field(repr=False, default_factory=dict)

    def server(self) -> ShardedServer:
        if self.best.engine == "exact":
            srv = self._srv_exact[self.best.knobs.get("storage_dtype")]
        else:
            srv = self._srv_hash
            for kk in ("n_probes", "window", "rerank_width"):
                v = self.best.knobs.get(kk)
                if v is not None:
                    srv._search_kw[kk] = v
        return srv

    def as_dict(self) -> dict:
        return {
            "best": self.best.as_dict(),
            "k": self.k,
            "metric": self.metric,
            "target_recall": self.target_recall,
            "measured": self.measured,
            "batch": self.batch,
            "sharded": True,
            "trials": [t.as_dict() for t in self.trials],
        }


def tune_sharded(
    points,
    k: int,
    *,
    mesh,
    queries=None,
    n_queries: int = 256,
    batch: int | None = None,
    target_recall: float = 0.9,
    metric: str = "l2",
    include_exact: bool = True,
    probe_grid=(None, 18),
    window_grid=(32, 96),
    rerank_grid=(None, 50),
    exact_tiers=(None,),
    packed_dtype=None,
    measure: bool | None = None,
    seed: int = 0,
    verbose: bool = False,
    **build_kw,
) -> ShardedTuneReport:
    """The auto-tuner over a mesh: every trial dispatches through
    ``ShardedServer.search`` on the given mesh, so the measured path —
    per-shard engines and the collective merge — is the production path.
    Recall is scored against the sharded exact oracle
    (``search_exact_sharded`` == global brute force).  Off-accelerator
    (CPU-mesh tests) the ranking falls back to the single-device tuner's
    candidate-rows cost proxy.  One hash build + one pack serve all hash
    trials; each ``exact_tiers`` entry is its own sharded corpus copy."""
    from ..engine.tuning import Trial, _measure_qps, _sample_queries
    from ..harness.scoring import recall_at_k

    points = jnp.asarray(points, jnp.float32)
    n = points.shape[0]
    if queries is None:
        queries = _sample_queries(points, n_queries, seed)
    else:
        queries = jnp.asarray(queries, jnp.float32)
    m = queries.shape[0]
    batch = m if batch is None else max(1, int(batch))
    if measure is None:
        measure = on_accelerator(mesh.devices.flat)

    if metric != "l2":
        from ..data.preprocess import prepare_points

        pts_m = prepare_points(points, metric)
        q_m = prepare_points(queries, metric)
    else:
        pts_m, q_m = points, queries
    true_ids, _ = search_exact_sharded(pts_m, q_m, k, mesh=mesh)
    true_ids = np.asarray(true_ids)

    q_run = queries if batch >= m else queries[:batch]
    scored = min(batch, m)

    trials: list[Trial] = []
    runners: list[tuple[Trial, Any]] = []
    srv_exact: dict[str | None, ShardedServer] = {}

    def note(t: Trial):
        trials.append(t)
        if verbose:
            print(f"  {t.engine:6s} {t.knobs} recall={t.recall:.3f} "
                  f"cost={t.cost:.0f}")

    if include_exact and k <= 128:
        for tier in exact_tiers:
            dt = {None: None, "bf16": jnp.bfloat16, "int8": jnp.int8}[tier]
            srv_e = ShardedServer.build(pts_m, k, mesh=mesh, mode="exact",
                                        storage_dtype=dt)
            srv_exact[tier] = srv_e

            def run_exact(srv_e=srv_e):
                return srv_e.search(q_run)

            ids, _ = run_exact()
            knobs = {} if tier is None else {"storage_dtype": tier}
            t = Trial("exact", knobs,
                      recall_at_k(true_ids[:scored],
                                  np.asarray(ids)[:scored], k),
                      cost=float(n) / (1 if tier is None
                                       else (2 if tier == "bf16" else 4)))
            note(t)
            runners.append((t, run_exact))

    srv_h = ShardedServer.build(points, k, mesh=mesh, mode="hash",
                                metric=metric, layout="packed",
                                window=max(window_grid),
                                packed_dtype=packed_dtype, seed=seed,
                                **build_kw)
    sw = srv_h.spk.super_width
    for P in probe_grid:
        p_eff = P if P is not None else srv_h.sidx.d_short + 1
        for w in window_grid:
            for rw in rerank_grid:
                def run_packed(P=P, w=w, rw=rw):
                    return srv_h.search(
                        q_run, n_probes=P, window=w, rerank_width=rw,
                    )

                ids, _ = run_packed()
                cost = srv_h.sidx.tries * p_eff * w * sw
                cost *= 1.0 + (0.0 if rw is None else rw / (2.0 * k))
                t = Trial(
                    "packed",
                    {"n_probes": P, "window": w, "rerank_width": rw},
                    recall_at_k(true_ids[:scored],
                                np.asarray(ids)[:scored], k),
                    cost,
                )
                note(t)
                runners.append((t, run_packed))

    qualified = [(t, r) for t, r in runners if t.recall >= target_recall]
    if not qualified:
        best = max(trials, key=lambda t: t.recall)
        cands = [(t, r) for t, r in runners if t is best]
    else:
        cands = qualified
    if measure:
        for t, run in cands:
            t.qps = _measure_qps(run, scored)
            if verbose:
                print(f"  measured {t.engine} {t.knobs}: {t.qps:.0f} QPS")
        best = max((t for t, _ in cands), key=lambda t: t.qps)
    else:
        best = min((t for t, _ in cands), key=lambda t: t.cost)

    return ShardedTuneReport(best=best, trials=trials, k=k, metric=metric,
                             target_recall=target_recall, measured=measure,
                             batch=batch, _srv_hash=srv_h,
                             _srv_exact=srv_exact)
