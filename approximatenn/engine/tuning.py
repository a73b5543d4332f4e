"""Operating-point auto-tuner: pick the serving config for a recall target.

Role in the reference: none — its operating point is whatever flags the
caller hand-picks (``/root/reference/ann.h:46-65`` exposes tries/rotation
counts and nothing chooses them).  Here the landscape has real choices:
the exact engine (recall 1.0), the packed hash path (n_probes x window x
rerank_width frontier), and the table path.  ``tune()`` walks that
landscape on a held-out query sample against the exact oracle and returns
the cheapest configuration meeting the recall target.

Design notes:

- One index build + one pack serve every hash trial: ``with_window`` is a
  query-time knob (free), ``n_probes``/``rerank_width`` are trace-time
  arguments.  The tuner never rebuilds per trial.
- Two passes: a recall pass (one batch per config — this also compiles),
  then a throughput pass over only the configs that met the target (warm
  programs, timed to ``jax.block_until_ready``).  Recall is
  data-dependent but cheap; QPS is expensive to measure, so losers never
  get timed.
- Off-accelerator (CPU tests) ``measure=False`` ranks survivors by a
  deterministic cost proxy (candidate rows scanned) instead of wall time,
  so the tuner's logic is testable on the virtual mesh.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..harness.scoring import recall_at_k
from ..utils.runtime import on_accelerator

# Grids reach the high-recall region (windows up to 192, rerank 50).
# Window is a query-time knob (free — one pack at max(window) serves every
# trial); rerank/supercharge are trace-time arguments.
DEFAULT_PROBE_GRID = (None, 12, 18, 24)  # None = blind Hamming-1 set
DEFAULT_WINDOW_GRID = (8, 32, 96, 192)
DEFAULT_RERANK_GRID = (None, 30, 50)
DEFAULT_SUPER_GRID = (1,)  # supercharge rounds; pass (1, 2) to widen
DEFAULT_EXACT_TIERS = (None,)  # exact storage tiers; e.g. (None, "bf16", "int8")


@dataclass
class Trial:
    """One evaluated operating point."""

    engine: str  # "exact" | "packed" | "table"
    knobs: dict
    recall: float
    cost: float  # candidate rows scanned per query (proxy; 0 order = cheap)
    qps: float | None = None  # measured only for target-meeting configs

    def as_dict(self) -> dict:
        return {
            "engine": self.engine,
            **self.knobs,
            "recall": round(self.recall, 4),
            "cost_rows": self.cost,
            "qps": None if self.qps is None else round(self.qps, 1),
        }


@dataclass
class TuneReport:
    """Everything ``tune()`` learned, plus the pieces to serve with."""

    best: Trial
    trials: list[Trial]
    k: int
    metric: str
    target_recall: float
    measured: bool
    batch: int = 0  # serving batch the trials dispatched at
    # batch > sample size: the QPS pass ran on tiled duplicate query rows
    # (duplicated queries probe identical windows — measured QPS can read
    # slightly optimistic vs batches of all-distinct queries)
    batch_tiled: bool = False
    _points: Any = field(repr=False, default=None)
    _index: Any = field(repr=False, default=None)
    _packed: Any = field(repr=False, default=None)

    def server(self):
        """A ready :class:`~approximatenn.engine.serving.Server` pinned
        to the winning operating point (reuses the tuner's build/pack —
        nothing is rebuilt)."""
        from .serving import Server

        if self.best.engine == "exact":
            tier = self.best.knobs.get("storage_dtype")
            dt = {None: None, "bf16": jnp.bfloat16,
                  "int8": jnp.int8}[tier]
            return Server.build(self._points, self.k, mode="exact",
                                metric=self.metric, storage_dtype=dt)
        srv = Server(points=self._points, k=self.k, mode="hash",
                     metric=self.metric, index=self._index,
                     n_probes=self.best.knobs.get("n_probes"))
        rw = self.best.knobs.get("rerank_width")
        if rw is not None:
            srv._search_kw["rerank_width"] = rw
        sr = self.best.knobs.get("supercharge_rounds")
        if sr is not None and sr != 1:
            srv._search_kw["supercharge_rounds"] = sr
        if self.best.engine == "packed":
            srv.packed = self._packed.with_window(self.best.knobs["window"])
        return srv

    def as_dict(self) -> dict:
        return {
            "best": self.best.as_dict(),
            "k": self.k,
            "metric": self.metric,
            "target_recall": self.target_recall,
            "measured": self.measured,
            "batch": self.batch,
            "batch_tiled": self.batch_tiled,
            "trials": [t.as_dict() for t in self.trials],
        }


def _sample_queries(points, n_queries: int, seed: int) -> jnp.ndarray:
    """Held-out-ish sample: corpus rows + 5%-of-std jitter (deterministic).
    Rows are drawn from the WHOLE corpus (a leading-block sample is biased
    on corpora with ordered cluster layout); only the sampled rows are
    pulled to host.  Real query logs are better — pass via ``queries=``."""
    n = points.shape[0]
    rng = np.random.default_rng(seed ^ 0x5EED)
    rows = np.sort(rng.choice(n, size=min(n_queries, n), replace=False))
    q = np.asarray(jnp.take(jnp.asarray(points), jnp.asarray(rows), axis=0),
                   np.float32)
    q = q + 0.05 * q.std(axis=0) * rng.standard_normal(q.shape)
    return jnp.asarray(q.astype(np.float32))


def _measure_qps(fn, m: int, target_s: float = 0.3) -> float:
    """Throughput of an already-compiled call, timed to
    ``jax.block_until_ready`` of its last output."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    dt = max(time.perf_counter() - t0, 1e-5)
    reps = max(1, min(50, int(target_s / dt)))
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return m * reps / (time.perf_counter() - t0)


def tune(
    points,
    k: int,
    *,
    queries=None,
    n_queries: int = 256,
    batch: int | None = None,
    target_recall: float = 0.9,
    metric: str = "l2",
    include_exact: bool = True,
    include_table: bool = False,
    probe_grid=DEFAULT_PROBE_GRID,
    window_grid=DEFAULT_WINDOW_GRID,
    rerank_grid=DEFAULT_RERANK_GRID,
    super_grid=DEFAULT_SUPER_GRID,
    exact_tiers=DEFAULT_EXACT_TIERS,
    packed_dtype=None,
    measure: bool | None = None,
    measure_all: bool = False,
    sequential_tiers: bool = False,
    seed: int = 0,
    verbose: bool = False,
    **build_kw,
) -> TuneReport:
    """Search the serving-knob space for the cheapest config meeting
    ``target_recall`` (recall@k vs the exact oracle on a query sample).

    Returns a :class:`TuneReport`; ``report.server()`` is a Server pinned
    to the winner.  ``queries``: a sample of real queries (recommended);
    synthesized from the corpus when absent.  ``measure=None`` auto-times
    on accelerators and falls back to the candidate-rows cost proxy on
    CPU.  ``**build_kw`` reaches the one hash build (tries, capacity, ...).

    ``batch`` is the PRODUCTION serving batch size: every trial dispatches
    through ``Server.search`` with exactly that many query rows (the
    sample is tiled/truncated as needed), so what the tuner measures is
    what production will run.
    Default: the query-sample size, i.e. "I will serve batches shaped
    like my sample".  Tune at the batch you serve at; the winner can
    legitimately differ across batch sizes, which is a property of the
    hardware, not a tuner bug.

    The winner is the max-QPS (measured) or min-cost (proxy) trial with
    recall >= target; if none qualifies, the max-recall trial.

    Memory budget note: by default every ``exact_tiers`` entry holds its
    own corpus copy for the whole tune, NEXT TO the hash index + packed
    view, which at 10M-point scale can sum past one device.
    ``sequential_tiers=True`` trials the tiers one at a time — build, score, MEASURE
    immediately, free — so only one tier's corpus is ever resident next
    to the hash view; the winner's server is rebuilt by
    ``TuneReport.server()`` (exact servers are always rebuilt there, so
    nothing else changes).  Sequential exact tiers are measured even
    when they miss the target (their QPS cannot be measured later), a
    few extra timing rounds in exchange for 10M-scale tier comparisons
    fitting device memory in one report.
    """
    from ..ops.distance import exact_search
    from .build import build
    from .serving import Server

    points = jnp.asarray(points)
    if points.dtype != jnp.float32:
        points = points.astype(jnp.float32)
    n = points.shape[0]
    if queries is None:
        queries = _sample_queries(points, n_queries, seed)
    else:
        queries = jnp.asarray(queries, jnp.float32)
    m = queries.shape[0]
    if measure is None:
        measure = on_accelerator(points.devices())

    # metric preprocessing once, shared by oracle and every trial
    if metric != "l2":
        from ..data.preprocess import prepare_points

        pts_m = prepare_points(points, metric)
        q_m = prepare_points(queries, metric)
    else:
        pts_m, q_m = points, queries

    true_ids, _ = exact_search(pts_m, q_m, k)
    true_ids = np.asarray(true_ids)

    # trials dispatch at the PRODUCTION batch size: every call Server
    # sees has exactly `batch` rows.  batch >= m tiles the sample up (recall scored on the m
    # distinct rows); batch < m slices the sample into batch-shaped
    # calls and scores recall over ALL m rows (a single small batch
    # would make the recall gate statistically noisy — ~several percent
    # one-sigma at 32 queries)
    batch = m if batch is None else max(1, int(batch))
    if batch > m:
        tile = -(-batch // m)
        q_run = jnp.concatenate([queries] * tile)[:batch]
        q_m_run = jnp.concatenate([q_m] * tile)[:batch]
        q_slices = q_m_slices = None
    elif batch < m:
        def _slices(qarr):
            out = []
            for s in range(0, m, batch):
                e = s + batch
                out.append(qarr[s:e] if e <= m
                           else jnp.concatenate([qarr[s:m], qarr[: e - m]]))
            return out

        q_slices, q_m_slices = _slices(queries), _slices(q_m)
        q_run, q_m_run = q_slices[0], q_m_slices[0]
    else:
        q_run, q_m_run = queries, q_m
        q_slices = q_m_slices = None

    # one build + one pack serve all hash trials; trials dispatch through
    # Server.search so the measured path IS the production path
    trials: list[Trial] = []

    def note(t: Trial):
        trials.append(t)
        if verbose:
            print(f"  {t.engine:6s} {t.knobs} recall={t.recall:.3f} "
                  f"cost={t.cost:.0f}")

    runners: list[tuple[Trial, Any]] = []  # (trial, replayable thunk)

    def score_full(run_on, slices, q_default) -> float:
        """Recall over the full m-row sample.  batch < m: one
        batch-shaped production call per slice (the first call doubles
        as the compile warm-up the QPS pass relies on); otherwise one
        call scored on the m distinct leading rows."""
        if slices is None:
            ids, _ = run_on(q_default)
            return recall_at_k(true_ids[:m], np.asarray(ids)[:m], k)
        parts = []
        for i, qs in enumerate(slices):
            ids, _ = run_on(qs)
            take = min(batch, m - i * batch)
            parts.append(np.asarray(ids)[:take])
        return recall_at_k(true_ids, np.concatenate(parts), k)

    def run_exact_trials():
        # one trial per exact storage tier.  Trials dispatch through
        # Server.search so the measured path IS the production path.
        # Recall is vs the f32 oracle (None = 1.0 by construction; the
        # bf16/int8 tiers are measured, not assumed).
        for tier in exact_tiers:
            if tier not in (None, "bf16", "int8"):
                raise ValueError(f"unknown exact tier {tier!r}")
            dt = {None: None, "bf16": jnp.bfloat16,
                  "int8": jnp.int8}[tier]
            srv_e = Server.build(pts_m, k, mode="exact", metric="l2",
                                 storage_dtype=dt)

            def run_exact_on(qa, srv_e=srv_e):
                return srv_e.search(qa)

            def run_exact(run_on=run_exact_on):
                return run_on(q_m_run)

            knobs = {} if tier is None else {"storage_dtype": tier}
            t = Trial("exact", knobs,
                      score_full(run_exact_on, q_m_slices, q_m_run),
                      cost=float(n) / (1 if tier is None
                                       else (2 if tier == "bf16" else 4)))
            note(t)
            if sequential_tiers:
                # measure NOW (warm from the recall pass), then free this
                # tier's corpus before the next one builds — only one
                # tier resident at a time (see the HBM budget note)
                if measure:
                    t.qps = _measure_qps(run_exact, batch)
                    if verbose:
                        print(f"  measured {t.engine} {t.knobs}: "
                              f"{t.qps:.0f} QPS")
                runners.append((t, None))
                del srv_e, run_exact, run_exact_on
            else:
                runners.append((t, run_exact))

    if include_exact and k <= 128 and sequential_tiers:
        # sequential mode runs the tiers BEFORE the hash view exists, so
        # one tier's corpus copy is never resident NEXT TO corpus +
        # tables + packed rows: peak memory is max(one tier + corpus,
        # hash view + corpus)
        run_exact_trials()

    index, _, _ = build(points, k, metric=metric, seed=seed,
                        store_points=True, **build_kw)
    # packed_dtype: storage width of the packed rows (bf16 halves, int8
    # quarters them)
    packed = index.packed(window=max(window_grid), dtype=packed_dtype)
    sw = packed.super_width
    srv_packed = Server(points=points, k=k, mode="hash", metric=metric,
                        index=index, packed=packed)
    srv_table = Server(points=points, k=k, mode="hash", metric=metric,
                       index=index)

    if include_exact and k <= 128 and not sequential_tiers:
        run_exact_trials()

    for P in probe_grid:
        p_eff = P if P is not None else index.d_short + 1
        for w in window_grid:
            for rw in rerank_grid:
                for sr in super_grid:
                    def run_packed_on(qa, P=P, w=w, rw=rw, sr=sr):
                        return srv_packed.search(
                            qa, n_probes=P, window=w, rerank_width=rw,
                            supercharge_rounds=sr,
                        )

                    def run_packed(run_on=run_packed_on):
                        return run_on(q_run)

                    cost = index.tries * p_eff * w * sw
                    cost *= 1.0 + (0.0 if rw is None else rw / (2.0 * k))
                    cost *= 1.0 + 0.25 * (sr - 1)
                    knobs = {"n_probes": P, "window": w, "rerank_width": rw}
                    if len(super_grid) > 1 or sr != 1:
                        knobs["supercharge_rounds"] = sr
                    t = Trial("packed", knobs,
                              score_full(run_packed_on, q_slices, q_run),
                              cost)
                    note(t)
                    runners.append((t, run_packed))

    if include_table:
        for P in probe_grid:
            p_eff = P if P is not None else index.d_short + 1
            for rw in rerank_grid:
                def run_table_on(qa, P=P, rw=rw):
                    return srv_table.search(qa, n_probes=P,
                                            rerank_width=rw)

                def run_table(run_on=run_table_on):
                    return run_on(q_run)

                cost = index.tries * p_eff * index.tmax
                cost *= 1.0 + (0.0 if rw is None else rw / (2.0 * k))
                t = Trial("table", {"n_probes": P, "rerank_width": rw},
                          score_full(run_table_on, q_slices, q_run), cost)
                note(t)
                runners.append((t, run_table))

    qualified = [(t, r) for t, r in runners if t.recall >= target_recall]
    if not qualified:
        best = max(trials, key=lambda t: t.recall)
        cands = [(t, r) for t, r in runners if t is best]
    else:
        cands = qualified

    if measure:
        # measure_all: time every trial, not just the qualifying ones —
        # the report then answers ANY target offline (full frontier)
        for t, run in (runners if measure_all else cands):
            if run is None or t.qps is not None:
                continue  # sequential tiers were measured (then freed)
            t.qps = _measure_qps(run, batch)
            if verbose:
                print(f"  measured {t.engine} {t.knobs}: {t.qps:.0f} QPS")
        best = max((t for t, _ in cands), key=lambda t: t.qps)
    else:
        best = min((t for t, _ in cands), key=lambda t: t.cost)

    return TuneReport(best=best, trials=trials, k=k, metric=metric,
                      target_recall=target_recall, measured=measure,
                      batch=batch, batch_tiled=batch > m,
                      _points=points, _index=index, _packed=packed)
