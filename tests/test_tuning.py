"""Auto-tuner: operating-point search for a recall target (no reference
counterpart — the reference's knobs are hand-picked, ``ann.h:46-65``)."""

import numpy as np
import pytest

import approximatenn as ann
from approximatenn.engine.tuning import Trial, TuneReport, tune


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    # clustered so the hash path has structure to find
    centers = rng.standard_normal((20, 24)).astype(np.float32) * 3
    X = (centers[rng.integers(0, 20, 4000)]
         + rng.standard_normal((4000, 24)).astype(np.float32))
    Q = (centers[rng.integers(0, 20, 64)]
         + rng.standard_normal((64, 24)).astype(np.float32))
    return X, Q


@pytest.mark.slow
def test_tune_meets_target_or_max_recall(corpus):
    X, Q = corpus
    rep = tune(X, 5, queries=Q, target_recall=0.6, tries=6, seed=0,
               probe_grid=(None, 12), window_grid=(8, 16),
               rerank_grid=(None,), measure=False)
    assert isinstance(rep, TuneReport)
    assert rep.trials, "no trials evaluated"
    assert all(isinstance(t, Trial) for t in rep.trials)
    # exact is always a trial (recall 1.0) so the target is reachable
    assert rep.best.recall >= 0.6
    # cost-proxy mode: the winner is the CHEAPEST qualifying config
    qual = [t for t in rep.trials if t.recall >= 0.6]
    assert rep.best.cost == min(t.cost for t in qual)


def test_tune_server_round_trip(corpus):
    """report.server() serves the winning config and reproduces the
    reported recall on the tuning sample."""
    X, Q = corpus
    rep = tune(X, 5, queries=Q, target_recall=0.5, tries=6, seed=0,
               probe_grid=(12,), window_grid=(8,),
               rerank_grid=(None, 20), measure=False)
    srv = rep.server()
    ids, dists = srv.search(Q)
    assert ids.shape == (64, 5)
    true_ids, _ = ann.exact_search(X, Q, 5)
    from approximatenn.harness.scoring import recall_at_k

    got = recall_at_k(np.asarray(true_ids), np.asarray(ids), 5)
    assert abs(got - rep.best.recall) < 1e-9, (got, rep.best.recall)


def test_tune_without_exact_candidate(corpus):
    """include_exact=False: the winner comes from the hash grid even when
    no config meets an impossible target (falls back to max recall)."""
    X, Q = corpus
    rep = tune(X, 5, queries=Q, target_recall=1.01, include_exact=False,
               tries=4, seed=0, probe_grid=(None,), window_grid=(8,),
               rerank_grid=(None,), measure=False)
    assert rep.best.engine == "packed"
    assert rep.best.recall == max(t.recall for t in rep.trials)


def test_tune_table_engine_and_dicts(corpus):
    X, Q = corpus
    rep = tune(X, 5, queries=Q, target_recall=0.0, include_exact=False,
               include_table=True, tries=4, seed=0, probe_grid=(12,),
               window_grid=(8,), rerank_grid=(None,), measure=False)
    engines = {t.engine for t in rep.trials}
    assert engines == {"packed", "table"}
    d = rep.as_dict()
    assert d["best"]["engine"] in ("packed", "table")
    assert len(d["trials"]) == len(rep.trials)
    # table winner must serve through the table path
    tbl = [t for t in rep.trials if t.engine == "table"][0]
    rep.best = tbl
    srv = rep.server()
    assert srv.packed is None
    ids, _ = srv.search(Q)
    assert ids.shape == (64, 5)


def test_tune_synthesizes_queries(corpus):
    X, _ = corpus
    rep = tune(X, 5, n_queries=32, target_recall=0.0, tries=4, seed=1,
               probe_grid=(None,), window_grid=(8,), rerank_grid=(None,),
               measure=False)
    assert rep.best is not None
    assert all(0.0 <= t.recall <= 1.0 for t in rep.trials)


def test_tune_angular_metric(corpus):
    X, Q = corpus
    rep = tune(X, 5, queries=Q, metric="angular", target_recall=0.0,
               tries=4, seed=0, probe_grid=(12,), window_grid=(8,),
               rerank_grid=(None,), measure=False)
    srv = rep.server()
    ids, _ = srv.search(Q)
    assert ids.shape == (64, 5)


def test_tune_batch_knob(corpus):
    """Trials dispatch at the PRODUCTION batch size: every call
    Server.search sees has exactly `batch` rows, and recall is scored
    over the FULL sample (batch < m slices it into batch-shaped calls — one small
    batch would make the recall gate statistically noisy)."""
    X, Q = corpus
    for batch in (16, 200):
        rep = tune(X, 5, queries=Q, batch=batch, target_recall=0.5,
                   tries=4, seed=0, probe_grid=(12,), window_grid=(8,),
                   rerank_grid=(None,), measure=False)
        assert rep.batch == batch
        assert rep.as_dict()["batch"] == batch
        pk = [t for t in rep.trials if t.engine == "packed"]
        assert pk and all(set(t.knobs) == {"n_probes", "window",
                                           "rerank_width"} for t in pk)
        assert all(0.0 <= t.recall <= 1.0 for t in rep.trials)
        # the winner still serves
        ids, _ = rep.server().search(Q)
        assert ids.shape == (64, 5)


def test_tune_exact_tiers_and_super_grid(corpus):
    """Round-4 trial space: exact storage tiers (bf16/int8) and
    supercharge_rounds are tunable knobs; the winner's server reproduces
    the winning tier."""
    X, Q = corpus
    rep = tune(X, 5, queries=Q, target_recall=0.0, tries=4, seed=0,
               probe_grid=(12,), window_grid=(8,), rerank_grid=(None,),
               super_grid=(1, 2), exact_tiers=(None, "bf16", "int8"),
               measure=False)
    exact_trials = [t for t in rep.trials if t.engine == "exact"]
    tiers = {t.knobs.get("storage_dtype") for t in exact_trials}
    assert tiers == {None, "bf16", "int8"}
    # f32 exact is 1.0 by construction; tiers close behind on this corpus
    by_tier = {t.knobs.get("storage_dtype"): t.recall for t in exact_trials}
    assert by_tier[None] == 1.0
    assert by_tier["bf16"] > 0.9 and by_tier["int8"] > 0.8
    srs = {t.knobs.get("supercharge_rounds")
           for t in rep.trials if t.engine == "packed"}
    assert srs == {1, 2}
    # a tier winner serves through Server.build(storage_dtype=...)
    rep.best = [t for t in exact_trials
                if t.knobs.get("storage_dtype") == "bf16"][0]
    srv = rep.server()
    assert srv.points.dtype == np.dtype("bfloat16") or str(
        srv.points.dtype) == "bfloat16"
    ids, _ = srv.search(Q)
    assert ids.shape == (64, 5)
    assert rep.as_dict()["batch_tiled"] is False


def test_tune_batch_tiled_flag(corpus):
    X, Q = corpus
    rep = tune(X, 5, queries=Q[:16], batch=64, target_recall=0.0,
               tries=4, seed=0, probe_grid=(12,), window_grid=(8,),
               rerank_grid=(None,), measure=False)
    assert rep.batch_tiled is True


@pytest.mark.slow
def test_ann_bench_tune_cli(capsys):
    """ann_bench --tune prints one TuneReport JSON line."""
    import json

    from approximatenn.harness import ann_bench

    rc = ann_bench.main([
        "--dataset", "gaussian-10k", "--max-n", "2000", "--k", "5",
        "--tries", "4", "--batch", "32", "--tune", "--target-recall", "0.5",
    ])
    out = capsys.readouterr().out
    assert rc == 0
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["target_recall"] == 0.5
    assert rec["best"]["recall"] >= 0.5  # exact is always in the pool
    assert rec["trials"]


def test_tune_sequential_tiers(corpus):
    """sequential_tiers=True (round-5): tiers are trialed one at a time
    (built, scored, freed) — report contents and winner semantics match
    the all-resident mode; the winner's server still serves."""
    X, Q = corpus
    rep = tune(X, 5, queries=Q, target_recall=0.9, tries=4, seed=0,
               probe_grid=(12,), window_grid=(8,), rerank_grid=(None,),
               exact_tiers=(None, "bf16", "int8"),
               sequential_tiers=True, measure=False)
    ex = [t for t in rep.trials if t.engine == "exact"]
    assert len(ex) == 3  # all three tiers trialed in ONE report
    tiers = {t.knobs.get("storage_dtype") for t in ex}
    assert tiers == {None, "bf16", "int8"}
    assert ex[0].recall == 1.0  # full-precision tier is the oracle
    srv = rep.server()
    ids, _ = srv.search(Q)
    assert np.asarray(ids).shape == (64, 5)
