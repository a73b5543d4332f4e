"""Packed (bucket-CSR wide-row) serving view — correctness gates.

The packed layout must preserve the search contract (sentinel padding,
dedup-by-min-distance, squared-L2 on raw coordinates) while its candidate
set is a *superset* of the padded-table path's at window >= tmax (alignment
spillover only adds real points).  Gates: recall not worse than the padded
path, candidate-superset property, window/knob behavior, metric handling.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import approximatenn as ann


def _recall(ids, true_ids):
    ids, true_ids = np.asarray(ids), np.asarray(true_ids)
    hits = sum(
        len(set(r[r < len(ids) * 10**9]) & set(t)) for r, t in zip(ids, true_ids)
    )
    return hits / true_ids.size


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(7)
    n, d, k, m = 4000, 24, 10, 64
    X = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    Y = jnp.asarray(rng.standard_normal((m, d)).astype(np.float32))
    index, _, _ = ann.build(X, k, tries=6, seed=3)
    true_ids, _ = ann.brute_force_knn(X, Y, k)
    return X, Y, index, true_ids


def test_packed_matches_or_beats_padded_path(built):
    X, Y, index, true_ids = built
    ids_row, dists_row = ann.search(index, X, Y)
    pi = index.packed(X)
    ids_p, dists_p = ann.search_packed(pi, X, Y)
    assert ids_p.shape == ids_row.shape and dists_p.shape == dists_row.shape
    r_row = _recall(ids_row, true_ids)
    r_p = _recall(ids_p, true_ids)
    # superset candidates -> the packed view should not lose quality
    assert r_p >= r_row - 0.02, (r_p, r_row)
    assert r_p > 0.5
    # distances are squared L2 on raw coordinates
    m, k = ids_p.shape
    sample = np.asarray(ids_p[:8])
    dd = np.asarray(dists_p[:8])
    Xn, Yn = np.asarray(X), np.asarray(Y)
    for r in range(8):
        for c in range(k):
            if sample[r, c] < index.n:
                ref = float(((Yn[r] - Xn[sample[r, c]]) ** 2).sum())
                assert abs(ref - float(dd[r, c])) < 1e-3 * max(1.0, ref)


def test_packed_candidate_superset(built):
    """Every id the padded table can serve for a probe is inside the packed
    window read for that probe (window >= tmax)."""
    X, Y, index, _ = built
    pi = index.packed(X)
    t, b = 2, 5  # arbitrary table/bucket
    tbl = np.asarray(index.tables[t, b])
    tbl = tbl[tbl < index.n]
    starts = np.asarray(pi.starts)
    ids = np.asarray(pi.ids)
    s = starts[t, b]
    w = pi.super_width
    lo = (s // w) * w
    covered = ids[t, lo : lo + pi.rows_per_probe() * w]
    assert set(tbl) <= set(covered.tolist())


def test_packed_window_knob(built):
    X, Y, index, true_ids = built
    pi = index.packed(X)
    shallow = pi.with_window(2)
    assert shallow.rows_per_probe() < pi.rows_per_probe()
    ids_s, _ = ann.search_packed(shallow, X, Y)
    ids_f, _ = ann.search_packed(pi, X, Y)
    assert _recall(ids_f, true_ids) >= _recall(ids_s, true_ids) - 0.02


def test_packed_directed_probes(built):
    X, Y, index, true_ids = built
    pi = index.packed(X)
    ids_b, _ = ann.search_packed(pi, X, Y)
    ids_d, _ = ann.search_packed(pi, X, Y, n_probes=index.d_short + 1)
    assert _recall(ids_d, true_ids) >= _recall(ids_b, true_ids) - 0.02


def test_packed_staged_equals_direct(built):
    """packed(staged=True) from a stage_points buffer == packed(points)
    when the staging dtype matches (same codes -> same CSR -> same rows)."""
    from approximatenn.index import stage_points

    X, Y, index, true_ids = built
    direct = index.packed(X, store_points=False)
    staged = index.packed(stage_points(X), staged=True, store_points=False)
    assert staged.d == direct.d and staged.lane_dim == direct.lane_dim
    np.testing.assert_array_equal(np.asarray(staged.ids), np.asarray(direct.ids))
    np.testing.assert_array_equal(
        np.asarray(staged.point_rows), np.asarray(direct.point_rows)
    )
    ids_s, _ = ann.search_packed(staged, X, Y)
    ids_d, _ = ann.search_packed(direct, X, Y)
    np.testing.assert_array_equal(np.asarray(ids_s), np.asarray(ids_d))


def test_packed_rerank_width(built):
    """A wider rerank pool keeps the output shape and never loses recall."""
    X, Y, index, true_ids = built
    pv = index.packed(X)
    ids0, _ = ann.search_packed(pv, X, Y)
    ids_w, _ = ann.search_packed(pv, X, Y, rerank_width=24)
    assert ids_w.shape == ids0.shape
    assert _recall(ids_w, true_ids) >= _recall(ids0, true_ids) - 1e-9


@pytest.mark.slow
def test_packed_staged_self_contained(built):
    """A staged view with store_points=True serves supercharge/rerank from
    the staging buffer itself (lane-padded, +inf sentinel row) — no second
    corpus resident (the 10M single-chip serving budget).  Results match
    serving the same view against the raw corpus."""
    from approximatenn.index import stage_points

    X, Y, index, true_ids = built
    staged = index.packed(stage_points(X), staged=True, store_points=True)
    assert staged.points is not None
    assert staged.points.shape == (index.n + 1, staged.lane_dim)
    ids_self, d_self = ann.search_packed(staged, Y, supercharge_rounds=2,
                                         rerank_width=3 * index.k)
    ids_raw, d_raw = ann.search_packed(staged, X, Y, supercharge_rounds=2,
                                       rerank_width=3 * index.k)
    np.testing.assert_array_equal(np.asarray(ids_self), np.asarray(ids_raw))
    np.testing.assert_allclose(np.asarray(d_self), np.asarray(d_raw),
                               rtol=1e-5, atol=1e-5)


def test_packed_bf16_storage(built):
    X, Y, index, true_ids = built
    pi = index.packed(X, dtype=jnp.bfloat16)
    assert pi.point_rows.dtype == jnp.bfloat16
    ids_p, dists_p = ann.search_packed(pi, X, Y)
    # bf16 candidate vectors cost a little recall at most
    assert _recall(ids_p, true_ids) > 0.45
    assert np.isfinite(np.asarray(dists_p[:, 0])).all()


def test_packed_bf16_corpus_not_upcast(built):
    """A bf16 corpus passed to the search wrappers is served as stored
    (never upcast to a full f32 copy — the 10M device-memory budget);
    supercharge distance gathers upcast per-block via type promotion."""
    X, Y, index, true_ids = built
    Xb = X.astype(jnp.bfloat16)
    pi = index.packed(Xb, store_points=False)
    ids_b, dists_b = ann.search_packed(pi, Xb, Y)
    ids_f, _ = ann.search_packed(pi, X, Y)
    rb, rf = _recall(ids_b, true_ids), _recall(ids_f, true_ids)
    assert rb >= rf - 0.02, (rb, rf)
    # table path accepts a bf16 corpus too
    ids_t, _ = ann.search(index, Xb, Y)
    assert _recall(ids_t, true_ids) > 0.5
    # distances remain f32 math over bf16-quantized vectors
    assert dists_b.dtype == index.bases.dtype
    sample, dd = np.asarray(ids_b[:4]), np.asarray(dists_b[:4])
    Xq = np.asarray(Xb.astype(jnp.float32))
    Yn = np.asarray(Y)
    for r in range(4):
        for c in range(ids_b.shape[1]):
            if sample[r, c] < index.n:
                ref = float(((Yn[r] - Xq[sample[r, c]]) ** 2).sum())
                assert abs(ref - float(dd[r, c])) < 2e-2 * max(1.0, ref)


def test_packed_sentinel_and_shapes(built):
    X, Y, index, _ = built
    pi = index.packed(X, window=4, super_width=8)
    assert pi.super_width == 8
    # storage is flat (one point per row); super_width only sets the
    # serve-time grouping and the n_pad alignment
    assert pi.point_rows.shape == (pi.tries * pi.n_pad, pi.lane_dim)
    assert pi.n_pad % 8 == 0
    assert pi.lane_dim % 128 == 0 and pi.lane_dim >= pi.d
    ids_p, dists_p = ann.search_packed(pi, X, Y)
    ids_np = np.asarray(ids_p)
    assert ids_np.max() <= index.n
    # sentinel rows carry +inf distance
    d_np = np.asarray(dists_p)
    assert np.all(np.isinf(d_np[ids_np == index.n]) | (ids_np != index.n).all())


def test_packed_angular_metric(rng):
    n, d, k, m = 2000, 16, 5, 32
    X = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    Y = jnp.asarray(rng.standard_normal((m, d)).astype(np.float32))
    index, _, _ = ann.build(X, k, tries=4, seed=1, metric="angular")
    pi = index.packed()  # points stored on the index for angular
    ids_p, _ = ann.search_packed(pi, queries=Y)
    Xn = np.asarray(index.points)
    Yn = np.asarray(Y) / np.linalg.norm(np.asarray(Y), axis=1, keepdims=True)
    d2 = ((Yn[:, None, :] - Xn[None, :, :]) ** 2).sum(-1)
    true_ids = np.argsort(d2, axis=1)[:, :k]
    assert _recall(ids_p, true_ids) > 0.4


@pytest.mark.slow
def test_packed_supercharge_rounds(built):
    """Knob parity with the table path: extra graph rounds may only help
    (monotone candidate pool), 0 disables supercharge entirely."""
    X, Y, index, true_ids = built
    pi = index.packed(X, store_points=False)
    recs = []
    for rounds in (0, 1, 2):
        ids, _ = ann.search_packed(pi, X, Y, supercharge_rounds=rounds)
        recs.append(_recall(ids, true_ids))
    assert recs[1] >= recs[0] - 1e-9 and recs[2] >= recs[1] - 1e-9, recs


def test_packed_save_load_roundtrip(built, tmp_path):
    """Packed views persist (serving restarts skip the re-pack); bf16
    rows round-trip through the uint16 encoding."""
    X, Y, index, true_ids = built
    for dt in (None, jnp.bfloat16):
        pi = index.packed(X, dtype=dt, store_points=False)
        p = str(tmp_path / f"pv_{dt}.npz")
        pi.save(p)
        pi2 = ann.PackedIndex.load(p)
        assert pi2.point_rows.dtype == pi.point_rows.dtype
        assert (pi2.n, pi2.k, pi2.window, pi2.super_width, pi2.d_pad) == (
            pi.n, pi.k, pi.window, pi.super_width, pi.d_pad
        )
        ids_a, _ = ann.search_packed(pi, X, Y)
        ids_b, _ = ann.search_packed(pi2, X, Y)
        np.testing.assert_array_equal(np.asarray(ids_a), np.asarray(ids_b))


def test_packed_requires_points():
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((500, 8)).astype(np.float32))
    index, _, _ = ann.build(X, 5, tries=3, seed=0)
    with pytest.raises(ValueError):
        index.packed()  # no stored points, none passed
    pi = index.packed(X, store_points=False)
    with pytest.raises(ValueError):
        ann.search_packed(pi, queries=X[:4])
    ids, _ = ann.search_packed(pi, X, X[:4])
    assert np.asarray(ids).shape == (4, 5)


def test_packed_int8_quantized_tier(built):
    """int8 storage: scale on the view, distances re-scored against the
    float corpus (so returned distances are TRUE squared L2), recall within
    a whisker of the float path, tail padding still sentinel."""
    X, Y, index, true_ids = built
    pi = index.packed(X, dtype=jnp.int8)
    assert pi.point_rows.dtype == jnp.int8
    assert pi.scale is not None and float(pi.scale) > 0
    # n_pad covers every slot plus the sentinel in whole super-rows
    assert pi.n_pad % pi.super_width == 0 and pi.n_pad > index.n
    ids_q, dists_q = ann.search_packed(pi, X, Y)
    ids_f, _ = ann.search_packed(index.packed(X), X, Y)
    rq, rf = _recall(ids_q, true_ids), _recall(ids_f, true_ids)
    assert rq >= rf - 0.05, (rq, rf)
    # the post-kernel re-score makes returned distances exact squared L2
    sample, dd = np.asarray(ids_q[:8]), np.asarray(dists_q[:8])
    Xn, Yn = np.asarray(X), np.asarray(Y)
    for r in range(8):
        for c in range(ids_q.shape[1]):
            if sample[r, c] < index.n:
                ref = float(((Yn[r] - Xn[sample[r, c]]) ** 2).sum())
                assert abs(ref - float(dd[r, c])) < 1e-3 * max(1.0, ref)


def test_packed_int8_tombstones(built):
    """Removed ids must never come back through the int8 view even though
    int8 has no +inf row encoding (the id-map masking path)."""
    X, Y, index, _ = built
    doomed = np.unique(np.asarray(ann.search_packed(
        index.packed(X, dtype=jnp.int8), X, Y)[0])[:, 0])[:5]
    idx2 = index.remove_points(jnp.asarray(doomed))
    pi2 = idx2.packed(X, dtype=jnp.int8)
    ids2, dd2 = ann.search_packed(pi2, X, Y)
    got = set(np.asarray(ids2).ravel().tolist())
    assert not (got & set(doomed.tolist()))
    assert np.isfinite(np.asarray(dd2[:, 0])).all()


@pytest.mark.slow
def test_packed_int8_tombstones_near_origin():
    """The round-2 VERDICT hole: int8 has no +inf encoding, so tombstoned
    slots used to sit in the packed buffer as ZERO rows at finite distance
    ||q/s||^2 — for near-origin queries they displaced real candidates
    from the per-table top-k before the id map masked them.  packed() now
    relocates dead slots to the tail (positions >= n_live), where the
    purely positional sentinel masks exclude them BEFORE the top-k, in
    the packed search path."""
    rng = np.random.default_rng(11)
    n, d, k = 2048, 24, 10
    X = rng.standard_normal((n, d)).astype(np.float32)
    # 64 points near the origin; remove half of them — the removed ones
    # quantize to ~zero rows, i.e. distance ~0 to an origin query (the
    # strongest displacement bait), while the surviving half are the true
    # nearest live neighbors
    X[:64] = 0.3 * rng.standard_normal((64, d)).astype(np.float32)
    X = jnp.asarray(X)
    index, _, _ = ann.build(X, k, tries=6, seed=3)
    doomed = np.arange(0, 64, 2)
    idx2 = index.remove_points(jnp.asarray(doomed))
    pi2 = idx2.packed(X, dtype=jnp.int8)
    assert pi2.n_live == n - len(doomed)
    # every dead slot was relocated past the live bound: the id map's
    # tail is all sentinel
    assert (np.asarray(pi2.ids)[:, pi2.n_live:] == n).all()

    # true live top-k at the origin (oracle with dead rows excluded)
    Y0 = jnp.asarray(0.05 * rng.standard_normal((16, d)).astype(np.float32))
    dist = ((np.asarray(Y0)[:, None, :] - np.asarray(X)[None]) ** 2).sum(-1)
    dist[:, doomed] = np.inf
    true_live = np.argsort(dist, axis=1)[:, :k]

    for ids, dd in (ann.search_packed(pi2, X, Y0),):
        got = np.asarray(ids)
        assert not (set(got.ravel().tolist()) & set(doomed.tolist()))
        # real candidates survive: the top-1 slot is a live id at its
        # true distance, not a sentinel (the old code returned mostly
        # sentinels here — dead zero-rows won every per-table slot)
        assert (got[:, 0] < n).all()
        assert np.isfinite(np.asarray(dd)[:, 0]).all()
        assert _recall(ids, true_live) >= 0.6


def test_packed_int8_save_load(built, tmp_path):
    X, Y, index, _ = built
    pi = index.packed(X, dtype=jnp.int8, store_points=False)
    p = str(tmp_path / "pv_int8.npz")
    pi.save(p)
    pi2 = ann.PackedIndex.load(p)
    assert pi2.point_rows.dtype == jnp.int8
    assert pi2.scale is not None
    assert float(pi2.scale) == pytest.approx(float(pi.scale))
    ids_a, _ = ann.search_packed(pi, X, Y)
    ids_b, _ = ann.search_packed(pi2, X, Y)
    np.testing.assert_array_equal(np.asarray(ids_a), np.asarray(ids_b))


def test_packed_int8_staged(built):
    """Staged bf16 buffer + dtype=int8 quantizes at pack time and keeps the
    float staging buffer as the rerank/supercharge corpus (the 10M int8
    serving budget); staged int8 input is rejected."""
    from approximatenn.index import stage_points

    X, Y, index, true_ids = built
    Xs = stage_points(X, jnp.bfloat16)
    pi = index.packed(Xs, staged=True, dtype=jnp.int8, store_points=True)
    assert pi.point_rows.dtype == jnp.int8
    assert pi.points.dtype == jnp.bfloat16  # the staging buffer itself
    ids_q, _ = ann.search_packed(pi, queries=Y)
    rq = _recall(ids_q, true_ids)
    ids_f, _ = ann.search_packed(index.packed(X), X, Y)
    assert rq >= _recall(ids_f, true_ids) - 0.05
    with pytest.raises(ValueError):
        index.packed(pi.point_rows[: X.shape[0] + 1], staged=True)


def test_packed_rows_big_matches_one_shot(built):
    """The huge-pack fill path (per-table donated updates, used above 2 GB
    output) must produce byte-identical rows to the one-shot gather."""
    from approximatenn.index import _packed_rows, _packed_rows_big

    X, _, index, _ = built
    from approximatenn.index import stage_points

    pts_s = stage_points(X)
    # CSR slot ids, same construction packed() uses: recompute via packed()
    pv = index.packed(X)
    n_pad = pv.ids.shape[1]
    a = _packed_rows(pts_s, pv.ids)
    b = _packed_rows_big(pts_s, pv.ids, n_pad)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_drop_tables_serving_only(built):
    X, Y, index, true_ids = built
    slim = index.drop_tables()
    assert slim.tables is None and slim.counts is None
    # packed view still builds and serves identically
    ids_a, _ = ann.search_packed(index.packed(X), X, Y)
    ids_b, _ = ann.search_packed(slim.packed(X), X, Y)
    np.testing.assert_array_equal(np.asarray(ids_a), np.asarray(ids_b))
    # table path refuses loudly; metadata stays usable
    with pytest.raises(ValueError, match="drop_tables"):
        ann.search(slim, X, Y)
    with pytest.raises(ValueError, match="drop_tables"):
        slim.save("/tmp/should_not_exist.npz")
    assert slim.memory_bytes() < index.memory_bytes()


def test_packed_save_load_bf16_points_roundtrip(built, tmp_path):
    """bf16 stored corpora must survive save/load: numpy silently writes
    ml_dtypes bfloat16 as void 'V2', which jnp.asarray rejects at load —
    every 2-byte float field goes through the uint16-word stash."""
    from approximatenn.index import PackedIndex, stage_points

    X, Y, index, _ = built
    Xs = stage_points(X, jnp.bfloat16)
    pv = index.packed(Xs, staged=True, store_points=True)
    assert pv.points.dtype == jnp.bfloat16
    p = str(tmp_path / "pv_bf16.npz")
    pv.save(p)
    pv2 = PackedIndex.load(p)
    assert pv2.points.dtype == jnp.bfloat16
    ids_a, _ = ann.search_packed(pv, queries=Y)
    ids_b, _ = ann.search_packed(pv2, queries=Y)
    np.testing.assert_array_equal(np.asarray(ids_a), np.asarray(ids_b))


def test_drop_tables_update_guards(built):
    X, _, index, _ = built
    slim = index.drop_tables()
    with pytest.raises(ValueError, match="drop_tables"):
        slim.add_points(X[:4], X)
    with pytest.raises(ValueError, match="drop_tables"):
        slim.remove_points([1, 2])
