"""End-to-end build/search gates (role of ``test_correctness.c``).

Gate 1 of SURVEY.md §4: statistical correctness against the exact
brute-force oracle at the reference's default operating point
(n=1000, d=80, k=10, tries=10) and at BASELINE config 1 (10k x 32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import approximatenn as ann
from approximatenn.harness.scoring import recall_at_k, score_guesses


@pytest.fixture(scope="module")
def default_data():
    rng = np.random.default_rng(7)
    X = rng.standard_normal((1000, 80)).astype(np.float32)
    Y = rng.standard_normal((50, 80)).astype(np.float32)
    return X, Y


@pytest.fixture(scope="module")
def built(default_data):
    X, _ = default_data
    return ann.build(X, 10, seed=1)


class TestBuild:
    def test_shapes_and_meta(self, built, default_data):
        X, _ = default_data
        idx, graph, gd = built
        assert graph.shape == (1000, 10) and gd.shape == (1000, 10)
        assert idx.d_short == 7 and idx.n_buckets == 128
        assert idx.tables.shape == (10, 128, idx.tmax)
        assert idx.bases.shape == (10, 7, 80)
        assert idx.graph.dtype == jnp.int32

    def test_graph_excludes_self_and_in_range(self, built):
        idx, graph, _ = built
        g = np.asarray(graph)
        assert not any(i in g[i] for i in range(1000))
        assert (g >= 0).all() and (g <= 1000).all()

    def test_graph_dists_are_true_sq_dists(self, built, default_data):
        X, _ = default_data
        idx, graph, gd = built
        g, d = np.asarray(graph), np.asarray(gd)
        i = 17
        for j in range(10):
            want = ((X[i] - X[g[i, j]]) ** 2).sum()
            np.testing.assert_allclose(d[i, j], want, rtol=1e-4)

    def test_graph_sorted_by_distance(self, built):
        _, _, gd = built
        d = np.asarray(gd)
        assert (np.diff(d, axis=1) >= -1e-6).all()

    def test_recall_default_point(self, built, default_data):
        X, _ = default_data
        _, graph, _ = built
        s = score_guesses(X, None, np.asarray(graph), 10)
        # the reference's own harness at this point reports ~0.85-0.95
        assert s.prob_correct > 0.75, str(s)
        assert s.mean_excess_rank < 10, str(s)

    def test_deterministic_same_key(self, default_data):
        X, _ = default_data
        _, g1, _ = ann.build(X, 10, key=jax.random.key(42))
        _, g2, _ = ann.build(X, 10, key=jax.random.key(42))
        np.testing.assert_array_equal(np.asarray(g1), np.asarray(g2))

    def test_different_keys_differ_hash_graph(self, default_data):
        # the hash-pipeline graph is an approximation steered by the
        # transform key (reference semantics, alg.c:387-392)
        X, _ = default_data
        _, g1, _ = ann.build(X, 10, key=jax.random.key(1), graph_mode="hash")
        _, g2, _ = ann.build(X, 10, key=jax.random.key(2), graph_mode="hash")
        assert (np.asarray(g1) != np.asarray(g2)).any()

    def test_exact_graph_key_invariant_and_true(self, default_data):
        # graph_mode="exact" (the auto default at this size) returns the
        # true kNN graph regardless of the transform key
        X, _ = default_data
        _, g1, _ = ann.build(X, 10, key=jax.random.key(1))
        _, g2, _ = ann.build(X, 10, key=jax.random.key(2))
        np.testing.assert_array_equal(np.asarray(g1), np.asarray(g2))
        ti, _ = ann.brute_force_knn_self(X, 10)
        np.testing.assert_array_equal(
            np.sort(np.asarray(g1), 1), np.sort(np.asarray(ti), 1)
        )


class TestSearch:
    def test_supercharge_rounds_knob(self, built, default_data):
        X, Y = default_data
        idx, _, _ = built
        r = []
        for rounds in (0, 1, 3):
            ids, _ = ann.search(idx, X, Y, supercharge_rounds=rounds)
            s = score_guesses(X, Y, np.asarray(ids), 10)
            r.append(s.prob_correct)
        assert r[1] >= r[0] - 0.02  # one round helps (reference semantics)
        assert r[2] >= r[1] - 0.02  # more rounds never meaningfully hurt

    def test_rerank_width_monotone_recall(self, built, default_data):
        X, Y = default_data
        idx, _, _ = built
        r = []
        for width in (None, 30, 60):
            ids, dists = ann.search(idx, X, Y, rerank_width=width)
            assert ids.shape == (Y.shape[0], 10)
            d = np.asarray(dists)
            assert (np.diff(d, axis=1) >= -1e-6).all()
            s = score_guesses(X, Y, np.asarray(ids), 10)
            r.append(s.prob_correct)
        # a wider pool feeds supercharge more seeds: recall never
        # meaningfully drops, and the widest pool is at least as good as
        # the reference-width baseline
        assert r[1] >= r[0] - 0.02
        assert r[2] >= r[0] - 0.02

    def test_query_recall_default_point(self, built, default_data):
        X, Y = default_data
        idx, _, _ = built
        ids, dists = ann.search(idx, X, Y)
        s = score_guesses(X, Y, np.asarray(ids), 10)
        assert s.prob_correct > 0.75, str(s)

    def test_chunked_driver_matches_one_shot(self, built, default_data):
        # the host-chunked driver (auto-selected for huge corpora where the
        # monolithic program's remat layout copies OOM) must be an exact
        # semantic match for the one-shot jit: per-table top-kk + dedup
        # merge == union top-kk
        X, Y = default_data
        idx, _, _ = built
        for kw in ({}, {"n_probes": 4}, {"rerank_width": 25},
                   {"supercharge_rounds": 2}):
            i0, d0 = ann.search(idx, X, Y, chunked=False, **kw)
            i1, d1 = ann.search(idx, X, Y, chunked=True, **kw)
            np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
            np.testing.assert_allclose(
                np.asarray(d0), np.asarray(d1), rtol=1e-5
            )

    def test_query_dists_sorted_and_true(self, built, default_data):
        X, Y = default_data
        idx, _, _ = built
        ids, dists = ann.search(idx, X, Y)
        ids, dists = np.asarray(ids), np.asarray(dists)
        assert (np.diff(dists, axis=1) >= -1e-6).all()
        for j in range(10):
            want = ((Y[3] - X[ids[3, j]]) ** 2).sum()
            np.testing.assert_allclose(dists[3, j], want, rtol=1e-4)

    def test_block_size_invariance(self, built, default_data):
        X, Y = default_data
        idx, _, _ = built
        a, _ = ann.search(idx, X, Y, block_rows=7)
        b, _ = ann.search(idx, X, Y, block_rows=50)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_reference_api_aliases(self, default_data):
        X, Y = default_data
        graph, gd, idx = ann.precomp(X, 10, tries=4, seed=0)
        assert idx is not None
        ids, dists = ann.query(idx, X, Y)
        assert ids.shape == (50, 10)
        g2, _, none = ann.precomp(X, 10, tries=4, seed=0, save=False)
        assert none is None
        np.testing.assert_array_equal(np.asarray(graph), np.asarray(g2))


class TestConfig1:
    """BASELINE config 1: random Gaussian 10k x 32 float, k=10."""

    def test_recall_10k_32(self):
        rng = np.random.default_rng(99)
        X = rng.standard_normal((10_000, 32)).astype(np.float32)
        Y = rng.standard_normal((200, 32)).astype(np.float32)
        idx, graph, _ = ann.build(X, 10, seed=5)
        tg, _ = ann.brute_force_knn_self(jnp.asarray(X), 10)
        assert recall_at_k(np.asarray(tg), np.asarray(graph), 10) > 0.6
        ids, _ = ann.search(idx, X, Y)
        tq, _ = ann.brute_force_knn(jnp.asarray(X), jnp.asarray(Y), 10)
        assert recall_at_k(np.asarray(tq), np.asarray(ids), 10) > 0.6


class TestEdgeCases:
    def test_capacity_mode_jittable_and_close(self, default_data):
        X, _ = default_data
        idx_e, g_e, _ = ann.build(X, 10, seed=3)
        idx_c, g_c, _ = ann.build(X, 10, seed=3, capacity=idx_e.tmax)
        np.testing.assert_array_equal(np.asarray(g_e), np.asarray(g_c))

    def test_small_capacity_still_works(self, default_data):
        X, _ = default_data
        idx, graph, _ = ann.build(X, 10, seed=3, capacity=4)
        s = score_guesses(X, None, np.asarray(graph), 10)
        assert s.prob_correct > 0.3  # degraded but functional

    def test_n_smaller_than_buckets(self):
        rng = np.random.default_rng(1)
        X = rng.standard_normal((64, 16)).astype(np.float32)
        idx, graph, _ = ann.build(X, 5, tries=3, seed=0)
        g = np.asarray(graph)
        assert ((g >= 0) & (g <= 64)).all()

    def test_k_larger_rows_padded_with_sentinel(self):
        rng = np.random.default_rng(2)
        X = rng.standard_normal((30, 8)).astype(np.float32)
        idx, graph, gd = ann.build(X, 10, tries=2, seed=0)
        assert ((np.asarray(graph) <= 30)).all()

    def test_float64(self, default_data):
        X, _ = default_data
        jax.config.update("jax_enable_x64", True)
        try:
            idx, graph, _ = ann.build(
                X.astype(np.float64), 10, seed=1, dtype=jnp.float64
            )
            s = score_guesses(X, None, np.asarray(graph), 10)
            assert s.prob_correct > 0.75
        finally:
            jax.config.update("jax_enable_x64", False)


class TestAutoCapacity:
    def test_auto_caps_hot_buckets(self, rng):
        """Clustered data: exact-max capacity explodes; auto stays linear
        and recall stays usable (points remain reachable via other tables
        and the graph)."""
        import approximatenn as ann
        from approximatenn.data import clustered_gaussian
        from approximatenn.ops.distance import brute_force_knn

        base = clustered_gaussian(rng, 6000, 16, n_clusters=8, zipf=1.5)
        import jax.numpy as jnp

        Xd = jnp.asarray(base)
        exact, _, _ = ann.build(Xd, 10, tries=6, seed=0)
        auto, _, _ = ann.build(Xd, 10, tries=6, seed=0, capacity="auto")
        assert auto.tmax < exact.tmax  # clustered data must trigger the cap
        q = jnp.asarray(base[rng.integers(0, 6000, 50)]
                        + 0.05 * rng.standard_normal((50, 16)).astype(np.float32))
        true_ids, _ = brute_force_knn(Xd, q, 10)
        got, _ = ann.search(auto, Xd, q)
        got, want = np.asarray(got), np.asarray(true_ids)
        recall = np.mean([len(set(got[i]) & set(want[i])) / 10 for i in range(50)])
        assert recall >= 0.6

    class _Dev:
        def __init__(self, stats):
            self._stats = stats

        def memory_stats(self):
            return self._stats

    @pytest.mark.parametrize("limit, want_auto", [
        (4 * 2 * 64 * 1000 * 4, False),  # exact-max tables fit the share
        (4 * 2 * 64 * 1000 * 4 - 4, True),  # one word over: "auto"
        (None, False),  # no limit reported: the explicit CPU budget
    ])
    def test_default_capacity_bounded_by_device(self, limit, want_auto):
        """capacity=None keeps the reference's exact max while its tables
        fit TABLE_SHARE of the device's memory limit, else takes "auto"
        and says so."""
        import warnings

        from approximatenn.engine import build as B

        counts = np.ones((2, 64), np.int32)
        counts[:, 0] = 1000  # one hot bucket
        assert B.TABLE_SHARE == 0.25
        dev = self._Dev({"bytes_limit": limit} if limit else None)
        auto = B.resolve_capacity(counts, "auto")
        assert auto < 1000
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tmax = B.resolve_capacity(counts, None, dev)
        assert tmax == (auto if want_auto else 1000)
        assert bool(caught) == want_auto

    def test_build_default_capacity_falls_back_to_auto(self, rng, monkeypatch):
        """ann.build with no capacity on a corpus whose exact-max tables
        outgrow the budget builds the "auto" index instead of failing."""
        import jax.numpy as jnp

        from approximatenn.data import clustered_gaussian
        from approximatenn.engine import build as B

        Xd = jnp.asarray(clustered_gaussian(rng, 3000, 16, n_clusters=4, zipf=1.5))
        auto, _, _ = ann.build(Xd, 10, tries=3, seed=0, capacity="auto")
        monkeypatch.setattr(B, "TABLE_BYTES_NO_LIMIT", 1 << 10)
        with pytest.warns(UserWarning, match="capacity=\"auto\""):
            bounded, _, _ = ann.build(Xd, 10, tries=3, seed=0)
        assert bounded.tmax == auto.tmax
        np.testing.assert_array_equal(np.asarray(bounded.tables),
                                      np.asarray(auto.tables))

    def test_bad_capacity_string(self, rng):
        import approximatenn as ann
        import jax.numpy as jnp

        p = jnp.asarray(rng.standard_normal((100, 8)).astype(np.float32))
        with pytest.raises(ValueError, match="auto"):
            ann.build(p, 5, tries=2, capacity="automatic")


class TestChunkedBuild:
    @pytest.mark.slow
    def test_chunked_equals_monolithic(self, rng):
        """The host-chunked graph build must produce the identical graph."""
        import jax.numpy as jnp
        from approximatenn.engine import build as B
        from approximatenn.ops.transforms import derive_dims

        n, d, k, tries = 1200, 16, 6, 4
        pts = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
        ds_, _ = derive_dims(n, k, d)
        rm, bases, codes, counts = B._hash_stage(
            pts, __import__("jax").random.key(3), d_short=ds_, tries=tries,
            rb=6, rlb=1, ra=1, rla=1, dtype=jnp.float32)
        tmax = B.resolve_capacity(counts, None)
        ta, ga, da = B.graph_stage(pts, codes, counts, k=k, d_short=ds_,
                                   tmax=tmax, block_rows=64)
        # force many chunks
        old = B._MAX_BLOCKS_PER_CALL
        B._MAX_BLOCKS_PER_CALL = 2
        try:
            tb, gb, db = B.graph_stage_chunked(
                pts, codes, counts, k=k, d_short=ds_, tmax=tmax, block_rows=64)
        finally:
            B._MAX_BLOCKS_PER_CALL = old
        np.testing.assert_array_equal(np.asarray(ga), np.asarray(gb))
        np.testing.assert_array_equal(np.asarray(ta), np.asarray(tb))
        np.testing.assert_allclose(np.asarray(da), np.asarray(db), rtol=1e-6)


class TestDirectedProbing:
    def test_first_probe_is_own_code(self, rng):
        from approximatenn.ops.hash import probe_codes_directed
        import jax.numpy as jnp

        proj = jnp.asarray(rng.standard_normal((7, 3, 5)).astype(np.float32))
        from approximatenn.ops.hash import pack_signs
        codes = pack_signs(proj)
        probes = probe_codes_directed(codes, proj, 6)
        assert probes.shape == (7, 3, 6)
        np.testing.assert_array_equal(np.asarray(probes[..., 0]), np.asarray(codes))

    def test_flip_costs_ordering(self):
        """With one near-zero projection, the first extra probe must flip
        exactly that coordinate's bit."""
        from approximatenn.ops.hash import pack_signs, probe_codes_directed
        import jax.numpy as jnp

        proj = jnp.array([[[3.0, -0.01, 2.0, -1.5]]])  # coord 1 is uncertain
        codes = pack_signs(proj)
        probes = np.asarray(probe_codes_directed(codes, proj, 3))[0, 0]
        own = int(np.asarray(codes)[0, 0])
        # coord 1 (MSB-first) is bit d_short-1-1 = 2
        assert probes[1] == own ^ (1 << 2)
        # second extra: cheapest remaining = coord 3 (|-1.5|) -> bit 0
        assert probes[2] == own ^ (1 << 0)

    def test_directed_beats_blind_at_equal_probes(self, rng):
        """On clustered data, query-directed probes (same count as the
        reference's ds+1) must not lose recall."""
        import jax.numpy as jnp
        import approximatenn as ann
        from approximatenn.data import clustered_gaussian
        from approximatenn.ops.distance import brute_force_knn

        base = clustered_gaussian(rng, 4000, 24, n_clusters=16, zipf=1.2)
        Xd = jnp.asarray(base)
        index, _, _ = ann.build(Xd, 10, tries=5, seed=3, capacity="auto")
        q = jnp.asarray(base[rng.integers(0, 4000, 64)]
                        + 0.05 * rng.standard_normal((64, 24)).astype(np.float32))
        true_ids, _ = brute_force_knn(Xd, q, 10)

        def recall(ids):
            got, want = np.asarray(ids), np.asarray(true_ids)
            return np.mean([len(set(got[i]) & set(want[i])) / 10 for i in range(64)])

        blind, _ = ann.search(index, Xd, q)
        directed, _ = ann.search(index, Xd, q, n_probes=index.d_short + 1)
        r_blind, r_dir = recall(blind), recall(directed)
        assert r_dir >= r_blind - 0.02  # at minimum: no regression

    def test_directed_build_graph_quality(self, rng):
        """Directed probing during the build must not hurt graph recall."""
        import jax.numpy as jnp
        import approximatenn as ann
        from approximatenn.ops.distance import brute_force_knn_self

        base = rng.standard_normal((2000, 16)).astype(np.float32)
        Xd = jnp.asarray(base)
        ti, _ = brute_force_knn_self(Xd, 8)
        want = np.asarray(ti)

        def graph_recall(graph):
            got = np.asarray(graph)
            return np.mean([len(set(got[i]) & set(want[i])) / 8 for i in range(2000)])

        _, g_blind, _ = ann.build(Xd, 8, tries=4, seed=5)
        _, g_dir, _ = ann.build(Xd, 8, tries=4, seed=5, n_probes=12)
        assert graph_recall(g_dir) >= graph_recall(g_blind) - 0.02


class TestDepthView:
    def test_with_depth_slices_tables(self, rng):
        import jax.numpy as jnp
        import approximatenn as ann

        base = rng.standard_normal((2000, 16)).astype(np.float32)
        Xd = jnp.asarray(base)
        index, _, _ = ann.build(Xd, 8, tries=4, seed=1)
        shallow = index.with_depth(3)
        assert shallow.tmax == 3 and shallow.tables.shape[-1] == 3
        np.testing.assert_array_equal(
            np.asarray(shallow.tables), np.asarray(index.tables[:, :, :3])
        )
        # searching the view works and stays in-universe
        ids, dd = ann.search(shallow, Xd, Xd[:16])
        assert int(np.asarray(ids).max()) <= 2000
        # no-op cases
        assert index.with_depth(index.tmax + 5) is index
        import pytest
        with pytest.raises(ValueError):
            index.with_depth(0)

    def test_depth_recall_monotone(self, rng):
        """Deeper reads can only help recall (same probes)."""
        import jax.numpy as jnp
        import approximatenn as ann
        from approximatenn.data import clustered_gaussian
        from approximatenn.ops.distance import brute_force_knn

        base = clustered_gaussian(rng, 4000, 16, n_clusters=12, zipf=1.3)
        Xd = jnp.asarray(base)
        index, _, _ = ann.build(Xd, 10, tries=5, seed=2)
        q = jnp.asarray(base[rng.integers(0, 4000, 64)]
                        + 0.05 * rng.standard_normal((64, 16)).astype(np.float32))
        want = np.asarray(brute_force_knn(Xd, q, 10)[0])

        def recall(idx):
            got = np.asarray(ann.search(idx, Xd, q)[0])
            return np.mean([len(set(got[i]) & set(want[i])) / 10 for i in range(64)])

        shallow, full = recall(index.with_depth(4)), recall(index)
        assert full >= shallow - 1e-9


class TestEdgeCases:
    def test_tiny_index(self, rng):
        import jax.numpy as jnp
        import approximatenn as ann

        p = jnp.asarray(rng.standard_normal((3, 5)).astype(np.float32))
        idx, g, _ = ann.build(p, 2, tries=2)
        assert g.shape == (3, 2)
        ids, dd = ann.search(idx, p, p)
        got = np.asarray(ids)
        assert got.shape == (3, 2) and got.max() <= 3

    def test_single_point(self, rng):
        import jax.numpy as jnp
        import approximatenn as ann

        p = jnp.asarray(rng.standard_normal((1, 4)).astype(np.float32))
        idx, g, _ = ann.build(p, 1, tries=1)
        ids, dd = ann.search(idx, p, p)
        # the only point is its own excluded self in the graph; query finds it
        assert np.asarray(ids)[0, 0] in (0, 1)

    def test_d_one(self, rng):
        import jax.numpy as jnp
        import approximatenn as ann
        from approximatenn.ops.distance import brute_force_knn

        p = jnp.asarray(rng.standard_normal((200, 1)).astype(np.float32))
        q = p[:9]
        idx, _, _ = ann.build(p, 5, tries=3, rots_before=0, rots_after=0)
        ids, _ = ann.search(idx, p, q)
        want = np.asarray(brute_force_knn(p, q, 5)[0])
        got = np.asarray(ids)
        rec = np.mean([len(set(got[i]) & set(want[i])) / 5 for i in range(9)])
        assert rec > 0.5

    def test_odd_dimension(self, rng):
        import jax.numpy as jnp
        import approximatenn as ann

        p = jnp.asarray(rng.standard_normal((500, 37)).astype(np.float32))
        idx, g, _ = ann.build(p, 6, tries=3)
        assert idx.bases.shape[-1] == 37
        ids, _ = ann.search(idx, p, p[:8], n_probes=10)
        assert np.asarray(ids).shape == (8, 6)
