"""Distributed build/search tests on the 8-device CPU mesh (SURVEY.md §4:
multi-chip logic validated via xla_force_host_platform_device_count)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# big-shape virtual-mesh gates: the bulk of the
# suite's wall clock.  Inner loop: -m 'not slow'.
pytestmark = pytest.mark.slow

import approximatenn as ann
from approximatenn.harness.scoring import recall_at_k
from approximatenn.parallel.sharded import (
    build_sharded,
    global_graph_sharded,
    make_mesh,
    search_exact_sharded,
    search_sharded,
)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((4096, 64)).astype(np.float32)
    Y = rng.standard_normal((128, 64)).astype(np.float32)
    return X, Y


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8
    return make_mesh(8)


@pytest.fixture(scope="module")
def sidx(data, mesh8):
    X, _ = data
    return build_sharded(X, 10, mesh=mesh8, seed=1)


class TestShardedExact:
    def test_exact_merge_equals_global_brute_force(self, data, mesh8):
        """Per-shard exact top-k + all_gather merge == global brute force:
        the correctness core of the distributed design."""
        X, Y = data
        ids, dists = search_exact_sharded(X, Y, 10, mesh=mesh8)
        tq, td = ann.brute_force_knn(jnp.asarray(X), jnp.asarray(Y), 10)
        assert recall_at_k(np.asarray(tq), np.asarray(ids), 10) == 1.0
        np.testing.assert_allclose(
            np.sort(np.asarray(dists), 1), np.sort(np.asarray(td), 1), rtol=1e-4
        )

    def test_exact_sharded_int8_tier(self, data, mesh8):
        """int8 storage shards: one global scale makes per-shard
        quantized-domain distances globally comparable — the merge equals
        the brute-force oracle on the same quantized grid."""
        X, Y = data
        Xq, scale = ann.quantize_corpus(X)
        ids, dists = search_exact_sharded(Xq, Y, 10, mesh=mesh8, scale=scale)
        s = float(scale)
        Xd = jnp.asarray(np.asarray(Xq, np.float32) * s)
        Yd = jnp.asarray(np.clip(np.round(Y / s), -127, 127) * s)
        tq, td = ann.brute_force_knn(Xd, Yd, 10)
        assert recall_at_k(np.asarray(tq), np.asarray(ids), 10) == 1.0
        np.testing.assert_allclose(
            np.sort(np.asarray(dists), 1), np.sort(np.asarray(td), 1),
            rtol=1e-4, atol=1e-5
        )
        # and near the full-precision oracle (quality of the tier itself)
        tf, _ = ann.brute_force_knn(jnp.asarray(X), jnp.asarray(Y), 10)
        assert recall_at_k(np.asarray(tf), np.asarray(ids), 10) > 0.9
        with pytest.raises(ValueError, match="scale"):
            search_exact_sharded(Xq, Y, 10, mesh=mesh8)

    def test_exact_sharded_bf16_tier(self, data, mesh8):
        """bf16 stored corpus: each shard multiplies at storage width with
        f32 accumulation; neighbor sets track the f32 oracle closely."""
        X, Y = data
        ids, _ = search_exact_sharded(
            jnp.asarray(X, jnp.bfloat16), Y, 10, mesh=mesh8)
        tf, _ = ann.brute_force_knn(jnp.asarray(X), jnp.asarray(Y), 10)
        assert recall_at_k(np.asarray(tf), np.asarray(ids), 10) > 0.95


class TestShardedBuild:
    def test_shapes(self, sidx):
        assert sidx.n_shards == 8 and sidx.n_local == 512
        assert sidx.tables.shape[0] == 8
        assert sidx.graph.shape == (8, 512, 10)

    def test_local_graphs_in_range(self, sidx):
        g = np.asarray(sidx.graph)
        assert (g >= 0).all() and (g <= sidx.n_local).all()

    def test_row_means_match_global_mean(self, sidx, data):
        X, _ = data
        np.testing.assert_allclose(
            np.asarray(sidx.row_means), X.mean(0), atol=1e-4
        )


class TestShardedSearch:
    def test_recall_at_least_single_device(self, sidx, data, mesh8):
        X, Y = data
        ids, _ = search_sharded(sidx, X, Y, mesh=mesh8)
        tq, _ = ann.brute_force_knn(jnp.asarray(X), jnp.asarray(Y), 10)
        rec = recall_at_k(np.asarray(tq), np.asarray(ids), 10)
        assert rec > 0.8, rec

    def test_global_ids_and_sorted(self, sidx, data, mesh8):
        X, Y = data
        ids, dists = search_sharded(sidx, X, Y, mesh=mesh8)
        ids, dists = np.asarray(ids), np.asarray(dists)
        assert (ids >= 0).all() and (ids <= sidx.n).all()
        assert (np.diff(dists, 1) >= -1e-6).all()
        # distances are true squared L2 to the returned global ids
        for j in range(10):
            want = ((Y[5] - X[ids[5, j]]) ** 2).sum()
            np.testing.assert_allclose(dists[5, j], want, rtol=1e-4)

    def test_global_graph(self, sidx, data, mesh8):
        X, _ = data
        gg, _ = global_graph_sharded(sidx, X, mesh=mesh8)
        tg, _ = ann.brute_force_knn_self(jnp.asarray(X), 10)
        gg = np.asarray(gg)
        assert not any(i in gg[i] for i in range(len(gg)))
        assert recall_at_k(np.asarray(tg), gg, 10) > 0.7

    def test_packed_sharded(self, sidx, data, mesh8):
        """Per-shard packed CSR views: recall not worse than the sharded
        table path (superset candidates per shard), global ids, true
        distances, bf16 storage accepted."""
        from approximatenn.parallel.sharded import (
            packed_sharded,
            search_packed_sharded,
        )

        X, Y = data
        spk = packed_sharded(sidx, X, mesh=mesh8)
        assert spk.point_rows.shape == (
            sidx.n_shards, sidx.tries * spk.n_pad_l, spk.d_pad
        )
        ids, dists = search_packed_sharded(sidx, spk, X, Y, mesh=mesh8)
        ids_t, _ = search_sharded(sidx, X, Y, mesh=mesh8)
        tq, _ = ann.brute_force_knn(jnp.asarray(X), jnp.asarray(Y), 10)
        rec_p = recall_at_k(np.asarray(tq), np.asarray(ids), 10)
        rec_t = recall_at_k(np.asarray(tq), np.asarray(ids_t), 10)
        assert rec_p >= rec_t - 0.02, (rec_p, rec_t)
        ids, dists = np.asarray(ids), np.asarray(dists)
        assert (ids >= 0).all() and (ids <= sidx.n).all()
        for j in range(10):
            want = ((Y[3] - X[ids[3, j]]) ** 2).sum()
            np.testing.assert_allclose(dists[3, j], want, rtol=1e-4)
        # bf16 storage halves the packed bytes and still serves
        spk_b = packed_sharded(sidx, X, mesh=mesh8, dtype=jnp.bfloat16)
        assert spk_b.point_rows.dtype == jnp.bfloat16
        ids_b, _ = search_packed_sharded(sidx, spk_b, X, Y, mesh=mesh8)
        rec_b = recall_at_k(np.asarray(tq), np.asarray(ids_b), 10)
        assert rec_b >= rec_p - 0.05, (rec_b, rec_p)

    def test_mesh_size_one_matches_spirit(self, data):
        """A 1-device mesh must work (degenerate distribution)."""
        X, Y = data
        mesh1 = make_mesh(1)
        sidx1 = build_sharded(X[:1024], 5, mesh=mesh1, seed=0)
        ids, _ = search_sharded(sidx1, X[:1024], Y, mesh=mesh1)
        tq, _ = ann.brute_force_knn(jnp.asarray(X[:1024]), jnp.asarray(Y), 5)
        assert recall_at_k(np.asarray(tq), np.asarray(ids), 5) > 0.6

    def test_auto_pads_indivisible_n(self, mesh8, rng):
        """n not divisible by the shard count is zero-padded internally
        (round-4; the reference's precomp accepts any n, ann.h:46-49);
        pad ids never appear in results."""
        X = rng.standard_normal((1001, 16)).astype(np.float32)
        Y = rng.standard_normal((32, 16)).astype(np.float32)
        sidx = build_sharded(X, 5, mesh=mesh8, tries=3, seed=0)
        assert sidx.n == 1001 and sidx.n_padded == 1008
        ids, dists = search_sharded(sidx, X, Y, mesh=mesh8)
        ids = np.asarray(ids)
        assert ((ids < 1001) | (ids == 1001)).all()  # real ids or sentinel
        tq, _ = ann.brute_force_knn(jnp.asarray(X), jnp.asarray(Y), 5)
        assert recall_at_k(np.asarray(tq), ids, 5) > 0.8

    def test_pad_rows_cannot_occupy_topk_slots(self, mesh8, rng):
        """Round-5 (round-4 VERDICT weak 1): zero pad rows — nearest
        possible points to a near-origin query — must not win per-shard
        top-k slots in the APPROXIMATE paths either.  Masked at the
        source (tables/graph/packed ids), every path returns k real ids.
        The corpus is shifted away from the origin so unmasked pads
        would dominate; probes/windows cover every bucket so each
        shard's candidate set is its full slice and the merge must equal
        global brute force."""
        from approximatenn.parallel.sharded import (
            packed_sharded,
            search_packed_sharded,
        )

        X = (rng.standard_normal((75, 16)) + 3.0).astype(np.float32)
        Y = (0.01 * rng.standard_normal((8, 16))).astype(np.float32)
        k = 5
        sidx = build_sharded(X, k, mesh=mesh8, tries=3, seed=0,
                             capacity=64, store_points=True)
        assert sidx.n_padded > sidx.n  # pads exist
        tq, _ = ann.brute_force_knn(jnp.asarray(X), jnp.asarray(Y), k)
        want = np.sort(np.asarray(tq), 1)
        ids_t, _ = search_sharded(sidx, X, Y, mesh=mesh8)
        spk = packed_sharded(sidx, mesh=mesh8, window=64)
        ids_p, _ = search_packed_sharded(sidx, spk, X, Y, mesh=mesh8)
        for name, ids in (("table", ids_t), ("packed", ids_p)):
            ids = np.asarray(ids)
            assert (ids < sidx.n).all(), (name, ids)  # k REAL ids, no
            # sentinel shrinkage, no pad leakage
            np.testing.assert_array_equal(np.sort(ids, 1), want,
                                          err_msg=name)

    def test_padded_exact_search_is_exact(self, mesh8, rng):
        """Zero pad rows must never displace true neighbors — stressed
        with near-origin queries (closest possible to the pads); the
        local-k widening guarantees exactness."""
        X = rng.standard_normal((997, 16)).astype(np.float32)
        Y = (0.01 * rng.standard_normal((16, 16))).astype(np.float32)
        ids, _ = search_exact_sharded(X, Y, 10, mesh=mesh8)
        tq, _ = ann.brute_force_knn(jnp.asarray(X), jnp.asarray(Y), 10)
        assert recall_at_k(np.asarray(tq), np.asarray(ids), 10) == 1.0


class TestCheckpoint:
    def test_save_load_roundtrip(self, rng, tmp_path):
        import jax
        from approximatenn.parallel.checkpoint import (
            load_sharded_index,
            save_sharded_index,
        )
        from approximatenn.parallel.sharded import (
            build_sharded,
            make_mesh,
            search_sharded,
        )

        mesh = make_mesh(4)
        pts = rng.standard_normal((256, 12)).astype(np.float32)
        q = rng.standard_normal((9, 12)).astype(np.float32)
        sidx = build_sharded(pts, 5, mesh=mesh, tries=3, seed=2)
        a = search_sharded(sidx, pts, q, mesh=mesh)

        save_sharded_index(sidx, tmp_path / "ck")
        loaded = load_sharded_index(tmp_path / "ck", mesh)
        assert loaded.n == sidx.n and loaded.tmax == sidx.tmax
        b = search_sharded(loaded, pts, q, mesh=mesh)
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))

    def test_shard_count_mismatch_rejected(self, rng, tmp_path):
        import pytest
        from approximatenn.parallel.checkpoint import (
            load_sharded_index,
            save_sharded_index,
        )
        from approximatenn.parallel.sharded import build_sharded, make_mesh

        mesh4 = make_mesh(4)
        pts = rng.standard_normal((64, 8)).astype(np.float32)
        sidx = build_sharded(pts, 4, mesh=mesh4, tries=2)
        save_sharded_index(sidx, tmp_path / "ck")
        with pytest.raises(ValueError, match="shards"):
            load_sharded_index(tmp_path / "ck", make_mesh(2))

    @pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
    def test_packed_save_load_roundtrip(self, rng, tmp_path, dtype):
        """ShardedPacked persists (round-2 VERDICT item 7): serving
        restarts skip the per-shard re-pack, in every storage tier —
        including bf16 (npz-hostile dtype) and int8 (replicated scale)."""
        from approximatenn.parallel.checkpoint import (
            load_sharded_packed,
            save_sharded_packed,
        )
        from approximatenn.parallel.sharded import (
            build_sharded,
            make_mesh,
            packed_sharded,
            search_packed_sharded,
        )

        dt = {"f32": None, "bf16": jnp.bfloat16, "int8": jnp.int8}[dtype]
        mesh = make_mesh(4)
        pts = rng.standard_normal((256, 12)).astype(np.float32)
        q = rng.standard_normal((9, 12)).astype(np.float32)
        sidx = build_sharded(pts, 5, mesh=mesh, tries=3, seed=2)
        spk = packed_sharded(sidx, pts, mesh=mesh, dtype=dt)
        a = search_packed_sharded(sidx, spk, pts, q, mesh=mesh)

        save_sharded_packed(spk, tmp_path / "pk")
        loaded = load_sharded_packed(tmp_path / "pk", mesh)
        assert loaded.point_rows.dtype == spk.point_rows.dtype
        assert loaded.n_pad_l == spk.n_pad_l
        assert loaded.window == spk.window
        if dtype == "int8":
            assert loaded.scale is not None
            assert float(loaded.scale) == pytest.approx(float(spk.scale))
        else:
            assert loaded.scale is None
        np.testing.assert_array_equal(
            np.asarray(loaded.ids), np.asarray(spk.ids)
        )
        b = search_packed_sharded(sidx, loaded, pts, q, mesh=mesh)
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))

    def test_packed_shard_count_mismatch_rejected(self, rng, tmp_path):
        from approximatenn.parallel.checkpoint import (
            load_sharded_packed,
            save_sharded_packed,
        )
        from approximatenn.parallel.sharded import (
            build_sharded,
            make_mesh,
            packed_sharded,
        )

        mesh4 = make_mesh(4)
        pts = rng.standard_normal((64, 8)).astype(np.float32)
        sidx = build_sharded(pts, 4, mesh=mesh4, tries=2)
        spk = packed_sharded(sidx, pts, mesh=mesh4)
        save_sharded_packed(spk, tmp_path / "pk")
        with pytest.raises(ValueError, match="shards"):
            load_sharded_packed(tmp_path / "pk", make_mesh(2))


def test_sharded_deep10m_shaped(mesh8):
    """The Deep-10M operating regime scaled down (VERDICT r1 item 2): a
    zipf-clustered corpus (skewed bucket statistics), capacity-bounded
    tables (at 10M the 32x-mean auto policy exceeds HBM next to the
    corpus, so serving uses a hard cap), hash-graph build sharded 8-way.
    Validates the sharded hash pipeline's *logic* at the shape the real
    10M single-chip measurement (BASELINE.md) runs at."""
    rng = np.random.default_rng(17)
    n, d, n_clusters = 16384, 24, 256
    w = np.arange(1, n_clusters + 1) ** -1.05
    cid = rng.choice(n_clusters, size=n, p=w / w.sum())
    centers = rng.standard_normal((n_clusters, d)) * 2.0
    X = (centers[cid] + rng.standard_normal((n, d))).astype(np.float32)
    qi = rng.integers(0, n, 64)
    Y = (X[qi] + 0.1 * rng.standard_normal((64, d))).astype(np.float32)

    sidx = build_sharded(X, 10, mesh=mesh8, tries=6, seed=5, capacity=24)
    assert sidx.tmax == 24  # the cap held against the hot clusters
    ids, dists = search_sharded(sidx, X, Y, mesh=mesh8, n_probes=18)
    tq, _ = ann.brute_force_knn(jnp.asarray(X), jnp.asarray(Y), 10)
    rec = recall_at_k(np.asarray(tq), np.asarray(ids), 10)
    assert rec > 0.5, rec  # capacity-starved but functional, as at 10M
    ids = np.asarray(ids)
    assert (ids >= 0).all() and (ids <= n).all()


class TestShardedRound4:
    """The sharded layer at round-3 engine parity (round-4 VERDICT items
    1+2): exact graph mode, angular metric, rerank/supercharge knobs,
    chunked pod-survivable drivers."""

    def test_exact_graph_matches_single_chip_recall(self, data, mesh8):
        """graph_mode='exact' per shard: sharded serve-time recall within
        noise of the single-chip exact-graph build at matched shapes, and
        >= the sharded hash-graph build (the round-3 quality lever)."""
        X, Y = data
        tq, _ = ann.brute_force_knn(jnp.asarray(X), jnp.asarray(Y), 10)
        sx = build_sharded(X, 10, mesh=mesh8, tries=6, seed=2,
                           graph_mode="exact")
        ids_x, _ = search_sharded(sx, X, Y, mesh=mesh8)
        rec_x = recall_at_k(np.asarray(tq), np.asarray(ids_x), 10)
        sh = build_sharded(X, 10, mesh=mesh8, tries=6, seed=2,
                           graph_mode="hash")
        ids_h, _ = search_sharded(sh, X, Y, mesh=mesh8)
        rec_h = recall_at_k(np.asarray(tq), np.asarray(ids_h), 10)
        assert rec_x >= rec_h - 1e-9, (rec_x, rec_h)
        # single-chip exact-graph build at the same shapes
        idx, _, _ = ann.build(jnp.asarray(X), 10, tries=6, seed=2,
                              graph_mode="exact")
        ids_1, _ = ann.search(idx, jnp.asarray(X), jnp.asarray(Y))
        rec_1 = recall_at_k(np.asarray(tq), np.asarray(ids_1), 10)
        assert rec_x >= rec_1 - 0.05, (rec_x, rec_1)

    def test_exact_graph_rows_are_true_local_knn(self, data, mesh8):
        """Each shard's graph rows equal the TRUE kNN of its local slice
        (id-set equality vs the oracle on the same slice)."""
        X, _ = data
        sx = build_sharded(X, 5, mesh=mesh8, tries=3, seed=0,
                           graph_mode="exact", chunk_rows=100)
        g = np.asarray(sx.graph)  # (8, n_local, 5)
        nl = sx.n_local
        for s in (0, 7):
            sl = X[s * nl:(s + 1) * nl]
            tg, _ = ann.brute_force_knn_self(jnp.asarray(sl), 5)
            assert recall_at_k(np.asarray(tg), g[s], 5) == 1.0

    def test_chunked_hash_build_matches_monolithic(self, data, mesh8):
        """Forcing the host-chunked sharded hash-graph driver at a chunk
        size that needs several chunks reproduces the monolithic build
        bit-for-bit (the pod-survivability path, CLAUDE.md rule 3)."""
        X, _ = data
        a = build_sharded(X, 10, mesh=mesh8, tries=3, seed=4,
                          graph_mode="hash", chunked=False)
        b = build_sharded(X, 10, mesh=mesh8, tries=3, seed=4,
                          graph_mode="hash", chunked=True, chunk_rows=100)
        np.testing.assert_array_equal(np.asarray(a.graph),
                                      np.asarray(b.graph))
        np.testing.assert_array_equal(np.asarray(a.tables),
                                      np.asarray(b.tables))

    def test_chunked_query_matches_monolithic(self, sidx, data, mesh8):
        X, Y = data
        a = search_sharded(sidx, X, Y, mesh=mesh8, chunked=False,
                           rerank_width=20, supercharge_rounds=2)
        b = search_sharded(sidx, X, Y, mesh=mesh8, chunked=True,
                           rerank_width=20, supercharge_rounds=2)
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
        np.testing.assert_allclose(np.asarray(a[1]), np.asarray(b[1]),
                                   rtol=1e-5)

    def test_rerank_and_supercharge_knobs(self, sidx, data, mesh8):
        """The round-3 recall knobs reach the sharded XLA paths (VERDICT
        r3 item 3): widened pools may not hurt, and typically help."""
        X, Y = data
        tq, _ = ann.brute_force_knn(jnp.asarray(X), jnp.asarray(Y), 10)
        base, _ = search_sharded(sidx, X, Y, mesh=mesh8)
        wide, _ = search_sharded(sidx, X, Y, mesh=mesh8, rerank_width=40,
                                 supercharge_rounds=2)
        r0 = recall_at_k(np.asarray(tq), np.asarray(base), 10)
        r1 = recall_at_k(np.asarray(tq), np.asarray(wide), 10)
        assert r1 >= r0 - 1e-9, (r0, r1)
        from approximatenn.parallel.sharded import (
            packed_sharded, search_packed_sharded,
        )

        spk = packed_sharded(sidx, X, mesh=mesh8)
        p0, _ = search_packed_sharded(sidx, spk, X, Y, mesh=mesh8)
        p1, _ = search_packed_sharded(sidx, spk, X, Y, mesh=mesh8,
                                      rerank_width=40, supercharge_rounds=2)
        rp0 = recall_at_k(np.asarray(tq), np.asarray(p0), 10)
        rp1 = recall_at_k(np.asarray(tq), np.asarray(p1), 10)
        assert rp1 >= rp0 - 1e-9, (rp0, rp1)

    def test_angular_sharded(self, mesh8, rng):
        """metric='angular' end-to-end sharded: normalized corpus stored
        on the index, queries normalized, recall vs the cosine oracle."""
        X = rng.standard_normal((2048, 24)).astype(np.float32)
        Y = rng.standard_normal((48, 24)).astype(np.float32)
        Xn = X / np.linalg.norm(X, axis=1, keepdims=True)
        Yn = Y / np.linalg.norm(Y, axis=1, keepdims=True)
        ta, _ = ann.brute_force_knn(jnp.asarray(Xn), jnp.asarray(Yn), 10)
        sidx = build_sharded(X, 10, mesh=mesh8, tries=4, seed=3,
                             metric="angular")
        assert sidx.points is not None  # stored normalized corpus
        ids, dists = search_sharded(sidx, None, Y, mesh=mesh8)
        assert recall_at_k(np.asarray(ta), np.asarray(ids), 10) > 0.85
        # distances are squared L2 on the NORMALIZED vectors
        ids = np.asarray(ids)
        want = ((Yn[3] - Xn[ids[3, 0]]) ** 2).sum()
        np.testing.assert_allclose(np.asarray(dists)[3, 0], want, rtol=1e-4)
        # packed serves the angular index without passing points
        from approximatenn.parallel.sharded import (
            packed_sharded,
            search_packed_sharded,
        )

        spk = packed_sharded(sidx, mesh=mesh8)
        fi, _ = search_packed_sharded(sidx, spk, None, Y, mesh=mesh8)
        assert recall_at_k(np.asarray(ta), np.asarray(fi), 10) > 0.85

    def test_graph_precision_knob_accepted(self, data, mesh8):
        """graph_precision plumbs through the sharded exact-graph build
        (CPU oracle path always ranks at HIGHEST, so results are equal)."""
        X, _ = data
        a = build_sharded(X, 5, mesh=mesh8, tries=2, seed=0,
                          graph_mode="exact", graph_precision="default")
        b = build_sharded(X, 5, mesh=mesh8, tries=2, seed=0,
                          graph_mode="exact", graph_precision="highest")
        np.testing.assert_array_equal(np.asarray(a.graph),
                                      np.asarray(b.graph))

    def test_checkpoint_roundtrip_with_metric_and_points(self, mesh8, rng,
                                                         tmp_path):
        from approximatenn.parallel.checkpoint import (
            load_sharded_index,
            save_sharded_index,
        )

        X = rng.standard_normal((512, 16)).astype(np.float32)
        Y = rng.standard_normal((8, 16)).astype(np.float32)
        sidx = build_sharded(X, 5, mesh=mesh8, tries=3, seed=2,
                             metric="angular")
        a = search_sharded(sidx, None, Y, mesh=mesh8)
        save_sharded_index(sidx, tmp_path / "ck")
        loaded = load_sharded_index(tmp_path / "ck", mesh8)
        assert loaded.metric == "angular" and loaded.points is not None
        b = search_sharded(loaded, None, Y, mesh=mesh8)
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))


def test_sharded_directed_probes(rng):
    from approximatenn.parallel.sharded import (
        build_sharded, make_mesh, search_sharded,
    )

    mesh = make_mesh(4)
    pts = rng.standard_normal((512, 12)).astype(np.float32)
    q = rng.standard_normal((7, 12)).astype(np.float32)
    sidx = build_sharded(pts, 5, mesh=mesh, tries=3, seed=1)
    a = search_sharded(sidx, pts, q, mesh=mesh, n_probes=6)
    assert np.asarray(a[0]).shape == (7, 5)
