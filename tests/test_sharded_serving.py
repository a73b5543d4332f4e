"""ShardedServer: the multi-device serving surface.

Role of ``/root/reference/ann.h:61-62`` (``query`` as the one serving
entry point) at SURVEY §2.3's mandated multi-chip scale — engine
routing, storage tiers, checkpoints and the tuner, all on the virtual
8-device CPU mesh.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import approximatenn as ann
from approximatenn.harness.scoring import recall_at_k
from approximatenn.parallel.serving import ShardedServer, tune_sharded
from approximatenn.parallel.sharded import make_mesh


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(8)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    X = rng.standard_normal((1200, 24)).astype(np.float32)
    Y = rng.standard_normal((16, 24)).astype(np.float32)
    return X, Y


class TestShardedServerExact:
    def test_auto_picks_exact_and_matches_brute_force(self, mesh8, data):
        X, Y = data
        srv = ShardedServer.build(X, k=5, mesh=mesh8)
        assert srv.mode == "exact"
        ids, dd = srv.search(Y)
        ti, _ = ann.brute_force_knn(jnp.asarray(X), jnp.asarray(Y), 5)
        np.testing.assert_array_equal(
            np.sort(np.asarray(ids), 1), np.sort(np.asarray(ti), 1)
        )
        d = srv.describe()
        assert d["n_shards"] == 8
        assert d["d"] == 24 and d["recall"] == 1.0

    def test_indivisible_n_pads_masked(self, mesh8):
        """The stored sharded corpus is padded; its zero rows must never
        serve as real points (n_true plumbing) — stressed with
        near-origin queries."""
        rng = np.random.default_rng(3)
        X = (rng.standard_normal((75, 16)) + 3.0).astype(np.float32)
        Y = (0.01 * rng.standard_normal((8, 16))).astype(np.float32)
        srv = ShardedServer.build(X, k=5, mesh=mesh8, mode="exact")
        assert srv.points.shape[0] == 80  # padded to the shard count
        ids, _ = srv.search(Y)
        ids = np.asarray(ids)
        assert (ids < 75).all()
        ti, _ = ann.brute_force_knn(jnp.asarray(X), jnp.asarray(Y), 5)
        np.testing.assert_array_equal(np.sort(ids, 1),
                                      np.sort(np.asarray(ti), 1))

    def test_int8_tier_global_scale(self, mesh8, data):
        X, Y = data
        srv = ShardedServer.build(X, k=5, mesh=mesh8,
                                  storage_dtype=jnp.int8)
        assert srv.mode == "exact" and srv.points.dtype == jnp.int8
        assert srv.scale is not None
        ids, _ = srv.search(Y)
        s = float(srv.scale)
        Xd = jnp.asarray(np.asarray(srv.points[:1200, :24],
                                    np.float32) * s)
        Yd = jnp.asarray(np.clip(np.round(Y / s), -127, 127) * s)
        ti, _ = ann.brute_force_knn(Xd, Yd, 5)
        np.testing.assert_array_equal(
            np.sort(np.asarray(ids), 1), np.sort(np.asarray(ti), 1)
        )
        assert srv.describe()["storage_dtype"] == "int8"
        assert srv.describe()["recall"] is None

    def test_bf16_tier(self, mesh8, data):
        X, Y = data
        srv = ShardedServer.build(X, k=5, mesh=mesh8,
                                  storage_dtype=jnp.bfloat16)
        assert srv.points.dtype == jnp.bfloat16
        ids, _ = srv.search(Y)
        Xr = jnp.asarray(X).astype(jnp.bfloat16).astype(jnp.float32)
        ti, _ = ann.brute_force_knn(Xr, jnp.asarray(Y), 5)
        overlap = np.mean([
            len(set(a.tolist()) & set(b.tolist())) / 5
            for a, b in zip(np.asarray(ids), np.asarray(ti))
        ])
        assert overlap > 0.9, overlap

    def test_angular_metric(self, mesh8, data):
        X, Y = data
        srv = ShardedServer.build(X, k=5, mesh=mesh8, mode="exact",
                                  metric="angular")
        ids, _ = srv.search(Y)
        Xn = X / np.linalg.norm(X, axis=1, keepdims=True)
        Yn = Y / np.linalg.norm(Y, axis=1, keepdims=True)
        ti, _ = ann.brute_force_knn(jnp.asarray(Xn), jnp.asarray(Yn), 5)
        np.testing.assert_array_equal(
            np.sort(np.asarray(ids), 1), np.sort(np.asarray(ti), 1)
        )


class TestShardedServerHash:
    def test_hash_packed_route_and_recall(self, mesh8, data):
        X, Y = data
        srv = ShardedServer.build(X, k=5, mesh=mesh8, mode="hash",
                                  tries=4, seed=2, capacity=64)
        assert srv.spk is not None
        d = srv.describe()
        assert d["layout"] == "packed" and d["index_mb"] > 0
        ids, _ = srv.search(Y)
        ti, _ = ann.brute_force_knn(jnp.asarray(X), jnp.asarray(Y), 5)
        rec = recall_at_k(np.asarray(ti), np.asarray(ids), 5)
        assert rec > 0.5, rec

    def test_hash_table_layout(self, mesh8, data):
        X, Y = data
        srv = ShardedServer.build(X, k=5, mesh=mesh8, mode="hash",
                                  layout="table", tries=4, seed=2)
        assert srv.spk is None and srv.describe()["layout"] == "table"
        ids, _ = srv.search(Y)
        assert np.asarray(ids).shape == (16, 5)

    def test_auto_resolves_hash_above_threshold(self, mesh8, data):
        X, _ = data
        srv = ShardedServer.build(X, k=5, mesh=mesh8, exact_max_n=100,
                                  tries=3, seed=2)
        assert srv.mode == "hash"

    def test_rejects_unknown_mode(self, mesh8, data):
        X, _ = data
        with pytest.raises(ValueError):
            ShardedServer.build(X, k=5, mesh=mesh8, mode="banana")
        with pytest.raises(ValueError, match="exact"):
            ShardedServer.build(X, k=5, mesh=mesh8, mode="hash",
                                storage_dtype=jnp.int8)


class TestShardedServerCheckpoint:
    def test_exact_roundtrip(self, mesh8, data, tmp_path):
        X, Y = data
        srv = ShardedServer.build(X, k=5, mesh=mesh8,
                                  storage_dtype=jnp.int8)
        a_ids, a_dd = srv.search(Y)
        srv.save(tmp_path / "srv")
        srv2 = ShardedServer.load(tmp_path / "srv", mesh=mesh8)
        assert srv2.mode == "exact"
        assert srv2.points.dtype == jnp.int8
        assert srv2.describe() == srv.describe()
        b_ids, b_dd = srv2.search(Y)
        np.testing.assert_array_equal(np.asarray(a_ids), np.asarray(b_ids))
        np.testing.assert_allclose(np.asarray(a_dd), np.asarray(b_dd),
                                   rtol=1e-5)

    def test_hash_roundtrip(self, mesh8, data, tmp_path):
        X, Y = data
        srv = ShardedServer.build(X, k=5, mesh=mesh8, mode="hash",
                                  tries=3, seed=2, capacity=48)
        a_ids, _ = srv.search(Y)
        srv.save(tmp_path / "hsrv")
        srv2 = ShardedServer.load(tmp_path / "hsrv", mesh=mesh8)
        assert srv2.describe() == srv.describe()
        b_ids, _ = srv2.search(Y)
        np.testing.assert_array_equal(np.asarray(a_ids), np.asarray(b_ids))


class TestTuneSharded:
    @pytest.mark.slow
    def test_tune_on_cpu_mesh(self, mesh8):
        """Trials dispatch through ShardedServer.search on the mesh;
        proxy ranking off-accelerator; the report's server() serves."""
        rng = np.random.default_rng(5)
        X = rng.standard_normal((640, 16)).astype(np.float32)
        rep = tune_sharded(
            X, 5, mesh=mesh8, n_queries=32, target_recall=0.9,
            probe_grid=(None,), window_grid=(16,), rerank_grid=(None,),
            tries=3, capacity=32, seed=1,
        )
        assert rep.trials and rep.best is not None
        assert not rep.measured  # CPU mesh -> cost proxy
        d = rep.as_dict()
        assert d["sharded"] and d["best"]["recall"] >= 0
        # exact meets any target; proxy picks it over the hash trial only
        # if cheaper — just assert the winner actually serves
        srv = rep.server()
        ids, _ = srv.search(jnp.asarray(X[:8]))
        assert np.asarray(ids).shape == (8, 5)
        # exact trial present and perfect
        ex = [t for t in rep.trials if t.engine == "exact"]
        assert ex and ex[0].recall == 1.0
