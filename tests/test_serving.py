"""Serving facade: engine auto-selection and dispatch."""

import jax.numpy as jnp
import numpy as np
import pytest

import approximatenn as ann
from approximatenn.engine.serving import Server


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    X = jnp.asarray(rng.standard_normal((3000, 16)).astype(np.float32))
    Y = jnp.asarray(rng.standard_normal((32, 16)).astype(np.float32))
    return X, Y


def test_auto_picks_exact_below_threshold(data):
    X, Y = data
    srv = Server.build(X, k=5)
    assert srv.mode == "exact"
    ids, dd = srv.search(Y)
    ti, td = ann.brute_force_knn(X, Y, 5)
    np.testing.assert_array_equal(
        np.sort(np.asarray(ids), 1), np.sort(np.asarray(ti), 1)
    )
    assert srv.describe()["recall"] == 1.0


def test_exact_bf16_storage(data):
    """storage_dtype=bf16 halves the served corpus and doubles the exact
    engine's auto threshold; results match the oracle on the rounded
    values (the exact kernel streams bf16 as stored, no f32 copy)."""
    X, Y = data
    srv = Server.build(X, k=5, storage_dtype=jnp.bfloat16)
    assert srv.mode == "exact"
    assert srv.points.dtype == jnp.bfloat16
    assert srv.describe()["storage_dtype"] == "bfloat16"
    ids, _ = srv.search(Y)
    ti, _ = ann.brute_force_knn(X.astype(jnp.bfloat16).astype(jnp.float32),
                                Y, 5)
    overlap = np.mean([
        len(set(a.tolist()) & set(b.tolist())) / 5
        for a, b in zip(np.asarray(ids), np.asarray(ti))
    ])
    assert overlap > 0.9, overlap
    # the doubled threshold: 3000 points, bf16 -> exact even when the f32
    # threshold would force hash
    srv2 = Server.build(X, k=5, storage_dtype=jnp.bfloat16,
                        exact_max_n=3000)
    assert srv2.mode == "exact"
    srv3 = Server.build(X, k=5, exact_max_n=1000, tries=4, seed=2)
    assert srv3.mode == "hash"


def test_exact_int8_storage(data):
    """storage_dtype=int8 quantizes the corpus (scale kept on the server,
    forwarded to the exact engine) for 4x the f32 auto threshold; results
    match the oracle on the quantization grid."""
    X, Y = data
    srv = Server.build(X, k=5, storage_dtype=jnp.int8)
    assert srv.mode == "exact"
    assert srv.points.dtype == jnp.int8
    assert srv.describe()["storage_dtype"] == "int8"
    assert "scale" in srv._search_kw
    ids, dd = srv.search(Y)
    s = float(srv._search_kw["scale"])
    Xd = jnp.asarray(np.asarray(srv.points, np.float32) * s)
    Yd = jnp.asarray(np.clip(np.round(np.asarray(Y) / s), -127, 127) * s)
    ti, td = ann.brute_force_knn(Xd, Yd, 5)
    np.testing.assert_array_equal(
        np.sort(np.asarray(ids), 1), np.sort(np.asarray(ti), 1)
    )
    # and near the full-precision oracle
    tf, _ = ann.brute_force_knn(X, Y, 5)
    overlap = np.mean([
        len(set(a.tolist()) & set(b.tolist())) / 5
        for a, b in zip(np.asarray(ids), np.asarray(tf))
    ])
    assert overlap > 0.9, overlap
    # 4x threshold: n=3000 stays exact at exact_max_n=750
    assert Server.build(X, k=5, storage_dtype=jnp.int8).mode == "exact"
    # int8 is exact-only: forcing hash mode must refuse loudly
    with pytest.raises(ValueError, match="exact"):
        Server.build(X, k=5, storage_dtype=jnp.int8, mode="hash")


def test_exact_int8_angular(data):
    """Angular + int8: normalize BEFORE quantizing; queries stay float
    into the engine (it quantizes them itself)."""
    X, Y = data
    srv = Server.build(X, k=5, metric="angular", storage_dtype=jnp.int8)
    assert srv.points.dtype == jnp.int8
    ids, _ = srv.search(Y)
    from approximatenn.data.preprocess import prepare_points

    Xn, Yn = prepare_points(X, "angular"), prepare_points(Y, "angular")
    ti, _ = ann.brute_force_knn(Xn, Yn, 5)
    overlap = np.mean([
        len(set(a.tolist()) & set(b.tolist())) / 5
        for a, b in zip(np.asarray(ids), np.asarray(ti))
    ])
    assert overlap > 0.9, overlap


def test_auto_picks_hash_above_threshold(data):
    X, Y = data
    srv = Server.build(X, k=5, exact_max_n=1000, tries=4, seed=2)
    assert srv.mode == "hash"
    ids, _ = srv.search(Y)
    assert np.asarray(ids).shape == (32, 5)
    d = srv.describe()
    assert d["layout"] == "table" and d["index_mb"] > 0


def test_hash_packed_layout(data):
    X, Y = data
    srv = Server.build(X, k=5, mode="hash", layout="packed", tries=4, seed=2)
    assert srv.packed is not None
    ids, _ = srv.search(Y)
    ti, _ = ann.brute_force_knn(X, Y, 5)
    hits = sum(
        len(set(a.tolist()) & set(b.tolist()))
        for a, b in zip(np.asarray(ids), np.asarray(ti))
    )
    assert hits / (32 * 5) > 0.5


def test_exact_angular(data):
    X, Y = data
    srv = Server.build(X, k=5, mode="exact", metric="angular")
    ids, _ = srv.search(Y)
    Xn = np.asarray(X) / np.linalg.norm(np.asarray(X), axis=1, keepdims=True)
    Yn = np.asarray(Y) / np.linalg.norm(np.asarray(Y), axis=1, keepdims=True)
    true_ids = np.argsort(
        ((Yn[:, None, :] - Xn[None, :, :]) ** 2).sum(-1), axis=1
    )[:, :5]
    np.testing.assert_array_equal(
        np.sort(np.asarray(ids), 1), np.sort(true_ids, 1)
    )


def test_rejects_unknown_mode(data):
    X, _ = data
    with pytest.raises(ValueError):
        Server.build(X, k=5, mode="banana")


def test_int8_auto_resolves_exact_above_threshold(data):
    """auto must never error on a quantized corpus: it has no hash path,
    so auto resolves to exact even past exact_max_n."""
    X, _ = data
    srv = Server.build(X, k=5, storage_dtype=jnp.int8, exact_max_n=100)
    assert srv.mode == "exact"


class TestServerUpdates:
    """Server-level add/remove (round-5: exact mode previously had no
    add/remove story — an append forced manual re-staging)."""

    def test_exact_add_points(self, data):
        X, Y = data
        srv = Server.build(X[:2000], k=5, mode="exact")
        extra = np.asarray(X[2000:2100])
        srv.add_points(extra)
        assert srv.points.shape[0] == 2100
        ids, _ = srv.search(Y)
        ti, _ = ann.brute_force_knn(X[:2100], Y, 5)
        np.testing.assert_array_equal(
            np.sort(np.asarray(ids), 1), np.sort(np.asarray(ti), 1)
        )

    def test_exact_add_points_lane_padded_int8(self, data):
        """int8 append: new rows are quantized with the server's existing
        scale at the stored width, and the grown corpus serves exactly
        over the quantization grid."""
        X, Y = data
        srv = Server.build(X[:2000], k=5, mode="exact",
                           storage_dtype=jnp.int8)
        srv.add_points(np.asarray(X[2000:2050]))
        assert srv.points.shape == (2050, 16)
        assert srv.points.dtype == jnp.int8
        ids, _ = srv.search(Y)
        s = float(srv._search_kw["scale"])
        Xd = jnp.asarray(np.asarray(srv.points, np.float32) * s)
        Yd = jnp.asarray(np.clip(np.round(np.asarray(Y) / s), -127, 127) * s)
        ti, _ = ann.brute_force_knn(Xd, Yd, 5)
        np.testing.assert_array_equal(
            np.sort(np.asarray(ids), 1), np.sort(np.asarray(ti), 1)
        )

    def test_exact_remove_points(self, data):
        X, Y = data
        srv = Server.build(X[:2000], k=5, mode="exact")
        # remove the true top-1 of query 0 (with a duplicate id in the
        # list); it must never come back
        ti, _ = ann.brute_force_knn(X[:2000], Y, 5)
        gone = int(np.asarray(ti)[0, 0])
        srv.remove_points([gone, gone])
        assert srv.points.shape[0] == 1999
        ids, dd = srv.search(Y[:1])
        kept = np.delete(np.asarray(X[:2000]), gone, axis=0)
        tk, _ = ann.brute_force_knn(jnp.asarray(kept), Y[:1], 5)
        np.testing.assert_array_equal(
            np.sort(np.asarray(ids), 1), np.sort(np.asarray(tk), 1)
        )

    def test_hash_add_remove_repacks(self, data):
        X, Y = data
        srv = Server.build(X[:2000], k=5, mode="hash", layout="packed",
                           tries=4, seed=2)
        w0 = srv.packed.window
        srv.add_points(np.asarray(X[2000:2020]))
        assert srv.index.n == 2020 and srv.packed.window == w0
        ids, _ = srv.search(Y)
        assert np.asarray(ids).shape == (32, 5)
        srv.remove_points([0, 1])
        ids, _ = srv.search(Y)
        assert not np.isin(np.asarray(ids), [0, 1]).any()


class TestExactMaxN:
    """mode="auto" bounds the exact engine by the device's memory limit."""

    class _Dev:
        def __init__(self, stats):
            self._stats = stats

        def memory_stats(self):
            return self._stats

    def test_from_bytes_limit(self):
        from approximatenn.engine.serving import (
            EXACT_CORPUS_SHARE,
            default_exact_max_n,
        )

        dev = self._Dev({"bytes_limit": 60 << 30})
        want = int(EXACT_CORPUS_SHARE * (60 << 30) // (128 * 4))
        assert default_exact_max_n(128, 4, dev) == want
        # narrower storage tiers fit proportionally more rows
        assert default_exact_max_n(128, 2, dev) == 2 * want
        assert default_exact_max_n(128, 1, dev) == 4 * want

    @pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 5}])
    def test_no_limit_takes_explicit_default(self, stats):
        from approximatenn.engine.serving import (
            EXACT_CORPUS_BYTES_NO_LIMIT,
            default_exact_max_n,
        )

        assert default_exact_max_n(100, 4, self._Dev(stats)) == (
            EXACT_CORPUS_BYTES_NO_LIMIT // 400)

    def test_auto_mode_uses_device_bound(self, data, monkeypatch):
        """Server.build(mode="auto") asks default_exact_max_n about the
        corpus's device; a bound below n resolves hash."""
        import approximatenn.engine.serving as serving

        X, _ = data
        seen = {}

        def fake(d, itemsize, device):
            seen.update(d=d, itemsize=itemsize, platform=device.platform)
            return 100

        monkeypatch.setattr(serving, "default_exact_max_n", fake)
        srv = Server.build(X, k=5, tries=3, seed=2)
        assert srv.mode == "hash"
        assert seen == {"d": 16, "itemsize": 4, "platform": "cpu"}
