"""Tests for the dataset layer: file formats, synthetic generators, metric
preprocessing, the angular search path, and index save/load with points."""

import numpy as np
import jax.numpy as jnp
import pytest

import approximatenn as ann
from approximatenn.data import (
    SPECS,
    ensure_groundtruth,
    normalize,
    prepare_points,
    read_any,
    read_vecs,
    synthesize,
    vecs_info,
    write_vecs,
)


class TestFormats:
    @pytest.mark.parametrize("suffix,comp", [
        (".fvecs", np.float32), (".ivecs", np.int32), (".bvecs", np.uint8),
    ])
    def test_roundtrip(self, tmp_path, rng, suffix, comp):
        if comp is np.uint8:
            arr = rng.integers(0, 256, (13, 9)).astype(comp)
        elif comp is np.int32:
            arr = rng.integers(0, 1000, (13, 9)).astype(comp)
        else:
            arr = rng.standard_normal((13, 9)).astype(comp)
        p = tmp_path / f"x{suffix}"
        write_vecs(p, arr)
        got = read_vecs(p, dtype=comp)
        np.testing.assert_array_equal(got, arr)
        info = vecs_info(p)
        assert info["n"] == 13 and info["d"] == 9

    def test_offset_count(self, tmp_path, rng):
        arr = rng.standard_normal((20, 5)).astype(np.float32)
        p = tmp_path / "x.fvecs"
        write_vecs(p, arr)
        got = read_vecs(p, offset=7, count=4)
        np.testing.assert_array_equal(got, arr[7:11])

    def test_corrupt_dimension_detected(self, tmp_path, rng):
        arr = rng.standard_normal((4, 3)).astype(np.float32)
        p = tmp_path / "x.fvecs"
        write_vecs(p, arr)
        raw = bytearray(p.read_bytes())
        raw[16:20] = np.int32(7).tobytes()  # corrupt row 1's dim field
        p.write_bytes(raw)
        with pytest.raises(ValueError, match="row 1"):
            read_vecs(p)

    def test_npy(self, tmp_path, rng):
        arr = rng.standard_normal((6, 4)).astype(np.float32)
        p = tmp_path / "x.npy"
        np.save(p, arr)
        np.testing.assert_array_equal(read_any(p), arr)
        np.testing.assert_array_equal(read_any(p, offset=2, count=3), arr[2:5])


class TestSynthetic:
    def test_specs_shapes(self):
        ds = synthesize("gaussian-10k", 2000, 32, 50, "l2")
        assert ds.base.shape == (2000, 32) and ds.queries.shape == (50, 32)
        assert ds.synthetic

    def test_clustered_is_skewed(self):
        from approximatenn.data import clustered_gaussian

        rng = np.random.default_rng(0)
        x = clustered_gaussian(rng, 60_000, 16, n_clusters=32)
        assert x.shape == (60_000, 16)
        # clustered data must have much larger spread than unit Gaussian
        assert x.std() > 1.5

    def test_groundtruth_matches_bruteforce(self):
        ds = synthesize("t", 500, 8, 20, "l2")
        gt = ensure_groundtruth(ds, 5)
        ids, _ = ann.brute_force_knn(jnp.asarray(ds.base), jnp.asarray(ds.queries), 5)
        np.testing.assert_array_equal(np.sort(gt, 1), np.sort(np.asarray(ids), 1))


class TestLoad:
    """``datasets.load`` reads staged files from ``$ANN_DATA`` and never
    swaps in the synthetic stand-in silently."""

    def test_reads_staged_files(self, tmp_path, rng, monkeypatch):
        from approximatenn.data import datasets

        base = rng.standard_normal((40, 6)).astype(np.float32)
        (tmp_path / "gaussian-10k").mkdir()
        np.save(tmp_path / "gaussian-10k" / "base.npy", base)
        np.save(tmp_path / "gaussian-10k" / "query.npy", base[:5])
        monkeypatch.setenv("ANN_DATA", str(tmp_path))
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("error")
            ds = datasets.load("gaussian-10k")
        assert not ds.synthetic
        np.testing.assert_array_equal(ds.base, base)
        assert ds.queries.shape == (5, 6)

    def test_synthetic_fallback_warns(self, tmp_path, monkeypatch):
        from approximatenn.data import datasets

        monkeypatch.setenv("ANN_DATA", str(tmp_path))
        with pytest.warns(UserWarning, match="ANN_DATA.*synthetic stand-in"):
            ds = datasets.load("gaussian-10k", max_n=300, max_queries=7)
        assert ds.synthetic and ds.base.shape == (300, 32)
        assert ds.queries.shape == (7, 32)

    def test_no_synthetic_raises(self, tmp_path, monkeypatch):
        from approximatenn.data import datasets

        monkeypatch.setenv("ANN_DATA", str(tmp_path))
        with pytest.raises(FileNotFoundError, match="gaussian-10k"):
            datasets.load("gaussian-10k", allow_synthetic=False)


class TestAngular:
    def test_normalize(self, rng):
        x = rng.standard_normal((10, 6)).astype(np.float32) * 7
        u = normalize(x)
        np.testing.assert_allclose((u**2).sum(-1), 1.0, rtol=1e-5)
        uj = np.asarray(normalize(jnp.asarray(x)))
        np.testing.assert_allclose(uj, u, rtol=1e-5)

    def test_prepare_points_rejects_unknown(self):
        with pytest.raises(ValueError, match="metric"):
            prepare_points(np.zeros((2, 2)), "cosine-ish")

    def test_angular_search_orders_by_cosine(self, rng):
        n, d, k = 800, 24, 5
        base = rng.standard_normal((n, d)).astype(np.float32)
        # random positive scaling: irrelevant to cosine, decisive for L2
        base *= rng.uniform(0.1, 10, (n, 1)).astype(np.float32)
        q = rng.standard_normal((8, d)).astype(np.float32)
        index, _, _ = ann.build(jnp.asarray(base), k, tries=8, metric="angular", seed=1)
        assert index.points is not None and index.metric == "angular"
        ids, dd = ann.search(index, queries=jnp.asarray(q))
        # oracle: exact cosine ordering
        bn, qn = normalize(base), normalize(q)
        true_ids, _ = ann.brute_force_knn(jnp.asarray(bn), jnp.asarray(qn), k)
        got, want = np.asarray(ids), np.asarray(true_ids)
        recall = np.mean([
            len(set(got[i]) & set(want[i])) / k for i in range(len(q))
        ])
        assert recall >= 0.7  # hash search, not exact; must be far from random

    def test_search_positional_convenience(self, rng):
        base = rng.standard_normal((300, 8)).astype(np.float32)
        index, _, _ = ann.build(jnp.asarray(base), 4, tries=4, store_points=True)
        a = ann.search(index, jnp.asarray(base[:5]))  # (index, queries)
        b = ann.search(index, jnp.asarray(base), jnp.asarray(base[:5]))
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))

    def test_search_without_points_errors(self, rng):
        base = rng.standard_normal((300, 8)).astype(np.float32)
        index, _, _ = ann.build(jnp.asarray(base), 4, tries=4)
        with pytest.raises(ValueError, match="store_points"):
            ann.search(index, queries=jnp.asarray(base[:5]))


class TestIndexIO:
    def test_save_load_with_points_and_metric(self, tmp_path, rng):
        base = rng.standard_normal((400, 12)).astype(np.float32)
        index, _, _ = ann.build(jnp.asarray(base), 5, tries=4, metric="angular")
        path = str(tmp_path / "idx.npz")
        index.save(path)
        loaded = ann.ANNIndex.load(path)
        assert loaded.metric == "angular" and loaded.points is not None
        q = jnp.asarray(rng.standard_normal((6, 12)).astype(np.float32))
        a = ann.search(index, queries=q)
        b = ann.search(loaded, queries=q)
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))

    def test_memory_counts_points(self, rng):
        base = rng.standard_normal((400, 12)).astype(np.float32)
        i1, _, _ = ann.build(jnp.asarray(base), 5, tries=4)
        i2, _, _ = ann.build(jnp.asarray(base), 5, tries=4, store_points=True)
        assert i2.memory_bytes() - i1.memory_bytes() == 400 * 12 * 4
