"""Unit tests for hashing, bucket tables, dedup/top-k, and distances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from approximatenn.ops.buckets import (
    bucket_counts,
    build_table,
    multiprobe_gather,
)
from approximatenn.ops.distance import (
    blocked_over_rows,
    brute_force_knn,
    brute_force_knn_self,
    candidate_dists,
)
from approximatenn.ops.hash import pack_signs, probe_codes
from approximatenn.ops.topk import (
    dedup_topk,
    dedup_topk_sort,
    topk_iter,
    topk_no_dedup,
)


class TestHash:
    def test_msb_first_packing(self):
        # first coordinate = most significant bit (compute.cl:228-230)
        x = jnp.array([[-1.0, 1.0, 1.0], [1.0, 1.0, -1.0], [-1.0, -1.0, -1.0]])
        np.testing.assert_array_equal(np.asarray(pack_signs(x)), [4, 1, 7])

    def test_negative_zero_counts_as_negative(self):
        # raw IEEE sign bit semantics (compute.cl:229)
        x = jnp.array([[-0.0, 0.0]])
        assert int(pack_signs(x)[0]) == 2

    def test_zero_width(self):
        assert pack_signs(jnp.zeros((5, 0))).shape == (5,)

    def test_probe_codes(self):
        # probe 0 = code; probe y flips bit y-1 (compute.cl:244)
        c = jnp.array([5], jnp.int32)
        got = np.asarray(probe_codes(c, 3))[0]
        np.testing.assert_array_equal(got, [5, 4, 7, 1])


class TestBuckets:
    def test_table_contents(self, rng):
        n, d_short = 200, 4
        codes = jnp.asarray(rng.integers(0, 16, n).astype(np.int32))
        counts = np.asarray(bucket_counts(codes, 16))
        tmax = int(counts.max())
        table = np.asarray(build_table(codes, 16, tmax, n))
        cn = np.asarray(codes)
        for b in range(16):
            members = set(np.where(cn == b)[0].tolist())
            got = [v for v in table[b] if v < n]
            assert set(got) == members
            assert all(v == n for v in table[b][counts[b]:])

    def test_capacity_overflow_drops(self):
        codes = jnp.zeros(10, jnp.int32)  # all in bucket 0
        table = np.asarray(build_table(codes, 4, 3, 10))
        assert (table[0] < 10).sum() == 3  # only capacity survive
        assert (table[1:] == 10).all()  # no bleed into other buckets

    def test_multiprobe_gather(self, rng):
        n, d_short = 64, 3
        codes = jnp.asarray(rng.integers(0, 8, n).astype(np.int32))
        tmax = int(np.asarray(bucket_counts(codes, 8)).max())
        table = build_table(codes, 8, tmax, n)
        cand = np.asarray(multiprobe_gather(table, codes[:5], d_short))
        assert cand.shape == (5, 4 * tmax)
        cn = np.asarray(codes)
        for i in range(5):
            expected = set()
            for probe in [cn[i], cn[i] ^ 1, cn[i] ^ 2, cn[i] ^ 4]:
                expected |= set(np.where(cn == probe)[0].tolist())
            got = set(v for v in cand[i] if v < n)
            assert got == expected


class TestTopk:
    def test_dedup_keeps_one_per_id(self):
        ids = jnp.array([[3, 1, 3, 2, 1, 5]], jnp.int32)
        dists = jnp.array([[0.3, 0.1, 0.3, 0.2, 0.1, 0.5]])
        gi, gd = dedup_topk(ids, dists, 4, sentinel=10)
        np.testing.assert_array_equal(np.asarray(gi)[0], [1, 2, 3, 5])
        np.testing.assert_allclose(np.asarray(gd)[0], [0.1, 0.2, 0.3, 0.5])

    def test_sentinel_padding_when_short(self):
        ids = jnp.array([[2, 2, 2, 7]], jnp.int32)
        dists = jnp.array([[0.5, 0.5, 0.5, jnp.inf]])
        gi, gd = dedup_topk(ids, dists, 3, sentinel=7)
        gi, gd = np.asarray(gi)[0], np.asarray(gd)[0]
        assert gi[0] == 2 and gd[0] == 0.5
        assert (gi[1:] == 7).all() and np.isinf(gd[1:]).all()

    def test_matches_numpy_reference(self, rng):
        m, L, k, n = 32, 50, 8, 40
        ids = rng.integers(0, n + 1, (m, L)).astype(np.int32)
        dd = rng.random((m, L)).astype(np.float32)
        dd[ids == n] = np.inf
        gi, gd = dedup_topk(jnp.asarray(ids), jnp.asarray(dd), k, n)
        gi = np.asarray(gi)
        for i in range(m):
            best = {}
            for j in range(L):
                if ids[i, j] < n:
                    best[ids[i, j]] = min(best.get(ids[i, j], np.inf), dd[i, j])
            want = sorted(best, key=best.get)[:k]
            got = [v for v in gi[i] if v < n]
            assert got == want

    def test_iter_matches_sort_form(self, rng):
        """The k-pass argmin form must equal the sort-based oracle form."""
        m, L, k, n = 16, 70, 9, 50
        ids = rng.integers(0, n + 1, (m, L)).astype(np.int32)
        dd = rng.integers(0, 30, (m, L)).astype(np.float32)  # force dist ties
        dd[ids == n] = np.inf
        ai, ad = dedup_topk(jnp.asarray(ids), jnp.asarray(dd), k, n)
        bi, bd = dedup_topk_sort(jnp.asarray(ids), jnp.asarray(dd), k, n)
        # with distance ties across different ids the picked set can
        # legitimately differ in tie order only — compare (dist, id) pairs
        # after sorting, and require identical distance sequences
        np.testing.assert_array_equal(np.asarray(ad), np.asarray(bd))
        for i in range(m):
            a = {(d_, v) for d_, v in zip(np.asarray(ad)[i], np.asarray(ai)[i]) if np.isfinite(d_)}
            got_d = sorted(d_ for d_, _ in a)
            want_d = sorted(d_ for d_ in np.asarray(bd)[i] if np.isfinite(d_))
            assert got_d == want_d

    def test_k_exceeds_candidates_pads(self):
        ids = jnp.array([[1, 2, 1]], jnp.int32)
        dists = jnp.array([[0.2, 0.1, 0.2]])
        gi, gd = dedup_topk(ids, dists, 6, sentinel=9)
        gi, gd = np.asarray(gi)[0], np.asarray(gd)[0]
        np.testing.assert_array_equal(gi[:2], [2, 1])
        assert (gi[2:] == 9).all() and np.isinf(gd[2:]).all()
        assert gi.shape == (6,)

    def test_topk_iter_matches_lax_topk(self, rng):
        m, L, k = 8, 200, 12
        dd = rng.random((m, L)).astype(np.float32)
        pos, vals = topk_iter(jnp.asarray(dd), k)
        neg, idx = jax.lax.top_k(-jnp.asarray(dd), k)
        np.testing.assert_array_equal(np.asarray(pos), np.asarray(idx))
        np.testing.assert_array_equal(np.asarray(vals), -np.asarray(neg))

    def test_topk_no_dedup_pads_past_length(self):
        dists = jnp.array([[0.3, 0.1]])
        ids = jnp.array([[7, 4]], jnp.int32)
        gi, gd = topk_no_dedup(dists, ids, 4)
        np.testing.assert_array_equal(np.asarray(gi)[0, :2], [4, 7])
        assert np.isinf(np.asarray(gd)[0, 2:]).all()


class TestDistance:
    def test_candidate_dists_exact(self, rng):
        n, d, m, L = 30, 7, 5, 9
        p = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((m, d)).astype(np.float32)
        cand = rng.integers(0, n + 3, (m, L)).astype(np.int32)  # some sentinels
        dd = np.asarray(candidate_dists(jnp.asarray(q), jnp.asarray(p), jnp.asarray(cand)))
        for i in range(m):
            for j in range(L):
                c = cand[i, j]
                if c >= n:
                    assert np.isinf(dd[i, j])
                else:
                    want = ((q[i] - p[c]) ** 2).sum()
                    np.testing.assert_allclose(dd[i, j], want, rtol=1e-5)

    def test_self_exclusion(self, rng):
        p = rng.standard_normal((10, 4)).astype(np.float32)
        cand = jnp.arange(10, dtype=jnp.int32)[:, None]  # each row's own id
        dd = candidate_dists(
            jnp.asarray(p), jnp.asarray(p), cand, exclude_self=jnp.arange(10, dtype=jnp.int32)
        )
        assert np.isinf(np.asarray(dd)).all()

    def test_dot_method_close_to_diff(self, rng):
        n, d, m, L = 50, 16, 8, 12
        p = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((m, d)).astype(np.float32)
        cand = rng.integers(0, n, (m, L)).astype(np.int32)
        a = np.asarray(candidate_dists(jnp.asarray(q), jnp.asarray(p), jnp.asarray(cand)))
        b = np.asarray(
            candidate_dists(jnp.asarray(q), jnp.asarray(p), jnp.asarray(cand), method="dot")
        )
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)

    def test_brute_force_vs_numpy(self, rng):
        n, d, m, k = 80, 12, 9, 5
        p = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((m, d)).astype(np.float32)
        ids, dists = brute_force_knn(jnp.asarray(p), jnp.asarray(q), k)
        dd = ((q[:, None, :] - p[None, :, :]) ** 2).sum(-1)
        want = np.argsort(dd, axis=1)[:, :k]
        np.testing.assert_array_equal(np.sort(np.asarray(ids), 1), np.sort(want, 1))

    def test_brute_force_self_excludes_diagonal(self, rng):
        p = rng.standard_normal((30, 6)).astype(np.float32)
        ids, _ = brute_force_knn_self(jnp.asarray(p), 4)
        ids = np.asarray(ids)
        assert not any(i in ids[i] for i in range(30))

    @pytest.mark.parametrize("block", [3, 7, 64])
    def test_blocked_invariance(self, rng, block):
        """Row blocking must not change results (padding correctness)."""
        n, d, m, k = 64, 8, 37, 6
        p = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
        q = jnp.asarray(rng.standard_normal((m, d)).astype(np.float32))
        a = brute_force_knn(p, q, k, block=block)
        b = brute_force_knn(p, q, k, block=m)
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
        np.testing.assert_allclose(np.asarray(a[1]), np.asarray(b[1]), rtol=1e-6)
