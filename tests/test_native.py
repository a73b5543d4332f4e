"""Tests for the native C++ host runtime against numpy/JAX oracles."""

import numpy as np
import jax.numpy as jnp
import pytest

from approximatenn import native
from approximatenn.ops.buckets import build_table
from approximatenn.ops.distance import brute_force_knn as jax_bf


def test_native_library_builds():
    # g++ is in the image; the compiled path must be active, not the fallback
    assert native.available()


class TestBucketTable:
    def test_matches_device_builder(self, rng):
        n, nb = 500, 32
        codes = rng.integers(0, nb, n).astype(np.int32)
        table, counts, tmax = native.bucket_table(codes, nb, None, n)
        dev = np.asarray(build_table(jnp.asarray(codes), nb, tmax, n))
        # same members per bucket; the native builder preserves the
        # reference's first-seen order, the device one sorted order
        for b in range(nb):
            assert set(table[b]) - {n} == set(dev[b]) - {n}
        np.testing.assert_array_equal(counts, np.bincount(codes, minlength=nb))

    def test_first_seen_order(self):
        codes = np.array([2, 0, 2, 1, 2], np.int32)
        table, counts, tmax = native.bucket_table(codes, 4, None, 5)
        assert tmax == 3
        np.testing.assert_array_equal(table[2], [0, 2, 4])
        np.testing.assert_array_equal(table[0], [1, 5, 5])

    def test_capacity_overflow(self):
        codes = np.zeros(10, np.int32)
        table, counts, tmax = native.bucket_table(codes, 2, 3, 10)
        assert tmax == 10 and table.shape == (2, 3)
        np.testing.assert_array_equal(table[0], [0, 1, 2])

    def test_rejects_out_of_range(self):
        with pytest.raises(ValueError):
            native.bucket_table(np.array([5], np.int32), 4, None, 1)


class TestBruteForce:
    def test_matches_jax_oracle(self, rng):
        n, d, m, k = 300, 17, 23, 7
        p = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((m, d)).astype(np.float32)
        ni, nd = native.brute_force_knn(p, q, k)
        ji, jd = jax_bf(jnp.asarray(p), jnp.asarray(q), k)
        np.testing.assert_array_equal(np.sort(ni, 1), np.sort(np.asarray(ji), 1))
        np.testing.assert_allclose(nd, np.asarray(jd), rtol=1e-4)

    def test_self_exclusion(self, rng):
        p = rng.standard_normal((50, 5)).astype(np.float32)
        ids, _ = native.brute_force_knn(p, p, 3, exclude_self_offset=0)
        assert not any(i in ids[i] for i in range(50))

    def test_k_exceeds_n_pads(self, rng):
        p = rng.standard_normal((4, 3)).astype(np.float32)
        ids, dd = native.brute_force_knn(p, p[:2], 6)
        assert (ids[:, 4:] == 4).all() and np.isinf(dd[:, 4:]).all()


class TestRankGuesses:
    def test_perfect_guess_scores_zero_miss(self, rng):
        n, d, m, k = 120, 9, 10, 5
        p = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((m, d)).astype(np.float32)
        ids, _ = native.brute_force_knn(p, q, k)
        rank_sum, miss, mx = native.rank_guesses(p, q, ids)
        np.testing.assert_array_equal(miss, 0)
        # exact guesses: ranks are a permutation of 0..k-1 (ties aside)
        assert (rank_sum <= k * (k - 1) // 2).all()
        assert (mx <= k - 1).all()

    def test_sentinel_guess_worst_rank(self, rng):
        p = rng.standard_normal((30, 4)).astype(np.float32)
        guesses = np.full((2, 3), 30, np.int32)  # all sentinels
        rank_sum, miss, mx = native.rank_guesses(p, p[:2], guesses)
        np.testing.assert_array_equal(mx, 30)
        np.testing.assert_array_equal(miss, 3)
