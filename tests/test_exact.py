"""The XLA exact engine (ops/distance.exact_search) against a float64 numpy
oracle, in every storage tier and precision, plus its wrapper's contract:
query blocks from the byte budget, exclusion, sentinel padding, argument
checks and the int8 quantizer."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest

from approximatenn.ops import distance
from approximatenn.ops.distance import (
    brute_force_knn,
    brute_force_knn_self,
    exact_search,
    quantize_corpus,
    query_block,
)

# |returned distance - float64 distance of the returned id| bound, in
# units of (|q|^2 + |p|^2): the cross-term expansion qn + pn - 2 q.p
# cancels, so the error scales with the norms, not the distance.
# highest/bf16/int8 accumulate exact (or float32-exact) products in f32;
# split3 drops the lo*lo term (~2^-16 of each product).
DIST_TOL = {"highest": 2.0 ** -20, "split3": 2.0 ** -14,
            "bf16": 2.0 ** -20, "int8": 2.0 ** -20}

SHAPES = {"n300_d24": (300, 24, 20), "n1037_d7": (1037, 7, 33)}


def _grid(tier, X, Y):
    """The corpus and queries the engine ranks, as float64, and the
    engine's arguments for the tier."""
    if tier == "bf16":
        Xs = jnp.asarray(X).astype(jnp.bfloat16)
        gx = np.asarray(Xs.astype(jnp.float32), np.float64)
        gy = np.asarray(jnp.asarray(Y).astype(jnp.bfloat16)
                        .astype(jnp.float32), np.float64)
        return Xs, gx, gy, {}
    if tier == "int8":
        Xq, s = quantize_corpus(X)
        s32 = np.float32(s)
        gx = np.asarray(Xq, np.float64) * np.float64(s32)
        gy = np.clip(np.round(Y / s32), -127, 127).astype(np.float64) * s32
        return Xq, gx, gy, {"scale": s}
    return (jnp.asarray(X), X.astype(np.float64), Y.astype(np.float64),
            {"matmul_precision": tier})


def _d64(gx, gy):
    return ((gy[:, None, :] - gx[None, :, :]) ** 2).sum(-1)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("k", [1, 10, 100, 130, 256])
@pytest.mark.parametrize("tier", ["highest", "split3", "bf16", "int8"])
def test_matches_f64_oracle(tier, k, shape):
    """Every returned id is within the oracle's k-th distance on the grid
    the tier ranks (exact up to ties), distances ascend and match the
    float64 distance of the returned id; k > 128 rides lax.top_k."""
    n, d, m = SHAPES[shape]
    rng = np.random.default_rng(zlib.crc32(f"{tier}/{k}/{shape}".encode()))
    X = rng.standard_normal((n, d)).astype(np.float32)
    Y = rng.standard_normal((m, d)).astype(np.float32)
    Xs, gx, gy, kw = _grid(tier, X, Y)
    ids, dd = exact_search(Xs, Y, k, block=7, **kw)
    ids, dd = np.asarray(ids), np.asarray(dd)
    assert ids.shape == dd.shape == (m, k) and dd.dtype == np.float32
    assert ((ids >= 0) & (ids < n)).all()
    assert all(len(set(r)) == k for r in ids.tolist())
    d64 = _d64(gx, gy)
    kth = np.sort(d64, 1)[:, k - 1: k]
    got = np.take_along_axis(d64, ids, 1)
    assert (got <= kth * (1 + 1e-9) + 1e-12).all()
    assert (np.diff(dd, axis=1) >= 0).all()
    norms = (gy ** 2).sum(1)[:, None] + (gx ** 2).sum(1)[ids]
    assert (np.abs(dd - got) <= DIST_TOL[tier] * norms).all()


def test_default_precision_is_a_speed_tier(rng):
    """"default" runs the backend's fastest f32 product (TF32 on NVIDIA
    GPUs; full f32 on the CPU): neighbor sets stay near the oracle."""
    X = rng.standard_normal((500, 32)).astype(np.float32)
    Y = rng.standard_normal((40, 32)).astype(np.float32)
    ia, _ = exact_search(X, Y, 10, matmul_precision="default")
    want = np.argsort(_d64(X.astype(np.float64), Y.astype(np.float64)), 1)
    overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in
                       zip(np.asarray(ia).tolist(), want[:, :10].tolist())])
    assert overlap > 0.9, overlap


def test_f16_storage_tier(rng):
    X = rng.standard_normal((400, 16)).astype(np.float32)
    Y = rng.standard_normal((12, 16)).astype(np.float32)
    Xh = jnp.asarray(X).astype(jnp.float16)
    ids, dd = exact_search(Xh, Y, 5)
    gx = np.asarray(Xh.astype(jnp.float32), np.float64)
    gy = np.asarray(jnp.asarray(Y).astype(jnp.float16).astype(jnp.float32),
                    np.float64)
    d64 = _d64(gx, gy)
    got = np.take_along_axis(d64, np.asarray(ids), 1)
    assert (got <= np.sort(d64, 1)[:, 4:5] * (1 + 1e-9)).all()
    assert np.asarray(dd).dtype == np.float32


def test_self_exclusion(rng):
    p = rng.standard_normal((200, 6)).astype(np.float32)
    ia, _ = brute_force_knn_self(p, 4)
    ia = np.asarray(ia)
    assert not any(i in ia[i] for i in range(200))
    d = _d64(p.astype(np.float64), p.astype(np.float64))
    np.fill_diagonal(d, np.inf)
    np.testing.assert_array_equal(np.sort(ia, 1), np.sort(np.argsort(d, 1)[:, :4], 1))
    # per-query exclusion ids; -1 excludes nothing
    excl = np.array([3, -1, 7], np.int32)
    ib, _ = exact_search(p, p[[3, 5, 7]], 2, exclude=excl)
    ib = np.asarray(ib)
    assert 3 not in ib[0] and ib[1, 0] == 5 and 7 not in ib[2]


def test_k_exceeds_n_pads_with_sentinel(rng):
    p = rng.standard_normal((5, 4)).astype(np.float32)
    q = rng.standard_normal((3, 4)).astype(np.float32)
    for k in (8, 200):  # the argmin passes and the lax.top_k branch
        ia, da = exact_search(p, q, k)
        ia, da = np.asarray(ia), np.asarray(da)
        assert (ia[:, 5:] == 5).all() and np.isinf(da[:, 5:]).all()
        assert np.isfinite(da[:, :5]).all()
        assert sorted(ia[0, :5].tolist()) == list(range(5))


def test_block_size_does_not_change_results(rng):
    """Uneven n, m not a multiple of the block: any block gives the same
    ids and distances as one block."""
    p = rng.standard_normal((333, 12)).astype(np.float32)
    q = rng.standard_normal((41, 12)).astype(np.float32)
    ia, da = exact_search(p, q, 5)
    for block in (1, 16, 40, 41):
        ib, db = exact_search(p, q, 5, block=block)
        np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))
        np.testing.assert_allclose(np.asarray(da), np.asarray(db), rtol=1e-6)


def test_query_block_from_byte_budget(monkeypatch):
    """The (block, n) distance matrix stays within the budget."""
    gib = distance.DIST_BLOCK_BYTES
    assert gib == 1 << 30
    assert query_block(10_000, 1_000_000, 4) == gib // (4 * 1_000_000)
    assert query_block(10_000, 1_000_000, 8) == gib // (8 * 1_000_000)
    assert query_block(50, 1000) == 50  # capped at m
    assert query_block(10, 10**12) == 1  # at least one row
    b = query_block(10_000, 3_000_000)
    assert b * 3_000_000 * 4 <= gib < (b + 1) * 3_000_000 * 4
    monkeypatch.setattr(distance, "DIST_BLOCK_BYTES", 4 * 100 * 7)
    assert query_block(30, 100) == 7


def test_default_block_follows_budget(rng, monkeypatch):
    """exact_search sizes its block from DIST_BLOCK_BYTES when none is
    given."""
    seen = {}
    orig = distance._exact_knn

    def spy(*a, **kw):
        seen.update(kw)
        return orig(*a, **kw)

    monkeypatch.setattr(distance, "_exact_knn", spy)
    monkeypatch.setattr(distance, "DIST_BLOCK_BYTES", 4 * 100 * 7)
    p = rng.standard_normal((100, 3)).astype(np.float32)
    exact_search(p, p[:30], 2)
    assert seen["block"] == 7


def test_brute_force_knn_is_the_f32_engine(rng):
    p = rng.standard_normal((257, 9)).astype(np.float32)
    q = rng.standard_normal((10, 9)).astype(np.float32)
    ia, da = brute_force_knn(p, q, 6)
    ib, db = exact_search(p, q, 6, matmul_precision="highest")
    np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))
    np.testing.assert_array_equal(np.asarray(da), np.asarray(db))


def test_rejects_unknown_precision(rng):
    p = rng.standard_normal((64, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="matmul_precision"):
        exact_search(p, p[:4], 3, matmul_precision="high")


def test_int8_requires_scale(rng):
    pq, _ = quantize_corpus(rng.standard_normal((64, 8)).astype(np.float32))
    with pytest.raises(ValueError, match="scale"):
        exact_search(pq, jnp.zeros((4, 8), jnp.float32), 3)


def test_int8_recall_vs_full_precision(rng):
    """Quantization at d=32 keeps neighbor sets near the full-precision
    oracle (the tier's quality band)."""
    pf = rng.standard_normal((600, 32)).astype(np.float32)
    q = rng.standard_normal((40, 32)).astype(np.float32)
    pq, scale = quantize_corpus(pf)
    ia, _ = exact_search(pq, q, 10, scale=scale)
    want = np.argsort(_d64(pf.astype(np.float64), q.astype(np.float64)), 1)
    overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in
                       zip(np.asarray(ia).tolist(), want[:, :10].tolist())])
    assert overlap > 0.9, overlap


def test_quantize_corpus_chunked_matches_one_shot(rng, monkeypatch):
    """The chunked quantizer (corpora past ~1 GB) is bit-identical to the
    one-shot form."""
    X = rng.standard_normal((1000, 16)).astype(np.float32)
    q1, s1 = quantize_corpus(X)
    monkeypatch.setattr(distance, "_QUANT_CHUNKED_MIN_BYTES", 0)
    q2, s2 = quantize_corpus(X, chunk_rows=137)
    assert float(s1) == float(s2)
    np.testing.assert_array_equal(np.asarray(q1), np.asarray(q2))
    assert q1.dtype == jnp.int8
    assert float(s1) == pytest.approx(np.abs(X).max() / 127.0)
