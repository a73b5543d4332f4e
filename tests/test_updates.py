"""Streaming index updates (add_points / remove_points) — new capability
over the reference's immutable save_t."""

import jax.numpy as jnp
import numpy as np
import pytest

import approximatenn as ann


@pytest.fixture(scope="module")
def base():
    rng = np.random.default_rng(5)
    X = jnp.asarray(rng.standard_normal((2000, 16)).astype(np.float32))
    index, _, _ = ann.build(X, 5, tries=4, seed=1, store_points=True)
    return X, index, rng


def test_add_points_found_by_search(base):
    X, index, rng = base
    Y = jnp.asarray(rng.standard_normal((20, 16)).astype(np.float32))
    # new points sit exactly at the queries -> must be the top hit
    idx2 = index.add_points(Y)
    assert idx2.n == index.n + 20
    ids, dists = ann.search(idx2, queries=Y)
    top = np.asarray(ids[:, 0])
    want = index.n + np.arange(20)
    assert (top == want).mean() > 0.9, top  # hashed bucket must contain self
    assert np.allclose(np.asarray(dists[:, 0])[top == want], 0.0, atol=1e-5)


def test_add_points_graph_rows_exact(base):
    X, index, rng = base
    Y = jnp.asarray(rng.standard_normal((8, 16)).astype(np.float32))
    idx2 = index.add_points(Y)
    allp = jnp.concatenate([X, Y])
    gnew = np.asarray(idx2.graph[index.n :])
    for i in range(8):
        d2 = ((np.asarray(allp) - np.asarray(Y[i])) ** 2).sum(1)
        d2[index.n + i] = np.inf  # self
        want = set(np.argsort(d2)[:5].tolist())
        assert set(gnew[i].tolist()) == want


def test_add_then_remove(base):
    X, index, rng = base
    Y = jnp.asarray(rng.standard_normal((10, 16)).astype(np.float32))
    idx2 = index.add_points(Y)
    dead = list(range(index.n, index.n + 10))
    idx3 = idx2.remove_points(jnp.asarray(dead))
    ids, _ = ann.search(idx3, queries=Y)
    assert not (set(np.asarray(ids).ravel().tolist()) & set(dead))


def test_remove_excludes_from_results(base):
    X, index, _ = base
    q = X[:16]
    ids0, _ = ann.search(index, X, q)
    victims = np.unique(np.asarray(ids0[:, 0]))
    idx2 = index.remove_points(jnp.asarray(victims))
    ids1, _ = ann.search(idx2, X, q)
    assert not (set(np.asarray(ids1).ravel().tolist()) & set(victims.tolist()))
    # sentinel never exceeds n
    assert np.asarray(ids1).max() <= index.n


def test_add_points_original_index_untouched(base):
    X, index, rng = base
    tables_before = np.asarray(index.tables).copy()
    Y = jnp.asarray(rng.standard_normal((4, 16)).astype(np.float32))
    index.add_points(Y)
    np.testing.assert_array_equal(tables_before, np.asarray(index.tables))


def test_add_points_requires_points():
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((500, 8)).astype(np.float32))
    index, _, _ = ann.build(X, 5, tries=3, seed=0)  # no stored points
    with pytest.raises(ValueError):
        index.add_points(X[:2])
    idx2 = index.add_points(X[:2] + 100.0, points=X)
    assert idx2.n == 502


def test_remove_durable_through_packed(base):
    # round-1 advisor finding: packed() used to repack removed points from
    # the raw matrix, resurrecting them
    X, index, _ = base
    q = X[:16]
    ids0, _ = ann.search(index, X, q)
    victims = np.unique(np.asarray(ids0[:, 0]))
    idx2 = index.remove_points(jnp.asarray(victims))
    pv = idx2.packed()
    ids1, dd1 = ann.search_packed(pv, queries=q)
    assert not (set(np.asarray(ids1).ravel().tolist()) & set(victims.tolist()))
    assert np.isfinite(np.asarray(dd1)).all()  # live results unaffected


def test_remove_durable_through_add_points(base):
    # removed ids must not resurface in NEW points' graph rows (and hence
    # via supercharge) after a later add
    X, index, rng = base
    victims = np.arange(0, 50)
    idx2 = index.remove_points(jnp.asarray(victims))
    # new points placed exactly at removed points: their true NNs are the
    # dead rows, the strongest possible resurrection bait
    Y = X[:10] + 1e-4
    idx3 = idx2.add_points(Y)
    gnew = np.asarray(idx3.graph[idx2.n:])
    assert not (set(gnew.ravel().tolist()) & set(victims.tolist()))
    ids, _ = ann.search(idx3, queries=Y)
    assert not (set(np.asarray(ids).ravel().tolist()) & set(victims.tolist()))


def test_reverse_edge_repair_updates_old_rows(base):
    """Round-4: an old point whose true kNN now includes a new point gets
    its graph row repaired (the reverse-edge offer) — old rows can reach
    new points through supercharge without a rebuild."""
    X, index, rng = base
    # place each new point ON an old point: the old point's nearest
    # neighbor is now the new point (distance ~0), and symmetrically the
    # old point is in the new point's top-k, so the repair must fire
    targets = np.arange(0, 40, 2)
    Y = X[targets] + 1e-4
    idx2 = index.add_points(Y)
    g_old = np.asarray(idx2.graph[targets])
    new_ids = index.n + np.arange(len(targets))
    hit = np.array([new_ids[i] in g_old[i] for i in range(len(targets))])
    assert hit.all(), hit
    # repaired rows stay exact: each equals the true kNN over the grown
    # corpus for those rows
    allp = np.concatenate([np.asarray(X), np.asarray(Y)])
    for i in (0, 5, 11):
        u = targets[i]
        d2 = ((allp - allp[u]) ** 2).sum(1)
        d2[u] = np.inf
        want = set(np.argsort(d2)[:5].tolist())
        assert set(g_old[i].tolist()) == want


def test_reverse_edge_repair_off_preserves_old_behavior(base):
    X, index, rng = base
    Y = X[:8] + 1e-4
    idx2 = index.add_points(Y, repair_reverse_edges=False)
    # old rows stale by design: no old row points at a NEW id (the
    # sentinel n_new is allowed — it's the rewritten old sentinel)
    g_old = np.asarray(idx2.graph[: index.n])
    assert not ((g_old >= index.n) & (g_old < idx2.n)).any()


def test_bulk_add_matches_bucket_semantics(base):
    # vectorized append: every new point lands at slot counts[b] + rank
    # (first-free-slot order), counts track true occupancy, overflow drops
    X, index, rng = base
    m = 500
    Y = jnp.asarray(rng.standard_normal((m, 16)).astype(np.float32))
    idx2 = index.add_points(Y)
    t0, t2 = np.asarray(index.tables), np.asarray(idx2.tables)
    c0, c2 = np.asarray(index.counts), np.asarray(idx2.counts)
    # recompute expected codes through the frozen transforms
    from approximatenn.ops.hash import pack_signs

    centered = Y - index.row_means
    proj = centered @ index.bases.reshape(index.tries * index.d_short, 16).T
    codes = np.asarray(pack_signs(proj.reshape(m, index.tries, index.d_short)))
    for t in range(index.tries):
        binc = np.bincount(codes[:, t], minlength=index.n_buckets)
        np.testing.assert_array_equal(c2[t], c0[t] + binc)
        for b in np.unique(codes[:, t]):
            new_ids = index.n + np.where(codes[:, t] == b)[0]
            start, stop = c0[t, b], min(c0[t, b] + len(new_ids), index.tmax)
            got = t2[t, b, start:stop]
            want = new_ids[: stop - start]  # stable rank = arrival order
            np.testing.assert_array_equal(got, want)
            # slots past tmax dropped, pre-existing slots untouched
            np.testing.assert_array_equal(t2[t, b, :start], t0[t, b, :start])


def test_bulk_add_overflow_drops_only_that_table():
    rng = np.random.default_rng(7)
    X = jnp.asarray(rng.standard_normal((400, 8)).astype(np.float32))
    index, _, _ = ann.build(X, 4, tries=3, seed=2, store_points=True,
                            capacity=4)
    Y = jnp.asarray(rng.standard_normal((200, 8)).astype(np.float32))
    idx2 = index.add_points(Y)
    c2 = np.asarray(idx2.counts)
    t2 = np.asarray(idx2.tables)
    assert (c2 > idx2.tmax).any()  # overflow actually happened
    # every table slot is a valid id or the sentinel
    assert ((t2 <= idx2.n) & (t2 >= 0)).all()
    # overflowed points stay reachable: exact hit via some table or graph
    ids, _ = ann.search(idx2, queries=Y)
    hit = (np.asarray(ids) == 400 + np.arange(200)[:, None]).any(1)
    assert hit.mean() > 0.8
