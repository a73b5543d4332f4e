"""Unit tests for the random structured-orthogonal transforms.

Validates the semantics documented against the reference kernels
(``compute.cl:55-122``) without translating them: orthogonality, Walsh
correctness vs a naive Hadamard, permutation embed/project behaviour, and
chain == materialized-basis equivalence (the property ``save_vecs``
establishes in the reference, ``alg.c:189-217``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from approximatenn.ops import transforms as T


def naive_hadamard(d):
    h = np.array([[1.0]])
    while h.shape[0] < d:
        h = np.block([[h, h], [h, -h]])
    return h / np.sqrt(d)


@pytest.mark.parametrize("d", [1, 2, 8, 64, 128])
def test_walsh_matches_naive_hadamard(d, rng):
    x = rng.standard_normal((5, d)).astype(np.float32)
    got = np.asarray(T.walsh(jnp.asarray(x)))
    want = x @ naive_hadamard(d).T.astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_walsh_orthonormal(rng):
    d = 32
    w = np.asarray(T.walsh(jnp.eye(d)))
    np.testing.assert_allclose(w @ w.T, np.eye(d), atol=1e-5)


def test_walsh_rejects_non_pow2():
    with pytest.raises(ValueError):
        T.walsh(jnp.ones((2, 3)))


def test_apply_rotation_is_givens(rng):
    d = 10
    x = rng.standard_normal((4, d)).astype(np.float32)
    i = jnp.array([1, 4])
    j = jnp.array([7, 2])
    a = jnp.array([0.3, 1.2], jnp.float32)
    got = np.asarray(T.apply_rotation(jnp.asarray(x), i, j, a))
    want = x.copy()
    for p, (ii, jj, aa) in enumerate(zip([1, 4], [7, 2], [0.3, 1.2])):
        c, s = np.cos(aa, dtype=np.float32), np.sin(aa, dtype=np.float32)
        want[:, ii] = x[:, ii] * c - x[:, jj] * s
        want[:, jj] = x[:, ii] * s + x[:, jj] * c
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # norm preserved
    np.testing.assert_allclose(
        (got * got).sum(1), (x * x).sum(1), rtol=1e-5
    )


def test_permutation_embed_and_project(rng):
    # embed semantics: out[:, y] = x[:, perm[y]] if perm[y] < d_pre else 0
    # (compute.cl:77-85)
    d_pre, d_post = 3, 8
    perm = jnp.array([2, 5, 0, 7, 1, 3, 4, 6])
    x = jnp.asarray(rng.standard_normal((2, d_pre)).astype(np.float32))
    out = np.asarray(T.apply_permutation(x, perm, d_pre))
    xn = np.asarray(x)
    for y, p in enumerate([2, 5, 0, 7, 1, 3, 4, 6]):
        want = xn[:, p] if p < d_pre else 0.0
        np.testing.assert_allclose(out[:, y], want)

    # project semantics: out[:, perm[y]] = x[:, y] for perm[y] < d_post
    # (compute.cl:88-96)
    x8 = jnp.asarray(rng.standard_normal((2, d_post)).astype(np.float32))
    out2 = np.asarray(T.apply_perm_inv(x8, perm, 3))
    x8n = np.asarray(x8)
    for y, p in enumerate([2, 5, 0, 7, 1, 3, 4, 6]):
        if p < 3:
            np.testing.assert_allclose(out2[:, p], x8n[:, y])


@pytest.mark.parametrize("d,rb,rlb,ra,rla", [(80, 6, 1, 1, 1), (33, 3, 4, 2, 8), (128, 0, 1, 0, 1)])
def test_basis_is_partial_isometry(d, rb, rlb, ra, rla):
    """The chain is orthogonal maps around a zero-fill embed d -> d_max and a
    coordinate projection d_max -> d_short, so B is a sub-block of an
    orthogonal d_max x d_max matrix: singular values <= 1, and exactly
    orthonormal rows when d == d_max (no zero-fill).  Matches the
    reference's construction (compute.cl:77-85 zero-fills out-of-range
    coordinates)."""
    d_short, d_max = T.derive_dims(1000, 10, d)
    p = T.sample_ortho_params(jax.random.key(0), d, d_max, rb, rlb, ra, rla)
    b = np.asarray(T.materialize_basis(p, d, d_short, jnp.float32))
    assert b.shape == (d_short, d)
    sv = np.linalg.svd(b, compute_uv=False)
    assert (sv <= 1 + 1e-4).all()
    if d == d_max:
        np.testing.assert_allclose(b @ b.T, np.eye(d_short), atol=1e-4)
    else:
        # Gram trace equals the expected mass of surviving coordinates
        assert 0 < np.trace(b @ b.T) <= d_short + 1e-3


def test_chain_equals_materialized_matmul(rng):
    """The property the reference proves via save_vecs (alg.c:189-217)."""
    d = 80
    d_short, d_max = T.derive_dims(1000, 10, d)
    p = T.sample_ortho_params(jax.random.key(3), d, d_max, 6, 1, 1, 1)
    x = jnp.asarray(rng.standard_normal((100, d)).astype(np.float32))
    via_chain = np.asarray(T.apply_ortho(x, p, d_short))
    b = T.materialize_basis(p, d, d_short, jnp.float32)
    via_matmul = np.asarray(x @ b.T)
    np.testing.assert_allclose(via_chain, via_matmul, rtol=1e-4, atol=1e-4)


def test_derive_dims_quirks():
    assert T.derive_dims(1000, 10, 80) == (7, 128)
    assert T.derive_dims(1024 * 10, 10, 32) == (10, 32)
    # n < k: the reference's size_t wrap clamps to d_max (alg.c:347-357)
    assert T.derive_dims(5, 10, 80) == (128, 128)
    assert T.derive_dims(10, 10, 80) == (0, 128)
    assert T.next_pow2(1) == 1 and T.next_pow2(2) == 2 and T.next_pow2(3) == 4


def test_batch_params_independent():
    ps = T.sample_ortho_params_batch(jax.random.key(0), 4, 16, 16, 2, 3, 1, 2)
    assert ps.rb_i.shape == (4, 2, 3)
    perms = np.asarray(ps.perm_b)
    assert not np.all(perms[0] == perms[1])
