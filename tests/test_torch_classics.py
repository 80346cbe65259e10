"""The port's classics (logistic regression, ItemCF / UserCF, matrix
factorization, ``load_logireg``) against the JAX package's on the CPU."""
import numpy as np
import pytest

from recommender_system_tpu.models import cf as jcf
from recommender_system_tpu.models import lr as jlr
from recommender_system_tpu.models import mf as jmf
from recommender_system_tpu.utils.datasets import load_logireg as j_load_logireg
from recommender_system_tpu_torch.models import cf, lr, mf
from recommender_system_tpu_torch.utils.datasets import load_logireg

USERS = ["User1", "User2", "User3", "User4", "User5"]
MOVIES = ["M1", "M2", "M3", "M4", "M5", "M6", "M7"]
BINARY = [[1, 1, 1, 0, 1, 0, 0], [0, 1, 1, 0, 0, 1, 0], [1, 0, 1, 1, 1, 1, 1],
          [1, 1, 1, 1, 1, 0, 0], [1, 1, 0, 1, 0, 1, 1]]
RATINGS = [[3, 4, 5, 0, 3, 0, 0], [0, 4, 2, 0, 0, 5, 0], [1, 0, 3, 5, 3, 3, 2],
           [3, 3, 5, 1, 2, 0, 0], [5, 5, 0, 2, 0, 4, 5]]
# f32 on both sides, the same steps: sums taken in another order
F32 = dict(rtol=1e-5, atol=1e-6)
# float64 similarities and scores
F64 = dict(rtol=1e-12, atol=1e-12)


def _ratings(n_users=60, n_items=80, density=0.1, seed=0):
    """A MovieLens-like matrix: integer ratings 1..5 on a few entries."""
    rng = np.random.default_rng(seed)
    r = rng.integers(1, 6, (n_users, n_items)).astype(np.float64)
    r[rng.random((n_users, n_items)) > density] = 0
    return r


def _lr_data(n=200, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 2)).astype(np.float32)
    y = (X.sum(1) + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    return X, y


# ---------------------------------------------------------- logistic regression

@pytest.mark.parametrize("stop,thresh", [(lr.STOP_ITER, 300), (lr.STOP_COST, 1e-6),
                                         (lr.STOP_GRAD, 0.02)])
def test_logistic_regression_matches_jax(stop, thresh):
    """The same minibatches from the seed, the same number of steps before
    the stop rule fires, theta and every cost at f32 tolerance."""
    X, y = _lr_data()
    kw = dict(batch_size=16, lr=0.05, stop_type=stop, thresh=thresh, seed=3)
    j_theta, j_costs = jlr.fit_logistic_regression(X, y, **kw)
    theta, costs = lr.fit_logistic_regression(X, y, device="cpu", **kw)
    assert len(costs) == len(j_costs) > 2
    np.testing.assert_allclose(costs, j_costs, **F32)
    np.testing.assert_allclose(theta, j_theta, **F32)
    assert theta.dtype == np.float32
    np.testing.assert_allclose(lr.predict_proba(theta, X, device="cpu"),
                               jlr.predict_proba(j_theta, X), **F32)
    np.testing.assert_allclose(
        lr.predict_proba(theta[1:], X, add_intercept=False, device="cpu"),
        jlr.predict_proba(j_theta[1:], X, add_intercept=False), **F32)


def test_logistic_regression_without_intercept_matches_jax():
    X, y = _lr_data(seed=1)
    kw = dict(batch_size=32, lr=0.1, thresh=50, add_intercept=False)
    j_theta, j_costs = jlr.fit_logistic_regression(X, y, **kw)
    theta, costs = lr.fit_logistic_regression(X, y, device="cpu", **kw)
    assert theta.shape == (2,)
    np.testing.assert_allclose(costs, j_costs, **F32)
    np.testing.assert_allclose(theta, j_theta, **F32)


# ----------------------------------------------------------------------- CF

@pytest.mark.parametrize("matrix", ["binary", "ratings", "movielens_like"])
def test_similarities_match_jax(matrix):
    m = {"binary": np.asarray(BINARY, float), "ratings": np.asarray(RATINGS, float),
         "movielens_like": _ratings()}[matrix]
    for port, ref in ((cf.euclidean_sim, jcf.euclidean_sim),
                      (cf.pearson_sim, jcf.pearson_sim)):
        for a in (m, m.T):
            got = port(a, device="cpu")
            assert got.dtype == np.float64
            np.testing.assert_allclose(got, ref(a), **F64)


def _same_ranking(got, want):
    assert [name for name, _ in got] == [name for name, _ in want]
    np.testing.assert_allclose([s for _, s in got], [float(s) for _, s in want], **F64)


@pytest.mark.parametrize("t", ["euc", "pea"])
def test_itemcf_and_usercf_recommend_as_jax(t):
    """The same names in the same order with the same scores, on the
    reference's toy matrices and on a MovieLens-like one."""
    for matrix in (BINARY, RATINGS):
        for user in USERS:
            _same_ranking(cf.ItemCF(USERS, MOVIES, matrix, t, device="cpu").recommend(user, 3),
                          jcf.ItemCF(USERS, MOVIES, matrix, t).recommend(user, 3))
            _same_ranking(
                cf.UserCF(USERS, MOVIES, matrix, t, device="cpu").recommend(user, 2, 3),
                jcf.UserCF(USERS, MOVIES, matrix, t).recommend(user, 2, 3))
    r = _ratings(seed=1)
    users = [f"u{i}" for i in range(r.shape[0])]
    items = [f"i{j}" for j in range(r.shape[1])]
    item_port = cf.ItemCF(users, items, r, t, device="cpu")
    item_jax = jcf.ItemCF(users, items, r, t)
    user_port = cf.UserCF(users, items, r, t, device="cpu")
    user_jax = jcf.UserCF(users, items, r, t)
    for user in users[:20]:
        if (r[users.index(user)] > 0).any():
            _same_ranking(item_port.recommend(user, 10), item_jax.recommend(user, 10))
        _same_ranking(user_port.recommend(user, 5, 10), user_jax.recommend(user, 5, 10))


def test_top_k_and_ties_keep_the_given_order():
    cands = [("a", 1.0), ("b", 3.0), ("c", 3.0), ("d", 2.0)]
    assert cf.top_k(cands, 3) == jcf.top_k(cands, 3) == [("b", 3.0), ("c", 3.0), ("d", 2.0)]
    # a user whose candidates all tie: item order, as the JAX package's
    tie = [[1, 0, 0, 0], [1, 0, 0, 0]]
    got = cf.ItemCF(["x", "y"], ["p", "q", "r", "s"], tie, "pea", device="cpu").recommend("x", 3)
    assert [n for n, _ in got] == ["q", "r", "s"]


def test_cf_runs_on_the_card_by_default():
    if cf.torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cf.pearson_sim(np.asarray(RATINGS, float))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lr.fit_logistic_regression(*_lr_data(), thresh=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mf.matrix_factorization(np.asarray(RATINGS, float), steps=1)


# ---------------------------------------------------------------------- MF

@pytest.mark.parametrize("matrix", ["ratings", "movielens_like"])
def test_matrix_factorization_matches_jax(matrix):
    """200 steps (or fewer, where a stop rule fires on both): P, Q and every
    loss at f32 tolerance; ``recommend`` ranks the same items."""
    r = {"ratings": np.asarray(RATINGS, np.float32),
         "movielens_like": _ratings(40, 30, density=0.3, seed=2).astype(np.float32)}[matrix]
    kw = dict(latent_dim=3, steps=200, lr=0.002, beta=0.02, seed=1)
    j_p, j_q, j_losses = jmf.matrix_factorization(r, **kw)
    p, q, losses = mf.matrix_factorization(r, device="cpu", **kw)
    assert len(losses) == len(j_losses) == 200
    np.testing.assert_allclose(losses, j_losses, **F32)
    np.testing.assert_allclose(p, j_p, **F32)
    np.testing.assert_allclose(q, j_q, **F32)
    assert losses[-1] < losses[0]
    items = [f"i{j}" for j in range(r.shape[1])]
    for u in range(r.shape[0]):
        got = mf.recommend(u, p, q, r[u] > 0, items, 3, device="cpu")
        want = jmf.recommend(u, j_p, j_q, r[u] > 0, items, 3)
        assert [n for n, _ in got] == [n for n, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], **F32)


def test_matrix_factorization_stop_rules_match_jax():
    """The loss-below-1e-3 rule: a rank-1 matrix (every entry observed)
    stops at the same step in both packages, the loss halving a step
    there."""
    rng = np.random.default_rng(0)
    r = ((rng.random((6, 1)) + 0.5) @ (rng.random((1, 5)) + 0.5)).astype(np.float32)
    kw = dict(latent_dim=1, steps=5000, lr=0.02, beta=0.0, seed=0)
    _, _, j_losses = jmf.matrix_factorization(r, **kw)
    _, _, losses = mf.matrix_factorization(r, device="cpu", **kw)
    assert len(losses) == len(j_losses) == 14
    np.testing.assert_allclose(losses, j_losses, **F32)
    assert losses[-1] < 1e-3 <= losses[-2]


# -------------------------------------------------------------- load_logireg

def test_load_logireg_bit_exact(tmp_path):
    rng = np.random.default_rng(0)
    rows = np.concatenate([rng.uniform(30, 100, (100, 2)), rng.integers(0, 2, (100, 1))], 1)
    path = tmp_path / "LogiReg_data.txt"
    np.savetxt(path, rows, delimiter=",", fmt="%.14f")
    X, y = load_logireg(str(path))
    jX, jy = j_load_logireg(str(path))
    assert X.dtype == jX.dtype == np.float32 and y.dtype == jy.dtype == np.float32
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)
    assert X.shape == (100, 2)
