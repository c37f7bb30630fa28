"""The port's data layer against the JAX package's: the Batcher's index
stream and wrap semantics, the numpy toy generator's statistics, and the
masked-batch conversion."""
import jax
import numpy as np
import pytest

from gpvae_tpu.data import batching as jbatching
from gpvae_tpu.data import synthetic as jsynthetic
from gpvae_tpu_torch.data import (
    Batcher, TOY_TIME_GRID, generate_toy_data, toy_to_masked_batch,
)


def _arrays(n=10):
    return {"x": np.arange(n * 3, dtype=np.float32).reshape(n, 3),
            "mask": np.arange(n) % 2 == 0}


@pytest.mark.parametrize("shuffle", [True, False])
def test_batcher_index_stream_matches_jax(shuffle):
    ours = Batcher(_arrays(), 4, seed=3, shuffle=shuffle)
    theirs = jbatching.Batcher(_arrays(), 4, seed=3, shuffle=shuffle)
    for _ in range(7):  # several wraps of a 10-row dataset
        np.testing.assert_array_equal(ours.next_indices(),
                                      theirs.next_indices())
    a, b = next(ours), next(theirs)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_batcher_wrap_semantics():
    batcher = Batcher(_arrays(), 4, seed=0)
    assert batcher.steps_per_epoch == 2
    first, second = batcher.next_indices(), batcher.next_indices()
    # one epoch draws without replacement
    assert len(set(first) | set(second)) == 8
    kept = first.copy()
    third = batcher.next_indices()  # 8 + 4 > 10: reshuffle, start over
    np.testing.assert_array_equal(first, kept)  # handed-out copies stay
    assert len(set(third)) == 4
    with pytest.raises(ValueError, match="batch_size"):
        Batcher(_arrays(), 11)
    with pytest.raises(ValueError, match="inconsistent"):
        Batcher({"a": np.zeros(3), "b": np.zeros(4)}, 2)


def _expected_observed_share(t=45, rate=0.7):
    """E[share of steps never drawn] when Poisson(rate * t) draws (capped
    at t) choose hidden steps uniformly with replacement."""
    from scipy import stats

    n = np.arange(0, 200)
    p = stats.poisson.pmf(n, rate * t)
    return float(np.sum(p * (1.0 - 1.0 / t) ** np.minimum(n, t)))


def test_toy_generator_statistics():
    n = 2000
    data = generate_toy_data(np.random.default_rng(0), n)
    x, mask, f, p = data["x"], data["mask"], data["f"], data["p"]
    assert x.shape == (n, 45, 15) and x.dtype == np.float32
    assert mask.shape == (n, 45) and f.shape == (n, 2, 45)
    np.testing.assert_allclose(data["time"], TOY_TIME_GRID, rtol=1e-6)
    # hidden steps carry the -1 sentinel, observed steps are in {0, 1}
    assert np.all(x[~mask] == -1.0)
    assert set(np.unique(x[mask])) <= {0.0, 1.0}
    expected = _expected_observed_share()
    assert abs(mask.mean() - expected) < 0.01
    # the JAX generator agrees in distribution
    jdata = jsynthetic.generate_toy_data(jax.random.key(0), n)
    assert abs(np.asarray(jdata["mask"]).mean() - expected) < 0.01
    # GP(RBF, var 1) and GP(Cosine, var 0.75) marginals, p on the simplex
    np.testing.assert_allclose(f.var(axis=(0, 2)), [1.0, 0.75], rtol=0.1)
    np.testing.assert_allclose(p.sum(axis=1), 1.0, atol=1e-5)
    assert p.min() >= 0.0
    # groups of five observation dims share a probability
    rate = np.where(mask[:, :, None], x, np.nan)
    group_means = [np.nanmean(rate[..., 5 * g:5 * g + 5]) for g in range(3)]
    np.testing.assert_allclose(group_means, p.mean(axis=(0, 2)), atol=0.01)


def test_toy_to_masked_batch_matches_jax():
    data = generate_toy_data(np.random.default_rng(1), 16)
    ours = toy_to_masked_batch(data)
    theirs = jsynthetic.toy_to_masked_batch(data)
    for k in ("x", "times", "mask"):
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert np.all(ours["x"][~ours["mask"]] == 0.0)
    # the reference pickle's sentinel layout [N, obs_dim, T], no mask
    legacy = {"x": np.swapaxes(data["x"], 1, 2), "time": data["time"]}
    ours_l = toy_to_masked_batch(legacy)
    theirs_l = jsynthetic.toy_to_masked_batch(legacy)
    for k in ("x", "times", "mask"):
        np.testing.assert_array_equal(ours_l[k], theirs_l[k])
    np.testing.assert_array_equal(ours_l["mask"], data["mask"])
