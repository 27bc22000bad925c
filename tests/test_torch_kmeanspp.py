"""The port's k-means++ draw is ``jax.random``'s: the centres the JAX
package's ``_kmeanspp_init(PRNGKey(seed), X, k)`` picks (float64, x64 on),
for seeds 0-49 over several (n, k), equal index for index; and a fit
with seed 42 from the port's own draw against the JAX package's
``gmm.fit`` (means within 1e-8, mean log-likelihood within 1e-6 nats per
sample), on random data and on the procedural pose table."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.priors import gmm as jgmm
from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
from cheetah_pose_estimation_tpu_torch.priors import gmm as tgmm

torch.set_num_threads(1)


@pytest.mark.parametrize("n,k,d", [(7, 7, 2), (50, 3, 4), (200, 5, 22),
                                   (1000, 8, 22)])
def test_kmeanspp_indices_equal_jax(n, k, d):
    X = np.random.default_rng(n + k).normal(size=(n, d))
    draw = jax.jit(lambda key, x: jgmm._kmeanspp_init(key, x, k))
    for seed in range(50):
        centres = np.asarray(draw(jax.random.PRNGKey(seed), jnp.asarray(X)))
        idx = tgmm.kmeanspp_indices(X, k, seed)
        assert np.array_equal(X[idx], centres), seed


def test_threefry_key_derivation_equals_jax():
    """PRNGKey, split and the 64-bit words under the draw, bit for bit
    (seeds past 2^32 included)."""
    for seed in (0, 42, 2 ** 32 + 5):
        key = tgmm._JaxKey.from_seed(seed)
        jkey = jax.random.PRNGKey(seed)
        assert [int(x) for x in key.k] == np.asarray(jkey).tolist()
        for a, b in zip(key.split(3), jax.random.split(jkey, 3)):
            assert [int(x) for x in a.k] == np.asarray(b).tolist()
        bits = jax.random.bits(jkey, (5,), jnp.uint64)
        assert key.bits64(5).tolist() == np.asarray(bits).tolist()


@pytest.mark.parametrize("table", ["random", "pose"])
def test_fit_seed_42_matches_jax(table):
    if table == "random":
        rng = np.random.default_rng(0)
        X = np.concatenate([rng.normal(loc=m, size=(150, 6))
                            for m in (-2.0, 0.0, 3.0)])
        k = 3
    else:
        X = bench_lib.procedural_pose_table((100, 101),
                                            n_frames=60).data[:, 6:28]
        k = 5
    jp = jgmm.fit(X, k, seed=42, max_iter=50)
    tp = tgmm.fit(X, k, seed=42, max_iter=50, device="cpu")
    assert np.abs(np.asarray(jp.means) - tp.means.numpy()).max() <= 1e-8
    assert abs(jgmm.score(jp, X) - tgmm.score(tp, X)) <= 1e-6
