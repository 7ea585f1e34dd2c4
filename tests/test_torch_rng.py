"""The port's threefry PRNG (gridgcn_torch.utils.jaxrng) against jax.random:
every key derivation and draw bit for bit, and flax's per-layer CAGQ keys."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gridgcn_torch.utils import jaxrng

torch.set_num_threads(1)

SEEDS = [0, 1, 42, 2 ** 31 - 1]
SHAPES = [(1,), (3,), (2, 5), (7, 1, 3), (1, 81920)]


def _data(key):
    return np.asarray(jax.random.key_data(key)) \
        if jnp.issubdtype(key.dtype, jax.dtypes.prng_key) else np.asarray(key)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_derivation_matches_jax(seed):
    kj, kt = jax.random.PRNGKey(seed), jaxrng.PRNGKey(seed)
    np.testing.assert_array_equal(_data(kj), kt)
    for num in (1, 2, 3, 5):
        np.testing.assert_array_equal(
            np.asarray(jax.random.split(kj, num)), jaxrng.split(kt, num))
    for d in (0, 1, 7, 2 ** 31 + 5, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            np.asarray(jax.random.fold_in(kj, d)), jaxrng.fold_in(kt, d))


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_match_jax(shape):
    for seed in SEEDS:
        kj = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
        got = jaxrng.bits(_data(kj), shape)
        assert got.dtype == torch.int64 and tuple(got.shape) == shape
        np.testing.assert_array_equal(
            np.asarray(jax.random.bits(kj, shape)).astype(np.int64),
            got.numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_matches_jax(shape):
    for seed in SEEDS:
        kj = jax.random.split(jax.random.PRNGKey(seed), 2)[1]
        want = np.asarray(jax.random.uniform(kj, shape))
        got = jaxrng.uniform(_data(kj), shape).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


def test_flax_make_rng_matches_model_keys(monkeypatch):
    """The key the JAX segmentation model hands to cagq in module
    gridconv{i} is flax_make_rng(root, ("gridconv{i}",), 1). Captured by a
    recording wrapper around gridgcn_tpu.models.gridconv.cagq (inside this
    test only), through a debug callback under jit."""
    import gridgcn_tpu.models.gridconv as jgridconv
    from gridgcn_tpu.configs import presets
    from gridgcn_tpu.models.build import build_model

    seen = []
    real = jgridconv.cagq

    def recording_cagq(xyz, mask, spec, key, bounds=None):
        jax.debug.callback(lambda k: seen.append(np.asarray(k)), key)
        return real(xyz, mask, spec, key, bounds=bounds)

    monkeypatch.setattr(jgridconv, "cagq", recording_cagq)
    cfg = presets.get("synthetic_tiny_seg")
    model = build_model(cfg.model)
    N = cfg.data.num_points
    xyz = jnp.asarray(np.random.default_rng(0).uniform(
        -1, 1, (1, N, 3)).astype(np.float32))
    mask = jnp.ones((1, N), bool)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "cagq": jax.random.PRNGKey(1)},
        xyz, None, mask))
    variables = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    root = jax.random.PRNGKey(9)
    fwd = jax.jit(lambda v, x, m, k: model.apply(v, x, None, m,
                                                 rngs={"cagq": k}))
    jax.block_until_ready(fwd(variables, xyz, mask, root))
    jax.effects_barrier()
    assert len(seen) == len(cfg.model.layers)
    for i, k in enumerate(seen):
        np.testing.assert_array_equal(
            k, jaxrng.flax_make_rng(_data(root), (f"gridconv{i}",), 1))


@pytest.mark.parametrize("n", [1, 7, 48, 512, 2048, 5000])
def test_permutation_matches_jax(n):
    """Both round counts of JAX's _shuffle: one round up to n = 1625, two
    for 2048 and 5000."""
    for seed in SEEDS:
        kj = jax.random.fold_in(jax.random.PRNGKey(seed), n)
        got = jaxrng.permutation(_data(kj), n)
        np.testing.assert_array_equal(
            np.asarray(jax.random.permutation(kj, n)), got.numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_gumbel_matches_jax(shape):
    """jaxrng.gumbel repeats XLA:CPU's float32 log (utils/xla_math), so the
    count of values that differ from jax.random.gumbel is 0: bit for bit,
    not just within an ulp."""
    for seed in SEEDS:
        kj = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
        want = np.asarray(jax.random.gumbel(kj, shape))
        got = jaxrng.gumbel(_data(kj), shape).numpy()
        assert got.dtype == np.float32
        assert int((want.view(np.int32) != got.view(np.int32)).sum()) == 0


def test_log_matches_xla_cpu():
    """utils.xla_math.log against jnp.log over a million positive values,
    from the smallest normal to 1e30: the count that differs is 0."""
    from gridgcn_torch.utils import xla_math

    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(0, 1, 500_000), 10.0 ** rng.uniform(-37.9, 30, 500_000),
        [np.finfo(np.float32).tiny, 1.0, 2.0, 0.5]]).astype(np.float32)
    x = np.maximum(x, np.finfo(np.float32).tiny)
    want = np.asarray(jnp.log(x))
    got = xla_math.log(torch.from_numpy(x)).numpy()
    assert int((want.view(np.int32) != got.view(np.int32)).sum()) == 0


@pytest.mark.parametrize("lo,hi", [(-1.0, 1.0), (0.3, 1.7), (-5.0, 2.5)])
def test_uniform_range_matches_jax(lo, hi):
    """minval/maxval: XLA:CPU fuses floats·(hi − lo) + lo into one FMA."""
    kj = jax.random.PRNGKey(9)
    want = np.asarray(jax.random.uniform(kj, (3, 5000), minval=lo,
                                         maxval=hi))
    got = jaxrng.uniform(_data(kj), (3, 5000), minval=lo, maxval=hi).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


def test_batched_keys_equal_per_key_draws():
    """A [B, 2] key array splits, and draws B rows, in one pass, each the
    result under its own key: split, bits, uniform, gumbel and
    permutation."""
    keys = jaxrng.split(jaxrng.PRNGKey(5), 4)
    both = jaxrng.split(keys, 3)
    assert both.shape == (4, 3, 2)
    for b, k in enumerate(keys):
        np.testing.assert_array_equal(both[b], jaxrng.split(k, 3))
    for fn in (jaxrng.bits, jaxrng.uniform, jaxrng.gumbel):
        got = fn(keys, (3, 7))
        assert tuple(got.shape) == (4, 3, 7)
        for b, k in enumerate(keys):
            assert torch.equal(got[b], fn(k, (3, 7)))
    got = jaxrng.permutation(keys, 300)
    for b, k in enumerate(keys):
        assert torch.equal(got[b], jaxrng.permutation(k, 300))
