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
