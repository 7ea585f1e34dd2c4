"""The port's augmentation inputs against the JAX package: jaxrng.normal and
bernoulli and xla_math's erf⁻¹/log1p bit for bit, augment_batch's draws and
point-dropout mask bit for bit (its coordinates to a stated tolerance), and
the Dataset's batch order, padding and example_mask."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gridgcn_tpu.configs import presets as jpresets
from gridgcn_tpu.data.augment import augment_batch as jaugment_batch
from gridgcn_tpu.data.pipeline import Dataset as JDataset
from gridgcn_torch.data.augment import augment_batch, augment_draws
from gridgcn_torch.data.pipeline import Dataset
from gridgcn_torch.utils import jaxrng, xla_math
from tests.test_torch_models import to_port

torch.set_num_threads(1)


def _differ(want, got) -> int:
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape and want.dtype == got.dtype
    return int((want.view(np.int32) != got.view(np.int32)).sum())


@pytest.mark.parametrize("seed", [0, 3])
def test_normal_matches_jax_over_a_million_draws(seed):
    """√2·erf⁻¹(u) through XLA:CPU's log1p, Horner FMAs and a correctly
    rounded sqrt: 0 differing values (torch's own erfinv differs in ~59%)."""
    kj = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.normal(kj, (1_000_000,)))
    got = jaxrng.normal(np.asarray(kj), (1_000_000,)).numpy()
    assert _differ(want, got) == 0


def test_normal_and_bernoulli_take_batched_keys():
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (3, 700)))(keys))
    assert _differ(want, jaxrng.normal(np.asarray(keys), (3, 700)).numpy()) == 0
    for p in (0.5, 0.3, 0.9):
        want = np.asarray(jax.vmap(
            lambda k: jax.random.bernoulli(k, p, (2500,)))(keys))
        got = jaxrng.bernoulli(np.asarray(keys), p, (2500,)).numpy()
        assert got.dtype == np.bool_ and (want == got).all()


@pytest.mark.parametrize("p", [0.5, 0.1, 1 / 3])
def test_bernoulli_matches_jax(p):
    kj = jax.random.fold_in(jax.random.PRNGKey(2), 9)
    want = np.asarray(jax.random.bernoulli(kj, p, (10_000,)))
    got = jaxrng.bernoulli(np.asarray(kj), p, (10_000,)).numpy()
    assert (want == got).all()


def test_erf_inv_and_log1p_match_xla_cpu():
    """Over a uniform grid of [−1, 1] with its end points (±inf) and the
    values next to them, and log1p over (−1, 1): 0 differing values."""
    x = np.concatenate([
        np.linspace(-1, 1, 400_001),
        [np.nextafter(np.float32(-1), np.float32(0)),
         np.nextafter(np.float32(1), np.float32(0)), 0.0, -0.0]]
    ).astype(np.float32)
    want = np.asarray(jax.jit(jax.lax.erf_inv)(x))
    assert _differ(want, xla_math.erf_inv(torch.from_numpy(x)).numpy()) == 0
    y = np.random.default_rng(0).uniform(-0.999, 1, 400_000).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log1p)(y))
    assert _differ(want, xla_math.log1p(torch.from_numpy(y)).numpy()) == 0


def test_sqrt_is_correctly_rounded():
    x = np.random.default_rng(1).uniform(0, 100, 500_000).astype(np.float32)
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    assert _differ(want, xla_math.sqrt(torch.from_numpy(x)).numpy()) == 0


def _scannet_aug(**kw):
    """scannet_seg's augmentation (rotate, scale, shift, jitter), with point
    dropout and three rotating feature columns added."""
    cfg = jpresets.get("scannet_seg")
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, dropout_max=0.4, feat_geo_channels=(1, 2, 3), **kw))


def _jax_draws(key, B, N, d):
    k_rot, k_scale, k_shift, k_jit, k_drop, k_dropn = jax.random.split(key, 6)
    return {
        "theta": jax.random.uniform(k_rot, (B,), minval=0.0,
                                    maxval=2.0 * jnp.pi),
        "scale": jax.random.uniform(k_scale, (B, 1, 1), minval=d.scale_low,
                                    maxval=d.scale_high),
        "shift": jax.random.uniform(k_shift, (B, 1, 3),
                                    minval=-d.shift_range,
                                    maxval=d.shift_range),
        "noise": jnp.clip(d.jitter_sigma * jax.random.normal(k_jit, (B, N, 3)),
                          -d.jitter_clip, d.jitter_clip),
        "ratio": jax.random.uniform(k_drop, (B, 1), maxval=d.dropout_max),
        "u": jax.random.uniform(k_dropn, (B, N)),
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_augment_batch_matches_jax(seed):
    """Every draw and the dropout mask bit for bit. xyz and the rotated
    feature columns to 2e-6 of their range: torch's cos/sin differ from
    XLA:CPU's by an ulp in ~5% of values, and the rotation's 3-term sums
    and the scale-shift-jitter chain round in another order."""
    cfg = _scannet_aug()
    B, N = 3, 2048
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-2, 4, (B, N, 3)).astype(np.float32)
    feat = rng.uniform(-1, 1, (B, N, 5)).astype(np.float32)
    mask = rng.uniform(size=(B, N)) < 0.9
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 17)
    want = {k: np.asarray(v) for k, v in _jax_draws(key, B, N,
                                                    cfg.data).items()}
    got = augment_draws(np.asarray(key), B, N, to_port(cfg).data, "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert _differ(want[k], got[k].numpy()) == 0, k

    jx, jm, jf = [np.asarray(a) for a in jaugment_batch(
        jnp.asarray(xyz), jnp.asarray(mask), key, cfg.data,
        feat=jnp.asarray(feat))]
    tx, tm, tf = augment_batch(torch.from_numpy(xyz), torch.from_numpy(mask),
                               np.asarray(key), to_port(cfg).data,
                               feat=torch.from_numpy(feat))
    np.testing.assert_array_equal(jm, tm.numpy())
    assert 0 < (~tm.numpy() & mask).sum() < mask.sum()
    np.testing.assert_allclose(tx.numpy(), jx, rtol=0, atol=2e-6 * 6)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=0, atol=2e-6 * 2)
    np.testing.assert_array_equal(tf.numpy()[..., [0, 4]], feat[..., [0, 4]])


def test_augment_off_is_the_identity():
    cfg = to_port(jpresets.get("synthetic_tiny"))
    assert not cfg.data.augment
    x = torch.zeros(2, 8, 3)
    m = torch.ones(2, 8, dtype=torch.bool)
    out = augment_batch(x, m, jaxrng.PRNGKey(0), cfg.data)
    assert out[0] is x and out[1] is m and out[2] is None


@pytest.mark.parametrize("size,batch,shuffle,drop_last", [
    (37, 8, True, True), (37, 8, True, False), (37, 8, False, False),
    (5, 8, True, True), (16, 4, True, True)])
def test_dataset_batches_match_jax(size, batch, shuffle, drop_last):
    """Order, padding of a final partial batch (rng.choice from the same
    generator), example_mask and every array, for seg labels with
    features."""
    rng = np.random.default_rng(size)
    pts = rng.uniform(-1, 1, (size, 64, 3)).astype(np.float32)
    lab = rng.integers(0, 13, (size, 64)).astype(np.int32)
    feat = rng.uniform(0, 1, (size, 64, 6)).astype(np.float32)
    want = list(JDataset(pts, lab, feat, "seg", 13).batches(
        batch, seed=7, shuffle=shuffle, drop_last=drop_last))
    ds = Dataset(pts, lab, feat, "seg", 13)
    got = list(ds.batches(batch, seed=7, shuffle=shuffle,
                          drop_last=drop_last))
    assert len(got) == len(want) > 0
    assert ds.steps_per_epoch(batch) == JDataset(pts, lab).steps_per_epoch(
        batch)
    for w, g in zip(want, got):
        assert sorted(w) == sorted(g)
        for k in w:
            np.testing.assert_array_equal(w[k], g[k], err_msg=k)
