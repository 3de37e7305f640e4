"""Port parity of the int8 gradient compression
(`training/compression.py`) against `repro.training.compression`.

  * `_compress_leaf` fed the draws `jax.random.uniform(key, shape,
    float32, -0.5, 0.5)` makes for JAX's key gives JAX's `compress_leaf`
    codes and scale bit for bit (zeros, tiny and huge leaves, ties);
  * the public `compress_leaf` / `compress_tree` draw their noise from a
    `torch.Generator` in [-0.5, 0.5): the same seed gives the same codes,
    every element is within one quantisation step of its gradient, and
    the rounding is unbiased over many draws;
  * `decompress_leaf` / `decompress_tree` round trips;
  * `compressed_psum` over a one-rank `gloo` group (an in-process store)
    returns each leaf by name within one step, whatever the dict's order.
The four-rank sum against JAX's `shard_map` is in test_torch_dp_step.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.training import compression as jc
from repro_torch.training import compression as tc

LEAVES = {
    "normal": lambda r: r.normal(size=(64, 33)),
    "wide": lambda r: r.normal(scale=1e3, size=(4, 5, 7)),
    "tiny": lambda r: r.normal(scale=1e-20, size=(257,)),
    "zeros": lambda r: np.zeros((3, 8)),
    "ties": lambda r: np.repeat(np.linspace(-127, 127, 9), 4).reshape(9, 4),
    "scalar": lambda r: np.asarray(r.normal()),
    "bf16_grid": lambda r: r.integers(-300, 300, size=(16, 16)) / 64.0,
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_compress_leaf_bit_equal_jax(leaf, seed):
    g = LEAVES[leaf](np.random.default_rng(seed)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    jq, js = jc.compress_leaf(key, jnp.asarray(g))
    noise = jax.random.uniform(key, g.shape, jnp.float32, -0.5, 0.5)
    q, s = tc._compress_leaf(torch.from_numpy(g),
                             torch.from_numpy(np.array(noise)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    back = tc.decompress_leaf(q, s)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jc.decompress_leaf(jq, js)))


def test_compress_leaf_generator_draws():
    g = torch.from_numpy(np.random.default_rng(3).normal(size=(4096,))
                         .astype(np.float32))
    q1, s1 = tc.compress_leaf(torch.Generator().manual_seed(7), g)
    q2, s2 = tc.compress_leaf(torch.Generator().manual_seed(7), g)
    assert torch.equal(q1, q2) and torch.equal(s1, s2)
    q3, _ = tc.compress_leaf(torch.Generator().manual_seed(8), g)
    assert not torch.equal(q1, q3)
    u = tc._uniform(torch.Generator().manual_seed(0), torch.empty(100_000))
    assert float(u.min()) >= -0.5 and float(u.max()) < 0.5
    assert abs(float(u.mean())) < 5e-3


def test_stochastic_rounding_is_unbiased():
    g = torch.tensor([0.3, -0.7, 0.05, 1.0, -0.999, 0.5])
    gen = torch.Generator().manual_seed(0)
    mean = torch.stack([tc.decompress_leaf(*tc.compress_leaf(gen, g))
                        for _ in range(4000)]).mean(0)
    scale = float(g.abs().max()) / 127
    assert float((mean - g).abs().max()) < 0.05 * scale


def test_compress_tree_round_trip():
    rng = np.random.default_rng(5)
    grads = {k: torch.from_numpy(LEAVES[k](rng).astype(np.float32))
             for k in sorted(LEAVES)}
    qs, scales = tc.compress_tree(torch.Generator().manual_seed(1), grads)
    assert set(qs) == set(scales) == set(grads)
    back = tc.decompress_tree(qs, scales)
    for k, g in grads.items():
        assert qs[k].dtype == torch.int8 and qs[k].shape == g.shape
        assert int(qs[k].abs().max()) <= 127
        # within one quantisation step of the gradient
        assert float((back[k] - g).abs().max()) <= float(scales[k]) * 1.0001
        assert torch.equal(back[k], tc.decompress_leaf(qs[k], scales[k]))


@pytest.fixture
def one_rank():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("reverse", [False, True])
def test_compressed_psum_one_rank_by_name(one_rank, reverse):
    rng = np.random.default_rng(9)
    grads = {k: torch.from_numpy(rng.normal(size=(8, 3 + i))
                                 .astype(np.float32))
             for i, k in enumerate(["a", "b", "c", "d"])}
    if reverse:
        grads = dict(reversed(list(grads.items())))
    out = tc.compressed_psum(grads, one_rank,
                             torch.Generator().manual_seed(2))
    assert list(out) == list(grads)
    for k, g in grads.items():
        step = float(g.abs().max()) / 127
        assert out[k].dtype == torch.float32
        assert float((out[k] - g).abs().max()) <= step * 1.0001
    # fed JAX's draws, one rank's sum is JAX's compress + decompress
    key = jax.random.PRNGKey(4)
    noise = {k: torch.from_numpy(np.array(jax.random.uniform(
        jax.random.fold_in(key, i), g.shape, jnp.float32, -0.5, 0.5)))
        for i, (k, g) in enumerate(sorted(grads.items()))}
    got = tc._compressed_psum(grads, one_rank, lambda n, g: noise[n])
    for i, (k, g) in enumerate(sorted(grads.items())):
        jq, js = jc.compress_leaf(jax.random.fold_in(key, i),
                                  jnp.asarray(g.numpy()))
        np.testing.assert_array_equal(
            got[k].numpy(), np.asarray(jc.decompress_leaf(jq, js)))
