"""Port parity of the routed MoE layer (`models/moe.py`).

JAX's `moe_init` parameters (carried across through a one-layer model's
`params_from_jax`) and numpy-seeded inputs go through both packages, on
the reduced olmoe-1b-7b and granite-moe-1b-a400m configs in float32:

  * the routing's integers — top experts, each route's slot in its
    expert's buffer, the keep mask — bit-equal to the JAX package's
    (`_jax_routing` below is `repro/models/moe.py:74-102` line for line);
  * `moe_with_aux` output and aux loss: rtol 1e-4, atol 1e-4, at
    `moe_dispatch_chunks` 0 and 2 (chunk-local capacity), capacity factor
    1 so that some routes drop;
  * forced ties (equal router logits, and equal pairs of columns): the
    lower expert first, as `lax.top_k` keeps them;
  * the low-capacity drop (tests/test_models.py's
    `test_moe_drops_tokens_at_low_capacity`): routes past the capacity
    contribute nothing, in both packages alike.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import model as jm
from repro.models import moe as jmoe
from repro_torch.configs import ARCHS
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax

ARCH_CASES = ["olmoe-1b-7b", "granite-moe-1b-a400m"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, **kw):
    return dataclasses.replace(ARCHS[arch].reduced(), dtype="float32",
                               num_layers=1, **kw)


def _layer(cfg, seed=3):
    """(JAX moe params, the port's MoE with the same numbers): the one
    layer of a JAX model carried across by `params_from_jax`."""
    jcfg = JModelConfig(**dataclasses.asdict(cfg))
    tree = jax.device_get(jm.init_params(jcfg, jax.random.PRNGKey(seed)))
    jp = {k: v[0] for k, v in tree["blocks"]["moe"].items()}
    return jcfg, jp, params_from_jax(tree, cfg, device="cpu").blocks[0].moe


def _x(cfg, b=2, s=32, seed=4):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


def _jax_routing(router, x, cfg):
    """The routing lines of `repro.models.moe.moe_with_aux`: top experts,
    positions and the keep mask of every chunk's routes."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.experts_per_token
    chunks = cfg.moe_dispatch_chunks
    if chunks <= 1 or t % chunks != 0:
        chunks = 1
    tc = t // chunks
    cap = int(cfg.capacity_factor * tc * k / e)
    cap = max(8, -(-cap // 8) * 8)
    xt = x.reshape(chunks, tc, d)
    logits = xt.astype(jnp.float32) @ router.astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(top_e, e, dtype=jnp.float32)
    flat_oh = onehot.reshape(chunks, tc * k, e)
    pos_in_e = jnp.cumsum(flat_oh, axis=1) - flat_oh
    pos = jnp.sum(pos_in_e * flat_oh, axis=-1).astype(jnp.int32)
    return {"top_e": top_e, "pos": pos, "keep": pos < cap, "cap": cap,
            "logits": logits}


def _routing_bit_equal(jp, tp, x, cfg):
    want = jax.device_get(_jax_routing(jp["router"], jnp.asarray(x), cfg))
    got = tmoe.moe_routing(torch.tensor(want["logits"]),
                           cfg.experts_per_token, want["cap"])
    assert tmoe.capacity(cfg, want["logits"].shape[1]) == want["cap"]
    np.testing.assert_array_equal(got["top_e"].numpy(), want["top_e"])
    np.testing.assert_array_equal(got["pos"].numpy(), want["pos"])
    np.testing.assert_array_equal(got["keep"].numpy(), want["keep"])
    assert got["pos"].dtype == torch.int32
    return want


@pytest.mark.parametrize("chunks", [0, 2], ids=["global", "chunks2"])
@pytest.mark.parametrize("arch", ARCH_CASES)
def test_moe_with_aux_matches_jax(arch, chunks):
    # capacity factor 1: the busiest experts overflow and drop routes
    cfg = _cfg(arch, moe_dispatch_chunks=chunks, capacity_factor=1.0)
    jcfg, jp, tp = _layer(cfg)
    x = _x(cfg, b=4, s=64)
    # the port's router logits are JAX's to float32 rounding
    logits = torch.nn.functional.linear(
        torch.as_tensor(x).reshape(-1, cfg.d_model), tp.router.weight)
    want = _routing_bit_equal(jp, tp, x, cfg)
    np.testing.assert_allclose(logits.numpy(),
                               want["logits"].reshape(-1, cfg.num_experts),
                               rtol=1e-5, atol=1e-6)
    assert not want["keep"].all(), "the case must drop some routes"
    jout, jaux = jmoe.moe_with_aux(jp, jnp.asarray(x), jcfg)
    out, aux = tmoe.moe_with_aux(tp, torch.as_tensor(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-4, atol=1e-4)
    assert aux.dtype == torch.float32
    torch.testing.assert_close(tmoe.moe(tp, torch.as_tensor(x), cfg), out,
                               rtol=0, atol=0)


@pytest.mark.parametrize("ties", ["all", "pairs"])
def test_forced_router_ties_keep_the_lower_expert_first(ties):
    cfg = _cfg("olmoe-1b-7b")
    jcfg, jp, tp = _layer(cfg)
    router = np.asarray(jp["router"]).copy()
    if ties == "all":
        router[:] = 0.0                       # every probability equal
    else:
        router[:, 1] = router[:, 0]           # experts (0, 1) and (2, 3)
        router[:, 3] = router[:, 2]           # are exact twins
    jp = dict(jp, router=jnp.asarray(router))
    with torch.no_grad():
        tp.router.weight.copy_(torch.as_tensor(router.T))
    x = _x(cfg, seed=8)
    want = _routing_bit_equal(jp, tp, x, cfg)
    top = want["top_e"].reshape(-1, cfg.experts_per_token)
    if ties == "all":
        assert (top == np.arange(cfg.experts_per_token)).all()
    else:
        assert set(map(tuple, top)) <= {(0, 1), (2, 3)}
    jout, jaux = jmoe.moe_with_aux(jp, jnp.asarray(x), jcfg)
    out, aux = tmoe.moe_with_aux(tp, torch.as_tensor(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-4, atol=1e-4)


def test_moe_drops_routes_at_low_capacity():
    """At capacity factor 0.25 routes drop (the output changes against
    factor 8, where none does), and the port drops exactly JAX's."""
    cfg = _cfg("olmoe-1b-7b", capacity_factor=0.25)
    jcfg, jp, tp = _layer(cfg)
    x = _x(cfg, seed=6)
    want = _routing_bit_equal(jp, tp, x, cfg)
    assert want["keep"].mean() < 0.5
    out_low, _ = tmoe.moe_with_aux(tp, torch.as_tensor(x), cfg)
    jlow, _ = jmoe.moe_with_aux(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(out_low.numpy(), np.asarray(jlow), rtol=1e-4,
                               atol=1e-4)
    hi = dataclasses.replace(cfg, capacity_factor=8.0)
    assert _routing_bit_equal(jp, tp, x, hi)["keep"].all()
    out_hi, _ = tmoe.moe_with_aux(tp, torch.as_tensor(x), hi)
    assert float((out_low - out_hi).abs().max()) > 1e-6
    # a token whose every route dropped gets exactly zero
    keep = want["keep"].reshape(-1, cfg.experts_per_token)
    dead = np.flatnonzero(~keep.any(axis=1))
    assert dead.size
    assert torch.equal(out_low.reshape(-1, cfg.d_model)[dead],
                       torch.zeros((dead.size, cfg.d_model)))


def test_capacity_rounds_up_to_eight():
    cfg = _cfg("olmoe-1b-7b")                 # 4 experts, top 2, cf 1.25
    assert [tmoe.capacity(cfg, t) for t in (1, 4, 64, 70)] == [8, 8, 40, 48]
    full = ARCHS["olmoe-1b-7b"]               # 64 experts, top 8
    assert tmoe.capacity(full, 4) == 8        # a decode step of B = 4
    assert tmoe.capacity(full, 4 * 1024) == 640
