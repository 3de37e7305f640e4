"""Port parity of the LM substrate: configs, layers, the dense model.

The same parameters (JAX's `init_params` tree carried across by
`params_from_jax`) and the same numpy-seeded tokens go through the JAX
package and the port, on reduced configs (2 layers, d_model 128), in
float32:

  * `rmsnorm` and `apply_rope` (the half-split rotation): rtol/atol 1e-6;
  * `forward` logits and `return_hidden` for stablelm-1.6b and
    starcoder2-7b with num_kv_heads=2 (GQA), with the flash kernel's plain
    version and with the blockwise path: rtol 1e-4, atol 1e-4;
  * `prefill(last_only=True)` and three `decode_step`s: logits and the KV
    caches, same tolerance;
  * the configs are the JAX package's, field for field;
  * every other family's init_params + forward runs (its JAX parity is
    tests/test_torch_families.py's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import layers as jl
from repro.models import model as jm
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.models import layers as tl
from repro_torch.models import model as tm
from repro_torch.models.convert import params_from_jax

RTOL, ATOL = 1e-4, 1e-4
B, S = 2, 32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, **kw):
    return dataclasses.replace(ARCHS[arch].reduced(), dtype="float32", **kw)


def _jcfg(cfg):
    """The JAX package's ModelConfig with the same fields."""
    return JModelConfig(**dataclasses.asdict(cfg))


def _pair(cfg, seed=3):
    """(JAX params, the port's Model carrying the same numbers)."""
    jp = jm.init_params(_jcfg(cfg), jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.device_get(jp), cfg, device="cpu")


def _tokens(cfg, shape, seed=5):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape
                                                ).astype(np.int32)


CASES = [("stablelm-1.6b", {}), ("starcoder2-7b", {"num_kv_heads": 2})]
CASE_IDS = ["stablelm-1.6b", "starcoder2-7b-kv2"]


# ------------------------------------------------------------------ configs
def test_configs_match_jax():
    assert set(ARCHS) == set(J_ARCHS)
    for name, cfg in ARCHS.items():
        j = J_ARCHS[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(j), name
        assert cfg.padded_vocab == j.padded_vocab
        assert (dataclasses.asdict(cfg.reduced())
                == dataclasses.asdict(j.reduced()))
    assert get_config("starcoder2-7b").head_dim == 128
    assert set(SHAPES) == {"train_4k", "prefill_32k", "decode_32k",
                           "long_500k"}
    with pytest.raises(KeyError):
        get_config("nope")


# ------------------------------------------------------------------- layers
def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 7, 128)).astype(np.float32) * 3
    scale = rng.normal(size=(128,)).astype(np.float32)
    want = jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)
    got = tl.rmsnorm(tl.RMSNorm(torch.as_tensor(scale)), torch.as_tensor(x),
                     1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 33, 4, 32)).astype(np.float32)
    pos = np.arange(33, dtype=np.int32)[None, :]
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tl.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # half-split, not interleaved: position 0 is the identity and the
    # first half pairs with the second
    assert torch.equal(got[:, 0], torch.as_tensor(x)[:, 0])


# -------------------------------------------------------------------- model
@pytest.mark.parametrize("arch,kw", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("flash", [False, True], ids=["blockwise", "flash"])
def test_forward_matches_jax(arch, kw, flash):
    cfg = _cfg(arch, use_flash_kernel=flash, **kw)
    jp, tp = _pair(cfg)
    toks = _tokens(cfg, (B, S))
    jcfg = _jcfg(cfg)
    want = jm.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got = tm.forward(tp, cfg, {"tokens": torch.as_tensor(toks)})
    assert got.shape == (B, S, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    want_h = jm.forward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                        return_hidden=True)
    got_h = tm.forward(tp, cfg, {"tokens": torch.as_tensor(toks)},
                       return_hidden=True)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=RTOL,
                               atol=ATOL)
    assert tm.param_count(tp) == jm.param_count(jp)


@pytest.mark.parametrize("arch,kw", CASES, ids=CASE_IDS)
def test_prefill_and_decode_match_jax(arch, kw):
    """prefill(last_only=True), then three decode steps: logits, the KV
    caches and the position against JAX."""
    cfg = _cfg(arch, use_flash_kernel=True, **kw)
    jcfg = _jcfg(cfg)
    jp, tp = _pair(cfg)
    toks = _tokens(cfg, (B, 16))
    max_len = 24
    jl_, jst = jm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                          max_len=max_len, last_only=True)
    tl_, tst = tm.prefill(tp, cfg, {"tokens": torch.as_tensor(toks)},
                          max_len=max_len, last_only=True)
    assert tl_.shape == (B, 1, cfg.padded_vocab)
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), rtol=RTOL,
                               atol=ATOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]),
                                   rtol=RTOL, atol=ATOL)
    nxt = _tokens(cfg, (3, B, 1), seed=9)
    for t in range(3):
        jl_, jst = jm.decode_step(jp, jcfg, jst, jnp.asarray(nxt[t]))
        tl_, tst = tm.decode_step(tp, cfg, tst, torch.as_tensor(nxt[t]))
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), rtol=RTOL,
                                   atol=ATOL)
        assert tst["pos"] == int(jst["pos"]) == 17 + t
    for key in ("k", "v"):
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]),
                                   rtol=RTOL, atol=ATOL)


def test_prefill_last_only_matches_full_forward():
    cfg = _cfg("starcoder2-7b", num_kv_heads=2, use_flash_kernel=True)
    tp = tm.init_params(cfg, 0, device="cpu")
    toks = torch.as_tensor(_tokens(cfg, (B, 16)))
    full = tm.forward(tp, cfg, {"tokens": toks})
    last, state = tm.prefill(tp, cfg, {"tokens": toks}, max_len=16,
                             last_only=True)
    torch.testing.assert_close(last[:, 0], full[:, -1], rtol=1e-5,
                               atol=1e-5)
    assert state["pos"] == 16


def test_sliding_window_ring_cache():
    """A windowed arch keeps the last `window` prompt positions and wraps
    decode writes, as the JAX package's ring buffer does."""
    cfg = _cfg("stablelm-1.6b", sliding_window=8)
    jcfg = _jcfg(cfg)
    jp, tp = _pair(cfg)
    toks = _tokens(cfg, (B, 16))
    jl_, jst = jm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                          max_len=32)
    tl_, tst = tm.prefill(tp, cfg, {"tokens": torch.as_tensor(toks)},
                          max_len=32)
    assert tst["k"].shape[2] == 8
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), rtol=RTOL,
                               atol=ATOL)
    nxt = _tokens(cfg, (B, 1), seed=2)
    jl_, jst = jm.decode_step(jp, jcfg, jst, jnp.asarray(nxt))
    tl_, tst = tm.decode_step(tp, cfg, tst, torch.as_tensor(nxt))
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tst["k"].numpy(), np.asarray(jst["k"]),
                               rtol=RTOL, atol=ATOL)


def test_init_params_storage_and_count():
    """Matrices in cfg.dtype, norm scales float32, the JAX package's
    parameter count; tied embeddings drop the unembed."""
    cfg = dataclasses.replace(ARCHS["starcoder2-7b"].reduced(),
                              num_kv_heads=2)
    tp = tm.init_params(cfg, 0, device="cpu")
    jp = jax.eval_shape(lambda: jm.init_params(_jcfg(cfg),
                                               jax.random.PRNGKey(0)))
    assert tm.param_count(tp) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jp))
    assert tp.blocks[0].attn.wq.weight.dtype == torch.bfloat16
    assert tp.blocks[0].attn.wk.weight.shape == (2 * 32, 128)
    assert tp.final_norm.scale.dtype == torch.float32
    assert not any(p.requires_grad for p in tp.parameters())
    tied = tm.init_params(ARCHS["minicpm-2b"].reduced(), 0, device="cpu")
    assert tied.unembed is None
    logits = tm.forward(tied, ARCHS["minicpm-2b"].reduced(),
                        {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    assert logits.shape == (1, 4, ARCHS["minicpm-2b"].reduced().padded_vocab)
    # the same seed gives the same parameters
    again = tm.init_params(cfg, 0, device="cpu")
    assert torch.equal(again.blocks[1].mlp.w_up.weight,
                       tp.blocks[1].mlp.w_up.weight)


def test_tied_embeddings_match_jax():
    cfg = _cfg("minicpm-2b")
    jp, tp = _pair(cfg)
    toks = _tokens(cfg, (1, 8))
    want = jm.forward(jp, _jcfg(cfg), {"tokens": jnp.asarray(toks)})
    got = tm.forward(tp, cfg, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "xlstm-125m", "zamba2-2.7b",
                                  "chameleon-34b", "hubert-xlarge"])
def test_other_families_are_not_ported(arch):
    """(The name is from before these families were ported, when their
    init raised.) Every family's init_params + forward now run on the CPU
    at the serving storage (bf16 matrices): finite logits over the padded
    vocab and the JAX package's parameter count
    (tests/test_torch_families.py holds them against JAX)."""
    cfg = ARCHS[arch].reduced()
    tp = tm.init_params(cfg, 0, device="cpu")
    jp = jax.eval_shape(lambda: jm.init_params(_jcfg(cfg),
                                               jax.random.PRNGKey(0)))
    assert tm.param_count(tp) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jp))
    assert not any(p.requires_grad for p in tp.parameters())
    if cfg.frontend == "frames":
        batch = {"frames": torch.randn((1, 8, cfg.d_model))}
    else:
        batch = {"tokens": torch.as_tensor(_tokens(cfg, (1, 8)))}
    logits = tm.forward(tp, cfg, batch)
    assert logits.shape == (1, 8, cfg.padded_vocab)
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits).all())
