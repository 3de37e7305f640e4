"""Port parity of the other LM families: moe (olmoe-1b-7b,
granite-moe-1b-a400m), vlm (chameleon-34b), audio (hubert-xlarge), ssm
(xlstm-125m) and hybrid (zamba2-2.7b).

The same parameters (JAX's `init_params` tree carried across by
`params_from_jax`) and the same numpy-seeded tokens or frames go through
the JAX package and the port, on reduced configs in float32, the flash
kernel's plain version on the attention path:

  * `forward` logits, `return_hidden` and the aux loss, `embed_texts`,
    `loss_fn` (its total, ce and aux) and `prefill`: rtol 1e-4, atol 1e-4;
  * gradients of `loss_fn`: rtol 1e-3, atol 1e-4 x the largest |g| of the
    tree; remat "full" gives the same gradients as "none" (equal);
  * prefill of 8 tokens, then 8 `decode_step`s against the JAX package's
    (logits and the states, rtol/atol 1e-4) at the default capacity
    factor, so MoE drops count in both;
  * decode against the parallel forward at capacity factor 8, as
    tests/test_models.py's `test_decode_matches_forward` (2e-3);
  * hubert bidirectional, with no decode state; zamba2's ring cache at
    S = 2 x window (window cut to 8);
  * `to_jax_layout(params_from_jax(tree))` == tree bit for bit;
  * greedy `generate` token-equal to the JAX package's; the serve and
    train launchers on the CPU for every family.
"""

import argparse
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import model as jm
from repro.serving.serve_loop import generate as j_generate
from repro_torch.configs import ARCHS
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tm
from repro_torch.models.convert import params_from_jax, to_jax_layout
from repro_torch.serving import rag as trag
from repro_torch.serving.serve_loop import generate

RTOL, ATOL = 1e-4, 1e-4
B, S = 2, 32
FAMILY_ARCHS = ["olmoe-1b-7b", "granite-moe-1b-a400m", "chameleon-34b",
                "hubert-xlarge", "xlstm-125m", "zamba2-2.7b"]
DECODERS = [a for a in FAMILY_ARCHS if not ARCHS[a].is_encoder]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, **kw):
    return dataclasses.replace(ARCHS[arch].reduced(),
                               **({"dtype": "float32",
                                   "use_flash_kernel": True} | kw))


def _jcfg(cfg):
    return JModelConfig(**dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def _jax_params(cfg, seed=3):
    return jax.device_get(jm.init_params(_jcfg(cfg), jax.random.PRNGKey(seed)))


def _pair(cfg, dtype=None):
    """(JAX params, the port's Model carrying the same numbers)."""
    jp = _jax_params(cfg)
    return jp, params_from_jax(jp, cfg, device="cpu", dtype=dtype)


def _batch(cfg, b=B, s=S, seed=5) -> dict:
    """numpy inputs + labels (some masked) for the config's frontend."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "frames":
        out = {"frames": rng.normal(size=(b, s, cfg.d_model)
                                    ).astype(np.float32)}
    else:
        out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)
                                      ).astype(np.int32)}
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, :5] = -1
    return out | {"labels": labels}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _jax_step(jcfg):
    return jax.jit(lambda p, st, t: jm.decode_step(p, jcfg, st, t))


def _states_close(got, want, path="state"):
    """A decode state (nested dicts of tensors, "pos") against JAX's."""
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict):
            _states_close(g, w, f"{path}/{key}")
        elif key == "pos":
            assert g == int(w), path
        else:
            _close(g.float().numpy(), w, what=f"{path}/{key}")


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_forward_matches_jax(arch):
    cfg = _cfg(arch)
    jcfg = _jcfg(cfg)
    jp, tp = _pair(cfg)
    batch = _batch(cfg)
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    want, waux = jm.forward(jp, jcfg, _j(inputs), with_aux=True)
    got, aux = tm.forward(tp, cfg, _t(inputs), with_aux=True)
    assert got.shape == (B, S, cfg.padded_vocab)
    _close(got, want, what="logits")
    _close(aux, waux, what="aux")
    assert (float(aux) > 0) == (cfg.family == "moe")
    want_h = jm.forward(jp, jcfg, _j(inputs), return_hidden=True)
    got_h = tm.forward(tp, cfg, _t(inputs), return_hidden=True)
    _close(got_h, want_h, what="hidden")
    assert tm.param_count(tp) == jm.param_count(jp)
    if cfg.frontend == "token":
        # JAX's embed_texts is the mean of these hidden states
        _close(trag.embed_texts(tp, cfg, _t(inputs)["tokens"]),
               np.asarray(want_h).mean(axis=1), what="embed_texts")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_grads_match_jax(arch):
    """loss_fn (with the MoE aux) and its parameter gradients against
    jax.value_and_grad of JAX's loss_fn; float32 masters."""
    cfg = _cfg(arch)
    jcfg = _jcfg(cfg)
    jp, tp = _pair(cfg, torch.float32)
    tp.requires_grad_(True)
    batch = _batch(cfg)
    (jloss, jmet), jgrads = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, jcfg, _j(batch))
    loss, met = tm.loss_fn(tp, cfg, _t(batch))
    loss.backward()
    _close(loss.detach(), jloss, what="loss")
    for key in ("ce", "aux"):
        _close(met[key].detach(), jmet[key], what=key)
    got = jax.tree_util.tree_leaves_with_path(to_jax_layout(
        {n: p.grad for n, p in tp.named_parameters()}, cfg))
    want = jax.tree_util.tree_leaves(jax.device_get(jgrads))
    assert len(got) == len(want)
    top = max(float(np.abs(w).max()) for w in want)
    for (path, g), w in zip(got, want):
        _close(g, w, rtol=1e-3, atol=1e-4 * top,
               what=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "xlstm-125m",
                                  "zamba2-2.7b"])
def test_remat_full_equals_none(arch):
    """remat "full" (each block, pair or group under
    torch.utils.checkpoint) recomputes the same forward."""
    out = []
    for remat in ("none", "full"):
        cfg = _cfg(arch, remat=remat)
        tp = tm.init_params(cfg, 1, device="cpu")
        tp.requires_grad_(True)
        loss, _ = tm.loss_fn(tp, cfg, _t(_batch(cfg, s=16)))
        loss.backward()
        out.append((loss.detach(), [p.grad for p in tp.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ decode
@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_then_decode_matches_jax(arch):
    """prefill of 8 tokens (max_len 16), then 8 decode steps: logits and
    the primed and final states against the JAX package's."""
    cfg = _cfg(arch)
    jcfg = _jcfg(cfg)
    jp, tp = _pair(cfg)
    toks = _batch(cfg, s=16)["tokens"]
    jl, jst = jm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :8])},
                         max_len=16)
    tl, tst = tm.prefill(tp, cfg, {"tokens": torch.as_tensor(toks[:, :8])},
                         max_len=16)
    _close(tl, jl, what="prefill logits")
    _states_close(tst, jax.device_get(jst))
    step = _jax_step(jcfg)
    for t in range(8, 16):
        jl, jst = step(jp, jst, jnp.asarray(toks[:, t:t + 1]))
        tl, tst = tm.decode_step(tp, cfg, tst,
                                 torch.as_tensor(toks[:, t:t + 1]))
        _close(tl, jl, what=f"decode logits at {t}")
    _states_close(tst, jax.device_get(jst))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "xlstm-125m",
                                  "zamba2-2.7b"])
def test_decode_matches_forward(arch):
    """Token-by-token decode reproduces the parallel forward (capacity
    factor 8, so no MoE route drops in either)."""
    cfg = _cfg(arch, capacity_factor=8.0)
    tp = tm.init_params(cfg, 3, device="cpu")
    toks = torch.as_tensor(_batch(cfg, s=16)["tokens"])
    ref = tm.forward(tp, cfg, {"tokens": toks})
    state = tm.init_decode_state(cfg, B, max_len=16, device="cpu")
    for t in range(16):
        lg, state = tm.decode_step(tp, cfg, state, toks[:, t:t + 1])
        _close(lg[:, 0], ref[:, t], rtol=2e-3, atol=2e-3, what=f"step {t}")


def test_encoder_is_bidirectional_with_no_decode_state():
    cfg = _cfg("hubert-xlarge")
    tp = tm.init_params(cfg, 3, device="cpu")
    frames = torch.as_tensor(_batch(cfg, b=1, s=16)["frames"])
    out1 = tm.forward(tp, cfg, {"frames": frames})
    frames2 = frames.clone()
    frames2[0, 12] += 1.0
    out2 = tm.forward(tp, cfg, {"frames": frames2})
    assert float((out1[0, 0] - out2[0, 0]).abs().max()) > 1e-6
    with pytest.raises(ValueError, match="encoder-only"):
        tm.init_decode_state(cfg, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        tm.prefill(tp, cfg, {"frames": frames}, max_len=16)


def test_zamba2_ring_cache_at_twice_the_window():
    """S = 2 x window: prefill keeps the prompt's last `window` positions
    in ring order, and decode wraps onto them, as the JAX package's."""
    cfg = _cfg("zamba2-2.7b", sliding_window=8)
    jcfg = _jcfg(cfg)
    jp, tp = _pair(cfg)
    toks = _batch(cfg, s=19)["tokens"]
    jl, jst = jm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :16])},
                         max_len=24)
    tl, tst = tm.prefill(tp, cfg, {"tokens": torch.as_tensor(toks[:, :16])},
                         max_len=24)
    assert tst["k"].shape[2] == 8
    _close(tl, jl, what="prefill logits")
    _states_close(tst, jax.device_get(jst))
    step = _jax_step(jcfg)
    for t in range(16, 19):
        jl, jst = step(jp, jst, jnp.asarray(toks[:, t:t + 1]))
        tl, tst = tm.decode_step(tp, cfg, tst,
                                 torch.as_tensor(toks[:, t:t + 1]))
        _close(tl, jl, what=f"decode logits at {t}")
    _states_close(tst, jax.device_get(jst))


# ------------------------------------------------------------------ layout
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_jax_layout_round_trip_is_bit_exact(arch):
    cfg = _cfg(arch)
    jp, tp = _pair(cfg, torch.float32)
    back = to_jax_layout(tp, cfg)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jp))
    for (path, b), j in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree_util.tree_leaves(jp)):
        assert b.dtype == np.float32 and b.shape == j.shape, path
        assert np.array_equal(b, j), jax.tree_util.keystr(path)
    assert to_jax_layout(tp, tp).keys() == back.keys()


# ------------------------------------------------------- entry points
@pytest.mark.parametrize("arch", DECODERS)
def test_greedy_generate_matches_jax(arch):
    cfg = _cfg(arch)
    jcfg = _jcfg(cfg)
    jp, tp = _pair(cfg)
    prompts = _batch(cfg, s=8, seed=11)["tokens"]
    want = np.asarray(j_generate(jp, jcfg, jnp.asarray(prompts),
                                 max_new_tokens=5))
    got = generate(tp, cfg, torch.as_tensor(prompts), max_new_tokens=5)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_launchers_run_every_family(arch):
    """launch/serve.py (an encoder is refused) and 2 steps of
    launch/train.py on the CPU."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--new-tokens", "3"]
    if ARCHS[arch].is_encoder:
        with pytest.raises(SystemExit, match="encoder-only"):
            tserve.main(argv)
    else:
        assert tuple(tserve.main(argv).shape) == (2, 11)
    metrics = ttrain.run(argparse.Namespace(
        arch=arch, reduced=True, steps=2, batch=2, seq=16, lr=1e-3,
        grad_accum=1, seed=0, mesh="none", ckpt_dir=None, ckpt_every=5,
        resume=False, log_every=1, device="cpu"))
    assert metrics["steps"] == 2
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["grad_norm"])
    assert (metrics["aux"] > 0) == (ARCHS[arch].family == "moe")
