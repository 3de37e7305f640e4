"""Port parity of the training slice: loss, gradients, AdamW, schedules,
train steps, checkpoints and the launcher.

The same parameters (JAX's `init_params` tree carried across by
`params_from_jax(dtype=torch.float32)`, the float32 masters) and the same
numpy-seeded tokens go through the JAX package and the port, on reduced
configs (stablelm-1.6b untied, minicpm-2b tied; 2 layers, d_model 128) in
float32, each with the flash kernel's path (the autograd Function over the
plain #11/#12 here) and the blockwise path:

  * `loss_fn` total and metrics vs JAX's: rtol 1e-5;
  * parameter gradients vs `jax.value_and_grad`, leaf by leaf: rtol 1e-4,
    atol 1e-6; remat "full" gives the same gradients as "none" (equal);
  * `schedule_fn` (cosine, wsd, constant) at a list of steps: rtol 1e-6;
  * two `adamw_update`s on float32 and bfloat16 leaves with clipping
    active: parameters rtol 1e-5 (float32) and within one bf16 ulp, m and
    v rtol 1e-5, grad_norm and lr rtol 1e-6;
  * three `make_train_step` steps from one state and batches vs JAX's:
    metrics rtol 1e-5; each step from JAX's state: m and sqrt(v) rtol
    1e-4 / atol 1e-7, parameters rtol 1e-4 / atol 1e-6 except where the
    element's clipped gradients are at float32 rounding level (RMS < 1e-7,
    then within 2 * lr; see the test); grad_accum 2
    equal to 1 within 1e-5 (as tests/test_training.py); the loss falls on
    a fixed batch;
  * checkpoints: bit-equal round trip into a different like-state,
    atomicity, exact resume (tests/test_training.py's contracts); a
    checkpoint of either package restores bit-equal in the other and its
    next step's loss is within 1e-5 of the straight run's;
  * the launcher on the CPU (tests/test_launchers.py's contracts).
"""

import argparse
import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import model as jm
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro_torch.configs import ARCHS
from repro_torch.data.synthetic import (
    FrameDataset,
    TokenDataset,
    make_lm_batch,
)
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tm
from repro_torch.models.convert import params_from_jax, to_jax_layout
from repro_torch.training import (
    OptimizerConfig,
    adamw_init,
    adamw_update,
    init_train_state,
    latest_step,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
    schedule_fn,
)
from repro_torch.training.train_loop import train_state_from_jax

B, S = 2, 32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, **kw):
    return dataclasses.replace(ARCHS[arch].reduced(),
                               **({"dtype": "float32"} | kw))


def _jcfg(cfg):
    return JModelConfig(**dataclasses.asdict(cfg))


def _batch(cfg, b=B, s=S, seed=5):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _jbatch(tokens, labels):
    return {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}


def _tbatch(tokens, labels):
    return {"tokens": torch.as_tensor(tokens),
            "labels": torch.as_tensor(labels)}


def _assert_tree_close(got: dict, want, rtol, atol, path=""):
    """Leaf by leaf within rtol/atol."""
    for key, g in got.items():
        w = want[key]
        if isinstance(g, dict):
            _assert_tree_close(g, w, rtol, atol, f"{path}/{key}")
            continue
        np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=rtol,
                                   atol=atol, err_msg=f"{path}/{key}")


CASES = [("stablelm-1.6b", False), ("stablelm-1.6b", True),
         ("minicpm-2b", False), ("minicpm-2b", True)]
CASE_IDS = ["untied-blockwise", "untied-flash", "tied-blockwise",
            "tied-flash"]


# ------------------------------------------------------------ loss + grads
@pytest.mark.parametrize("arch,flash", CASES, ids=CASE_IDS)
def test_loss_and_grads_match_jax(arch, flash):
    """loss_fn and its parameter gradients against jax.value_and_grad of
    JAX's loss_fn; some labels negative (masked out)."""
    cfg = _cfg(arch, use_flash_kernel=flash)
    jcfg = _jcfg(cfg)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_jax(jax.device_get(jp), cfg, device="cpu",
                         dtype=torch.float32)
    tp.requires_grad_(True)
    tokens, labels = _batch(cfg)
    labels[0, :5] = -1
    (jloss, jmet), jgrads = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, jcfg, _jbatch(tokens, labels))
    loss, met = tm.loss_fn(tp, cfg, _tbatch(tokens, labels))
    loss.backward()
    loss = loss.detach()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(met["ce"].item(), float(jmet["ce"]),
                               rtol=1e-5)
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    grads = {n: p.grad for n, p in tp.named_parameters()}
    _assert_tree_close(to_jax_layout(grads, cfg), jax.device_get(jgrads),
                       rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("flash", [False, True], ids=["blockwise", "flash"])
def test_remat_full_equals_none(flash):
    """cfg.remat == "full" (each block under torch.utils.checkpoint)
    recomputes the same forward: the same loss and gradients."""
    out = []
    for remat in ("none", "full"):
        cfg = _cfg("minicpm-2b", use_flash_kernel=flash, remat=remat)
        tp = tm.init_params(cfg, 1, device="cpu")
        tp.requires_grad_(True)
        loss, _ = tm.loss_fn(tp, cfg, _tbatch(*_batch(cfg)))
        loss.backward()
        out.append((loss.detach(), [p.grad for p in tp.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_forward_with_aux_and_padding_mask():
    """forward(with_aux=True) gives (logits, 0); loss_fn ignores the vocab
    padding columns (their logits change nothing)."""
    cfg = _cfg("minicpm-2b", vocab_size=500)      # padded to 512
    tp = tm.init_params(cfg, 2, device="cpu")
    batch = _tbatch(*_batch(cfg))
    logits, aux = tm.forward(tp, cfg, batch, with_aux=True)
    assert logits.shape == (B, S, cfg.padded_vocab) and float(aux) == 0.0
    lz = torch.logsumexp(logits[..., :cfg.vocab_size].float(), -1)
    gold = logits.float().gather(-1, batch["labels"].long()[..., None])[..., 0]
    loss, _ = tm.loss_fn(tp, cfg, batch)
    torch.testing.assert_close(loss, (lz - gold).mean(), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------- optimizer
@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_schedule_fn_matches_jax(schedule):
    cfg = OptimizerConfig(peak_lr=3e-4, schedule=schedule, warmup_steps=10,
                          total_steps=100, decay_frac=0.2, min_lr_frac=0.1)
    jcfg = jopt.OptimizerConfig(**dataclasses.asdict(cfg))
    for step in (0, 1, 5, 10, 11, 50, 79, 80, 81, 90, 99, 100, 150):
        want = float(jopt.schedule_fn(jcfg, jnp.int32(step)))
        assert schedule_fn(cfg, step) == pytest.approx(want, rel=1e-6,
                                                       abs=1e-12), step


def test_adamw_update_matches_jax():
    """Two updates on a float32 and a bfloat16 leaf, gradients far above
    the clip norm (clipping active)."""
    rng = np.random.default_rng(4)
    w32 = rng.normal(size=(6, 5)).astype(np.float32)
    w16 = rng.normal(size=(7,)).astype(np.float32)
    cfg = OptimizerConfig(peak_lr=1e-2, schedule="cosine", warmup_steps=1,
                          total_steps=10, clip_norm=1.0)
    jcfg = jopt.OptimizerConfig(**dataclasses.asdict(cfg))
    jparams = {"w32": jnp.asarray(w32),
               "w16": jnp.asarray(w16, jnp.bfloat16)}
    params = torch.nn.ParameterDict({
        "w32": torch.nn.Parameter(torch.as_tensor(w32)),
        "w16": torch.nn.Parameter(torch.as_tensor(w16).to(torch.bfloat16))})
    jstate, state = jopt.adamw_init(jparams), adamw_init(params)
    assert state["m"]["w16"].dtype == torch.float32
    for t in range(2):
        g32 = rng.normal(size=w32.shape).astype(np.float32) * 50
        g16 = rng.normal(size=w16.shape).astype(np.float32) * 50
        jparams, jstate, jmet = jopt.adamw_update(
            jcfg, {"w32": jnp.asarray(g32),
                   "w16": jnp.asarray(g16, jnp.bfloat16)}, jstate, jparams)
        params, state, met = adamw_update(
            cfg, {"w32": torch.as_tensor(g32),
                  "w16": torch.as_tensor(g16).to(torch.bfloat16)}, state,
            params)
        assert float(met["grad_norm"]) > 10 * cfg.clip_norm
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(met["lr"], float(jmet["lr"]), rtol=1e-6)
        np.testing.assert_allclose(params["w32"].detach().numpy(),
                                   np.asarray(jparams["w32"]), rtol=1e-5,
                                   atol=1e-7)
        assert params["w16"].dtype == torch.bfloat16
        np.testing.assert_allclose(params["w16"].detach().float().numpy(),
                                   np.asarray(jparams["w16"], np.float32),
                                   rtol=2 ** -8, atol=0)
        for key in ("m", "v"):
            for leaf in ("w32", "w16"):
                np.testing.assert_allclose(state[key][leaf].numpy(),
                                           np.asarray(jstate[key][leaf]),
                                           rtol=1e-5, atol=1e-9)
        assert state["step"] == int(jstate["step"]) == t + 1


def test_init_train_state_wants_float32_masters():
    cfg = _cfg("stablelm-1.6b", dtype="bfloat16")
    with pytest.raises(ValueError, match="float32 master"):
        init_train_state(cfg, tm.init_params(cfg, 0, device="cpu"))
    f32 = tm.init_params(cfg, 0, device="cpu", param_dtype=torch.float32)
    served = tm.init_params(cfg, 0, device="cpu")
    # the same draws: the serving storage is the masters cast to bf16
    for (n, a), (_, b) in zip(f32.named_parameters(),
                              served.named_parameters()):
        assert a.dtype == torch.float32
        assert torch.equal(a.to(b.dtype), b), n
    state = init_train_state(cfg, f32)
    assert all(p.requires_grad for p in state.params.parameters())
    assert state.opt_state["step"] == 0
    assert not any(p.requires_grad for p in served.parameters())


# --------------------------------------------------------------- train step
# Adam divides each element's step by the RMS of its clipped gradients
# (sqrt of the bias-corrected v), so an element whose gradients are at
# float32 rounding level moves by a rounding-dependent share of lr. The
# two packages' clipped gradients differ by up to 4e-8 per element on these
# configs (float32 sums over the batch in another order); TAU is the RMS
# below which an element's step is not held to rtol/atol but to 2 * lr,
# the most a step of size lr can differ by.
TAU = 1e-7


def _clipped_grads_jax(jcfg, opt, params, batch, accum):
    """JAX's clipped gradient of one train step, as its adamw_update
    sees it: microbatch gradients averaged, then scaled to clip_norm."""
    mb = len(batch["tokens"]) // accum
    grads = [jax.grad(lambda p, i=i: jm.loss_fn(p, jcfg, {
        k: v[i * mb:(i + 1) * mb] for k, v in batch.items()})[0])(params)
        for i in range(accum)]
    g = jax.tree_util.tree_map(lambda *x: sum(x) / accum, *grads)
    norm = jnp.sqrt(sum(jnp.sum(x * x) for x in jax.tree_util.tree_leaves(g)))
    scale = jnp.minimum(1.0, opt.clip_norm / (norm + 1e-9))
    return jax.tree_util.tree_map(lambda x: x * scale, g)


def _clipped_grads_torch(cfg, opt, params, batch, accum):
    """The port's clipped gradient of one train step, in JAX's layout."""
    mb = len(batch["tokens"]) // accum
    params.zero_grad(set_to_none=True)
    for i in range(accum):
        tm.loss_fn(params, cfg, {k: v[i * mb:(i + 1) * mb]
                                 for k, v in batch.items()})[0].backward()
    grads = {n: p.grad / accum for n, p in params.named_parameters()}
    params.zero_grad(set_to_none=True)
    norm = float(torch.sqrt(sum((g * g).sum() for g in grads.values())))
    return jax.tree_util.tree_map(
        lambda x: x * min(1.0, opt.clip_norm / (norm + 1e-9)),
        to_jax_layout(grads, cfg))


@pytest.mark.parametrize("arch,flash", [("stablelm-1.6b", True),
                                        ("minicpm-2b", False)],
                         ids=["untied-flash", "tied-blockwise"])
def test_three_train_steps_match_jax(arch, flash):
    """Three steps of make_train_step (grad_accum 2) on three batches
    against JAX's jitted step. The chained runs' metrics agree within
    rtol 1e-5. Each step is also taken by the port from JAX's state before
    it and held to JAX's state after it: m and sqrt(v) (the gradient's
    units) within rtol 1e-4 / atol 1e-7 everywhere; parameters within rtol
    1e-4 / atol 1e-6 wherever the RMS of the element's JAX clipped
    gradients so far is at least TAU, and within 2 * lr below it (seen at
    step 1 only: 1e-4 on 12 elements with |g| < 7e-8). The two packages'
    clipped gradients are shown to differ by less than TAU."""
    cfg = _cfg(arch, use_flash_kernel=flash)
    jcfg = _jcfg(cfg)
    opt = OptimizerConfig(peak_lr=1e-3, schedule="wsd", warmup_steps=1,
                          total_steps=4)
    jopt_cfg = jopt.OptimizerConfig(**dataclasses.asdict(opt))
    jstep = jax.jit(jtl.make_train_step(jcfg, jopt_cfg, grad_accum=2))
    jgrads = jax.jit(lambda p, b: _clipped_grads_jax(jcfg, opt, p, b, 2))
    jstate = jtl.init_train_state(jcfg, jm.init_params(
        jcfg, jax.random.PRNGKey(7)))
    chained = train_state_from_jax(jax.device_get(jstate), cfg, device="cpu")
    step = make_train_step(cfg, opt, grad_accum=2)
    sq_sum = None
    for t in range(1, 4):
        tokens, labels = _batch(cfg, b=4, seed=19 + t)
        batch = _tbatch(tokens, labels)
        before = train_state_from_jax(jax.device_get(jstate), cfg,
                                      device="cpu")
        g = jax.device_get(jgrads(jstate.params, _jbatch(tokens, labels)))
        got_g = _clipped_grads_torch(cfg, opt, before.params, batch, 2)
        for gl, wl in zip(jax.tree_util.tree_leaves(got_g),
                          jax.tree_util.tree_leaves(g)):
            assert np.abs(gl - wl).max() < TAU
        sq_sum = jax.tree_util.tree_map(
            lambda x: (1 - opt.b2) * x * x, g) if sq_sum is None else \
            jax.tree_util.tree_map(lambda a, x: opt.b2 * a
                                   + (1 - opt.b2) * x * x, sq_sum, g)
        rms = jax.tree_util.tree_map(
            lambda a: np.sqrt(a / (1 - opt.b2 ** t)), sq_sum)

        jstate, jmet = jstep(jstate, _jbatch(tokens, labels))
        after, _ = step(before, batch)
        chained, met = step(chained, batch)
        for key in ("loss", "ce", "lr", "grad_norm"):
            np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                       rtol=1e-5, err_msg=key)
        want = jax.device_get(jstate)
        assert after.opt_state["step"] == int(want.opt_state["step"]) == t
        lr = float(jmet["lr"])
        for path, got_p, want_p, r in zip(
                *zip(*jax.tree_util.tree_leaves_with_path(
                    to_jax_layout(after.params, cfg))),
                jax.tree_util.tree_leaves(want.params),
                jax.tree_util.tree_leaves(rms)):
            where = f"step {t} {jax.tree_util.keystr(path)}"
            held = r >= TAU
            np.testing.assert_allclose(got_p[held], want_p[held], rtol=1e-4,
                                       atol=1e-6, err_msg=where)
            np.testing.assert_allclose(got_p[~held], want_p[~held], rtol=0,
                                       atol=2 * lr, err_msg=where)
        _assert_tree_close(to_jax_layout(after.opt_state["m"], cfg),
                           want.opt_state["m"], rtol=1e-4, atol=1e-7)
        _assert_tree_close(
            jax.tree_util.tree_map(np.sqrt, to_jax_layout(
                after.opt_state["v"], cfg)),
            jax.tree_util.tree_map(np.sqrt, want.opt_state["v"]),
            rtol=1e-4, atol=1e-7)
    assert chained.opt_state["step"] == 3


def test_grad_accum_equivalence():
    """grad_accum=2 must match the full-batch step (same update)."""
    cfg = _cfg("stablelm-1.6b")
    opt = OptimizerConfig(peak_lr=1e-3, total_steps=10, warmup_steps=0)
    batch = make_lm_batch(cfg, 4, 16, seed=1, step=0)
    out = []
    for accum in (1, 2):
        state = init_train_state(cfg, tm.init_params(
            cfg, 1, device="cpu", param_dtype=torch.float32))
        state, _ = make_train_step(cfg, opt, grad_accum=accum)(state, batch)
        out.append(state.params)
    for a, b in zip(out[0].parameters(), out[1].parameters()):
        assert float((a - b).abs().max().detach()) < 1e-5
    assert all(p.grad is None for p in out[1].parameters())


def test_grad_accum_must_divide():
    cfg = _cfg("stablelm-1.6b")
    state = init_train_state(cfg, tm.init_params(
        cfg, 0, device="cpu", param_dtype=torch.float32))
    with pytest.raises(ValueError, match="multiple of grad_accum"):
        make_train_step(cfg, OptimizerConfig(), grad_accum=2)(
            state, make_lm_batch(cfg, 3, 8, seed=0, step=0))


def test_loss_decreases_smoke():
    cfg = ARCHS["stablelm-1.6b"].reduced()
    opt = OptimizerConfig(peak_lr=1e-3, total_steps=30, warmup_steps=3)
    step = make_train_step(cfg, opt)
    state = init_train_state(cfg, tm.init_params(
        cfg, 0, device="cpu", param_dtype=torch.float32))
    batch = make_lm_batch(cfg, 4, 32, seed=0, step=0)    # fixed: memorise
    losses = []
    for _ in range(30):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::6]


def test_lm_batches_are_a_function_of_seed_and_step():
    cfg = ARCHS["minicpm-2b"].reduced()
    a = make_lm_batch(cfg, 2, 16, seed=3, step=5)
    assert torch.equal(a["tokens"], TokenDataset(cfg, 2, 16, seed=3)(5)[
        "tokens"])
    assert not torch.equal(a["tokens"], make_lm_batch(cfg, 2, 16, 3, 6)[
        "tokens"])
    assert not torch.equal(a["tokens"], make_lm_batch(cfg, 2, 16, 4, 5)[
        "tokens"])
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (2, 16)
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert int(a["tokens"].max()) < cfg.vocab_size
    # frames (the encoder's frontend): shapes, dtypes, (seed, step)
    enc = ARCHS["hubert-xlarge"].reduced()
    f = make_lm_batch(enc, 2, 16, seed=3, step=5)
    assert set(f) == {"frames", "labels"}
    assert f["frames"].dtype == torch.float32
    assert f["frames"].shape == (2, 16, enc.d_model)
    assert f["labels"].dtype == torch.int32 and f["labels"].shape == (2, 16)
    assert 0 <= int(f["labels"].min()) and int(f["labels"].max()) < \
        enc.vocab_size
    again = FrameDataset(enc, 2, 16, seed=3)(5)
    assert all(torch.equal(f[k], again[k]) for k in f)
    assert not torch.equal(f["frames"], make_lm_batch(enc, 2, 16, 3, 6)[
        "frames"])
    assert not torch.equal(f["frames"], make_lm_batch(enc, 2, 16, 4, 5)[
        "frames"])


def test_jax_layout_round_trip():
    """to_jax_layout inverts params_from_jax exactly (float32)."""
    cfg = _cfg("stablelm-1.6b")
    jp = jax.device_get(jm.init_params(_jcfg(cfg), jax.random.PRNGKey(0)))
    back = to_jax_layout(params_from_jax(jp, cfg, device="cpu",
                                         dtype=torch.float32), cfg)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        assert np.array_equal(flat_b[path], np.asarray(leaf)), path


# -------------------------------------------------------------- checkpoints
def _state(cfg, seed):
    return init_train_state(cfg, tm.init_params(
        cfg, seed, device="cpu", param_dtype=torch.float32))


def test_checkpoint_roundtrip(tmp_path):
    """A trained state restores bit for bit into a different like-state."""
    cfg = _cfg("minicpm-2b")
    state, _ = make_train_step(cfg, OptimizerConfig())(
        _state(cfg, 0), make_lm_batch(cfg, 2, 8, seed=0, step=0))
    save_checkpoint(str(tmp_path), 42, state, extra_meta={"arch": cfg.name})
    assert latest_step(str(tmp_path)) == 42
    back = restore_checkpoint(str(tmp_path), 42, _state(cfg, 1))
    assert back.opt_state["step"] == 1
    for (n, a), (_, b) in zip(state.params.named_parameters(),
                              back.params.named_parameters()):
        assert torch.equal(a, b), n
    for key in ("m", "v"):
        for n, a in state.opt_state[key].items():
            assert torch.equal(a, back.opt_state[key][n]), (key, n)


def test_checkpoint_atomicity_and_async(tmp_path):
    """A step without meta (a crash between the renames) is ignored; an
    async write is complete once its meta exists."""
    cfg = _cfg("stablelm-1.6b")
    state = _state(cfg, 0)
    save_checkpoint(str(tmp_path), 1, state)
    save_checkpoint(str(tmp_path), 2, state)
    os.remove(str(tmp_path / "step_00000002.npz.meta.json"))
    assert latest_step(str(tmp_path)) == 1
    path = save_checkpoint(str(tmp_path), 3, state, async_write=True)
    deadline = time.time() + 60
    while not os.path.exists(path + ".meta.json"):
        assert time.time() < deadline
        time.sleep(0.05)
    assert latest_step(str(tmp_path)) == 3
    assert latest_step(str(tmp_path / "nothing")) is None


def test_train_resume_exact(tmp_path):
    """6 straight steps == 3 steps + checkpoint + restore into another
    state + 3 steps."""
    cfg = _cfg("stablelm-1.6b")
    opt = OptimizerConfig(peak_lr=1e-3, total_steps=20, warmup_steps=0)
    step = make_train_step(cfg, opt)
    data = TokenDataset(cfg, 2, 16, seed=3)
    s_a = _state(cfg, 2)
    for t in range(6):
        s_a, _ = step(s_a, data(t))
    s_b = _state(cfg, 2)
    for t in range(3):
        s_b, _ = step(s_b, data(t))
    save_checkpoint(str(tmp_path), 3, s_b)
    s_b2 = restore_checkpoint(str(tmp_path), 3, _state(cfg, 9))
    for t in range(3, 6):
        s_b2, _ = step(s_b2, data(t))
    for a, b in zip(s_a.params.parameters(), s_b2.params.parameters()):
        assert float((a - b).abs().max().detach()) < 1e-5


def test_checkpoints_cross_packages(tmp_path):
    """A run checkpointed by either package resumes in the other. JAX
    saves its state after 2 steps, the port restores it into a state of
    another seed and takes step 3; the port saves its own state after 2
    steps, JAX restores it and takes step 3. The restored parameters and
    moments are bit-equal to the saved ones, and each resumed step's loss
    is within 1e-5 of the saving package's straight third step."""
    cfg = _cfg("minicpm-2b")
    jcfg = _jcfg(cfg)
    opt = OptimizerConfig(peak_lr=1e-3, schedule="wsd", warmup_steps=1,
                          total_steps=4)
    jstep = jax.jit(jtl.make_train_step(
        jcfg, jopt.OptimizerConfig(**dataclasses.asdict(opt))))
    step = make_train_step(cfg, opt)
    batches = [_batch(cfg, seed=31 + t) for t in range(3)]
    init = jtl.init_train_state(jcfg, jm.init_params(
        jcfg, jax.random.PRNGKey(3)))

    # JAX: 3 straight steps, its checkpoint after 2
    jstate, jlosses = init, []
    for t, (tokens, labels) in enumerate(batches):
        if t == 2:
            jckpt.save_checkpoint(str(tmp_path / "jax"), 2, jstate)
            jsaved = jax.device_get(jstate)
        jstate, met = jstep(jstate, _jbatch(tokens, labels))
        jlosses.append(float(met["loss"]))
    back = restore_checkpoint(str(tmp_path / "jax"), 2, _state(cfg, 11))
    assert back.opt_state["step"] == 2
    for got, want in ((to_jax_layout(back.params, cfg), jsaved.params),
                      (to_jax_layout(back.opt_state["m"], cfg),
                       jsaved.opt_state["m"]),
                      (to_jax_layout(back.opt_state["v"], cfg),
                       jsaved.opt_state["v"])):
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                                jax.tree_util.tree_leaves(want)):
            assert np.array_equal(g, np.asarray(w)), path
    _, met = step(back, _tbatch(*batches[2]))
    assert abs(float(met["loss"]) - jlosses[2]) <= 1e-5

    # the port: 3 straight steps, its checkpoint after 2
    state, losses = train_state_from_jax(jax.device_get(init), cfg,
                                         device="cpu"), []
    for t, (tokens, labels) in enumerate(batches):
        if t == 2:
            save_checkpoint(str(tmp_path / "port"), 2, state)
            saved = {key: to_jax_layout(tree, cfg) for key, tree in (
                ("params", state.params), ("m", state.opt_state["m"]),
                ("v", state.opt_state["v"]))}
        state, met = step(state, _tbatch(tokens, labels))
        losses.append(float(met["loss"]))
    like = jtl.init_train_state(jcfg, jm.init_params(
        jcfg, jax.random.PRNGKey(12)))
    jback = jckpt.restore_checkpoint(str(tmp_path / "port"), 2, like)
    assert int(jback.opt_state["step"]) == 2
    for key, want in saved.items():
        got = jback.params if key == "params" else jback.opt_state[key]
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                                jax.tree_util.tree_leaves(want)):
            assert np.array_equal(np.asarray(g), w), (key, path)
    _, met = jstep(jback, _jbatch(*batches[2]))
    assert abs(float(met["loss"]) - losses[2]) <= 1e-5


# ----------------------------------------------------------------- launcher
def _args(**kw):
    base = dict(arch="stablelm-1.6b", reduced=True, steps=6, batch=2, seq=32,
                lr=1e-3, grad_accum=1, seed=0, mesh="none", multi_pod=False,
                ckpt_dir=None, ckpt_every=3, resume=False, log_every=3,
                device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def test_train_launcher_runs():
    metrics = ttrain.run(_args())
    assert metrics["steps"] == 6 and len(metrics["history"]) == 6
    assert metrics["loss"] > 0 and np.isfinite(metrics["grad_norm"])
    assert all(h["seconds"] > 0 for h in metrics["history"])


def test_train_launcher_checkpoint_resume(tmp_path):
    d = str(tmp_path / "ckpt")
    ttrain.run(_args(steps=6, ckpt_dir=d))
    assert os.path.exists(os.path.join(d, "step_00000006.npz"))
    # resume continues from the saved step and finishes more steps
    m2 = ttrain.run(_args(steps=9, ckpt_dir=d, resume=True))
    assert m2["steps"] == 9 and len(m2["history"]) == 3


def test_train_launcher_grad_accum_and_minicpm():
    """grad_accum, and minicpm (tied embeddings, the WSD schedule) through
    main() as the command line runs it."""
    assert ttrain.run(_args(steps=4, batch=4, grad_accum=2))["steps"] == 4
    m = ttrain.main(["--arch", "minicpm-2b", "--reduced", "--device", "cpu",
                     "--steps", "3", "--batch", "2", "--seq", "32"])
    assert m["steps"] == 3
    cfg, opt, _ = ttrain.build(_args(arch="minicpm-2b", steps=3))
    assert opt.schedule == "wsd" and cfg.use_flash_kernel


def test_train_launcher_refuses_a_mesh():
    """--mesh debug needs a process group of world size 4 (torchrun);
    without one it raises, naming the size."""
    with pytest.raises(RuntimeError, match="world size 4"):
        ttrain.run(_args(mesh="debug"))
