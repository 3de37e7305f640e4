"""Port parity of the state-space and recurrent blocks (`models/ssm.py`):
Mamba2 (SSD) and xLSTM's mLSTM / sLSTM.

JAX's block parameters (the one block of a one-group zamba2 or one-pair
xlstm model, carried across by `params_from_jax`) and numpy-seeded inputs
go through both packages, on reduced configs in float32; every function
against the JAX package's: rtol 1e-4, atol 1e-4 (the states too). Cases:

  * `causal_conv1d`, `conv_step`, `_fit_chunk`, `_segsum` (its -inf
    above the diagonal);
  * `ssd_scan` with and without `h_init`, `ssd_step`;
  * the blocks' forwards with `return_state` at S = 32, at a ragged S = 24
    (`_fit_chunk` 16 -> 12) and at S = 2 < K - 1 (the conv state
    left-padded); the state inits;
  * each `*_step` carried over 16 steps from its state init: every
    output against the forward's and JAX's step's, and the last state
    against the forward's returned one;
  * `mlstm_chunked` from a given state; `_slstm_cell`.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import model as jm
from repro.models import ssm as jssm
from repro_torch.configs import ARCHS
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_jax

RTOL, ATOL = 1e-4, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what="", rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _dict_close(got: dict, want: dict, what=""):
    assert set(got) == set(want), what
    for key in want:
        _close(got[key], want[key], f"{what}/{key}")


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(shape, seed, scale=1.0):
    return (_rng(seed).normal(size=shape) * scale).astype(np.float32)


# ----------------------------------------------------------------- blocks
MAMBA = dataclasses.replace(ARCHS["zamba2-2.7b"].reduced(), dtype="float32",
                            num_layers=1, attn_every=1)
XLSTM = dataclasses.replace(ARCHS["xlstm-125m"].reduced(), dtype="float32",
                            num_layers=2)


@functools.lru_cache(maxsize=None)
def _block(kind: str):
    """(cfg, JAX params of the block, the port's block) for "mamba2",
    "mlstm" or "slstm"."""
    cfg = MAMBA if kind == "mamba2" else XLSTM
    tree = jax.device_get(jm.init_params(
        JModelConfig(**dataclasses.asdict(cfg)), jax.random.PRNGKey(7)))
    model = params_from_jax(tree, cfg, device="cpu")
    if kind == "mamba2":
        jp = jax.tree_util.tree_map(lambda a: a[0, 0],
                                    tree["mamba_groups"]["mamba"])
        tp = model.mamba_groups[0][0].mamba
    else:
        jp = jax.tree_util.tree_map(lambda a: a[0], tree["pairs"][kind])
        tp = getattr(model.pairs[0], kind)
    return cfg, jp, tp


def _fns(mod, kind):
    return (getattr(mod, f"{kind}_forward"), getattr(mod, f"{kind}_step"),
            getattr(mod, f"{kind}_state_init"))


KINDS = ["mamba2", "mlstm", "slstm"]


# ------------------------------------------------------------- causal conv
def test_causal_conv_and_its_step():
    x = _normal((2, 9, 12), 0)
    w = _normal((4, 12), 1, 0.3)
    b = _normal((12,), 2)
    want = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tssm.causal_conv1d(torch.as_tensor(x), torch.as_tensor(w),
                             torch.as_tensor(b))
    _close(got, want, "causal_conv1d")
    jbuf = jnp.zeros((2, 3, 12))
    tbuf = torch.zeros((2, 3, 12))
    for t in range(9):
        jy, jbuf = jssm.conv_step(jnp.asarray(x[:, t]), jbuf, jnp.asarray(w),
                                  jnp.asarray(b))
        ty, tbuf = tssm.conv_step(torch.as_tensor(x[:, t]), tbuf,
                                  torch.as_tensor(w), torch.as_tensor(b))
        _close(ty, jy, f"conv_step {t}")
        _close(ty, got[:, t], f"conv_step {t} vs the conv")
    _close(tbuf, jbuf, "conv buffer")
    assert tbuf.dtype == torch.float32


def test_fit_chunk_and_segsum():
    for s, chunk in ((64, 16), (24, 16), (7, 16), (2, 128), (4096, 64),
                     (1000, 128)):
        assert tssm._fit_chunk(s, chunk) == jssm._fit_chunk(s, chunk)
    log_a = -np.abs(_normal((2, 3, 8), 3))
    want = np.asarray(jssm._segsum(jnp.asarray(log_a)))
    got = tssm._segsum(torch.as_tensor(log_a)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    assert (got[np.isinf(got)] < 0).all()
    _close(got[np.isfinite(got)], want[np.isfinite(want)], "segsum")


# ===================================================================== SSD
def _ssd_inputs(b=2, s=32, h=4, p=8, n=6, seed=10):
    return (_normal((b, s, h, p), seed),
            np.log1p(np.exp(_normal((b, s, h), seed + 1))).astype(np.float32),
            np.log(np.linspace(1.0, 16.0, h)).astype(np.float32),
            _normal((b, s, n), seed + 2), _normal((b, s, n), seed + 3))


@pytest.mark.parametrize("with_h", [False, True], ids=["zero", "h_init"])
def test_ssd_scan_matches_jax(with_h):
    args = _ssd_inputs()
    h0 = _normal((2, 4, 6, 8), 20) if with_h else None
    jy, jh = jssm.ssd_scan(*map(jnp.asarray, args), chunk=8,
                           h_init=None if h0 is None else jnp.asarray(h0))
    ty, th = tssm.ssd_scan(*map(torch.as_tensor, args), chunk=8,
                           h_init=None if h0 is None else torch.as_tensor(h0))
    _close(ty, jy, "y")
    _close(th, jh, "h_final")
    # chunking changes nothing: one chunk, and a split in two with the
    # first half's state carried
    one, h_one = tssm.ssd_scan(*map(torch.as_tensor, args), chunk=32,
                               h_init=None if h0 is None
                               else torch.as_tensor(h0))
    _close(one, ty, "chunk 32 vs 8")
    first = [torch.as_tensor(a[:, :16]) if a.ndim > 1 else torch.as_tensor(a)
             for a in args]
    second = [torch.as_tensor(a[:, 16:]) if a.ndim > 1 else
              torch.as_tensor(a) for a in args]
    y1, h1 = tssm.ssd_scan(*first, chunk=8, h_init=None if h0 is None
                           else torch.as_tensor(h0))
    y2, h2 = tssm.ssd_scan(*second, chunk=8, h_init=h1)
    _close(torch.cat([y1, y2], 1), ty, "split")
    _close(h2, th, "split state")


def test_ssd_step_matches_jax():
    x, dt, a_log, b_in, c_in = _ssd_inputs(s=1)
    h = _normal((2, 4, 6, 8), 21)
    jy, jh = jssm.ssd_step(*(jnp.asarray(a[:, 0]) if a.ndim > 1 else
                             jnp.asarray(a) for a in (x, dt, a_log, b_in,
                                                       c_in)),
                           jnp.asarray(h))
    ty, th = tssm.ssd_step(*(torch.as_tensor(a[:, 0]) if a.ndim > 1 else
                             torch.as_tensor(a) for a in (x, dt, a_log, b_in,
                                                          c_in)),
                           torch.as_tensor(h))
    _close(ty, jy, "y")
    _close(th, jh, "h")


# ------------------------------------------------------ blocks: forward
@pytest.mark.parametrize("s", [32, 24, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_block_forward_and_state_match_jax(kind, s):
    cfg, jp, tp = _block(kind)
    jfwd, _, jinit = _fns(jssm, kind)
    tfwd, _, tinit = _fns(tssm, kind)
    jcfg = JModelConfig(**dataclasses.asdict(cfg))
    x = _normal((2, s, cfg.d_model), 30 + s)
    jy, jst = jfwd(jp, jnp.asarray(x), jcfg, return_state=True)
    ty, tst = tfwd(tp, torch.as_tensor(x), cfg, return_state=True)
    _close(ty, jy, f"{kind} y")
    _dict_close(tst, jax.device_get(jst), f"{kind} state")
    assert all(v.dtype == torch.float32 for v in tst.values())
    torch.testing.assert_close(tfwd(tp, torch.as_tensor(x), cfg), ty,
                               rtol=0, atol=0)
    _dict_close(tinit(cfg, 3), jax.device_get(jinit(jcfg, 3)),
                f"{kind} state init")


# ---------------------------------------------------------- blocks: steps
@pytest.mark.parametrize("kind", KINDS)
def test_step_carried_16_steps_matches_the_forward(kind):
    cfg, jp, tp = _block(kind)
    jfwd, jstep, jinit = _fns(jssm, kind)
    tfwd, tstep, tinit = _fns(tssm, kind)
    jcfg = JModelConfig(**dataclasses.asdict(cfg))
    x = _normal((2, 16, cfg.d_model), 40)
    y_fwd, st_fwd = tfwd(tp, torch.as_tensor(x), cfg, return_state=True)
    tst, jst = tinit(cfg, 2), jinit(jcfg, 2)
    for t in range(16):
        ty, tst = tstep(tp, torch.as_tensor(x[:, t:t + 1]), tst, cfg)
        jy, jst = jstep(jp, jnp.asarray(x[:, t:t + 1]), jst, jcfg)
        _close(ty, jy, f"{kind} step {t} vs JAX")
        _close(ty[:, 0], y_fwd[:, t], f"{kind} step {t} vs the forward")
    _dict_close(tst, jax.device_get(jst), f"{kind} state vs JAX")
    _dict_close(tst, {k: v.numpy() for k, v in st_fwd.items()},
                f"{kind} state vs the forward's")


# ------------------------------------------------------------ mLSTM, sLSTM
def test_mlstm_chunked_from_a_state_matches_jax():
    b, s, h, d = 2, 32, 4, 8
    q, k, v = (_normal((b, s, h, d), 50 + i) for i in range(3))
    i_pre, f_pre = _normal((b, s, h), 53), _normal((b, s, h), 54) + 2.0
    state = (_normal((b, h, d, d), 55), np.abs(_normal((b, h, d), 56)),
             _normal((b, h), 57))
    jy, jst = jssm.mlstm_chunked(*map(jnp.asarray, (q, k, v, i_pre, f_pre)),
                                 chunk=8, state=tuple(map(jnp.asarray, state)))
    ty, tst = tssm.mlstm_chunked(*map(torch.as_tensor, (q, k, v, i_pre,
                                                         f_pre)),
                                 chunk=8,
                                 state=tuple(map(torch.as_tensor, state)))
    _close(ty, jy, "y")
    for name, g, w in zip("cnm", tst, jst):
        _close(g, w, name)


def test_slstm_cell_matches_jax():
    cfg, jp, tp = _block("slstm")
    d = cfg.d_model
    g_x = _normal((3, 4 * d), 60)
    carry = (_normal((3, d), 61), np.abs(_normal((3, d), 62)) + 0.5,
             _normal((3, d), 63), _normal((3, d), 64))
    (jc, jh_out) = jssm._slstm_cell(jp, jnp.asarray(g_x),
                                    tuple(map(jnp.asarray, carry)), d)
    (tc, th_out) = tssm._slstm_cell(tp, torch.as_tensor(g_x),
                                    tuple(map(torch.as_tensor, carry)), d)
    _close(th_out, jh_out, "h")
    for name, g, w in zip("cnhm", tc, jc):
        _close(g, w, name)
