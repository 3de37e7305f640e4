"""Port parity of the flash-attention module (kernels #10, #11, #12).

The wrappers, called with CPU tensors, run their plain versions — the
Pallas kernels' block loop — held here against the JAX functions they
replace (Pallas in interpret mode off a TPU, as `tests/test_kernels.py`
runs it):

  * `flash_attention` (plain) vs JAX `flash_attention` and
    `flash_attention_ref`, and `flash_attention_fwd` (plain) vs
    `flash_attention_fwd_pallas` (o and lse): rtol 1e-4, atol 1e-4 (the
    tolerance of tests/test_kernels.py's flash tests), float32, over the
    four shapes of those tests, one with q_offset > 0 and Sq < Skv, three
    at head dim 80 (causal GQA, a window, q_offset > 0), and one bfloat16
    case (atol 2e-2);
  * ragged lengths (no multiple of the block) and fully masked leading
    tiles against the blockwise oracle in one chunk;
  * `flash_traffic_bytes` equal to JAX's;
  * the backward: `flash_attention_bwd` (plain) vs
    `flash_attention_bwd_pallas` (interpret mode) on the same q, k, v, o,
    lse and dO, dq/dk/dv at rtol/atol 1e-4 in float32 and atol 2e-2 in
    bfloat16, over the shapes above plus rows that see no key; the
    port's `flash_attention` under autograd (the autograd Function) vs
    `jax.grad` of JAX's `flash_attention` with the same cotangent, and vs
    torch autograd of `blockwise_attention`, rtol/atol 1e-4.

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_kernel as jfk
from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_ref as t_flash_ref)
from repro_torch.models.attention import blockwise_attention

RTOL, ATOL = 1e-4, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, b, sq, skv, h, hk, dh):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, dh)).astype(np.float32),
            rng.normal(size=(b, skv, hk, dh)).astype(np.float32),
            rng.normal(size=(b, skv, hk, dh)).astype(np.float32))


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


# b, sq, skv, h, hk, dh, causal, window, q_offset
SHAPES = [
    (2, 128, 128, 4, 4, 32, True, 0, 0),
    (1, 128, 128, 8, 2, 64, True, 0, 0),       # GQA
    (2, 128, 128, 4, 4, 32, False, 0, 0),      # bidirectional (encoder)
    (1, 256, 256, 4, 2, 32, True, 64, 0),      # sliding window
    (1, 64, 192, 6, 2, 32, True, 0, 128),      # q_offset > 0, Sq < Skv
    # head dim 80 (stablelm-3b, zamba2-2.7b, hubert-xlarge)
    (1, 128, 128, 8, 2, 80, True, 0, 0),       # causal GQA
    (1, 192, 192, 4, 2, 80, True, 64, 0),      # sliding window
    (1, 64, 192, 6, 2, 80, True, 0, 128),      # q_offset > 0, Sq < Skv
]
IDS = ["mha", "gqa", "bidir", "window", "q_offset", "gqa-d80", "window-d80",
       "q_offset-d80"]


@pytest.mark.parametrize("b,sq,skv,h,hk,dh,causal,window,q_offset", SHAPES,
                         ids=IDS)
def test_flash_attention_plain_vs_jax(b, sq, skv, h, hk, dh, causal, window,
                                      q_offset):
    q, k, v = _qkv(1, b, sq, skv, h, hk, dh)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = tops.flash_attention(*_t(q, k, v), **kw, block_q=64,
                               block_kv=64).numpy()
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **kw, block_q=64,
                                block_kv=64)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    ref = flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              **kw)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)
    t_ref = t_flash_ref(*_t(q, k, v), **kw).numpy()
    np.testing.assert_allclose(t_ref, np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,sq,skv,h,hk,dh,causal,window,q_offset", SHAPES,
                         ids=IDS)
def test_flash_attention_fwd_plain_vs_pallas(b, sq, skv, h, hk, dh, causal,
                                             window, q_offset):
    """o and lse against `flash_attention_fwd_pallas` ((B, H, S, Dh)
    layout, interpret mode), at the same blocks."""
    q, k, v = _qkv(2, b, sq, skv, h, hk, dh)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = tops.flash_attention_fwd(*_t(q, k, v), **kw, block_q=64,
                                      block_kv=64)
    jo, jlse = jfk.flash_attention_fwd_pallas(
        *(jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v)), **kw,
        block_q=64, block_kv=64, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.swapaxes(np.asarray(jo), 1, 2),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=RTOL,
                               atol=ATOL)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    # #11's o is #10's
    assert torch.equal(o, tops.flash_attention(*_t(q, k, v), **kw,
                                               block_q=64, block_kv=64))


def test_flash_attention_bf16_vs_jax():
    """bfloat16 in and out, p rounded to bf16 before the PV product, as
    the Pallas kernel does: atol 2e-2 against JAX."""
    q, k, v = _qkv(3, 1, 128, 128, 8, 2, 64)
    got = tops.flash_attention(*(x.to(torch.bfloat16) for x in _t(q, k, v)),
                               causal=True, block_q=64, block_kv=64)
    assert got.dtype == torch.bfloat16
    want = jops.flash_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=True,
        block_q=64, block_kv=64)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("sq,skv,window,q_offset", [
    (100, 100, 0, 0), (77, 150, 0, 73), (130, 130, 40, 0), (50, 200, 64, 150)])
def test_flash_plain_ragged_vs_blockwise(sq, skv, window, q_offset):
    """Any Sq and Skv: the block loop masks the ragged tails (blocks 64,
    lengths that are not multiples of it) and matches the blockwise oracle
    in one chunk (a plain masked softmax); rows whose first tiles are
    fully masked (window, q_offset) stay finite and exact."""
    q, k, v = _t(*_qkv(4, 2, sq, skv, 6, 2, 32))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    got, lse = tops.flash_attention_fwd(q, k, v, **kw, block_q=64,
                                        block_kv=64)
    want = blockwise_attention(q, k, v, **kw, q_chunk=sq, kv_chunk=skv)
    assert torch.isfinite(got).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    # lse is the log-sum-exp of the visible scores
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(3, dim=2))
    s = s * 32 ** -0.5
    qp = torch.arange(sq)[:, None] + q_offset
    kp = torch.arange(skv)[None, :]
    mask = (kp <= qp) & ((kp > qp - window) if window else True)
    want_lse = torch.logsumexp(s.masked_fill(~mask, -torch.inf), dim=-1)
    torch.testing.assert_close(lse, want_lse, rtol=RTOL, atol=ATOL)


def test_flash_plain_block_sweep():
    """The block sizes change only the float32 rounding."""
    q, k, v = _t(*_qkv(5, 1, 256, 256, 4, 2, 32))
    ref = tops.flash_attention(q, k, v, causal=True, block_q=256,
                               block_kv=256)
    for bq, bkv in [(64, 64), (128, 64), (64, 128), (32, 96)]:
        out = tops.flash_attention(q, k, v, causal=True, block_q=bq,
                                   block_kv=bkv)
        torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)


def test_flash_traffic_model_matches_jax():
    for args in [(1, 4, 4, 1024, 1024, 64), (4, 36, 4, 4096, 4096, 128)]:
        assert (tops.flash_traffic_bytes(*args, block_q=256)
                == jops.flash_traffic_bytes(*args, block_q=256))


def test_inference_variant_is_the_forward():
    q, k, v = _t(*_qkv(6, 1, 64, 64, 4, 2, 32))
    assert torch.equal(
        tops.flash_attention_inference(q, k, v, causal=True, block_q=64,
                                       block_kv=64),
        tops.flash_attention(q, k, v, causal=True, block_q=64, block_kv=64))


# ---------------------------------------------------------- backward (#12)
BWD_SHAPES = SHAPES + [
    # rows 150..191 see no key: window 16 ends before them (rows 120..149
    # see some); the Pallas backward gives them no gradient
    (1, 64, 128, 4, 2, 32, True, 16, 120),
]
BWD_IDS = IDS + ["rows-that-see-no-key"]


def _fwd_pallas(q, k, v, kw):
    """o (B, Sq, H, Dh) and lse from `flash_attention_fwd_pallas`."""
    jo, jlse = jfk.flash_attention_fwd_pallas(
        *(jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v)), **kw,
        block_q=64, block_kv=64, interpret=True)
    return np.array(np.swapaxes(np.asarray(jo, np.float32), 1, 2)), \
        np.array(jlse)


@pytest.mark.parametrize("b,sq,skv,h,hk,dh,causal,window,q_offset",
                         BWD_SHAPES, ids=BWD_IDS)
def test_flash_attention_bwd_plain_vs_pallas(b, sq, skv, h, hk, dh, causal,
                                             window, q_offset):
    """dq, dk, dv of the plain #12 against `flash_attention_bwd_pallas`
    (interpret mode) fed the same q, k, v, o, lse and dO: rtol/atol 1e-4.
    Rows that see no key get zero dq in both (and add nothing to dk, dv),
    which is not what autodiff of the forward gives for them."""
    q, k, v = _qkv(7, b, sq, skv, h, hk, dh)
    do = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = _fwd_pallas(q, k, v, kw)
    got = tops.flash_attention_bwd(*_t(q, k, v, o, lse, do), **kw,
                                   block_q=64, block_kv=64)
    want = jfk.flash_attention_bwd_pallas(
        *(jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v, o)),
        jnp.asarray(lse), jnp.swapaxes(jnp.asarray(do), 1, 2), **kw,
        block_q=64, block_kv=64, interpret=True)
    for name, g, w, like in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.shape == like.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.swapaxes(np.asarray(w), 1, 2),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    if window and q_offset:
        blind = np.arange(sq) + q_offset - window >= skv - 1
        assert blind.any() and not blind.all()
        assert not got[0][:, blind].any()


def test_flash_attention_bwd_bf16_vs_pallas():
    """bfloat16 in and out, ds, p^T and ds^T rounded to bf16 before their
    products as the Pallas kernels do: atol 2e-2 against them."""
    q, k, v = _qkv(9, 1, 128, 128, 8, 2, 64)
    do = np.random.default_rng(10).normal(size=q.shape).astype(np.float32)
    bf = [jnp.swapaxes(jnp.asarray(x, jnp.bfloat16), 1, 2) for x in (q, k, v)]
    jo, jlse = jfk.flash_attention_fwd_pallas(*bf, causal=True, block_q=64,
                                              block_kv=64, interpret=True)
    jdo = jnp.swapaxes(jnp.asarray(do, jnp.bfloat16), 1, 2)
    want = jfk.flash_attention_bwd_pallas(*bf, jo, jlse, jdo, causal=True,
                                          block_q=64, block_kv=64,
                                          interpret=True)

    def t16(x):
        return torch.as_tensor(np.swapaxes(np.asarray(x, np.float32), 1, 2)
                               ).to(torch.bfloat16)
    got = tops.flash_attention_bwd(*(t16(x) for x in (*bf, jo)),
                                   torch.as_tensor(np.array(jlse)), t16(jdo),
                                   causal=True, block_q=64, block_kv=64)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.swapaxes(np.asarray(w, np.float32), 1,
                                               2), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("b,sq,skv,h,hk,dh,causal,window,q_offset", SHAPES,
                         ids=IDS)
def test_flash_attention_autograd_vs_jax_grad(b, sq, skv, h, hk, dh, causal,
                                              window, q_offset):
    """The port's `flash_attention` under autograd (forward #11, backward
    #12 through `FlashAttentionFn`, plain versions here) against
    `jax.grad` of JAX's `flash_attention` (its custom_vjp over the Pallas
    kernels) with the same cotangent, and against torch autograd of
    `blockwise_attention`: rtol/atol 1e-4. (No row here is blind to
    every key: there autodiff of the forward and the kernels differ.)"""
    import jax
    q, k, v = _qkv(11, b, sq, skv, h, hk, dh)
    ct = np.random.default_rng(12).normal(size=q.shape).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)

    def f_jax(q_, k_, v_):
        return jnp.sum(jops.flash_attention(q_, k_, v_, **kw, block_q=64,
                                            block_kv=64) * ct)
    want = jax.grad(f_jax, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    qt, kt, vt = (x.requires_grad_() for x in _t(q, k, v))
    (tops.flash_attention(qt, kt, vt, **kw, block_q=64, block_kv=64)
     * torch.as_tensor(ct)).sum().backward()
    q2, k2, v2 = (x.requires_grad_() for x in _t(q, k, v))
    (blockwise_attention(q2, k2, v2, **kw, q_chunk=64, kv_chunk=64)
     * torch.as_tensor(ct)).sum().backward()
    for name, got, w, ref in zip(("dq", "dk", "dv"), (qt, kt, vt), want,
                                 (q2, k2, v2)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
        torch.testing.assert_close(got.grad, ref.grad, rtol=RTOL, atol=ATOL)


def test_flash_attention_dispatch():
    """Under autograd the Function runs; without a gradient to take (no
    grad mode, or no input requiring one) the forward is #10's, and the
    two forwards agree exactly."""
    q, k, v = _t(*_qkv(13, 1, 64, 64, 4, 2, 32))
    kw = dict(causal=True, block_q=64, block_kv=64)
    plain = tops.flash_attention(q, k, v, **kw)
    assert plain.grad_fn is None
    qg = q.clone().requires_grad_()
    out = tops.flash_attention(qg, k, v, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert torch.equal(out.detach(), plain)
    with torch.no_grad():
        assert tops.flash_attention(qg, k, v, **kw).grad_fn is None
    out.sum().backward()
    assert qg.grad.shape == q.shape


@pytest.mark.parametrize("sq,skv,window,q_offset", [
    (100, 100, 0, 0), (77, 150, 0, 73), (130, 130, 40, 0), (50, 200, 64, 150)])
def test_flash_bwd_plain_ragged_vs_blockwise(sq, skv, window, q_offset):
    """Any Sq and Skv: the backward's block loops mask the ragged tails
    (blocks 64) and give autograd's gradients of the blockwise oracle in
    one chunk, rtol/atol 1e-4 (every row here sees a key)."""
    q, k, v = _t(*_qkv(14, 2, sq, skv, 6, 2, 32))
    do = torch.as_tensor(np.random.default_rng(15).normal(
        size=q.shape).astype(np.float32))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    o, lse = tops.flash_attention_fwd(q, k, v, **kw, block_q=64, block_kv=64)
    got = tops.flash_attention_bwd(q, k, v, o, lse, do, **kw, block_q=64,
                                   block_kv=64)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    (blockwise_attention(*leaves, **kw, q_chunk=sq, kv_chunk=skv)
     * do).sum().backward()
    for g, leaf in zip(got, leaves):
        torch.testing.assert_close(g, leaf.grad, rtol=RTOL, atol=ATOL)
