"""Port parity of the flash-attention module (kernels #10 and #11).

The wrappers, called with CPU tensors, run their plain versions — the
Pallas kernels' block loop — held here against the JAX functions they
replace (Pallas in interpret mode off a TPU, as `tests/test_kernels.py`
runs it):

  * `flash_attention` (plain) vs JAX `flash_attention` and
    `flash_attention_ref`, and `flash_attention_fwd` (plain) vs
    `flash_attention_fwd_pallas` (o and lse): rtol 1e-4, atol 1e-4 (the
    tolerance of tests/test_kernels.py's flash tests), float32, over the
    four shapes of those tests, one with q_offset > 0 and Sq < Skv, and
    one bfloat16 case (atol 2e-2);
  * ragged lengths (no multiple of the block) and fully masked leading
    tiles against the blockwise oracle in one chunk;
  * `flash_traffic_bytes` equal to JAX's.

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
]
IDS = ["mha", "gqa", "bidir", "window", "q_offset"]


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
