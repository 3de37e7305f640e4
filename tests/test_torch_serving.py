"""Port parity of serving: greedy generation and retrieval-augmented
serving over the port's `JasperIndex`.

Same parameters in both packages (`params_from_jax`), numpy-seeded
tokens, reduced configs in float32:

  * greedy `generate` equals the JAX package's token for token (the
    argmax over the padded vocab), flash kernel (plain version) and
    blockwise path;
  * `embed_texts` against JAX: rtol 1e-4, atol 1e-5;
  * a `RagPipeline` round on both packages — ingest (the first call
    builds, the next inserts), evict, retrieve: no evicted payload, and
    the top-1 payload equal to JAX's on >= 0.95 of the queries;
  * (tests/test_torch_package.py holds that `RagPipeline`,
    `init_params` and the serve launcher raise without a card unless
    given `device="cpu"`.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import model as jm
from repro.serving import rag as jrag
from repro.serving.serve_loop import generate as j_generate
from repro_torch.configs import ARCHS
from repro_torch.core.search_spec import SearchSpec
from repro_torch.models import model as tm
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import rag as trag
from repro_torch.serving.serve_loop import generate, make_serve_step


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, **kw):
    return dataclasses.replace(ARCHS[arch].reduced(), dtype="float32", **kw)


def _pair(cfg, seed=3):
    jcfg = JModelConfig(**dataclasses.asdict(cfg))
    jp = jm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, params_from_jax(jax.device_get(jp), cfg, device="cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape
                                                ).astype(np.int32)


@pytest.mark.parametrize("arch,kw,flash", [
    ("stablelm-1.6b", {}, False),
    ("starcoder2-7b", {"num_kv_heads": 2}, True)],
    ids=["stablelm-1.6b-blockwise", "starcoder2-7b-kv2-flash"])
def test_greedy_generate_matches_jax(arch, kw, flash):
    cfg = _cfg(arch, use_flash_kernel=flash, **kw)
    jcfg, jp, tp = _pair(cfg)
    prompts = _tokens(cfg, (2, 8), seed=11)
    want = np.asarray(j_generate(jp, jcfg, jnp.asarray(prompts),
                                 max_new_tokens=6))
    timings = {}
    got = generate(tp, cfg, torch.as_tensor(prompts), max_new_tokens=6,
                   timings=timings)
    assert got.shape == (2, 14) and got.dtype == torch.int32
    assert (got[:, :8].numpy() == prompts).all()
    np.testing.assert_array_equal(got.numpy(), want)
    assert timings["prefill_s"] > 0 and timings["decode_s"] > 0


def test_serve_step_and_sampling():
    cfg = _cfg("stablelm-1.6b")
    tp = tm.init_params(cfg, 1, device="cpu")
    prompts = torch.as_tensor(_tokens(cfg, (3, 5), seed=1))
    _, state = tm.prefill(tp, cfg, {"tokens": prompts}, max_len=8)
    step = make_serve_step(cfg)
    logits, state = step(tp, state, prompts[:, -1:])
    assert logits.shape == (3, 1, cfg.padded_vocab) and state["pos"] == 6
    a = generate(tp, cfg, prompts, max_new_tokens=4, temperature=0.8, seed=5)
    b = generate(tp, cfg, prompts, max_new_tokens=4, temperature=0.8, seed=5)
    assert a.shape == (3, 9) and torch.equal(a, b)
    assert (a[:, 5:] < cfg.padded_vocab).all()


def test_embed_texts_matches_jax():
    cfg = _cfg("starcoder2-7b", num_kv_heads=2, use_flash_kernel=True)
    jcfg, jp, tp = _pair(cfg)
    toks = _tokens(cfg, (6, 16), seed=2)
    want = np.asarray(jrag.embed_texts(jp, jcfg, jnp.asarray(toks)))
    got = trag.embed_texts(tp, cfg, torch.as_tensor(toks))
    assert got.dtype == torch.float32 and got.shape == (6, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_rag_round_matches_jax():
    """ingest (build, then a streamed insert) -> evict -> retrieve on both
    packages over the same weights and corpus."""
    cfg = _cfg("starcoder2-7b", num_kv_heads=2, use_flash_kernel=True)
    jcfg, jp, tp = _pair(cfg)
    n_docs, doc_len = 160, 16
    corpus = _tokens(cfg, (n_docs, doc_len), seed=7)
    payloads = [f"doc-{i}" for i in range(n_docs)]
    jpipe = jrag.RagPipeline(jp, jcfg, capacity=256)
    tpipe = trag.RagPipeline(tp, cfg, capacity=256, device="cpu")
    for s, e in ((0, 96), (96, n_docs)):
        jpipe.ingest(jnp.asarray(corpus[s:e]), payloads[s:e])
        ids = tpipe.ingest(torch.as_tensor(corpus[s:e]), payloads[s:e])
        np.testing.assert_array_equal(ids, np.arange(s, e))
    evicted = np.arange(0, n_docs, 10)
    assert jpipe.evict(evicted) == tpipe.evict(evicted) == evicted.size
    queries = corpus[::3]
    want = jpipe.retrieve(jnp.asarray(queries), k=4)
    got = tpipe.retrieve(torch.as_tensor(queries), k=4)
    gone = {payloads[i] for i in evicted}
    assert not any(p in gone for row in got for p in row)
    # the index itself returns no tombstoned row
    q = trag.embed_texts(tp, cfg, torch.as_tensor(queries))
    raw = tpipe.index.searcher(SearchSpec(k=4, beam_width=32)).search(q).ids
    raw = raw.numpy()
    assert not tpipe.index.tombstoned(raw[raw >= 0]).any()
    agree = np.mean([bool(g) and bool(w) and g[0] == w[0]
                     for g, w in zip(got, want)])
    assert agree >= 0.95, agree
    # live documents find themselves
    live = [i for i in range(0, n_docs, 3) if i not in set(evicted)]
    hit = np.mean([got[i // 3][0] == payloads[i] for i in live])
    assert hit >= 0.9, hit

