"""The port's examples (`repro_torch.examples`) against the JAX package's
(`examples/`), on the CPU.

  * quickstart at 1,500 x 32 against the same `JasperIndex` calls of the
    JAX package at those sizes, on the same numpy-seeded rows: the
    session's plan-cache counters (hits, misses, traces), the size after
    the insert and the `memory_stats` byte counts equal; recall@10 at
    each beam within 0.05 of JAX's and >= 0.75; the save/load round trip;
  * train_lm: the JAX script, loaded by path with its launcher replaced,
    hands the launcher the argv the port hands its own, less `--device`
    and the checkpoint directory; the port trains 3 reduced steps into a
    fresh directory and resumes for a fourth, with finite losses;
  * rag_serve over a 64-document corpus, JAX's reduced stablelm-1.6b
    carried across by `params_from_jax`, float32: the index size and the
    plan-cache counters equal, the retrieved payloads agree on >= 0.95 of
    the (query, rank) places, and the greedy tokens equal JAX's.
"""

import dataclasses
import importlib.util
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.examples import quickstart, rag_serve, train_lm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECALL_SLACK = 0.05
RECALL_FLOOR = 0.75
HIT_AGREEMENT = 0.95


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors gain nothing from intra-op threads; one thread keeps
    this file from competing with the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_jax_example(name: str):
    """The JAX package's example script as a module, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------- quickstart
QS = dict(n=1500, dims=32, n_queries=100)


def _jax_quickstart(tmp_path, n, dims, n_queries):
    """examples/quickstart.py's calls at these sizes."""
    from repro.core import JasperIndex, SearchSpec
    from repro.core.construction import ConstructionParams

    rng = np.random.default_rng(0)
    data = rng.normal(size=(n, dims)).astype(np.float32)
    queries = rng.normal(size=(n_queries, dims)).astype(np.float32)
    idx = JasperIndex(
        dims, capacity=n + 2000, quantization="rabitq", bits=4,
        construction=ConstructionParams(degree_bound=32, beam_width=32,
                                        max_iters=48, rev_cap=32))
    idx.build(data)
    out = {"recall": {}}
    for beam in quickstart.BEAMS:
        out["recall"][beam] = {
            "exact": idx.recall(queries, spec=SearchSpec(
                k=10, beam_width=beam)),
            "rabitq": idx.recall(queries, spec=SearchSpec(
                k=10, beam_width=beam, quantized=True))}
    spec = SearchSpec(k=10, beam_width=32, quantized=True)
    session = idx.searcher(spec)
    jax.block_until_ready(session.search(queries).ids)
    jax.block_until_ready(session.search(queries).ids)
    out["cache"] = session.cache_stats.as_dict()
    out["memory"] = idx.memory_stats()
    idx.insert(rng.normal(size=(1000, dims)).astype(np.float32))
    out["size"] = idx.size
    path = str(tmp_path / "jasper_quickstart.npz")
    idx.save(path)
    idx2 = JasperIndex.load(path)
    a = idx.searcher(k=5).search(queries[:8])
    b = idx2.searcher(k=5).search(queries[:8])
    assert (np.asarray(a.ids) == np.asarray(b.ids)).all()
    return out


def test_quickstart_matches_jax(tmp_path, capsys):
    got = quickstart.main(device="cpu", **QS)
    want = _jax_quickstart(tmp_path, **QS)
    assert got["roundtrip"] and got["device"] == "cpu"
    assert "save/load roundtrip OK" in capsys.readouterr().out
    for key in ("hits", "misses", "traces"):
        assert got["cache"][key] == want["cache"][key], (got["cache"],
                                                         want["cache"])
    assert got["size"] == want["size"] == QS["n"] + 1000
    for key, value in want["memory"].items():
        if key.endswith("bytes") or key.endswith("bytes_per_row"):
            assert got["memory"][key] == value, key
    assert got["memory"]["rows_tier"] == want["memory"]["rows_tier"]
    for beam in quickstart.BEAMS:
        for lane in ("exact", "rabitq"):
            g, w = got["recall"][beam][lane], want["recall"][beam][lane]
            assert abs(g - w) <= RECALL_SLACK, (beam, lane, g, w)
            assert g >= RECALL_FLOOR, (beam, lane, g)
    assert got["graph"]["max_degree"] <= 32
    assert got["graph"]["n_valid"] == QS["n"]


# --------------------------------------------------------------- train_lm
@pytest.mark.parametrize("flags", [[], ["--full"],
                                   ["--steps", "3", "--arch", "minicpm-2b"]],
                         ids=["default", "full", "steps-arch"])
def test_train_lm_hands_the_launcher_jax_argv(flags, monkeypatch):
    jmod = load_jax_example("train_lm")
    seen = []
    monkeypatch.setattr(jmod, "train_main",
                        lambda: seen.append(list(sys.argv[1:])))
    monkeypatch.setattr(sys, "argv", ["train_lm.py"] + flags)
    jmod.main()
    port = train_lm.launcher_argv(train_lm.parser().parse_args(flags))
    assert seen == [port]
    with_device = train_lm.launcher_argv(train_lm.parser().parse_args(
        flags + ["--device", "cpu"]), ckpt_dir="elsewhere")
    i = with_device.index("--ckpt-dir")
    assert with_device[i + 1] == "elsewhere"
    assert with_device[-2:] == ["--device", "cpu"]
    assert with_device[:i + 1] + with_device[i + 2:-2] \
        == port[:i + 1] + port[i + 2:]


def test_train_lm_trains_and_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    first = train_lm.main(["--steps", "3", "--device", "cpu"], ckpt_dir=ckpt)
    assert first["steps"] == 3 and len(first["history"]) == 3
    assert "resumed" not in capsys.readouterr().out
    again = train_lm.main(["--steps", "4", "--device", "cpu"], ckpt_dir=ckpt)
    assert "resumed from step 3" in capsys.readouterr().out
    assert again["steps"] == 4 and len(again["history"]) == 1
    ces = [h["ce"] for h in first["history"] + again["history"]]
    assert all(math.isfinite(c) for c in ces), ces
    # random weights: the first cross-entropy sits near ln V
    ln_v = math.log(512)
    assert ln_v - 0.5 <= ces[0] <= ln_v + 3, ces[0]


# -------------------------------------------------------------- rag_serve
RAG = dict(n_docs=64, n_new=32)


def _jax_rag(jp, jcfg, n_docs, n_new):
    """examples/rag_serve.py's calls on a corpus of these sizes."""
    from repro.serving.rag import RagPipeline
    from repro.serving.serve_loop import generate

    jmod = load_jax_example("rag_serve")
    rng = np.random.default_rng(0)
    rag = RagPipeline(jp, jcfg, capacity=4096)
    toks, docs = jmod.fake_corpus(rng, n_docs, jcfg.vocab_size)
    rag.ingest(toks, docs)
    q_toks, _ = jmod.fake_corpus(rng, 4, jcfg.vocab_size)
    rag.retrieve(q_toks, k=3)
    hits = rag.retrieve(q_toks, k=3)
    out = {"hits": hits, "cache": rag.index.plans.stats.as_dict()}
    toks2, docs2 = jmod.fake_corpus(rng, n_new, jcfg.vocab_size)
    rag.ingest(toks2, [f"new-{d}" for d in docs2])
    out["size"] = rag.index.size
    prompt = jnp.concatenate([q_toks[:1, :8], q_toks[:1, 8:16]], axis=1)
    gen = generate(jp, jcfg, prompt, max_new_tokens=8)
    out["generated"] = np.asarray(gen[0, -8:]).tolist()
    return out


def test_rag_serve_matches_jax():
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.models import model as jm
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_jax

    cfg = dataclasses.replace(get_config("stablelm-1.6b").reduced(),
                              dtype="float32")
    jcfg = JModelConfig(**dataclasses.asdict(cfg))
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.device_get(jp), cfg, device="cpu")
    got = rag_serve.serve(tp, cfg, **RAG)
    want = _jax_rag(jp, jcfg, **RAG)
    assert got["size"] == want["size"] == sum(RAG.values())
    for key in ("hits", "misses", "traces"):
        assert got["cache"][key] == want["cache"][key], (got["cache"],
                                                         want["cache"])
    places = [(g, w) for gr, wr in zip(got["hits"], want["hits"])
              for g, w in zip(gr, wr)]
    assert len(got["hits"]) == len(want["hits"]) == 4
    assert len(places) == 12
    assert np.mean([g == w for g, w in places]) >= HIT_AGREEMENT, \
        (got["hits"], want["hits"])
    assert got["generated"] == want["generated"]


def test_rag_serve_main_builds_its_own_weights():
    """`main` draws the weights from a seeded generator: two runs agree."""
    a = rag_serve.main(device="cpu")
    b = rag_serve.main(device="cpu")
    assert a["hits"] == b["hits"] and a["generated"] == b["generated"]
    assert a["size"] == 512 + 256
    assert a["cache"]["hits"] >= 1 and a["cache"]["traces"] == 1
