"""Guards of the PyTorch/CUDA port (`src/repro_torch`).

  * the package imports neither JAX nor the JAX package: every submodule
    imports in a subprocess whose import system refuses `jax`, `jaxlib`
    and `repro`;
  * `chip_smoke.py` imports neither;
  * no silent CPU fallback: with no GPU, entry points raise unless
    `device="cpu"` is given, and kernel wrappers run their plain version
    only for CPU tensors (any other device raises).
"""

import ast
import os
import pkgutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors gain nothing from intra-op threads; one thread keeps
    this file from competing with the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _submodules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_package_has_the_slice_modules():
    mods = set(_submodules())
    for name in ("core.rabitq", "core.vamana", "core.medoid",
                 "core.distances", "core.mutations", "core.robust_prune",
                 "core.beam_search", "core.construction", "core.search_spec",
                 "core.index_core", "core.index", "data.synthetic",
                 "kernels.build", "kernels.distance.ops",
                 "kernels.rabitq_dot.ops", "kernels.search_step.ops",
                 "kernels.search_step.ref", "kernels.topk.ops",
                 "configs", "configs.base", "configs.starcoder2_7b",
                 "kernels.flash_attention.ops", "kernels.flash_attention.ref",
                 "models.layers", "models.attention", "models.model",
                 "models.convert", "serving.serve_loop", "serving.rag",
                 "launch.serve", "training", "training.optimizer",
                 "training.train_loop", "training.checkpoint",
                 "launch.train", "core.plans", "obs", "obs.tracing",
                 "obs.metrics", "serving.loadgen", "serving.scheduler",
                 "serving.anns_service", "core.storage", "core.pq",
                 "core.distributed", "core.resharding", "launch.mesh",
                 "models.moe", "models.ssm", "models.sharding_ctx",
                 "launch.shardings", "training.compression",
                 "training.dp_step", "examples.quickstart",
                 "examples.streaming_updates", "examples.rag_serve",
                 "examples.train_lm"):
        assert f"repro_torch.{name}" in mods, name


def test_imports_without_jax_or_repro():
    """Every submodule imports with jax, jaxlib and repro blocked."""
    code = textwrap.dedent(f"""
        import importlib, importlib.abc, sys
        BLOCKED = ("jax", "jaxlib", "repro")

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked import of {{name}}")
                return None

        sys.meta_path.insert(0, Block())
        for mod in {_submodules()!r}:
            importlib.import_module(mod)
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in BLOCKED)
        assert not leaked, leaked
        print("ok", len({_submodules()!r}))
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", ["chip_smoke.py", "src/repro_torch"])
def test_no_jax_or_repro_import_statements(path):
    """No import statement of jax/jaxlib/repro anywhere in the port or in
    chip_smoke.py (static check, including function-local imports)."""
    full = os.path.join(REPO, path)
    files = ([full] if full.endswith(".py") else
             [os.path.join(d, f) for d, _, fs in os.walk(full)
              for f in fs if f.endswith(".py")])
    assert files
    for fname in files:
        tree = ast.parse(open(fname).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    f"{fname} imports {n}"


def test_tf32_is_off():
    import repro_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Alone in a directory (and, here, with no CUDA device) the script
    exits non-zero and prints no result line."""
    import shutil
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# ------------------------------------------------------------ no fallback
def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_gpu(monkeypatch):
    from repro_torch.core.index import JasperIndex
    from repro_torch.core.index_core import core_from_arrays, init_core
    from repro_torch.device import resolve_device
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        JasperIndex(8, 16)
    with pytest.raises(RuntimeError):
        init_core(16, 8, 4)
    arrays = {"vectors": np.zeros((16, 8), np.float32),
              "adjacency": np.full((16, 4), -1, np.int32),
              "n_valid": np.int32(0), "medoid": np.int32(0)}
    with pytest.raises(RuntimeError):
        core_from_arrays(arrays, bits=4, store_dims=8, quantized=False)
    # explicit CPU works
    idx = JasperIndex(8, 16, device="cpu")
    assert idx.core.vectors.device.type == "cpu"
    assert init_core(16, 8, 4, device="cpu").adjacency.shape == (16, 4)


def test_sharded_mesh_needs_the_card(monkeypatch):
    """The sharded index's mesh resolves to the card unless "cpu" is
    given; a mesh over cards the machine lacks is refused."""
    from repro_torch.core.distributed import ShardedJasperIndex
    from repro_torch.launch.mesh import make_mesh
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh((4, 2), ("data", "model"))
    with pytest.raises(RuntimeError):
        make_mesh((4,), ("data",), device="cuda")
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    assert mesh.shape == {"data": 4, "model": 2}
    idx = ShardedJasperIndex(mesh, 8, 16)
    assert idx.n_shards == 4 and idx.core.adjacency.device.type == "cpu"
    assert idx.core.adjacency.shape == (64, 64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="past the 1 CUDA"):
        make_mesh((2,), ("data",), device=["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="distinct"):
        make_mesh((2, 2), ("data", "data"), device="cpu")


def test_lm_entry_points_raise_without_gpu(monkeypatch):
    """The serving slice's entry points: the card, or the CPU only when
    asked for."""
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve
    from repro_torch.models import model as tm
    from repro_torch.serving.rag import RagPipeline
    _no_cuda(monkeypatch)
    cfg = dataclasses.replace(ARCHS["stablelm-1.6b"].reduced(),
                              dtype="float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.init_decode_state(cfg, 1, 8)
    params = tm.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RagPipeline(params, cfg, capacity=16)
    assert RagPipeline(params, cfg, capacity=16,
                       device="cpu").index.device.type == "cpu"
    argv = ["--arch", "stablelm-1.6b", "--reduced", "--batch", "2",
            "--prompt-len", "8", "--new-tokens", "3"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(argv)
    assert serve.main(argv + ["--device", "cpu"]).shape == (2, 11)


def test_training_entry_points_raise_without_gpu(monkeypatch):
    """The training slice's entry points: the card, or the CPU only when
    asked for."""
    import argparse
    from repro_torch.configs import ARCHS
    from repro_torch.launch import train
    from repro_torch.models import model as tm
    from repro_torch.training import init_train_state
    _no_cuda(monkeypatch)
    cfg = ARCHS["minicpm-2b"].reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(cfg, tm.init_params(cfg, 0,
                                             param_dtype=torch.float32))
    state = init_train_state(cfg, tm.init_params(
        cfg, 0, device="cpu", param_dtype=torch.float32))
    assert state.opt_state["m"]["embed.table"].device.type == "cpu"
    args = argparse.Namespace(
        arch="minicpm-2b", reduced=True, steps=1, batch=2, seq=16, lr=1e-3,
        grad_accum=1, seed=0, mesh="none", ckpt_dir=None, ckpt_every=10,
        resume=False, log_every=1, device=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.run(args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "minicpm-2b", "--reduced", "--steps", "1"])
    args.device = "cpu"
    assert train.run(args)["steps"] == 1


def test_examples_raise_without_gpu(monkeypatch, tmp_path):
    """Each example's `main`: the card, or the CPU only when asked for."""
    from repro_torch.examples import (quickstart, rag_serve,
                                      streaming_updates, train_lm)
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main(n=64, dims=8, n_queries=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.cli([])
    for mode in (["--churn", "--quick"], ["--churn", "--quick",
                                          "--sharded"],
                 ["--reshard", "--quick"], ["--serve", "--quick"],
                 ["--tenants", "--quick"], ["--tiered", "--quick"],
                 ["--quick"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            streaming_updates.main(mode)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        streaming_updates.mesh_devices()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rag_serve.main()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rag_serve.cli([])
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_lm.main(["--steps", "1"], ckpt_dir=ckpt)
    # asked for the CPU, they run there
    out = quickstart.main(n=300, dims=16, n_queries=8, device="cpu")
    assert out["device"] == "cpu" and out["size"] == 1300
    assert streaming_updates.mesh_devices("cpu") == ["cpu"] * 8
    assert train_lm.main(["--steps", "1", "--device", "cpu"],
                         ckpt_dir=ckpt)["steps"] == 1


def test_kernel_build_refuses_without_gpu(monkeypatch):
    from repro_torch.kernels import build
    _no_cuda(monkeypatch)
    build._libs.clear()
    with pytest.raises(RuntimeError, match="CUDA device"):
        build.load("gather_l2")


def _wrapper_inputs(device):
    rng = np.random.default_rng(0)
    n, d, q, k, bits = 64, 16, 3, 5, 4

    def t(x):
        return torch.as_tensor(x, device=device)

    packed = t(rng.integers(0, 256, (n, d * bits // 8), dtype=np.uint8))
    table = t(rng.normal(size=(n, d)).astype(np.float32))
    ids = t(rng.integers(-1, n, (q, k)).astype(np.int32))
    qv = t(rng.normal(size=(q, d)).astype(np.float32))
    vec = t(rng.normal(size=(n,)).astype(np.float32))
    qs = t(rng.normal(size=(q,)).astype(np.float32))
    return dict(packed=packed, table=table, ids=ids, q=qv, vec=vec, qs=qs,
                n=n, bits=bits)


def _call_wrappers(x):
    from repro_torch.kernels.distance.ops import (gather_l2, gather_l2_tiled,
                                                  pairwise_l2)
    from repro_torch.kernels.rabitq_dot.ops import (
        rabitq_distance, rabitq_gather_distance, rabitq_search_step)
    from repro_torch.kernels.search_step.ops import fused_hop, fused_search
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_bwd, flash_attention_fwd)
    from repro_torch.kernels.topk.ops import topk
    out = {}
    out["gather_l2"] = lambda: gather_l2(x["q"], x["table"],
                                         x["vec"].abs(), x["ids"])
    out["gather_l2_tiled"] = lambda: gather_l2_tiled(
        x["q"], x["table"], x["vec"].abs(), x["ids"])
    out["pairwise_l2"] = lambda: pairwise_l2(x["q"], x["table"])
    out["rabitq_distance"] = lambda: rabitq_distance(
        x["packed"], x["vec"], x["vec"], x["q"], x["qs"], x["qs"],
        bits=x["bits"])
    safe = x["ids"].clamp(min=0).long()
    out["rabitq_gather_distance"] = lambda: rabitq_gather_distance(
        x["packed"][safe], x["vec"][safe], x["vec"][safe], x["q"], x["qs"],
        x["qs"], bits=x["bits"])
    out["rabitq_search_step"] = lambda: rabitq_search_step(
        x["ids"], x["packed"], x["vec"], x["vec"], x["n"], x["q"], x["qs"],
        x["qs"], bits=x["bits"])
    q, k = x["ids"].shape
    dev = x["ids"].device
    f_ids = torch.full((q, k), -1, dtype=torch.int32, device=dev)
    f_ids[:, 0] = 0
    f_d = torch.full((q, k), float("inf"), device=dev)
    f_d[:, 0] = 1.0
    adj = x["ids"].new_zeros((x["n"], 4)) - 1
    out["fused_search"] = lambda: fused_search(
        f_ids, f_d, torch.zeros_like(f_ids),
        torch.full((4,), k, dtype=torch.int32, device=dev), x["q"],
        x["qs"], x["qs"], adj, x["packed"], x["vec"], x["vec"], None, None,
        None, x["n"], quantized=True, bits=x["bits"], max_iters=4)
    out["fused_hop"] = lambda: fused_hop(
        f_ids, f_d, torch.zeros_like(f_ids), k, x["q"], x["qs"], x["qs"], adj,
        x["packed"], x["vec"], x["vec"], None, None, None, x["n"],
        quantized=True, bits=x["bits"])
    out["topk"] = lambda: topk(f_d, f_ids, 2)
    rng = np.random.default_rng(1)
    fq, fk, fv = (torch.as_tensor(rng.normal(size=(1, 70, hh, 32)).astype(
        np.float32)).to(dev) for hh in (6, 2, 2))
    out["flash_attention"] = lambda: flash_attention(fq, fk, fv, block_q=64,
                                                     block_kv=64)
    out["flash_attention_fwd"] = lambda: flash_attention_fwd(
        fq, fk, fv, block_q=64, block_kv=64)
    fo = torch.zeros_like(fq)
    lse = torch.zeros((1, 6, 70), device=dev)
    out["flash_attention_bwd"] = lambda: flash_attention_bwd(
        fq, fk, fv, fo, lse, fo, block_q=64, block_kv=64)
    return out


@pytest.mark.parametrize("name", ["gather_l2", "rabitq_search_step",
                                  "fused_search", "fused_hop", "topk",
                                  "gather_l2_tiled", "pairwise_l2",
                                  "rabitq_distance",
                                  "rabitq_gather_distance",
                                  "flash_attention", "flash_attention_fwd",
                                  "flash_attention_bwd"])
def test_wrappers_plain_only_on_cpu(name, monkeypatch):
    """CPU tensors take the plain version (no build, no launch counted);
    tensors on any other non-CUDA device raise rather than fall back."""
    _no_cuda(monkeypatch)
    from repro_torch.kernels import build
    build._libs.clear()
    fn = _call_wrappers(_wrapper_inputs("cpu"))[name]
    wrapper = {"gather_l2": "repro_torch.kernels.distance.ops",
               "gather_l2_tiled": "repro_torch.kernels.distance.ops",
               "pairwise_l2": "repro_torch.kernels.distance.ops",
               "rabitq_search_step": "repro_torch.kernels.rabitq_dot.ops",
               "rabitq_distance": "repro_torch.kernels.rabitq_dot.ops",
               "rabitq_gather_distance": "repro_torch.kernels.rabitq_dot.ops",
               "fused_search": "repro_torch.kernels.search_step.ops",
               "fused_hop": "repro_torch.kernels.search_step.ops",
               "topk": "repro_torch.kernels.topk.ops",
               "flash_attention": "repro_torch.kernels.flash_attention.ops",
               "flash_attention_fwd":
                   "repro_torch.kernels.flash_attention.ops",
               "flash_attention_bwd":
                   "repro_torch.kernels.flash_attention.ops"}[name]
    mod = __import__(wrapper, fromlist=[name])
    before = getattr(mod, name).launches
    out = fn()
    assert getattr(mod, name).launches == before
    assert not build._libs
    first = out[0] if isinstance(out, tuple) else out
    assert first.device.type == "cpu"
    meta_fn = _call_wrappers(_wrapper_inputs("meta"))[name]
    with pytest.raises(ValueError, match="cuda or cpu"):
        meta_fn()
