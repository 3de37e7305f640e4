"""The port's dry-runs (`repro_torch.launch.dryrun`, `dryrun_anns`,
`report`) against the JAX package's.

* `input_structs`: JAX's shapes and dtypes for every runnable (arch x
  shape) cell (the port of `tests/test_launchers.py`'s check).
* Per-rank `argument_bytes` of a train cell at the 16 x 16 production mesh
  (one process as rank 0 of a `fake` 256-rank group): exactly the sum of
  `NamedSharding.shard_shape` bytes over JAX's sanitised train-state and
  batch shardings at the same `AbstractMesh`, for stablelm-1.6b,
  zamba2-2.7b and xlstm-125m.
* Full-width cells run to "ok": stablelm-1.6b and olmoe-1b-7b train_4k
  (single-pod), the MoE cell also with `--opt moe_local` (a slab a
  device, JAX's `_moe_shard_map`).
* `abstract_core`: JAX's field for field, shape and dtype, for every
  variant, dataset and mesh, with the shard count and per-shard capacity.
  JAX's `abstract_core` builds its `MutationState` without the `labels`
  plane that class requires (so JAX's ANNS dry-run stops there); the test
  gives it JAX's `init_mutation_state` labels, (rows, N_LABEL_BYTES)
  uint8, and the port holds the same.
* `report`'s tables: JAX's, character for character, on the same records.

JAX's `launch.dryrun*` modules set a 512-device XLA flag at import; they
are imported only after `jax.devices()` has started the backend, where the
flag has no effect.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import cell_is_runnable as jrunnable
from repro.configs import get_config as jget
from repro.launch import report as jreport
from repro.launch import shardings as jshd
from repro.models import model as jm
from repro.training import train_loop as jtl
from repro_torch.configs import ARCHS, SHAPES, cell_is_runnable, get_config
from repro_torch.launch import dryrun, dryrun_anns, report
from repro_torch.launch.mesh import production_layout


def _jax_dryruns():
    """JAX's dry-run modules, imported once the backend has started; the
    XLA flag their import sets is taken back out of the environment, so no
    later subprocess of this worker inherits it."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdr
    from repro.launch import dryrun_anns as jda
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return jdr, jda


def _dtype(dt) -> str:
    return str(dt).replace("torch.", "")


# ------------------------------------------------------------ input structs
def test_input_structs_equal_jax_for_every_runnable_cell():
    jdr, _ = _jax_dryruns()
    assert sorted(ARCHS) == sorted(JARCHS) and list(SHAPES) == list(JSHAPES)
    n = 0
    for name in sorted(ARCHS):
        for sname in SHAPES:
            ok, why = cell_is_runnable(get_config(name), SHAPES[sname])
            assert (ok, why) == jrunnable(jget(name), JSHAPES[sname])
            if not ok:
                continue
            got = dryrun.input_structs(get_config(name), SHAPES[sname])
            want = jdr.input_structs(jget(name), JSHAPES[sname])
            assert list(got) == list(want)
            for k in got:
                assert got[k].shape == want[k].shape
                assert _dtype(got[k].dtype) == str(want[k].dtype)
                assert all(d > 0 for d in got[k].shape)
            n += 1
    assert n == 31


# ------------------------------------------------------------ arguments
def _jax_train_argument_bytes(name: str, shape: str = "train_4k") -> int:
    """Sum of shard_shape bytes over JAX's sanitised train-state and batch
    shardings at the 16 x 16 AbstractMesh."""
    jdr, _ = _jax_dryruns()
    jcfg = jget(name)
    amesh = AbstractMesh((16, 16), ("data", "model"))
    state = jax.eval_shape(lambda k: jtl.init_train_state(
        jcfg, jm.init_params(jcfg, k)), jax.random.PRNGKey(0))
    s_shd = jshd.sanitize_shardings(jshd.train_state_shardings(amesh, jcfg),
                                    state, amesh)
    inputs = jdr.input_structs(jcfg, JSHAPES[shape])
    b_all = jshd.batch_shardings(amesh, jcfg)
    in_shd = {k: jshd.sanitize_shardings(b_all[k], inputs[k], amesh)
              for k in inputs}
    total = 0
    for tree, shd in ((state, s_shd), (inputs, in_shd)):
        leaves = jax.tree_util.tree_leaves(tree)
        shds = jax.tree_util.tree_leaves(
            shd, is_leaf=lambda s: isinstance(s, jax.sharding.NamedSharding))
        assert len(leaves) == len(shds)
        for x, sh in zip(leaves, shds):
            total += (math.prod(sh.shard_shape(x.shape))
                      * jnp.dtype(x.dtype).itemsize)
    return total


@pytest.fixture
def production_mesh():
    """Rank 0 of a fake 256-rank group and its 16 x 16 mesh; the group is
    destroyed after."""
    with dryrun.fake_world(*production_layout()) as mesh:
        yield mesh


def _port_train_argument_bytes(name: str, mesh) -> int:
    cfg = get_config(name)
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = dryrun._abstract_params(cfg, True)
        _, state_bytes = dryrun.sharded_train_state(model, mesh, cfg)
        global_in = {k: torch.zeros(st.shape, dtype=st.dtype) for k, st in
                     dryrun.input_structs(cfg, SHAPES["train_4k"]).items()}
        local = dryrun._local_inputs(global_in, mesh, cfg, None)
        return state_bytes + sum(t.numel() * t.element_size()
                                 for t in local.values())


@pytest.mark.parametrize("name", ["stablelm-1.6b", "zamba2-2.7b",
                                  "xlstm-125m"])
def test_train_argument_bytes_equal_jax_shard_shapes(name, production_mesh):
    assert (_port_train_argument_bytes(name, production_mesh)
            == _jax_train_argument_bytes(name))


def test_a_full_width_cell_runs_and_moe_training_is_unsupported(tmp_path):
    """stablelm-1.6b and olmoe-1b-7b train_4k at the single-pod mesh run
    to "ok" with the record's keys and JAX's argument bytes for stablelm:
    the parameters gathered a unit at a time and the gradients
    reduce-scattered (`models/fsdp.py`). (MoE training was refused under a
    mesh before `_moe_shard_map` and the global dispatch were ported; the
    test keeps its name.)"""
    recs = dryrun.run_cells(["stablelm-1.6b", "olmoe-1b-7b"], ["train_4k"],
                            multi_pod=False, out_dir=str(tmp_path))
    ok, moe = recs
    assert ok["status"] == "ok", ok.get("traceback")
    assert moe["status"] == "ok", moe.get("traceback")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "olmoe-1b-7b__train_4k__singlepod.json",
        "stablelm-1.6b__train_4k__singlepod.json"]
    assert ok["mesh"] == {"data": 16, "model": 16} and ok["n_chips"] == 256
    mem = ok["memory_per_device"]
    assert mem["argument_bytes"] == _jax_train_argument_bytes(
        "stablelm-1.6b")
    assert mem["temp_bytes"] > 0
    assert ok["cost_per_device"]["flops"] > 0
    for rec in recs:
        coll = rec["collectives_per_device"]
        # every unit's parameters all-gathered (again in the recompute),
        # every gradient reduce-scattered; only scalars, the
        # vocab-parallel loss' row statistics and the small gradients
        # summed over "model" (the norm scales', and a MoE router's
        # shards: (E, D/16) float32 a layer) all-reduced
        rcfg = get_config(rec["arch"])
        router = (rcfg.num_layers * rcfg.num_experts * rcfg.d_model // 16
                  * 4)
        assert coll["all-gather"]["bytes"] > 0
        assert coll["reduce-scatter"]["bytes"] > 0
        assert coll["all-reduce"]["bytes"] < 1e6 + router
    # float32 gathers: the blocks' parameters twice (the forward and the
    # remat recompute), the embedding and the head once, each over "data"
    # alone (a rank computes on its sixteenth over "model": heads, ff and
    # vocabulary columns); bf16 gathers: the sequence-parallel residual,
    # (16, 4,096, 2,048), before each attention and MLP, again in the
    # recompute and in the backward of their reduce-scatters, and before
    # the head and in the embedding's backward
    n = ok["n_params"]
    by_dtype = ok["collectives_by_dtype_per_device"]["all-gather"]
    assert 6 * n / 16 <= by_dtype["float32"] <= 9 * n / 16
    cfg = get_config("stablelm-1.6b")
    residual = 16 * 4096 * cfg.d_model * 2
    assert by_dtype["bfloat16"] == (6 * cfg.num_layers + 2) * residual
    kernels = ok["kernels_per_device"]
    layers = get_config("stablelm-1.6b").num_layers
    assert kernels["flash_attention_bwd"]["calls"] == layers
    assert moe["kernels_per_device"]["flash_attention_bwd"]["calls"] == \
        get_config("olmoe-1b-7b").num_layers
    assert ok["roofline"]["dominant"] in ("compute_s", "memory_s",
                                          "collective_s")
    assert 0 < ok["model_vs_hlo_flops"] < 1
    # the report reads the port's records: its wall time in the compile
    # column
    table = report.dryrun_table(
        report._load(os.path.join(tmp_path, "*.json")), "singlepod")
    assert "| stablelm-1.6b | train_4k | ok | " in table
    assert f"| {ok['run_s']}s | ag:" in table
    assert "| olmoe-1b-7b | train_4k | ok | " in table


def test_moe_local_runs(tmp_path, capsys):
    """JAX's --opt moe_local (a MoE config's `moe_dispatch_chunks = -1`: a
    slab a device) runs through the CLI: olmoe's train_4k cell at the
    single-pod mesh, recorded with the switch; a dense config is
    unchanged by it."""
    dryrun.main(["--opt", "moe_local", "--arch", "olmoe-1b-7b", "--shape",
                 "train_4k", "--out", str(tmp_path)])
    assert "1 ok, 0 skipped, 0 unsupported, 0 errors" in \
        capsys.readouterr().out
    with open(tmp_path / "olmoe-1b-7b__train_4k__singlepod.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["opts"] == ["moe_local"]
    assert rec["collectives_per_device"]["reduce-scatter"]["bytes"] > 0


@pytest.mark.parametrize("opt", ["no_sp"])
def test_switches_the_port_lacks_are_refused(opt, tmp_path, capsys):
    """JAX's --opt no_sp (refused while the port had no tensor-parallel
    step; the test keeps its name) now runs: stablelm-1.6b's train_4k cell
    through the CLI, recorded with the switch, its residual whole on every
    rank of the model axis: the activations' sums over "model" are
    all-reduces of a (16, 4,096, 2,048) bf16 residual, no bf16 gather or
    reduce-scatter remains, and the parameters' gathers are the
    sequence-parallel cell's."""
    dryrun.main(["--opt", opt, "--arch", "stablelm-1.6b", "--shape",
                 "train_4k", "--out", str(tmp_path)])
    assert "1 ok, 0 skipped, 0 unsupported, 0 errors" in \
        capsys.readouterr().out
    with open(tmp_path / "stablelm-1.6b__train_4k__singlepod.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["opts"] == [opt]
    by_dtype = rec["collectives_by_dtype_per_device"]
    cfg = get_config("stablelm-1.6b")
    residual = 16 * 4096 * cfg.d_model * 2
    # a block: the attention's and the MLP's sums in the forward and the
    # backward, the attention's again in the recompute (which stops at the
    # last tensor the backward needs, before the MLP's sum); the
    # embedding's sum and the head's gradient
    assert by_dtype["all-reduce"]["bfloat16"] == \
        (5 * cfg.num_layers + 2) * residual
    assert "bfloat16" not in by_dtype["all-gather"]
    assert "bfloat16" not in by_dtype["reduce-scatter"]
    n = rec["n_params"]
    assert 6 * n / 16 <= by_dtype["all-gather"]["float32"] <= 9 * n / 16


# ------------------------------------------------------------ ANNS cores
def _jax_core(jda, variant, n_shards, cap, d, bits=4):
    """JAX's abstract core as `lower_anns_cell` builds it for `variant`,
    with the labels plane its `MutationState` needs."""
    from repro.core.mutations import N_LABEL_BYTES, MutationState

    def mutation_state(**kw):
        rows = kw["free_ids"].shape[0]
        return MutationState(labels=jax.ShapeDtypeStruct(
            (rows, N_LABEL_BYTES), jnp.uint8), **kw)

    orig = jda.MutationState
    jda.MutationState = mutation_state
    try:
        quantized = variant.startswith("rabitq")
        rerank = variant == "rabitq_rerank"
        return jda.abstract_core(
            n_shards, cap, d,
            vec_dtype=jnp.bfloat16 if variant == "exact_bf16" else jnp.float32,
            vec_dims=(1 if quantized and not rerank else None),
            quantized=quantized, bits=bits)
    finally:
        jda.MutationState = orig


def _fields(core) -> dict:
    out = {}
    for name in ("vectors", "vec_sqnorm", "adjacency", "n_valid", "medoid"):
        out[name] = getattr(core, name)
    for name in ("tombstone_bits", "labels", "free_ids", "n_free",
                 "n_deleted", "generation"):
        out["mut." + name] = getattr(core.mut, name)
    if core.codes is not None:
        for name in ("packed", "data_add", "data_rescale"):
            out["codes." + name] = getattr(core.codes, name)
        out["rq.rotation"] = core.rq_params.rotation
        out["rq.centroid"] = core.rq_params.centroid
    return {k: (tuple(v.shape), _dtype(v.dtype)) for k, v in out.items()}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("variant", [v for v in dryrun_anns.VARIANTS
                                     if v != "bruteforce"])
def test_abstract_core_equals_jax(variant, multi_pod):
    from repro.configs.base import ANNS_DATASETS as JDATASETS
    _, jda = _jax_dryruns()
    shape, axes = (((2, 16, 16), ("pod", "data", "model")) if multi_pod
                   else ((16, 16), ("data", "model")))
    amesh = AbstractMesh(shape, axes)
    mesh = dryrun_anns.production_mesh(multi_pod)
    assert set(dryrun_anns.ANNS_DATASETS) == set(JDATASETS)
    for ds_name, ds in dryrun_anns.ANNS_DATASETS.items():
        assert ds.full_n == JDATASETS[ds_name].full_n
        # JAX's lower_anns_cell: rows over every axis but "model"
        n_shards = 1
        for ax in (a for a in amesh.axis_names if a != "model"):
            n_shards *= amesh.shape[ax]
        cap = -(-ds.full_n // n_shards)
        cap += (-cap) % 8
        spec, got_shards, got_cap = dryrun_anns.shard_geometry(ds.full_n,
                                                               mesh)
        assert (got_shards, got_cap) == (n_shards, cap)
        assert spec.row_axes == axes[:-1] and spec.query_axis == "model"
        d = ds.dims + (1 if ds.metric == "mips" else 0)
        want = _jax_core(jda, variant, n_shards, cap, d)
        with FakeTensorMode():
            got = dryrun_anns.variant_core(variant, n_shards, cap, d)
        assert _fields(got) == _fields(want)
        if got.codes is not None:
            assert (got.codes.bits, got.codes.dims) == (want.codes.bits,
                                                        want.codes.dims)
            assert got.rq_params.bits == want.rq_params.bits


# ------------------------------------------------------------ report
def _records() -> tuple[list, list]:
    roof = {"compute_s": 0.8187, "memory_s": 1.2729, "collective_s": 0.0301,
            "dominant": "memory_s", "bound_s": 1.2729,
            "roofline_fraction": 0.6432}
    coll = {"all-gather": {"bytes": 6.9e9, "count": 389.0},
            "all-reduce": {"bytes": 6.5e9, "count": 221.0},
            "reduce-scatter": {"bytes": 0.0, "count": 0.0},
            "total": {"bytes": 13.4e9, "count": 610.0}}
    lm = [
        {"_file": "a__train_4k__singlepod.json", "status": "ok", "arch": "a",
         "shape": "train_4k", "memory_per_device": {"total_gb": 136.3},
         "collectives_per_device": coll, "roofline": roof,
         "model_vs_hlo_flops": 0.0499, "compile_s": 12.5},
        {"_file": "a__decode_32k__singlepod.json", "status": "ok",
         "arch": "a", "shape": "decode_32k",
         "memory_per_device": {"total_gb": 0.4},
         "collectives_per_device": coll,
         "roofline": dict(roof, dominant="collective_s", bound_s=0.2),
         "model_vs_hlo_flops": None},
        {"_file": "b__long_500k__singlepod.json", "status": "skipped",
         "arch": "b", "shape": "long_500k",
         "reason": "pure full-attention arch: 500k decode needs sub-q"},
        {"_file": "c__train_4k__multipod.json", "status": "error",
         "arch": "c", "shape": "train_4k"},
        {"_file": "a__train_4k__singlepod_opt.json", "status": "ok",
         "arch": "a", "shape": "train_4k",
         "memory_per_device": {"total_gb": 1.0},
         "collectives_per_device": coll,
         "roofline": dict(roof, dominant="compute_s"),
         "model_vs_hlo_flops": 1.7}]
    anns = [
        {"_file": "bigann__exact__singlepod.json", "status": "ok",
         "dataset": "bigann", "variant": "exact",
         "memory_per_device_gb": 4.578, "queries_per_sec_at_roof": 1.154e5,
         "roofline": dict(roof, bound_s=0.0009)},
        {"_file": "deep__rabitq__multipod.json", "status": "error",
         "dataset": "deep", "variant": "rabitq"}]
    return lm, anns


@pytest.mark.parametrize("x", [None, 0.0, 0.0004, 0.25, 1.0, 37.125])
def test_fmt_seconds_equals_jax(x):
    assert report.fmt_seconds(x) == jreport.fmt_seconds(x)


@pytest.mark.parametrize("tag", ["singlepod", "multipod", "singlepod_opt"])
def test_report_tables_equal_jax(tag):
    lm, anns = _records()
    assert report.dryrun_table(lm, tag) == jreport.dryrun_table(lm, tag)
    assert report.roofline_table(lm, tag) == jreport.roofline_table(lm, tag)
    assert report.anns_table(anns) == jreport.anns_table(anns)


# ------------------------------------------------------------ the backend
@pytest.fixture
def gloo_world_of_one():
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture
def fake_world_of_one():
    with dryrun.fake_world((1, 1), ("data", "model")) as mesh:
        yield mesh


def test_a_gloo_group_still_refuses_a_cuda_mesh(gloo_world_of_one,
                                                monkeypatch):
    """The backend check itself (the card resolved without one): a gloo
    group under a cuda mesh raises naming NCCL."""
    from repro_torch.launch import mesh as tmesh
    monkeypatch.setattr(tmesh, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    with pytest.raises(RuntimeError, match="takes nccl"):
        tmesh.make_debug_mesh(1, 1)


def test_the_fake_backend_only_where_the_dry_run_asks(fake_world_of_one,
                                                      monkeypatch):
    """Only the dry-run's `fake_world` builds a mesh on the fake group;
    the launchers' CPU and cuda meshes refuse it, as they refuse any
    backend not their device's."""
    from repro_torch.launch import mesh as tmesh
    assert fake_world_of_one.mesh_dim_names == ("data", "model")
    with pytest.raises(RuntimeError, match="takes gloo"):
        tmesh.make_debug_mesh(1, 1, device="cpu")
    monkeypatch.setattr(tmesh, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    with pytest.raises(RuntimeError, match="takes nccl"):
        tmesh.make_debug_mesh(1, 1)
    with pytest.raises(RuntimeError, match="takes nccl"):
        tmesh.init_distributed()


def test_the_gloo_group_refuses_the_dry_run(gloo_world_of_one):
    with pytest.raises(RuntimeError, match="already initialised"):
        with dryrun.fake_world(*production_layout()):
            pass
