"""Port parity of the mesh half: the logical-axis rules
(`models/sharding_ctx.py`), the spec trees (`param_specs`, `state_specs`,
`train_state_specs`), their port layout (`models/convert.py`
`named_specs`) and the shardings of `launch/shardings.py`, against the
JAX package's.

No process group is needed: specs resolve on the port's one-device
`launch.mesh.Mesh` (axis names and sizes) and JAX's `AbstractMesh` of
the same shape, so the production meshes (16 x 16, 2 x 16 x 16) are
held without 256 processes. Shapes come from `jax.eval_shape` of JAX's
`init_params` at full width, carried into the port's layout by
`models/convert.py` `_leaves` (stacked axes dropped, matrices
transposed). Everything compares exactly.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as jget
from repro.launch import shardings as jshd
from repro.models import model as jm
from repro.models import sharding_ctx as jctx
from repro.training import train_loop as jtl
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as tm
from repro_torch.models import sharding_ctx as ctx
from repro_torch.models.convert import _leaves, named_specs
from repro_torch.training.train_loop import TrainState, train_state_specs

NAMES = sorted(ARCHS)
MESHES = {"debug": ((2, 2), ("data", "model")),
          "production": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}


def meshes(kind):
    shape, axes = MESHES[kind]
    return make_mesh(shape, axes, device="cpu"), AbstractMesh(shape, axes)


def jspec(ns) -> tuple:
    return tuple(ns.spec)


def jleaves(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda s: isinstance(s, jax.sharding.NamedSharding))


def port_layout(jax_tree, cfg, leaf=lambda x: x) -> dict:
    """A JAX-layout tree of shardings or shapes keyed by the port's names
    (stacked axes dropped, matrices transposed)."""
    out = {}
    for name, path, index, transposed in _leaves(cfg):
        node = jax_tree
        for key in path:
            node = node[key]
        t = tuple(leaf(node))[len(index):]
        out[name] = t[::-1] if transposed else t
    return out


def abstract_state(name):
    jcfg = jget(name)
    return jax.eval_shape(lambda k: jtl.init_train_state(
        jcfg, jm.init_params(jcfg, k)), jax.random.PRNGKey(0))


def port_state_shapes(name) -> TrainState:
    cfg = get_config(name)
    s = abstract_state(name)
    shape = port_layout(s.params, cfg, lambda a: a.shape)
    opt = s.opt_state
    return TrainState(shape, {
        "m": port_layout(opt["m"], cfg, lambda a: a.shape),
        "v": port_layout(opt["v"], cfg, lambda a: a.shape), "step": ()})


# ---------------------------------------------------------------- rules
def test_default_rules_equal_jax():
    assert ctx.DEFAULT_RULES == jctx.DEFAULT_RULES


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_rules_logical_to_spec_and_shard_count(kind):
    mesh, amesh = meshes(kind)
    assert ctx.current_rules() is None and ctx.logical_to_spec(("x",)) == ()
    with ctx.sharding_rules(mesh), jctx.sharding_rules(amesh):
        assert ctx.current_rules() == jctx.current_rules()
        assert ctx.current_mesh() is mesh
        for name in ctx.DEFAULT_RULES:
            assert ctx.shard_count(name) == jctx.shard_count(name), name
            names = (name, None, "batch")
            assert ctx.logical_to_spec(names) == tuple(
                jctx.logical_to_spec(names))
    assert ctx.current_rules() is None and ctx.current_mesh() is None
    over = {"res_seq": None, "batch": ("data", "pod")}
    with ctx.sharding_rules(mesh, over), jctx.sharding_rules(amesh, over):
        assert ctx.current_rules() == jctx.current_rules()
    assert shd.resolve_rules(mesh, over) == jshd.resolve_rules(amesh, over)


# (shape, logical names): divisible and not, first come first served,
# several mesh axes on one dimension
CONSTRAIN_CASES = [
    ((8, 4096, 2048), ("batch", "res_seq", "act_embed")),
    ((8, 4096, 36, 64), ("batch", "seq", "act_heads", None)),
    ((8, 4096, 4, 128), ("batch", "seq", "act_kv", None)),
    ((3, 4096, 5632), ("batch", "seq", "act_ff")),
    ((64, 512, 2048), ("moe_chunk", "expert", "act_embed")),
    ((64, 8, 640, 2048), ("moe_chunk", "expert", "expert_cap", None)),
    ((8, 1000, 32000), ("batch", "seq", "act_vocab")),
    ((32, 4096, 2048), ("batch", "attn_seq", None)),
    ((2, 6), ("batch", "kv_seq")),
]


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("case", range(len(CONSTRAIN_CASES)))
def test_resolve_spec_matches_constrain(kind, case, monkeypatch):
    """`resolve_spec` is what JAX's `constrain` hands
    `with_sharding_constraint` (captured in place of the call)."""
    shape, names = CONSTRAIN_CASES[case]
    mesh, amesh = meshes(kind)
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(s) or x)
    with jctx.sharding_rules(amesh):
        jctx.constrain(jax.ShapeDtypeStruct(shape, np.float32), names)
        want = tuple(seen[0].spec)
    with ctx.sharding_rules(mesh):
        got = ctx.resolve_spec(shape, names, ctx.current_rules(), mesh)
        # a plain tensor passes through constrain untouched
        x = torch.zeros(2, 2)
        assert ctx.constrain(x, ("batch", None)) is x
    assert got == want


def test_placements_major_to_minor():
    mesh, _ = meshes("multi_pod")
    assert ctx.placements_of(mesh, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert ctx.placements_of(mesh, (None, "data")) == (
        Replicate(), Shard(1), Replicate())
    assert ctx.placements_of(mesh, ()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        ctx.placements_of(mesh, (("data", "pod"),))
    with pytest.raises(ValueError, match="twice"):
        ctx.placements_of(mesh, ("data", "data"))


def test_local_shard_slices_in_mesh_order():
    """A dimension over ("pod", "data") is split pod-major, then the
    model split of another dimension: the slices of JAX's
    `devices_indices_map` for those coordinates."""
    mesh, _ = meshes("debug")
    full = torch.arange(8 * 6).reshape(8, 6)
    pl = ctx.placements_of(mesh, ("model", "data"))
    for i in range(2):
        for j in range(2):
            got = ctx.local_shard(full, mesh, pl, (i, j))
            assert torch.equal(got, full[4 * j:4 * j + 4, 3 * i:3 * i + 3])
    m3 = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    pl = ctx.placements_of(m3, (("pod", "data"), None))
    for p in range(2):
        for d in range(2):
            got = ctx.local_shard(full, m3, pl, (p, d, 1))
            k = 2 * p + d
            assert torch.equal(got, full[2 * k:2 * k + 2])
    with pytest.raises(ValueError, match="split"):
        ctx.local_shard(torch.zeros(3, 4), mesh, (Shard(0), Replicate()),
                        (0, 0))


# ----------------------------------------------------------- spec trees
@pytest.mark.parametrize("name", NAMES)
def test_param_specs_equal_jax_and_map_to_port_layout(name):
    cfg, jcfg = get_config(name).reduced(), jget(name).reduced()
    specs = tm.param_specs(cfg)
    assert specs == jm.param_specs(jcfg)
    # each port parameter's names pair with its dimensions as JAX's do
    shapes = jax.eval_shape(lambda k: jm.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    named = named_specs(specs, cfg)
    model = tm.init_params(cfg, 0, device="cpu")
    params = dict(model.named_parameters())
    assert set(named) == set(params)
    for port, path, index, transposed in _leaves(cfg):
        spec, shape = specs, shapes
        for key in path:
            spec, shape = spec[key], shape[key]
        pairs = list(zip(spec[len(index):], shape.shape[len(index):]))
        if transposed:
            pairs = pairs[::-1]
        assert list(zip(named[port], params[port].shape)) == pairs, port


@pytest.mark.parametrize("name", NAMES)
def test_state_specs_equal_jax_and_fit_decode_state(name):
    cfg, jcfg = get_config(name).reduced(), jget(name).reduced()
    if cfg.is_encoder:
        with pytest.raises(ValueError):
            tm.state_specs(cfg)
        with pytest.raises(ValueError):
            jm.state_specs(jcfg)
        return
    specs = tm.state_specs(cfg)
    assert specs == jm.state_specs(jcfg)
    state = tm.init_decode_state(cfg, 2, 16, device="cpu")

    def fits(spec, leaf):
        if isinstance(spec, dict):
            assert set(spec) == set(leaf)
            for k in spec:
                fits(spec[k], leaf[k])
        else:
            assert len(spec) == getattr(leaf, "ndim", 0)
    fits(specs, state)


@pytest.mark.parametrize("name", NAMES)
def test_train_state_specs_equal_jax(name):
    cfg, jcfg = get_config(name), jget(name)
    ts = train_state_specs(tm.param_specs(cfg))
    jts = jtl.train_state_specs(jm.param_specs(jcfg))
    assert ts.params == jts.params and ts.opt_state == jts.opt_state


# ------------------------------------------------------------ shardings
@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_train_state_shardings_equal_jax(name, kind):
    """train_state_shardings, then sanitize_shardings at the full width's
    shapes: every spec equals JAX's, carried into the port's layout."""
    cfg = get_config(name)
    mesh, amesh = meshes(kind)
    s_shd = shd.train_state_shardings(mesh, cfg)
    j_shd = jshd.train_state_shardings(amesh, jget(name))
    assert {n: s.spec for n, s in shd.param_shardings(mesh, cfg).items()} \
        == port_layout(jshd.param_shardings(amesh, jget(name)), cfg, jspec)
    san = shd.sanitize_shardings(s_shd, port_state_shapes(name), mesh)
    jsan = jshd.sanitize_shardings(j_shd, abstract_state(name), amesh)
    for tree, jtree in ((s_shd, j_shd), (san, jsan)):
        assert tree.opt_state["step"].spec == jspec(jtree.opt_state["step"])
        for key, got, want in (("params", tree.params, jtree.params),
                               ("m", tree.opt_state["m"],
                                jtree.opt_state["m"]),
                               ("v", tree.opt_state["v"],
                                jtree.opt_state["v"])):
            spec = {n: s.spec for n, s in got.items()}
            assert spec == port_layout(want, cfg, jspec), key
            for s in got.values():
                assert s.mesh is mesh
                s.placements                   # resolves on the mesh


@pytest.mark.parametrize("kind", ["debug", "production"])
@pytest.mark.parametrize("name", NAMES)
def test_decode_batch_logits_shardings_equal_jax(name, kind):
    cfg, jcfg = get_config(name), jget(name)
    mesh, amesh = meshes(kind)
    for over in (None, {"kv_seq": None}):
        if cfg.is_encoder:
            break
        got = shd.decode_state_shardings(mesh, cfg, over)
        want = jshd.decode_state_shardings(amesh, jcfg, over)
        flat = jax.tree_util.tree_leaves(got, is_leaf=lambda s: isinstance(
            s, shd.NamedSharding))
        assert [s.spec for s in flat] == [jspec(s) for s in jleaves(want)]
        assert jax.tree_util.tree_structure(
            got, is_leaf=lambda s: isinstance(s, shd.NamedSharding)) \
            == jax.tree_util.tree_structure(want, is_leaf=lambda s: isinstance(
                s, jax.sharding.NamedSharding))
    got = shd.batch_shardings(mesh, cfg)
    want = jshd.batch_shardings(amesh, jcfg)
    assert {k: s.spec for k, s in got.items()} == {
        k: jspec(s) for k, s in want.items()}
    assert shd.logits_sharding(mesh).spec == jspec(
        jshd.logits_sharding(amesh))
    assert shd.replicated(mesh).spec == jspec(jshd.replicated(amesh)) == ()
