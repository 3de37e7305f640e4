"""The port's MoE under a mesh (`models/moe.py` `_moe_global` and
`_moe_slabs`, JAX's `_moe_shard_map`) in four `gloo` processes on the 2 x 2
("data", "model") debug mesh, against the JAX package on four fake XLA
devices (`--xla_force_host_platform_device_count=4`, one subprocess for the
module).

The reduced granite-moe-1b-a400m and olmoe-1b-7b (4 experts, top 2), float32,
`capacity_factor=0.5`, so routes are dropped: each manual-SPMD slab holds 8
slots where the global buffer holds 16, and the two modes give different
outputs (the count prefix of the global dispatch shows only where routes
drop).

  * `moe_with_aux` alone, each rank on its rows of a (4, 16) batch, in both
    modes (`moe_dispatch_chunks` 0 and -1), against JAX's jitted call under
    `sharding_rules(mesh)`: every route's position and keep bit-equal to
    JAX's formula over the global chunk or the slab, outputs and the summed
    aux shares within rtol 1e-5 / atol 1e-5; the manual-SPMD fallbacks of
    JAX's shape rules (S = 1 with B over data + model and over data only; a
    batch that does not split over data, run as the whole batch on every
    rank);
  * two sharded train steps (`make_sharded_train_step`, grad_accum 1 and 2)
    against JAX's jitted step on the same mesh: parameters within 2e-4;
  * the launcher under `torchrun --nproc-per-node 4 --mesh debug` for both
    architectures in both modes.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_dp_step import _env, run_ranks

pytestmark = pytest.mark.multidevice

ARCHS = ("granite-moe-1b-a400m", "olmoe-1b-7b")
MODES = (0, -1)
# (name, arch, mode, B, S): the main shape in both modes, then the
# manual-SPMD fallbacks of `_moe_shard_map`'s shape rules
ALONE = ([(f"{a}/{m}", a, m, 4, 16) for a in ARCHS for m in MODES]
         + [("s1_data_model", ARCHS[0], -1, 4, 1),
            ("s1_data", ARCHS[0], -1, 2, 1),
            ("b_not_split", ARCHS[0], -1, 3, 16)])
STEPS = [(f"{a}/{m}/{acc}", a, m, acc)
         for a in ARCHS for m in MODES for acc in (1, 2)]
CFG_OF = """
def cfg_of(arch, mode):
    return dataclasses.replace(ARCH_CFGS[arch].reduced(), dtype="float32",
                               capacity_factor=0.5, moe_dispatch_chunks=mode)
"""

JAX_REF = CFG_OF + """
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import ARCHS as ARCH_CFGS
from repro.data.synthetic import make_lm_batch
from repro.launch import shardings as shd
from repro.launch.mesh import make_debug_mesh
from repro.models.model import init_params
from repro.models.moe import moe_with_aux
from repro.models.sharding_ctx import sharding_rules
from repro.training.optimizer import OptimizerConfig
from repro.training.train_loop import init_train_state, make_train_step

ALONE, STEPS = json.loads(sys.argv[2]), json.loads(sys.argv[3])
mesh = make_debug_mesh(2, 2)
out = {}


def routes(xt, router, cfg):
    # a slab's routing: JAX's formula (models/moe.py:164-175)
    t = xt.shape[0]
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = max(8, -(-int(cfg.capacity_factor * t * k / e) // 8) * 8)
    probs = jax.nn.softmax(xt @ router, axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    oh = jax.nn.one_hot(top_e, e, dtype=jnp.float32).reshape(t * k, e)
    pos = jnp.sum((jnp.cumsum(oh, axis=0) - oh) * oh, -1).astype(jnp.int32)
    return np.asarray(pos), np.asarray(pos < cap)


def slabs(b, s, mode):
    # the token slabs of a (b, s) batch, batch block major: one for global
    # dispatch, else `_moe_shard_map`'s shape rules (moe.py:208-214)
    if mode == 0:
        return 1, b, s
    dn, mn = 2, 2
    bl = b // dn if b % dn == 0 else b
    if s % mn == 0 and s > 1:
        return None, bl, s // mn
    if b % (dn * mn) == 0:
        return None, b // (dn * mn), s
    return None, bl, s


for name, arch, mode, b, s in ALONE:
    cfg = cfg_of(arch, mode)
    p = jax.tree_util.tree_map(lambda a: a[0], init_params(
        cfg, jax.random.PRNGKey(3))["blocks"]["moe"])
    x = np.random.default_rng(7).normal(size=(b, s, cfg.d_model)).astype(
        np.float32)
    with mesh, sharding_rules(mesh):
        o, aux = jax.jit(lambda p, x: moe_with_aux(p, x, cfg))(p, x)
    _, bl, sl = slabs(b, s, mode)
    pos, keep = [], []
    for i in range(b // bl):
        for j in range(s // sl):
            xt = x[i * bl:(i + 1) * bl, j * sl:(j + 1) * sl].reshape(
                bl * sl, -1)
            pk = routes(jnp.asarray(xt), p["router"], cfg)
            pos.append(pk[0])
            keep.append(pk[1])
    for k_, v in p.items():
        out[f"alone/{name}/p/{k_}"] = np.asarray(v)
    out[f"alone/{name}/x"] = x
    out[f"alone/{name}/out"] = np.asarray(o)
    out[f"alone/{name}/aux"] = np.asarray(aux)
    out[f"alone/{name}/pos"] = np.concatenate(pos)
    out[f"alone/{name}/keep"] = np.concatenate(keep)


def dump(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jax.device_get(tree))[0]:
        key = "/".join(str(getattr(q, "key", q)) for q in path)
        out[f"{prefix}/{key}"] = np.asarray(leaf)


opt = OptimizerConfig(peak_lr=1e-3, total_steps=10, warmup_steps=0)
for name, arch, mode, accum in STEPS:
    cfg = cfg_of(arch, mode)
    state = init_train_state(cfg, init_params(cfg, jax.random.PRNGKey(0)))
    dump(f"step/{name}/init", state.params)
    s_abs = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), state)
    s_shd = shd.sanitize_shardings(shd.train_state_shardings(mesh, cfg),
                                   s_abs, mesh)
    batches = [make_lm_batch(cfg, 4 * accum, 16, seed=0, step=t)
               for t in range(2)]
    b_shd = {k: shd.sanitize_shardings(v, batches[0][k], mesh)
             for k, v in shd.batch_shardings(mesh, cfg).items()}
    losses = []
    with mesh, sharding_rules(mesh):
        jstep = jax.jit(make_train_step(cfg, opt, accum),
                        in_shardings=(s_shd, b_shd),
                        out_shardings=(s_shd, None))
        state = jax.device_put(state, s_shd)
        for t, batch in enumerate(batches):
            state, m = jstep(state, jax.device_put(batch, b_shd))
            losses.append([float(m["loss"]), float(m["aux"]),
                           float(m["grad_norm"])])
            for k_, v in batch.items():
                out[f"step/{name}/batch{t}/{k_}"] = np.asarray(v)
    dump(f"step/{name}/final", state.params)
    out[f"step/{name}/losses"] = np.asarray(losses)
np.savez(sys.argv[1], **out)
print("JAX_REF_OK")
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_moe") / "ref.npz")
    env = _env()
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    out = subprocess.run([sys.executable, "-c", JAX_REF, path,
                          json.dumps(ALONE), json.dumps(STEPS)], env=env,
                         capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stdout + out.stderr
    return path


# every rank: the port's side of every case, one process group for all
PORT = CFG_OF + """
from repro_torch.configs import ARCHS as ARCH_CFGS
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import moe as moe_mod
from repro_torch.models.convert import named_from_jax
from repro_torch.models.layers import linear
from repro_torch.models.sharding_ctx import data_rank, sharding_rules
from repro_torch.training.dp_step import make_sharded_train_step
from repro_torch.training.train_loop import train_state_from_jax

ALONE, STEPS = json.loads(os.environ["ALONE"]), json.loads(os.environ["STEPS"])
ref = np.load(os.environ["JAX_REF"])
mesh = make_debug_mesh(2, 2, device="cpu")
n, r = data_rank(mesh)
data_group = mesh.get_group("data")
seen = {}
real_experts = moe_mod._experts


def spy(params, xt, rt, pos, keep, slots):
    seen["pos"], seen["keep"] = rt["pos"].reshape(-1), keep.reshape(-1)
    return real_experts(params, xt, rt, pos, keep, slots)


moe_mod._experts = spy
alone = {}
for name, arch, mode, b, s in ALONE:
    cfg = cfg_of(arch, mode)
    p = {k: torch.from_numpy(ref[f"alone/{name}/p/{k}"])
         for k in ("router", "w_gate", "w_up", "w_down")}
    m = moe_mod.MoE(linear(p["router"].T.contiguous()), p["w_gate"],
                    p["w_up"], p["w_down"])
    x = torch.from_numpy(ref[f"alone/{name}/x"])
    split = b % n == 0
    rows = x[r * (b // n):(r + 1) * (b // n)] if split else x
    with sharding_rules(mesh, split_rows=split):
        o, aux = moe_mod.moe_with_aux(m, rows, cfg)
    dist.all_reduce(aux, group=data_group)
    want = ref[f"alone/{name}/out"]
    want = want[r * (b // n):(r + 1) * (b // n)] if split else want
    pos = ref[f"alone/{name}/pos"]
    keep = ref[f"alone/{name}/keep"]
    k0 = r * seen["pos"].numel() if split else 0
    k1 = k0 + seen["pos"].numel()
    alone[name] = dict(
        pos=bool(np.array_equal(seen["pos"].numpy(), pos[k0:k1])),
        keep=bool(np.array_equal(seen["keep"].numpy(), keep[k0:k1])),
        dropped=int((~keep).sum()),
        out=bool(np.allclose(o.numpy(), want, rtol=1e-5, atol=1e-5)),
        out_err=float(np.abs(o.numpy() - want).max()),
        aux=float(aux), aux_ref=float(ref[f"alone/{name}/aux"]))
moe_mod._experts = real_experts


def tree(prefix):
    out = {}
    for k in ref.files:
        if k.startswith(prefix + "/"):
            node = out
            *path, last = k[len(prefix) + 1:].split("/")
            for q in path:
                node = node.setdefault(q, {})
            node[last] = ref[k]
    return out


zeros = lambda t: {k: zeros(v) if isinstance(v, dict) else np.zeros_like(v)
                   for k, v in t.items()}
opt = OptimizerConfig(peak_lr=1e-3, total_steps=10, warmup_steps=0)
steps = {}
for name, arch, mode, accum in STEPS:
    cfg = cfg_of(arch, mode)
    init = tree(f"step/{name}/init")
    state = train_state_from_jax(
        (init, {"m": zeros(init), "v": zeros(init), "step": 0}), cfg, "cpu")
    s_shd = shd.sanitize_shardings(shd.train_state_shardings(mesh, cfg),
                                   shd.state_shapes(state), mesh)
    state = shd.shard_train_state(state, s_shd)
    step = make_sharded_train_step(cfg, opt, mesh, accum)
    losses = []
    for t in range(2):
        batch = {k: torch.from_numpy(ref[f"step/{name}/batch{t}/{k}"])
                 for k in ("tokens", "labels")}
        state, met = step(state, batch)
        losses.append([float(met["loss"]), float(met["aux"]),
                       float(met["grad_norm"])])
    want = named_from_jax(tree(f"step/{name}/final"), cfg)
    err = max(float((p.full_tensor() - torch.from_numpy(want[k])).abs().max())
              for k, p in state.params.named_parameters())
    steps[name] = dict(err=err, losses=losses,
                       losses_ref=ref[f"step/{name}/losses"].tolist())
report(alone=alone, steps=steps)
"""


@pytest.fixture(scope="module")
def port(jax_ref, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("port_moe"))
    return run_ranks(PORT, out, timeout=400, JAX_REF=jax_ref,
                     ALONE=json.dumps(ALONE), STEPS=json.dumps(STEPS))


@pytest.mark.parametrize("case", ALONE, ids=[c[0] for c in ALONE])
def test_moe_with_aux_under_a_mesh_equals_jax(port, case):
    name, _, mode, b, s = case
    for r, rep in enumerate(port):
        got = rep["alone"][name]
        assert got["pos"] and got["keep"], (r, got)
        assert got["out"], (r, got)
        assert abs(got["aux"] - got["aux_ref"]) <= 1e-5 + 1e-5 * abs(
            got["aux_ref"]), (r, got)
    if (b, s) == (4, 16):
        assert port[0]["alone"][name]["dropped"] > 0


def test_the_two_modes_differ_at_this_shape(port):
    """At capacity factor 0.5 a slab drops routes the global buffer keeps,
    so a port that ran only the global path would fail the -1 cases."""
    for a in ARCHS:
        g, m = port[0]["alone"][f"{a}/0"], port[0]["alone"][f"{a}/-1"]
        assert g["aux_ref"] != m["aux_ref"]
        assert g["dropped"] != m["dropped"]


@pytest.mark.parametrize("case", STEPS, ids=[c[0] for c in STEPS])
def test_sharded_moe_step_matches_jax(port, case):
    name = case[0]
    for r, rep in enumerate(port):
        got = rep["steps"][name]
        assert got["err"] < 2e-4, (r, got)
        for (loss, aux, gn), (jl, ja, jg) in zip(got["losses"],
                                                  got["losses_ref"]):
            assert abs(loss - jl) < 1e-5 * max(1.0, abs(jl)), (r, got)
            assert abs(aux - ja) < 1e-5 * max(1.0, abs(ja)), (r, got)
            assert abs(gn - jg) < 1e-5 * max(1.0, abs(jg)), (r, got)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", MODES)
def test_launcher_trains_moe_under_a_mesh(tmp_path, arch, mode):
    """`torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh
    debug --device cpu` with a MoE architecture: no refusal, finite
    losses, in both dispatch modes."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
           "--arch", arch, "--reduced", "--device", "cpu", "--mesh", "debug",
           "--batch", "4", "--seq", "16", "--steps", "2", "--log-every", "1",
           "--moe-dispatch-chunks", str(mode)]
    out = subprocess.run(cmd, env=_env(), timeout=120, capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "mesh=debug" in out.stdout and "step     2 loss" in out.stdout
    loss = float(out.stdout.split("step     2 loss")[1].split()[0])
    assert np.isfinite(loss)


def test_slab_shapes_follow_jax_rules():
    """`slab_shape` on a 2 x 2 mesh without a process group (a
    `launch.mesh.Mesh` stands in: only names, sizes and a coordinate)."""
    from repro_torch.models.moe import slab_shape

    class M:
        mesh_dim_names = ("data", "model")
        shape = (2, 2)

        @staticmethod
        def get_coordinate():
            return (0, 0)
    assert slab_shape(4, 16, M) == (2, 8)       # seq over model
    assert slab_shape(4, 1, M) == (1, 1)        # batch over data + model
    assert slab_shape(2, 1, M) == (1, 1)        # batch over data
    assert slab_shape(3, 16, M) == (3, 8)       # no batch split
    assert slab_shape(1, 1, M) == (1, 1)
    assert slab_shape(6, 3, M) == (3, 3)        # seq 3 does not split


def test_port_imports_no_jax():
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src", "repro_torch", "models")
    for f in ("moe.py", "fsdp.py", "sharding_ctx.py"):
        text = open(os.path.join(src, f)).read()
        assert "import jax" not in text and "from repro." not in text, f
