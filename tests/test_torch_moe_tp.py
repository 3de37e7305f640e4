"""The MoE families on the "model" axis (`models/tensor_parallel.py`'s plan
for the moe family, `models/moe.py` under a plan): a model rank computes
its E/tp experts on every token of its rows (global dispatch) or its own
token slab with the experts gathered whole (manual SPMD, JAX's
`_moe_shard_map`), in `gloo` processes on the CPU.

The configs are the reduced granite-moe-1b-a400m and olmoe-1b-7b (4 experts,
top 2), float32, `capacity_factor=0.5` so that routes drop, and
granite-moe with one kv head, so that a MoE family takes the
context-parallel fallback in training and prefill and split-KV in decode.
One JAX subprocess on four fake XLA devices
(`--xla_force_host_platform_device_count=4`) writes the reference, then
one launch of four ranks on the 2 x 2 ("data", "model") debug mesh runs:

  * (a) `moe_with_aux` under a plan against JAX's jitted call under
    `sharding_rules(mesh)`: every route's position and keep bit-equal to
    JAX's formula over the global chunk or the slab, the output and the
    aux summed over the data ranks within rtol 1e-5 / atol 1e-5, both
    modes, the residual sequence-parallel and `no_sp`, and JAX's shape
    rules' fallbacks (S = 1 with the rows over data + model, S = 1 with
    them over data only, repeated on the model ranks; a batch that does
    not split over data);
  * (b) the sharded train step (`make_sharded_train_step`, grad_accum 1
    and 2, both modes) against JAX's jitted step: parameters within 2e-4,
    loss, aux and grad norm within 1e-5 relative
    (`tests/test_torch_moe_mesh.py`'s bounds); global dispatch also
    against the single-device step (`tests/test_torch_mesh_fsdp.py`'s
    `_check`), SP and `no_sp`, remat "none" and "full";
  * (c) prefill and 4 decode steps under the serving plan against JAX's
    sharded lowering (`decode_state_shardings`), within 2e-4 of the
    largest |logit|, both modes; global dispatch also against one device,
    within 1e-4 (`tests/test_torch_tp_serving.py`'s bounds);
  * (d) under global dispatch every model rank's routes (`top_e`) and
    positions bit-equal to the other's, and in both modes the aux value
    the same on every model rank;

and in this process:

  * (e) on a fake 1 x 2 mesh (`dryrun.fake_world`) each model rank counts
    at most 0.55 of the 1 x 1 run's operations in training in both modes
    (0.6 on granite-moe's fallback), and at most 0.52 in prefill and
    decode under global dispatch.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from test_torch_dp_step import _env, run_ranks
from test_torch_mesh_fsdp import STEP, _check

pytestmark = pytest.mark.multidevice

GRANITE, OLMOE = "granite-moe-1b-a400m", "olmoe-1b-7b"
FALLBACK = {"num_kv_heads": 1}
# name: (arch, config fields beside float32 and capacity factor 0.5)
CONFIGS = {"granite": (GRANITE, {}), "olmoe": (OLMOE, {}),
           "granite_kv1": (GRANITE, FALLBACK)}
MODES = (0, -1)
NO_SP = {"res_seq": None}
# (a): name, config, mode, B, S, the rules' overrides
ALONE = ([(f"{c}/{m}/{r}", c, m, 4, 16, ov) for c in ("granite", "olmoe")
          for m in MODES for r, ov in (("sp", None), ("no_sp", NO_SP))]
         + [("global_s1", "granite", 0, 4, 1, NO_SP),
            ("s1_data_model", "granite", -1, 4, 1, NO_SP),
            ("s1_data", "granite", -1, 2, 1, NO_SP),
            ("b_not_split", "granite", -1, 3, 16, None),
            ("b_not_split/no_sp", "olmoe", -1, 3, 16, NO_SP)])
# JAX's `moe_with_aux` does not read "res_seq": one reference a shape
ALONE_REFS = sorted({(c, m, b, s) for _, c, m, b, s, _ in ALONE})
# (b) against JAX: name, config, mode, grad_accum
STEPS = [(f"{c}/{m}/{acc}", c, m, acc) for c in CONFIGS for m in MODES
         for acc in (1, 2)]
# (b) against one device (global dispatch): name, config, grad_accum,
# remat, the rules' overrides
SINGLE = [("granite/1", "granite", 1, "none", None),
          ("granite/2/full", "granite", 2, "full", None),
          ("olmoe/1", "olmoe", 1, "none", None),
          ("granite_kv1/1/full", "granite_kv1", 1, "full", None),
          ("granite/no_sp", "granite", 1, "none", NO_SP),
          ("granite_kv1/no_sp", "granite_kv1", 2, "none", NO_SP)]
# (c): name, config, mode
SERVE = [(f"{c}/{m}", c, m) for c in CONFIGS for m in MODES]
ROWS, PROMPT, DECODE, MAX_LEN = 4, 16, 4, 32

JAX_REF = """
import dataclasses, json, os, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import ARCHS as ARCH_CFGS
from repro.data.synthetic import make_lm_batch
from repro.launch import shardings as shd
from repro.launch.mesh import make_debug_mesh
from repro.models import model as M
from repro.models.moe import moe_with_aux
from repro.models.sharding_ctx import sharding_rules
from repro.training.optimizer import OptimizerConfig
from repro.training.train_loop import init_train_state, make_train_step

out_dir = sys.argv[1]
CONFIGS, REFS, STEPS, SERVE = (json.loads(a) for a in sys.argv[2:6])
mesh = make_debug_mesh(2, 2)
out = {}


def cfg_of(name, mode):
    arch, extra = CONFIGS[name]
    return dataclasses.replace(ARCH_CFGS[arch].reduced(), dtype="float32",
                               capacity_factor=0.5, moe_dispatch_chunks=mode,
                               **extra)


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
    # (rows, positions) of a slab: the whole batch for global dispatch,
    # else `_moe_shard_map`'s shape rules (moe.py:208-214)
    if mode == 0:
        return b, s
    bl = b // 2 if b % 2 == 0 else b
    if s % 2 == 0 and s > 1:
        return bl, s // 2
    if b % 4 == 0:
        return b // 4, s
    return bl, s


def flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(
                jax.device_get(tree))[0]}


for conf, mode, b, s in REFS:
    key = f"alone/{conf}/{mode}/{b}x{s}"
    cfg = cfg_of(conf, mode)
    p = jax.tree_util.tree_map(lambda a: a[0], M.init_params(
        cfg, jax.random.PRNGKey(3))["blocks"]["moe"])
    x = np.random.default_rng(7).normal(size=(b, s, cfg.d_model)).astype(
        np.float32)
    with mesh, sharding_rules(mesh):
        o, aux = jax.jit(lambda p, x: moe_with_aux(p, x, cfg))(p, x)
    bl, sl = slabs(b, s, mode)
    pos, keep = [], []
    for i in range(b // bl):
        for j in range(s // sl):
            xt = x[i * bl:(i + 1) * bl, j * sl:(j + 1) * sl].reshape(
                bl * sl, -1)
            pk = routes(jnp.asarray(xt), p["router"], cfg)
            pos.append(pk[0])
            keep.append(pk[1])
    for k_, v in p.items():
        out[f"{key}/p/{k_}"] = np.asarray(v)
    out[f"{key}/x"] = x
    out[f"{key}/out"] = np.asarray(o)
    out[f"{key}/aux"] = np.asarray(aux)
    out[f"{key}/pos"] = np.concatenate(pos)
    out[f"{key}/keep"] = np.concatenate(keep)

opt = OptimizerConfig(peak_lr=1e-3, total_steps=10, warmup_steps=0)
for name, conf, mode, accum in STEPS:
    cfg = cfg_of(conf, mode)
    state = init_train_state(cfg, M.init_params(cfg, jax.random.PRNGKey(0)))
    for k_, v in flat(state.params).items():
        out[f"step/{name}/init/{k_}"] = v
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
    for k_, v in flat(state.params).items():
        out[f"step/{name}/final/{k_}"] = v
    out[f"step/{name}/losses"] = np.asarray(losses)

data = np.load(os.path.join(out_dir, "prompts.npz"))
tokens, nxt = data["tokens"], data["next"]
max_len = int(sys.argv[6])
for i, (name, conf, mode) in enumerate(SERVE):
    cfg = cfg_of(conf, mode)
    params = M.init_params(cfg, jax.random.PRNGKey(5 + i))
    for k_, v in flat(params).items():
        out[f"serve/{name}/params/{k_}"] = v
    with mesh, sharding_rules(mesh):
        p_shd = shd.sanitize_shardings(shd.param_shardings(mesh, cfg),
                                       params, mesh)
        state_abs = jax.eval_shape(
            lambda: M.init_decode_state(cfg, tokens.shape[0], max_len))
        st_shd = shd.sanitize_shardings(shd.decode_state_shardings(
            mesh, cfg), state_abs, mesh)
        t_shd = shd.sanitize_shardings(shd.batch_shardings(mesh, cfg)[
            "tokens"], tokens, mesh)
        pre = jax.jit(lambda p, t: M.prefill(p, cfg, {"tokens": t},
                                             max_len=max_len),
                      in_shardings=(p_shd, t_shd),
                      out_shardings=(None, st_shd))
        step = jax.jit(lambda p, st, t: M.decode_step(p, cfg, st, t),
                       in_shardings=(p_shd, st_shd, t_shd),
                       out_shardings=(None, st_shd))
        params = jax.device_put(params, p_shd)
        logits, state = pre(params, jnp.asarray(tokens))
        out[f"serve/{name}/logits0"] = np.asarray(logits)
        for t in range(nxt.shape[1]):
            logits, state = step(params, state, jnp.asarray(nxt[:, t:t + 1]))
            out[f"serve/{name}/logits{t + 1}"] = np.asarray(logits)
np.savez(os.path.join(out_dir, "ref.npz"), **out)
print("JAX_REF_OK")
"""

PORT = STEP + """
from repro_torch.launch import dryrun
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import moe as moe_mod
from repro_torch.models import tensor_parallel as tpm
from repro_torch.models.convert import named_from_jax, params_from_jax
from repro_torch.models.fsdp import ShardedParams
from repro_torch.models.layers import linear
from repro_torch.models.model import decode_step, prefill
from repro_torch.models.sharding_ctx import (data_rank, local_batch,
                                             sharding_rules)
from repro_torch.training.train_loop import train_state_from_jax

CONFIGS = json.loads(os.environ["CONFIGS"])
ALONE, STEPS, SINGLE, SERVE = (json.loads(os.environ[k]) for k in (
    "ALONE", "STEPS", "SINGLE", "SERVE"))
MAX_LEN = int(os.environ["MAX_LEN"])
ref = np.load(os.path.join(OUT, "ref.npz"))
mesh = make_debug_mesh(2, 2, device="cpu")
n, r = data_rank(mesh)
M_RANK = mesh.get_coordinate()[1]
data_group = mesh.get_group("data")
opt = OptimizerConfig(peak_lr=1e-3, total_steps=10, warmup_steps=0)


def cfg_of(name, mode=0):
    arch, extra = CONFIGS[name]
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               capacity_factor=0.5, moe_dispatch_chunks=mode,
                               **extra)


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


seen = {}
real_experts = moe_mod._experts


def spy(params, xt, rt, pos, keep, slots, **kw):
    seen.update(top_e=rt["top_e"].reshape(-1).clone(),
                pos=rt["pos"].reshape(-1).clone(), keep=keep.reshape(-1))
    return real_experts(params, xt, rt, pos, keep, slots, **kw)


def slab_index(mode, b, s):
    # which of JAX's slabs (batch block major) this rank routes
    if mode == 0:
        return r if b % n == 0 else 0
    i = r if b % n == 0 else 0
    if s % 2 == 0 and s > 1:
        return 2 * i + M_RANK
    if b % 4 == 0:
        return 2 * r + M_RANK
    return i


def leaves_of(m, x):
    out = [m.router.weight, m.w_gate, m.w_up, m.w_down, x]
    for t in out:
        t.requires_grad_()
    return out


def unsplit_grads(p, x, g, cfg, mode, b, s):
    # the gradients of <out, g> + aux on one process over the global
    # batch: one chunk (global dispatch) or JAX's slabs, each a chunk
    full = moe_mod.MoE(linear(p["router"].T.contiguous()),
                       *(p[k].clone() for k in ("w_gate", "w_up", "w_down")))
    leaves = leaves_of(full, x.clone())
    if mode == 0:
        out, aux = moe_mod.moe_with_aux(full, leaves[-1], cfg)
    else:
        bl = b // 2 if b % 2 == 0 else b
        bl, sl = ((bl, s // 2) if s % 2 == 0 and s > 1 else
                  (b // 4, s) if b % 4 == 0 else (bl, s))
        out, aux = moe_mod._slabs(full, leaves[-1], cfg, bl, sl)
    return torch.autograd.grad((out * g).sum() + aux, leaves)


def alone(conf, mode, b, s, overrides):
    key = f"alone/{conf}/{mode}/{b}x{s}"
    cfg = cfg_of(conf, mode)
    split = b % n == 0
    with sharding_rules(mesh, overrides, split_rows=split):
        plan = tpm.make_plan(cfg, mesh)
    p = {k: torch.from_numpy(ref[f"{key}/p/{k}"])
         for k in ("router", "w_gate", "w_up", "w_down")}
    ws = [p[k].clone() for k in ("w_gate", "w_up", "w_down")]
    e = cfg.num_experts // plan.size
    if plan.experts:
        ws = [w[M_RANK * e:(M_RANK + 1) * e] for w in ws]
    m = moe_mod.MoE(linear(p["router"].T.contiguous()), *ws)
    x = torch.from_numpy(ref[f"{key}/x"])
    g = torch.from_numpy(np.random.default_rng(11).normal(
        size=x.shape).astype(np.float32))
    want_grads = unsplit_grads(p, x, g, cfg, mode, b, s)
    want = ref[f"{key}/out"]
    wx = want_grads[-1]
    if split:
        x, g, want, wx = (t[r * (b // n):(r + 1) * (b // n)]
                          for t in (x, g, want, wx))
    if plan.sp:
        h = s // plan.size
        x, g, want, wx = (t[:, M_RANK * h:(M_RANK + 1) * h]
                          for t in (x, g, want, wx))
    leaves = leaves_of(m, x.clone())
    with sharding_rules(mesh, overrides, split_rows=split):
        o, aux = moe_mod.moe_with_aux(m, leaves[-1], cfg, plan)
    grads = [t.contiguous() for t in torch.autograd.grad(
        (o * g).sum() + aux, leaves)]
    o, aux = o.detach(), aux.detach().clone()
    share = float(aux)
    dist.all_reduce(aux, group=data_group)
    # the parameters' gradients summed as the plan's modes sum them: the
    # router over every rank, the experts over the data ranks where a
    # rank holds its own ("local"), else over every rank too
    dist.all_reduce(grads[0])
    for t in grads[1:4]:
        dist.all_reduce(t, group=data_group if plan.experts else None)
    wants = list(want_grads[:4]) + [wx]
    if plan.experts:
        wants[1:4] = [w[M_RANK * e:(M_RANK + 1) * e] for w in wants[1:4]]
    grad_err = max(float((a - w).abs().max()) / float(w.abs().max())
                   for a, w in zip(grads, wants))
    pos, keep = ref[f"{key}/pos"], ref[f"{key}/keep"]
    k0 = slab_index(mode, b, s) * seen["pos"].numel()
    k1 = k0 + seen["pos"].numel()
    return dict(
        pos=bool(np.array_equal(seen["pos"].numpy(), pos[k0:k1])),
        keep=bool(np.array_equal(seen["keep"].numpy(), keep[k0:k1])),
        dropped=int((~keep).sum()), sp=plan.sp, experts=plan.experts,
        out=bool(np.allclose(o.numpy(), want, rtol=1e-5, atol=1e-5)),
        out_err=float(np.abs(o.numpy() - want).max()),
        aux=float(aux), aux_ref=float(ref[f"{key}/aux"]), share=share,
        top_e=seen["top_e"].tolist(), routes_pos=seen["pos"].tolist(),
        grad_err=grad_err if split else None)


def step_against_jax(name, conf, mode, accum):
    cfg = cfg_of(conf, mode)
    init = tree(f"step/{name}/init")
    zeros = lambda t: {k: zeros(v) if isinstance(v, dict) else
                       np.zeros_like(v) for k, v in t.items()}
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
    with sharding_rules(mesh):
        plan = tpm.make_plan(cfg, mesh)
    return dict(err=err, losses=losses, heads=plan.heads,
                experts=plan.experts,
                losses_ref=ref[f"step/{name}/losses"].tolist())


def step_against_single(conf, accum, remat, overrides):
    arch, extra = CONFIGS[conf]
    return compare(mesh, arch, accum, remat, 2, overrides,
                   capacity_factor=0.5, **extra)


def serve(model, cfg, tokens, nxt, plan):
    # the prefill's logits, then each decode step's, over the whole
    # padded vocab (the ranks' vocabulary columns gathered)
    gather = (lambda t: t) if plan is None or not plan.vocab else (
        lambda t: tpm.all_gather(t, plan, t.dim() - 1))
    logits, state = prefill(model, cfg, {"tokens": tokens}, MAX_LEN)
    outs = [gather(logits)]
    for t in range(nxt.shape[1]):
        logits, state = decode_step(model, cfg, state, nxt[:, t:t + 1])
        outs.append(gather(logits))
    return outs


def split_serve(model, cfg, overrides=None):
    dryrun._sharded_params(model, mesh, cfg, overrides)
    with sharding_rules(mesh, overrides):
        plan = tpm.make_plan(cfg, mesh, serving=True)
    loc = local_batch(PROMPTS, mesh)
    with ShardedParams(model, mesh, plan), sharding_rules(mesh, overrides):
        return serve(model, cfg, loc["tokens"], loc["next"], plan), plan


def serve_against(name, conf, mode):
    cfg = cfg_of(conf, mode)
    model = params_from_jax(tree(f"serve/{name}/params"), cfg, device="cpu")
    got, plan = split_serve(model, cfg)
    np.savez(os.path.join(OUT, f"port_{name.replace('/', '_')}_rank{RANK}"
                          ".npz"), *[t.numpy() for t in got])
    out = dict(heads=plan.heads, experts=plan.experts)
    if mode == 0:
        # the unsplit path on the same parameters, this rank's rows
        one = serve(init_params(cfg, 0, device="cpu"), cfg,
                    PROMPTS["tokens"], PROMPTS["next"], None)
        got, _ = split_serve(init_params(cfg, 0, device="cpu"), cfg)
        rows = slice(2 * r, 2 * r + 2)
        out["single_err"] = max(
            float((g - w[rows]).abs().max()) / float(w[rows].abs().max())
            for g, w in zip(got, one))
    return out


PROMPTS = {k: torch.from_numpy(v) for k, v in np.load(
    os.path.join(OUT, "prompts.npz")).items()}
moe_mod._experts = spy
alone_out = {name: alone(*c) for name, *c in ALONE}
moe_mod._experts = real_experts
steps = {name: step_against_jax(name, *c) for name, *c in STEPS}
single = {name: step_against_single(*c) for name, *c in SINGLE}
with torch.no_grad():
    served = {name: serve_against(name, *c) for name, *c in SERVE}
report(alone=alone_out, steps=steps, single=single, serve=served)
"""


@pytest.fixture(scope="module")
def moe_tp(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("moe_tp"))
    rng = np.random.default_rng(31)
    np.savez(os.path.join(out, "prompts.npz"),
             tokens=rng.integers(0, 500, (ROWS, PROMPT)).astype(np.int32),
             next=rng.integers(0, 500, (ROWS, DECODE)).astype(np.int32))
    env = _env()
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    jax_run = subprocess.run(
        [sys.executable, "-c", JAX_REF, out, json.dumps(CONFIGS),
         json.dumps(ALONE_REFS), json.dumps(STEPS), json.dumps(SERVE),
         str(MAX_LEN)], env=env, capture_output=True, text=True, timeout=500)
    assert jax_run.returncode == 0 and "JAX_REF_OK" in jax_run.stdout, (
        jax_run.stdout + jax_run.stderr)
    reports = run_ranks(
        PORT, out, timeout=500, CONFIGS=json.dumps(CONFIGS),
        ALONE=json.dumps([(c[0], *c[1:]) for c in ALONE]),
        STEPS=json.dumps(STEPS), SINGLE=json.dumps(SINGLE),
        SERVE=json.dumps(SERVE), MAX_LEN=MAX_LEN)
    return dict(reports=reports, out=out)


@pytest.mark.parametrize("case", ALONE, ids=[c[0] for c in ALONE])
def test_moe_under_a_plan_equals_jax(moe_tp, case):
    """(a): each rank's routes, output and (summed over the data ranks)
    aux against JAX's jitted `moe_with_aux` on the same mesh; the plan
    puts the expert weights on "model" under global dispatch only."""
    name, _, mode, b, s, overrides = case
    for rank, rep in enumerate(moe_tp["reports"]):
        got = rep["alone"][name]
        assert got["pos"] and got["keep"], (rank, got)
        assert got["out"], (rank, got["out_err"])
        assert abs(got["aux"] - got["aux_ref"]) <= 1e-5 + 1e-5 * abs(
            got["aux_ref"]), (rank, got["aux"], got["aux_ref"])
        assert got["experts"] == (mode == 0)
        assert got["sp"] == (overrides is None)
    if (b, s) == (4, 16):
        assert moe_tp["reports"][0]["alone"][name]["dropped"] > 0


@pytest.mark.parametrize("case", [c for c in ALONE if c[3] % 2 == 0],
                         ids=[c[0] for c in ALONE if c[3] % 2 == 0])
def test_moe_gradients_under_a_plan_match_unsplit(moe_tp, case):
    """(a): the gradients of <out, g> + aux (g a fixed cotangent) on each
    rank, the parameters' summed as the plan's modes sum them, against
    the unsplit layer's on one process (one chunk, or JAX's slabs), within
    1e-5 of the largest: the aux's parts count once over "model", and
    where the model ranks repeat a slab (S = 1, the rows over data only)
    each rank's gradient is a tp-th."""
    for rank, rep in enumerate(moe_tp["reports"]):
        got = rep["alone"][case[0]]
        assert got["grad_err"] <= 1e-5, (rank, got["grad_err"])


@pytest.mark.parametrize("case", STEPS, ids=[c[0] for c in STEPS])
def test_sharded_moe_step_under_a_plan_matches_jax(moe_tp, case):
    """(b): the tensor-parallel step against JAX's jitted step from the
    same parameters on the same batches: parameters within 2e-4 after two
    steps, loss, aux and grad norm within 1e-5 relative; granite-moe's one
    kv head takes the context-parallel fallback."""
    name, conf = case[0], case[1]
    for rank, rep in enumerate(moe_tp["reports"]):
        got = rep["steps"][name]
        assert got["err"] < 2e-4, (rank, got)
        assert got["heads"] == ("num_kv_heads" not in CONFIGS[conf][1])
        assert got["experts"] == (case[2] == 0)
        for (loss, aux, gn), (jl, ja, jg) in zip(got["losses"],
                                                  got["losses_ref"]):
            assert abs(loss - jl) < 1e-5 * max(1.0, abs(jl)), (rank, got)
            assert abs(aux - ja) < 1e-5 * max(1.0, abs(ja)), (rank, got)
            assert abs(gn - jg) < 1e-5 * max(1.0, abs(jg)), (rank, got)


@pytest.mark.parametrize("case", SINGLE, ids=[c[0] for c in SINGLE])
def test_sharded_moe_step_under_a_plan_matches_single_device(moe_tp, case):
    """(b): global dispatch under the plan against the single-device step
    (`_check`: parameters and moments within 2e-4 after two steps, the
    first step's gradient shards within 1e-5 of the largest, the metrics
    within 1e-5)."""
    for rep in moe_tp["reports"]:
        _check(rep["single"][case[0]])


@pytest.mark.parametrize("case", SERVE, ids=[c[0] for c in SERVE])
def test_moe_serving_under_a_plan_matches_jax(moe_tp, case):
    """(c): each rank's prefill logits (its rows, the whole padded vocab)
    and its 4 decode steps' against JAX's sharded `prefill` and
    `decode_step` from the same parameters, within 2e-4 of the largest
    |logit|; under global dispatch also against the unsplit path, within
    1e-4. The decode state is the rank's kv heads (olmoe, granite-moe) or
    its slice of the cache (granite-moe with one kv head: split-KV)."""
    name, conf, mode = case
    out = moe_tp["out"]
    want = np.load(os.path.join(out, "ref.npz"))
    want = [want[f"serve/{name}/logits{t}"] for t in range(1 + DECODE)]
    for rank, rep in enumerate(moe_tp["reports"]):
        got = rep["serve"][name]
        assert got["heads"] == ("num_kv_heads" not in CONFIGS[conf][1])
        assert got["experts"] == (mode == 0)
        arrs = np.load(os.path.join(
            out, f"port_{name.replace('/', '_')}_rank{rank}.npz"))
        rows = slice(2 * (rank // 2), 2 * (rank // 2) + 2)
        for i, w in enumerate(want):
            g = arrs[f"arr_{i}"]
            assert g.shape == w[rows].shape, (g.shape, w.shape)
            err = np.abs(g - w[rows]).max() / np.abs(w[rows]).max()
            assert err <= 2e-4, (name, i, err)
        if mode == 0:
            assert got["single_err"] <= 1e-4, got


@pytest.mark.parametrize("name", [c[0] for c in ALONE])
def test_model_ranks_agree_on_routes_and_aux(moe_tp, name):
    """(d): the two model ranks of each data rank hold the same aux value;
    under global dispatch they route the same gathered tokens through the
    same float32 product, so their routes and positions are bit-equal (a
    rank that disagreed would send a token to an expert no rank runs)."""
    mode = next(c[2] for c in ALONE if c[0] == name)
    reps = [rep["alone"][name] for rep in moe_tp["reports"]]
    for d in (0, 1):
        a, b = reps[2 * d], reps[2 * d + 1]
        assert a["share"] == b["share"], (d, a["share"], b["share"])
        if mode == 0:
            assert a["top_e"] == b["top_e"], d
            assert a["routes_pos"] == b["routes_pos"], d


def _flops(cfg, shape, opts=()) -> dict:
    flops = {}
    for m, rank in ((1, 0), (2, 0), (2, 1)):
        with dryrun.fake_world((1, m), ("data", "model"), rank) as mesh:
            rec = dryrun.dry_run_cell(cfg, shape, mesh, opts=opts)
        flops[m, rank] = rec["cost_per_device"]["flops"]
    return flops


@pytest.mark.parametrize("conf, opts, bound", [
    ("granite", (), 0.55), ("granite", ("moe_local",), 0.55),
    ("olmoe", (), 0.55), ("olmoe", ("moe_local",), 0.55),
    ("granite_kv1", (), 0.6), ("granite_kv1", ("moe_local",), 0.6)],
    ids=["granite/global", "granite/local", "olmoe/global", "olmoe/local",
         "granite_kv1/global", "granite_kv1/local"])
def test_a_moe_rank_computes_its_share_in_training(conf, opts, bound):
    """(e): under the op analyzer on a fake 1 x 2 mesh each model rank of
    the train step counts at most `bound` of the 1 x 1 step's operations:
    its heads (or its queries on the fallback), its vocabulary columns,
    and its experts (global dispatch) or its token slab (manual SPMD); the
    routing (D·E a token) is all that repeats."""
    arch, extra = CONFIGS[conf]
    cfg = dataclasses.replace(get_config(arch).reduced(), **extra)
    flops = _flops(cfg, ShapeConfig("train_tiny", 64, 4, "train"), opts)
    for rank in (0, 1):
        assert flops[2, rank] <= bound * flops[1, 0], flops


@pytest.mark.parametrize("conf, kind", [
    ("olmoe", "prefill"), ("olmoe", "decode"), ("granite_kv1", "prefill"),
    ("granite_kv1", "decode")])
def test_a_moe_rank_serves_its_share(conf, kind):
    """(e): prefill and decode under the serving plan and global dispatch
    count at most 0.52 of the 1 x 1 run's operations on each rank of a
    fake 1 x 2 mesh (the heads path, and the fallback with split-KV)."""
    arch, extra = CONFIGS[conf]
    cfg = dataclasses.replace(get_config(arch).reduced(), **extra)
    flops = _flops(cfg, ShapeConfig(f"{kind}_tiny", 64, 4, kind))
    for rank in (0, 1):
        assert flops[2, rank] <= 0.52 * flops[1, 0], flops


def test_experts_that_do_not_tile_are_refused():
    """The plan splits a MoE block's experts, so an expert count that does
    not tile the model axis is refused, as a d_ff is."""
    from repro_torch.models import tensor_parallel as tpm
    from repro_torch.models.sharding_ctx import sharding_rules
    cfg = dataclasses.replace(get_config(OLMOE).reduced(), num_experts=3)
    with dryrun.fake_world((1, 2), ("data", "model")) as mesh:
        with sharding_rules(mesh):
            with pytest.raises(ValueError, match="expert count 3"):
                tpm.make_plan(cfg, mesh)
            plan = tpm.make_plan(get_config(OLMOE).reduced(), mesh)
    assert plan is not None and plan.experts
    assert plan.mode("blocks.0.moe.w_gate") == "local"
    assert plan.mode("blocks.0.moe.router.weight") == "partial"

