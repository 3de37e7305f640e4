"""The SSM and hybrid families on the "model" axis
(`models/tensor_parallel.py`'s plan for "ssm" and "hybrid",
`models/ssm.py` under a plan): a model rank
computes its Mamba2 heads (zamba2), its mLSTM channels and heads and its
sLSTM feed-forward columns (xLSTM), in `gloo` processes on the CPU.

The configs are the reduced zamba2-2.7b (4 Mamba2 heads, 4 kv heads),
the reduced xlstm-125m (4 mLSTM heads, which tile 2) and xlstm-125m with
one mLSTM head (a cell kept whole on every model rank, as 4 heads are on
16), float32. One JAX subprocess on four fake XLA devices
(`--xla_force_host_platform_device_count=4`) writes the reference, then
one launch of four ranks on the 2 x 2 ("data", "model") debug mesh runs:

  * (a) each unit under a plan (a Mamba2 layer with its pre-norm; an
    mLSTM/sLSTM pair) against JAX's jitted call under
    `sharding_rules(mesh)`: rtol and atol 1e-5, the residual
    sequence-parallel and `no_sp`; the gradients of <out, g> (g a fixed
    cotangent) through `ShardedParams` (each leaf's shard, summed over the
    ranks as its mode says) and of the input against the unsplit unit on
    one process, within 1e-5 of each one's largest;
  * (b) the sharded train step (`make_sharded_train_step`, grad_accum 1
    and 2) against JAX's jitted step: for xLSTM the parameters within
    2e-4 after two steps and loss and grad norm within 1e-5 relative
    (`tests/test_torch_moe_mesh.py`'s bounds) and against the
    single-device step (`tests/test_torch_mesh_fsdp.py`'s `_check`), SP
    and `no_sp`, remat "none" and "full". zamba2's reduced float32 step
    on a split sits on a floor that `_check`'s bounds do not clear, and
    the witness is JAX's own: its jitted step under `sharding_rules` on
    the same mesh lands 5.2-6.4e-4 from its unsplit step in the
    parameters after two steps and 2.0-4.8e-5 from it in a layer's
    first-step gradients (a_log). Twelve Mamba2 layers whose decays are
    exponentials of cumulative sums (`ssd_scan`) turn a reordered sum
    (the row-parallel `out_proj`, the norm's two-level sum) into changes
    of ~1e-5 of a parameter's largest on its smallest gradients (a_log,
    dt_bias), and AdamW's update of an element whose gradient is at that
    noise is set by the noise. So zamba2 is held by the witness' bounds
    (`_check_floor`): its parameters within 2e-4 where their first-step
    gradient exceeds FLOOR_MASK (100 x AdamW's eps), its first-step
    gradient shards within FLOOR_GRAD of each parameter's largest against
    one device and within `ZAMBA_JAX_GRAD` against JAX, the losses within
    1e-5 and the grad norm within 1e-5 relative (against one device the
    second step's within 1e-4, after an AdamW update on the floor), while
    each unit's gradients match the unsplit unit's to ~1e-6 ((a)); the
    witness itself is a test;
  * (c) prefill and 4 decode steps under the serving plan against JAX's
    sharded lowering (`decode_state_shardings`), within 2e-4 of the
    largest |logit|, and against one device, within 1e-4
    (`tests/test_torch_tp_serving.py`'s bounds); zamba2 with a window of
    8 slots, so that the 16-token prompt and the decode steps wrap its
    ring cache;

and in this process:

  * (d) on a fake 1 x 2 mesh (`dryrun.fake_world`) each model rank's
    counted operations against the 1 x 1 run: zamba2 at most 0.55 in
    training, prefill and decode; xLSTM at the share its whole parts
    imply (see `_xlstm_share`);
  * (e) a config whose SSM heads, inner width or feed-forward width does
    not tile the model axis is refused, and the plan's modes.
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
from test_torch_mesh_fsdp import (FLOOR_GRAD, FLOOR_MASK, STEP, _check,
                                  _check_floor)

pytestmark = pytest.mark.multidevice

ZAMBA, XLSTM = "zamba2-2.7b", "xlstm-125m"
# name: (arch, config fields beside float32)
CONFIGS = {"zamba2": (ZAMBA, {}), "xlstm": (XLSTM, {}),
           "xlstm_h1": (XLSTM, {"ssm_heads": 1})}
NO_SP = {"res_seq": None}
# (a): name, config, the rules' overrides
UNITS = [(f"{c}/{r}", c, ov) for c in CONFIGS
         for r, ov in (("sp", None), ("no_sp", NO_SP))]
# (b) against JAX: name, config, grad_accum
STEPS = [(f"{c}/{acc}", c, acc) for c in CONFIGS for acc in (1, 2)]
# (b) against one device: name, config, grad_accum, remat, overrides
SINGLE = [("xlstm/1/none", "xlstm", 1, "none", None),
          ("xlstm/2/full", "xlstm", 2, "full", None),
          ("xlstm_h1/1/full", "xlstm_h1", 1, "full", None),
          ("xlstm_h1/2/none", "xlstm_h1", 2, "none", None),
          ("xlstm/no_sp", "xlstm", 1, "none", NO_SP),
          ("zamba2/1/none", "zamba2", 1, "none", None),
          ("zamba2/2/full", "zamba2", 2, "full", None),
          ("zamba2/no_sp", "zamba2", 1, "full", NO_SP)]
# (c): name, config
SERVE = [(c, c) for c in CONFIGS]
WINDOW = 8
ROWS, PROMPT, DECODE, MAX_LEN = 4, 16, 4, 32
# zamba2's first-step gradient shards against JAX's split ones, relative
# to each parameter's largest: the floor twice, once for each package's
# split, the unsplit packages' own distance inside it (see the module
# note)
ZAMBA_JAX_GRAD = 2 * FLOOR_GRAD

JAX_REF = """
import dataclasses, json, os, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import ARCHS as ARCH_CFGS
from repro.data.synthetic import make_lm_batch
from repro.launch import shardings as shd
from repro.launch.mesh import make_debug_mesh
from repro.models import model as M
from repro.models import ssm
from repro.models.layers import rmsnorm
from repro.models.sharding_ctx import sharding_rules
from repro.training.optimizer import OptimizerConfig
from repro.training.train_loop import init_train_state, make_train_step

out_dir = sys.argv[1]
CONFIGS, STEPS, SERVE = (json.loads(a) for a in sys.argv[2:5])
WINDOW = int(sys.argv[6])
mesh = make_debug_mesh(2, 2)
out = {}


def cfg_of(name, serve=False):
    arch, extra = CONFIGS[name]
    cfg = dataclasses.replace(ARCH_CFGS[arch].reduced(), dtype="float32",
                              **extra)
    if serve and cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, sliding_window=WINDOW)
    return cfg


def flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(
                jax.device_get(tree))[0]}


def unit(cfg):
    eps = cfg.norm_eps
    if cfg.family == "hybrid":
        def fn(p, x):
            p = jax.tree_util.tree_map(lambda a: a[0, 0], p["mamba_groups"])
            return x + ssm.mamba2_forward(p["mamba"],
                                          rmsnorm(p["ln"], x, eps), cfg)
        return fn

    def fn(p, x):
        p = jax.tree_util.tree_map(lambda a: a[0], p["pairs"])
        x = x + ssm.mlstm_forward(p["mlstm"], rmsnorm(p["ln1"], x, eps), cfg)
        return x + ssm.slstm_forward(p["slstm"], rmsnorm(p["ln2"], x, eps),
                                     cfg)
    return fn


for conf in CONFIGS:
    cfg = cfg_of(conf)
    params = M.init_params(cfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, 16, cfg.d_model)).astype(np.float32)
    with mesh, sharding_rules(mesh):
        o = jax.jit(unit(cfg))(params, x)
    for k_, v in flat(params).items():
        out[f"unit/{conf}/params/{k_}"] = v
    out[f"unit/{conf}/x"] = x
    out[f"unit/{conf}/g"] = rng.normal(size=x.shape).astype(np.float32)
    out[f"unit/{conf}/out"] = np.asarray(o)

opt = OptimizerConfig(peak_lr=1e-3, total_steps=10, warmup_steps=0)
for name, conf, accum in STEPS:
    cfg = cfg_of(conf)
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
    grad = jax.jit(jax.grad(lambda p, b: M.loss_fn(p, cfg, b)[0]))
    if cfg.family == "hybrid":
        # the floor's witness: JAX's own step unsplit, from the same state
        # on the same batches
        for k_, v in flat(grad(state.params, batches[0])).items():
            out[f"step/{name}/plain_grad/{k_}"] = v
        plain, pstep = state, jax.jit(make_train_step(cfg, opt, accum))
        for batch in batches:
            plain, m = pstep(plain, batch)
        for k_, v in flat(plain.params).items():
            out[f"step/{name}/plain_final/{k_}"] = v
    with mesh, sharding_rules(mesh):
        if accum == 1 or cfg.family == "hybrid":
            grad = jax.jit(jax.grad(lambda p, b: M.loss_fn(p, cfg, b)[0]))
            for k_, v in flat(grad(
                    jax.device_put(state.params, s_shd.params),
                    jax.device_put(batches[0], b_shd))).items():
                out[f"step/{name}/grad/{k_}"] = v
        jstep = jax.jit(make_train_step(cfg, opt, accum),
                        in_shardings=(s_shd, b_shd),
                        out_shardings=(s_shd, None))
        state = jax.device_put(state, s_shd)
        for t, batch in enumerate(batches):
            state, m = jstep(state, jax.device_put(batch, b_shd))
            losses.append([float(m["loss"]), float(m["grad_norm"])])
            for k_, v in batch.items():
                out[f"step/{name}/batch{t}/{k_}"] = np.asarray(v)
    for k_, v in flat(state.params).items():
        out[f"step/{name}/final/{k_}"] = v
    out[f"step/{name}/losses"] = np.asarray(losses)

data = np.load(os.path.join(out_dir, "prompts.npz"))
tokens, nxt = data["tokens"], data["next"]
max_len = int(sys.argv[5])
for i, (name, conf) in enumerate(SERVE):
    cfg = cfg_of(conf, serve=True)
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
from repro_torch.models import fsdp
from repro_torch.models import model as model_mod
from repro_torch.models import ssm
from repro_torch.models import tensor_parallel as tpm
from repro_torch.models.convert import named_from_jax, params_from_jax
from repro_torch.models.fsdp import ShardedParams
from repro_torch.models.layers import rmsnorm
from repro_torch.models.model import decode_step, prefill
from repro_torch.models.sharding_ctx import local_batch, sharding_rules
from repro_torch.training.train_loop import train_state_from_jax

CONFIGS = json.loads(os.environ["CONFIGS"])
UNITS, STEPS, SINGLE, SERVE = (json.loads(os.environ[k]) for k in (
    "UNITS", "STEPS", "SINGLE", "SERVE"))
MAX_LEN, WINDOW = int(os.environ["MAX_LEN"]), int(os.environ["WINDOW"])
ref = np.load(os.path.join(OUT, "ref.npz"))
mesh = make_debug_mesh(2, 2, device="cpu")
D_RANK, M_RANK = mesh.get_coordinate()
COORD = mesh.get_coordinate()
opt = OptimizerConfig(peak_lr=1e-3, total_steps=10, warmup_steps=0)


def cfg_of(name, serve=False):
    arch, extra = CONFIGS[name]
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              **extra)
    if serve and cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, sliding_window=WINDOW)
    return cfg


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


def unit_of(model, cfg):
    # (its parameters' prefix, the unit, its forward under a plan or none)
    eps = cfg.norm_eps
    if cfg.family == "hybrid":
        layer = model.mamba_groups[0][0]

        def fn(x, tp):
            return x + ssm.mamba2_forward(layer.mamba,
                                          rmsnorm(layer.ln, x, eps), cfg,
                                          tp=tp)
        return "mamba_groups.0.0", layer, fn
    pair = model.pairs[0]
    return "pairs.0", pair, lambda x, tp: model_mod._pair(pair, x, cfg, None,
                                                          tp)[0]


def rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def unit(conf, overrides):
    cfg = cfg_of(conf)
    p = tree(f"unit/{conf}/params")
    x = torch.from_numpy(ref[f"unit/{conf}/x"])
    g = torch.from_numpy(ref[f"unit/{conf}/g"])
    want = torch.from_numpy(ref[f"unit/{conf}/out"])
    # the unsplit unit's gradients on one process, the global batch
    full = params_from_jax(p, cfg, device="cpu")
    prefix, mod, fn = unit_of(full, cfg)
    names = [n for n, _ in mod.named_parameters()]
    for t in mod.parameters():
        t.requires_grad_()
    xw = x.clone().requires_grad_()
    wgrads = torch.autograd.grad((fn(xw, None) * g).sum(),
                                 [xw, *mod.parameters()])
    # the split unit: this rank's rows (and sequence slice under SP)
    model = params_from_jax(p, cfg, device="cpu")
    dryrun._sharded_params(model, mesh, cfg, overrides)
    with sharding_rules(mesh, overrides):
        plan = tpm.make_plan(cfg, mesh)
    rows = slice(2 * D_RANK, 2 * D_RANK + 2)
    xs, gs, ws, wx = (t[rows] for t in (x, g, want, wgrads[0]))
    if plan.sp:
        cut = slice(8 * M_RANK, 8 * M_RANK + 8)
        xs, gs, ws, wx = (t[:, cut] for t in (xs, gs, ws, wx))
    xs = xs.clone().requires_grad_()
    prefix, mod, fn = unit_of(model, cfg)
    with ShardedParams(model, mesh, plan) as sp, sharding_rules(mesh,
                                                               overrides):
        with fsdp.gathered(mod):
            out = fn(xs, plan)
        (out * gs).sum().backward()
    errs = {"x": rel(xs.grad, wx)}
    for n, wg in zip(names, wgrads[1:]):
        full_name = f"{prefix}.{n}"
        placements = model.get_parameter(full_name).placements
        errs[n] = rel(sp.leaves[full_name].grad,
                      local_shard(wg, mesh, placements, COORD))
    return dict(out=rel(out.detach(), ws), sp=plan.sp,
                ssm_heads=plan.ssm_heads, grads=errs,
                modes={n: plan.mode(f"{prefix}.{n}") for n in names})


def first_grads(step, state, batch):
    # the step's first gradient shards, as its loss_and_grads returns them
    real, got = dp_step.loss_and_grads, []

    def captured(*args, **kwargs):
        out = real(*args, **kwargs)
        got.append({n: g.clone() for n, g in out[2].items()})
        return out
    dp_step.loss_and_grads = captured
    try:
        state, met = step(state, batch)
    finally:
        dp_step.loss_and_grads = real
    return state, met, got[0]


def step_against_jax(name, conf, accum):
    cfg = cfg_of(conf)
    init = tree(f"step/{name}/init")
    zeros = lambda t: {k: zeros(v) if isinstance(v, dict) else
                       np.zeros_like(v) for k, v in t.items()}
    state = train_state_from_jax(
        (init, {"m": zeros(init), "v": zeros(init), "step": 0}), cfg, "cpu")
    s_shd = shd.sanitize_shardings(shd.train_state_shardings(mesh, cfg),
                                   shd.state_shapes(state), mesh)
    state = shd.shard_train_state(state, s_shd)
    step = make_sharded_train_step(cfg, opt, mesh, accum)
    losses, gerr = [], None
    for t in range(2):
        batch = {k: torch.from_numpy(ref[f"step/{name}/batch{t}/{k}"])
                 for k in ("tokens", "labels")}
        if t == 0 and accum == 1:
            placements = {n: p.placements
                          for n, p in state.params.named_parameters()}
            state, met, grads = first_grads(step, state, batch)
            want = named_from_jax(tree(f"step/{name}/grad"), cfg)
            gerr = max(rel(grads[n], local_shard(
                torch.from_numpy(want[n]), mesh, placements[n], COORD))
                for n in grads)
        else:
            state, met = step(state, batch)
        losses.append([float(met["loss"]), float(met["grad_norm"])])
    want = named_from_jax(tree(f"step/{name}/final"), cfg)
    diff = {k: (p.full_tensor() - torch.from_numpy(want[k])).abs()
            for k, p in state.params.named_parameters()}
    err = max(float(d.max()) for d in diff.values())
    masked = None
    if cfg.family == "hybrid":
        # the elements whose first-step gradient (JAX's, unsplit) is above
        # AdamW's eps scale
        g = named_from_jax(tree(f"step/{name}/plain_grad"), cfg)
        masked = max(float((d * (torch.from_numpy(g[k]).abs()
                                 > FLOOR_MASK)).max())
                     for k, d in diff.items())
    return dict(err=err, masked=masked, gerr=gerr, losses=losses,
                losses_ref=ref[f"step/{name}/losses"].tolist())


def step_against_single(conf, accum, remat, overrides):
    arch, extra = CONFIGS[conf]
    return compare(mesh, arch, accum, remat, 2, overrides, **extra)


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
    return outs, state


def split_serve(model, cfg):
    dryrun._sharded_params(model, mesh, cfg, None)
    with sharding_rules(mesh):
        plan = tpm.make_plan(cfg, mesh, serving=True)
    loc = local_batch(PROMPTS, mesh)
    with ShardedParams(model, mesh, plan), sharding_rules(mesh):
        outs, state = serve(model, cfg, loc["tokens"], loc["next"], plan)
    shapes = {k: {kk: list(vv.shape) for kk, vv in v.items()}
              if isinstance(v, dict) else
              (list(v.shape) if isinstance(v, torch.Tensor) else None)
              for k, v in state.items()}
    return outs, plan, shapes


def serve_against(name, conf):
    cfg = cfg_of(conf, serve=True)
    model = params_from_jax(tree(f"serve/{name}/params"), cfg, device="cpu")
    got, plan, shapes = split_serve(model, cfg)
    np.savez(os.path.join(OUT, f"port_{name}_rank{RANK}.npz"),
             *[t.numpy() for t in got])
    # the unsplit path on the same parameters, this rank's rows
    one, _ = serve(init_params(cfg, 0, device="cpu"), cfg,
                   PROMPTS["tokens"], PROMPTS["next"], None)
    got, _, _ = split_serve(init_params(cfg, 0, device="cpu"), cfg)
    rows = slice(2 * D_RANK, 2 * D_RANK + 2)
    return dict(ssm_heads=plan.ssm_heads, shapes=shapes,
                single_err=max(rel(g, w[rows]) for g, w in zip(got, one)))


PROMPTS = {k: torch.from_numpy(v) for k, v in np.load(
    os.path.join(OUT, "prompts.npz")).items()}
units = {name: unit(c, ov) for name, c, ov in UNITS}
steps = {c[0]: step_against_jax(*c) for c in STEPS}
single = {name: step_against_single(*c) for name, *c in SINGLE}
with torch.no_grad():
    served = {name: serve_against(name, conf) for name, conf in SERVE}
report(units=units, steps=steps, single=single, serve=served)
"""


@pytest.fixture(scope="module")
def ssm_tp(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ssm_tp"))
    rng = np.random.default_rng(41)
    np.savez(os.path.join(out, "prompts.npz"),
             tokens=rng.integers(0, 500, (ROWS, PROMPT)).astype(np.int32),
             next=rng.integers(0, 500, (ROWS, DECODE)).astype(np.int32))
    env = _env()
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    jax_run = subprocess.run(
        [sys.executable, "-c", JAX_REF, out, json.dumps(CONFIGS),
         json.dumps(STEPS), json.dumps(SERVE), str(MAX_LEN), str(WINDOW)],
        env=env, capture_output=True, text=True, timeout=500)
    assert jax_run.returncode == 0 and "JAX_REF_OK" in jax_run.stdout, (
        jax_run.stdout + jax_run.stderr)
    reports = run_ranks(
        PORT, out, timeout=500, CONFIGS=json.dumps(CONFIGS),
        UNITS=json.dumps(UNITS), STEPS=json.dumps(STEPS),
        SINGLE=json.dumps(SINGLE), SERVE=json.dumps(SERVE), MAX_LEN=MAX_LEN,
        WINDOW=WINDOW)
    return dict(reports=reports, out=out)


@pytest.mark.parametrize("case", UNITS, ids=[c[0] for c in UNITS])
def test_unit_under_a_plan_equals_jax(ssm_tp, case):
    """(a): each rank's output of the unit (its rows, its slice of the
    sequence under SP) against JAX's jitted unit on the same mesh, within
    1e-5 of the largest; the mLSTM cell splits by heads where they tile
    the model axis."""
    name, conf, overrides = case
    for rank, rep in enumerate(ssm_tp["reports"]):
        got = rep["units"][name]
        assert got["out"] <= 1e-5, (rank, got["out"])
        assert got["sp"] == (overrides is None)
        assert got["ssm_heads"] == (conf != "xlstm_h1")


@pytest.mark.parametrize("case", UNITS, ids=[c[0] for c in UNITS])
def test_unit_gradients_under_a_plan_match_unsplit(ssm_tp, case):
    """(a): the gradients of <out, g> through `ShardedParams` (each leaf
    this rank's shard of the gradient, summed over the data ranks and,
    for a "partial" parameter, over "model") and of the input, against the
    unsplit unit's on one process, within 1e-5 of each one's largest: a
    norm whose backward did not sum over "model", or a whole region (B
    and C, the sLSTM recurrence, an mLSTM cell kept whole) whose gradient
    counted on every rank, is off by its whole size."""
    name, conf, _ = case
    for rank, rep in enumerate(ssm_tp["reports"]):
        got = rep["units"][name]
        for what, err in got["grads"].items():
            assert err <= 1e-5, (rank, what, err, got["modes"].get(what))


@pytest.mark.parametrize("case", STEPS, ids=[c[0] for c in STEPS])
def test_sharded_ssm_step_under_a_plan_matches_jax(ssm_tp, case):
    """(b): the tensor-parallel step against JAX's jitted step from the
    same parameters on the same batches: loss and grad norm within 1e-5
    relative on both steps; xLSTM's parameters within 2e-4 after two
    steps; zamba2's within 2e-4 where JAX's first-step gradient exceeds
    FLOOR_MASK, and its first-step gradient shards within
    `ZAMBA_JAX_GRAD` of each parameter's largest |g| (see the module
    note)."""
    name, conf, accum = case
    for rank, rep in enumerate(ssm_tp["reports"]):
        got = rep["steps"][name]
        for (loss, gn), (jl, jg) in zip(got["losses"], got["losses_ref"]):
            assert abs(loss - jl) < 1e-5 * max(1.0, abs(jl)), (rank, got)
            assert abs(gn - jg) < 1e-5 * max(1.0, abs(jg)), (rank, got)
        if conf == "zamba2":
            assert got["masked"] < 2e-4, (rank, got)
            if accum == 1:
                assert got["gerr"] <= ZAMBA_JAX_GRAD, (rank, got["gerr"])
        else:
            assert got["err"] < 2e-4, (rank, got)


def _layer_rel(want: np.ndarray, got: np.ndarray, stacked: bool) -> float:
    """max |got - want| relative to want's largest |.|, a layer at a time
    where the leaf stacks zamba2's Mamba2 layers (groups, layers, ...),
    as the port's leaves are a layer each."""
    if stacked:
        want = want.reshape(-1, *want.shape[2:])
        got = got.reshape(-1, *got.shape[2:])
        return max(_layer_rel(w, g, False) for w, g in zip(want, got))
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.mark.parametrize("accum", [1, 2])
def test_jax_own_split_sits_on_zamba2s_float32_floor(ssm_tp, accum):
    """(b)'s witness for zamba2's bounds: JAX's own jitted step under
    `sharding_rules` on the 2 x 2 mesh against its unsplit jitted step,
    from the same state on the same batches. Its split misses the bounds
    that `_check` holds the other families to (a layer's first-step
    gradients further than 1e-5 of its largest, the parameters further
    than 2e-4 after two steps), so no split of this float32 config can be
    held to them; it meets FLOOR_GRAD, and 2e-4 on the parameters whose
    first-step gradient exceeds FLOOR_MASK (`_check_floor`'s bounds)."""
    name = f"zamba2/{accum}"
    ref = np.load(os.path.join(ssm_tp["out"], "ref.npz"))

    def leaves(what):
        pre = f"step/{name}/{what}/"
        return {k[len(pre):]: ref[k] for k in ref.files if k.startswith(pre)}
    g_split, g_plain = leaves("grad"), leaves("plain_grad")
    p_split, p_plain = leaves("final"), leaves("plain_final")
    gerr = max(_layer_rel(g_plain[k], g_split[k],
                          k.startswith("mamba_groups/")) for k in g_plain)
    diff = {k: np.abs(p_split[k] - p_plain[k]) for k in p_plain}
    err = max(float(d.max()) for d in diff.values())
    masked = max(float((d * (np.abs(g_plain[k]) > FLOOR_MASK)).max())
                 for k, d in diff.items())
    assert 1e-5 < gerr <= FLOOR_GRAD, gerr
    assert err > 2e-4 and masked < 2e-4, (err, masked)


@pytest.mark.parametrize("case", SINGLE, ids=[c[0] for c in SINGLE])
def test_sharded_ssm_step_under_a_plan_matches_single_device(ssm_tp, case):
    """(b): the step under the plan against the single-device step: for
    xLSTM `_check` (parameters and moments within 2e-4 after two steps,
    the first step's gradient shards within 1e-5 of the largest, the
    metrics within 1e-5); for zamba2 `_check_floor` (see the module
    note)."""
    check = _check_floor if case[1] == "zamba2" else _check
    for rep in ssm_tp["reports"]:
        check(rep["single"][case[0]])


@pytest.mark.parametrize("case", SERVE, ids=[c[0] for c in SERVE])
def test_ssm_serving_under_a_plan_matches_jax(ssm_tp, case):
    """(c): each rank's prefill logits (its rows, the whole padded vocab)
    and its 4 decode steps' against JAX's sharded `prefill` and
    `decode_step` from the same parameters, within 2e-4 of the largest
    |logit|, and against the unsplit path, within 1e-4. The decode state
    is the rank's shard: its Mamba2 heads and the channels it convolves,
    its kv heads of zamba2's ring cache, its mLSTM heads (whole on one
    head) and conv channels, the sLSTM's whole."""
    name, conf = case
    out = ssm_tp["out"]
    want = np.load(os.path.join(out, "ref.npz"))
    want = [want[f"serve/{name}/logits{t}"] for t in range(1 + DECODE)]
    arch, extra = CONFIGS[conf]
    cfg = dataclasses.replace(get_config(arch).reduced(), **extra)
    for rank, rep in enumerate(ssm_tp["reports"]):
        got = rep["serve"][name]
        arrs = np.load(os.path.join(out, f"port_{name}_rank{rank}.npz"))
        rows = slice(2 * (rank // 2), 2 * (rank // 2) + 2)
        for i, w in enumerate(want):
            g = arrs[f"arr_{i}"]
            assert g.shape == w[rows].shape, (g.shape, w.shape)
            err = np.abs(g - w[rows]).max() / np.abs(w[rows]).max()
            assert err <= 2e-4, (name, i, err)
        assert got["single_err"] <= 1e-4, got
        shapes = got["shapes"]
        h, di = cfg.n_ssm_heads, 2 * cfg.d_model
        if cfg.family == "hybrid":
            n = cfg.ssm_state_dim
            assert shapes["mamba"]["h"][3] == h // 2
            assert shapes["mamba"]["conv"][-1] == cfg.d_inner // 2 + 2 * n
            assert shapes["k"][2:4] == [WINDOW, cfg.num_kv_heads // 2]
        else:
            assert shapes["mlstm"]["c"][2] == (h // 2 if h % 2 == 0 else h)
            assert shapes["mlstm"]["conv"][-1] == di // 2
            assert shapes["slstm"]["h"][-1] == cfg.d_model


def _flops(cfg, shape) -> dict:
    flops = {}
    for m, rank in ((1, 0), (2, 0), (2, 1)):
        with dryrun.fake_world((1, m), ("data", "model"), rank) as mesh:
            rec = dryrun.dry_run_cell(cfg, shape, mesh)
        flops[m, rank] = rec["cost_per_device"]["flops"]
    return flops


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_a_zamba2_rank_computes_its_share(kind):
    """(d): under the op analyzer on a fake 1 x 2 mesh each model rank of
    zamba2's train step, prefill and decode counts at most 0.55 of the
    1 x 1 run's operations: its Mamba2 heads, its shared-attention heads,
    its vocabulary columns; what repeats on both ranks is small (the B
    and C columns of `in_proj` and their conv, the heads' C·B products)."""
    cfg = get_config(ZAMBA).reduced()
    flops = _flops(cfg, ShapeConfig(f"{kind}_tiny", 64, 4, kind))
    for rank in (0, 1):
        assert flops[2, rank] <= 0.55 * flops[1, 0], flops


def _xlstm_share(cfg, kind: str, seq: int) -> float:
    """The share of the 1 x 1 run's counted operations that a rank of a
    1 x 2 mesh counts, from the parts that stay whole on every rank: the
    sLSTM's input projection (D x 4D a token) and its block-diagonal
    recurrence (4 heads of D/4 x D a token), 5·D² multiply-adds a token
    of a pair, while every other product splits in two: the mLSTM's
    projections (2·D·di up and gate, 3·di² q/k/v, 2·di·H gates, di·D
    down, 4·di conv), its cell (a head a token: 3·Q·dk for the chunk's
    scores, weights·V and normaliser, 2·dk² + 2·dk for the reads and the
    update of C and n; a decode step 3·dk² + 2·dk), the sLSTM's
    feed-forward (2·D·ff) and the head (D·V). Training counts each
    product's backward in the same proportion. The reduced config's
    prefill counts exactly this share (0.5767)."""
    from repro_torch.models.ssm import slstm_ff_width
    d, h, vocab = cfg.d_model, cfg.n_ssm_heads, cfg.padded_vocab
    di, ff = 2 * d, slstm_ff_width(cfg)
    dk = di // h
    q = min(cfg.ssm_chunk, seq)
    whole = 4 * d * d + d * d
    proj = 2 * d * di + 3 * di * di + 2 * di * h + di * d + 4 * di
    cell = (h * (3 * q * dk + 2 * dk * dk + 2 * dk) if kind != "decode"
            else h * (3 * dk * dk + 2 * dk))
    split = proj + cell + 2 * d * ff
    pairs = cfg.num_layers // 2
    head = d * vocab
    total = pairs * (whole + split) + head
    return (pairs * (whole + split / 2) + head / 2) / total


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_an_xlstm_rank_computes_its_share(kind):
    """(d): each model rank of xlstm's train step, prefill and decode on
    a fake 1 x 2 mesh counts no more than the share its whole parts
    imply (`_xlstm_share`, + 0.02) of the 1 x 1 run's operations, and no
    less than half: the sLSTM recurrence stays whole, everything else
    splits."""
    cfg = get_config(XLSTM).reduced()
    flops = _flops(cfg, ShapeConfig(f"{kind}_tiny", 64, 4, kind))
    share = _xlstm_share(cfg, kind, 64)
    for rank in (0, 1):
        got = flops[2, rank] / flops[1, 0]
        assert 0.5 <= got <= share + 0.02, (got, share, flops)


def test_ssm_widths_that_do_not_tile_are_refused():
    """(e): the plan splits the SSM heads and inner widths, so a zamba2
    whose SSM heads or kv heads, or an xLSTM whose mLSTM or sLSTM
    feed-forward width, does not tile the model axis is refused; the
    modes follow JAX's specs (Mamba2's fused `in_proj` and conv gathered
    whole, the sLSTM recurrence repeated)."""
    from repro_torch.models import tensor_parallel as tpm
    from repro_torch.models.sharding_ctx import sharding_rules
    zamba, xlstm = get_config(ZAMBA).reduced(), get_config(XLSTM).reduced()
    with dryrun.fake_world((1, 2), ("data", "model")) as mesh:
        with sharding_rules(mesh):
            with pytest.raises(ValueError, match="SSM head count 3"):
                tpm.make_plan(dataclasses.replace(zamba, ssm_heads=3), mesh)
            with pytest.raises(ValueError, match="kv head count 1"):
                tpm.make_plan(dataclasses.replace(zamba, num_kv_heads=1),
                              mesh)
            plan = tpm.make_plan(zamba, mesh)
            xplan = tpm.make_plan(dataclasses.replace(xlstm, ssm_heads=1),
                                  mesh)
    assert plan.ssm_heads and not xplan.ssm_heads
    g = "mamba_groups.0.0.mamba."
    assert [plan.mode(g + n) for n in (
        "in_proj.weight", "conv_w", "conv_b", "a_log", "d_skip", "dt_bias",
        "norm.scale", "out_proj.weight")] == ["partial"] * 3 + ["local"] * 5
    assert plan.mode("shared_attn.attn.wq.weight") == "local"
    assert plan.mode("pairs.0.mlstm.f_bias") == "partial"
    assert xplan.mode("pairs.0.mlstm.f_bias") == "replica"
    assert xplan.mode("pairs.0.mlstm.w_q.weight") == "local"
    assert [xplan.mode(f"pairs.0.slstm.{n}") for n in (
        "w_in.weight", "r", "bias", "w_ff_up.weight",
        "w_ff_down.weight")] == ["replica"] * 3 + ["local"] * 2
    with dryrun.fake_world((1, 16), ("data", "model")) as mesh:
        with sharding_rules(mesh):
            with pytest.raises(ValueError,
                               match="sLSTM feed-forward width 168"):
                tpm.make_plan(xlstm, mesh)
            with pytest.raises(ValueError, match="mLSTM width 264"):
                tpm.make_plan(dataclasses.replace(xlstm, d_model=132), mesh)
            big = tpm.make_plan(get_config(XLSTM), mesh)
            zplan = tpm.make_plan(get_config(ZAMBA), mesh)
    # xlstm-125m's 4 mLSTM heads do not tile 16: its cells run whole
    assert big is not None and not big.ssm_heads
    assert zplan is not None and zplan.ssm_heads
