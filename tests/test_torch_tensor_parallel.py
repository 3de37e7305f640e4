"""Tensor-parallel compute on the "model" axis in the sharded train step
(`models/tensor_parallel.py`, `models/fsdp.py`'s modes, the split
attention, MLP, embedding, head and loss), in `gloo` processes on the CPU:

  * (a) the slice against JAX: on the 2 x 2 ("data", "model") debug mesh
    the port's step (four ranks) and JAX's jitted sharded step on four XLA
    CPU devices (`tests/test_distributed.py`'s build) run from the same
    parameters (`models/convert.py`) on the same numpy-seeded batches of
    the reduced stablelm-1.6b: parameters within 2e-4, losses within 1e-5
    after two steps;
  * (b) every family of the slice against the single-device step
    (`tests/test_torch_mesh_fsdp.py`'s tolerances): stablelm-1.6b on the
    heads path (remat "none" and "full", grad_accum 1 and 2), minicpm-2b
    (tied: the vocab-parallel table in the embedding and the head),
    starcoder2-7b with one kv head (1 does not tile 2: the
    context-parallel fallback, `q_offset` > 0), hubert-xlarge (frames,
    bidirectional), stablelm-1.6b and the fallback under `no_sp`, each
    also on its first-step gradient shards; minicpm-2b with a padded vocab
    that does not tile the axis, its gradients against the single-device
    ones; a d_ff that does not tile it refused;
  * (c) each boundary Function and the vocab-parallel embedding and
    cross-entropy against its unsplit formula at the model axis' two
    ranks, forward and gradient (a negative token id, a label in the
    padded columns, a fully masked row);
  * (e) `_Layout.scatter`'s modes: a "model"-replicated gradient summed
    over "model" only in mode "partial" — and a norm scale's gradient in
    the step equal to the single-device one only so;
  * (d) the compute is split: a rank's counted operations under
    `roofline/op_analyzer.py` on a fake 1 x 2 mesh against 1 x 1, on both
    model ranks.

One module-scoped launch of four ranks runs (a), (b), (c) and (e); JAX's
step runs in one subprocess beside it, whose initial parameters the
ranks wait for.
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
from repro_torch.models.convert import named_from_jax
from test_torch_dp_step import _env, run_ranks
from test_torch_mesh_fsdp import STEP, _check

pytestmark = pytest.mark.multidevice

CASES = [
    ("stablelm/1/none", "stablelm-1.6b", 1, "none", {}, None),
    ("stablelm/2/none", "stablelm-1.6b", 2, "none", {}, None),
    ("stablelm/1/full", "stablelm-1.6b", 1, "full", {}, None),
    ("stablelm/2/full", "stablelm-1.6b", 2, "full", {}, None),
    ("minicpm/tied", "minicpm-2b", 1, "none", {}, None),
    ("starcoder2/fallback", "starcoder2-7b", 1, "full",
     {"num_kv_heads": 1}, None),
    ("hubert/frames", "hubert-xlarge", 1, "none", {}, None),
    ("stablelm/no_sp", "stablelm-1.6b", 2, "none", {}, {"res_seq": None}),
    ("starcoder2/fallback/no_sp", "starcoder2-7b", 1, "none",
     {"num_kv_heads": 1}, {"res_seq": None}),
]
# the padded vocab (511) does not tile 2: the tied table and the head
# replicated
UNTILED = {"vocab_size": 511, "vocab_round": 1}
BOUNDARIES = ("gather_seq", "gather_seq/split_grad", "scatter_seq",
              "split_seq", "copy_to_region", "reduce_from_region",
              "vocab_parallel_embed", "vocab_parallel_embed/no_sp",
              "vocab_parallel_cross_entropy")

# JAX's sharded step on 4 fake devices from its own initial parameters,
# written first (the ranks start from them), then two steps on the test's
# batches
JAX_STEP = """
import dataclasses, os, sys
import numpy as np, jax
from repro.configs import ARCHS
from repro.launch import shardings as shd
from repro.launch.mesh import make_debug_mesh
from repro.models.model import init_params
from repro.models.sharding_ctx import sharding_rules
from repro.training.optimizer import OptimizerConfig
from repro.training.train_loop import init_train_state, make_train_step

out_dir = sys.argv[1]
cfg = dataclasses.replace(ARCHS["stablelm-1.6b"].reduced(), dtype="float32")
opt = OptimizerConfig(peak_lr=1e-3, total_steps=10, warmup_steps=0)
params = init_params(cfg, jax.random.PRNGKey(3))


def flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


np.savez(os.path.join(out_dir, "params.tmp.npz"), **flat(params))
os.replace(os.path.join(out_dir, "params.tmp.npz"),
           os.path.join(out_dir, "params.npz"))
data = np.load(os.path.join(out_dir, "batches.npz"))
state = init_train_state(cfg, params)
mesh = make_debug_mesh(2, 2)
s_abs = jax.tree_util.tree_map(
    lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state)
s_shd = shd.sanitize_shardings(shd.train_state_shardings(mesh, cfg), s_abs,
                               mesh)
losses = []
with mesh, sharding_rules(mesh):
    step = jax.jit(make_train_step(cfg, opt), out_shardings=(s_shd, None))
    state = jax.device_put(state, s_shd)
    for t in range(2):
        batch = {k: data[f"{k}{t}"] for k in ("tokens", "labels")}
        b_shd = {k: shd.sanitize_shardings(v, batch[k], mesh)
                 for k, v in shd.batch_shardings(mesh, cfg).items()}
        state, m = step(state, jax.device_put(batch, b_shd))
        losses.append(float(m["loss"]))
np.savez(os.path.join(out_dir, "after.npz"), losses=np.asarray(losses),
         **flat(jax.device_get(state.params)))
print("JAX_TP_OK")
"""

RANKS = STEP + """
import time
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import tensor_parallel as tpm
from repro_torch.models.fsdp import ShardedParams, _Layout
from repro_torch.models.model import _CrossEntropy
from repro_torch.models.sharding_ctx import local_batch, sharding_rules
from repro_torch.training.train_loop import train_state_from_jax
mesh = make_debug_mesh(2, 2, device="cpu")
coord = dict(zip(("data", "model"), mesh.get_coordinate()))
M = coord["model"]
opt = OptimizerConfig(peak_lr=1e-3, total_steps=10, warmup_steps=0)


def cfg_of(arch, remat="none", **extra):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               remat=remat, **extra)


def compare_tp(arch, accum, remat, extra, overrides):
    # tests/test_torch_mesh_fsdp.py's run, with the rules' overrides, and
    # the plan it ran
    got = compare(mesh, arch, accum, remat, 2, overrides, **extra)
    with sharding_rules(mesh, overrides):
        plan = tpm.make_plan(cfg_of(arch, remat, **extra), mesh)
    return dict(got, heads=plan.heads, sp=plan.sp)


def grads_against_single(arch, extra, overrides):
    # each parameter's gradient shard against the single-device gradient,
    # relative to its largest element, with the step's label weights
    cfg = cfg_of(arch, **extra)
    batch = make_lm_batch(cfg, 4, 16, 0, 0)
    batch["labels"][0:2, :12] = -1
    batch["labels"][2, :] = -1
    ref = init_train_state(cfg, init_params(cfg, 0, device="cpu",
                                            param_dtype=torch.float32))
    _, _, rg = loss_and_grads(ref.params, cfg, batch)
    state, _ = ltrain.sharded_state(cfg, 0, mesh, torch.device("cpu"))
    model = state.params
    loc = local_batch(batch, mesh)
    valid = (loc["labels"] >= 0).sum().float()
    total = (batch["labels"] >= 0).sum().float()
    with sharding_rules(mesh, overrides):
        plan = tpm.make_plan(cfg, mesh)
    sp = ShardedParams(model, mesh, plan=plan)
    with sp, sharding_rules(mesh, overrides):
        _, _, grads = loss_and_grads(model, cfg, loc, 1,
                                     (valid / total)[None], sp.leaves)
    err = max(float((grads[n] - local_shard(
        rg[n], mesh, model.get_parameter(n).placements,
        mesh.get_coordinate())).abs().max()) / float(rg[n].abs().max())
        for n in grads)
    return dict(err=err, vocab=plan.vocab)


def rand(seed, *shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def grad_of(fn, x, g):
    x = x.clone().requires_grad_()
    y = fn(x)
    (y * g).sum().backward()
    return y.detach(), x.grad


def boundaries(plan, plan_nosp):
    # each rank's tensors are drawn from its model rank's seed, so every
    # rank can form the others' (the unsplit formula's operands)
    b, s, d = 2, 8, 6
    h = s // 2
    sl = slice(M * h, (M + 1) * h)
    errs = {}
    xs = [rand(10 + r, b, s, d) for r in range(2)]
    gs = [rand(20 + r, b, s, d) for r in range(2)]
    hs = [rand(30 + r, b, h, d) for r in range(2)]
    # all-gather: forward the whole x, backward the sum of the gradients'
    # slices (split_grad: the slice of the one gradient)
    y, gx = grad_of(lambda t: tpm.gather_seq(t, plan), xs[0][:, sl], gs[M])
    errs["gather_seq"] = max(float((y - xs[0]).abs().max()),
                             float((gx - (gs[0] + gs[1])[:, sl]).abs().max()))
    y, gx = grad_of(lambda t: tpm.gather_seq(t, plan, split_grad=True),
                    xs[0][:, sl], gs[0])
    errs["gather_seq/split_grad"] = max(float((y - xs[0]).abs().max()),
                                        float((gx - gs[0][:, sl]).abs().max()))
    # reduce-scatter: forward the slice of the sum, backward the gradients'
    # slices gathered
    y, gx = grad_of(lambda t: tpm.scatter_seq(t, plan), xs[M], hs[M])
    errs["scatter_seq"] = max(
        float((y - (xs[0] + xs[1])[:, sl]).abs().max()),
        float((gx - torch.cat(hs, 1)).abs().max()))
    y, gx = grad_of(lambda t: tpm.split_seq(t, plan_nosp), xs[0], hs[M])
    errs["split_seq"] = max(float((y - xs[0][:, sl]).abs().max()),
                            float((gx - torch.cat(hs, 1)).abs().max()))
    y, gx = grad_of(lambda t: tpm.copy_to_region(t, plan_nosp), xs[0], gs[M])
    errs["copy_to_region"] = max(float((y - xs[0]).abs().max()),
                                 float((gx - gs[0] - gs[1]).abs().max()))
    y, gx = grad_of(lambda t: tpm.reduce_from_region(t, plan_nosp), xs[M],
                    gs[0])
    errs["reduce_from_region"] = max(
        float((y - xs[0] - xs[1]).abs().max()),
        float((gx - gs[0]).abs().max()))
    # the vocab-parallel lookup: this rank's rows of a (16, d) table
    table = rand(40, 16, d)
    tokens = torch.randint(0, 16, (b, s),
                           generator=torch.Generator().manual_seed(41))
    tokens[0, 0] = -1                      # from the end, as table[-1]
    rows = slice(M * 8, (M + 1) * 8)
    for name, p, g in (("vocab_parallel_embed", plan, hs[M]),
                       ("vocab_parallel_embed/no_sp", plan_nosp, gs[0])):
        y, gt = grad_of(lambda t: tpm.vocab_parallel_embed(
            t, tokens, torch.float32, p), table[rows], g)
        want, gw = grad_of(lambda t: t[tokens.long()], table,
                           torch.cat(hs, 1) if p.sp else gs[0])
        want = want[:, sl] if p.sp else want
        errs[name] = max(float((y - want).abs().max()),
                         float((gt - gw[rows]).abs().max()))
    # the vocab-parallel cross-entropy: 64 padded columns, 60 real, a
    # label in the padding, a fully masked row, masked labels
    logits = rand(50, b, s, 64)
    labels = torch.randint(0, 60, (b, s),
                           generator=torch.Generator().manual_seed(51))
    labels[0, :3] = -1
    labels[1, 5] = 62
    labels[1, 6] = 63
    logits = torch.cat([logits, rand(52, 1, s, 64)])
    labels = torch.cat([labels, torch.full((1, s), -1)])
    full = logits.clone().requires_grad_()
    ref = _CrossEntropy.apply(full, labels, 60)
    ref.backward()
    cols = slice(M * 32, (M + 1) * 32)
    loc = logits[..., cols].clone().requires_grad_()
    got = tpm.vocab_parallel_cross_entropy(loc, labels, 60, plan, 1 << 9)
    got.backward()
    errs["vocab_parallel_cross_entropy"] = max(
        abs(float(got) - float(ref)) / abs(float(ref)),
        float((loc.grad - full.grad[..., cols]).abs().max()))
    return errs


def scatter_repair():
    # a (4,)-vector replicated over "model", split over "data" (a norm
    # scale's placements); each rank's gradient differs over both axes
    from torch.distributed.tensor import Replicate, Shard
    axes = [(a, 2, mesh.get_group(a)) for a in ("data", "model")]
    rank = 2 * coord["data"] + M
    g = torch.arange(8.) * (1 + rank) + 0.25 * rank
    total = sum(torch.arange(8.) * (1 + r) + 0.25 * r for r in range(4))
    data_only = sum(torch.arange(8.) * (1 + 2 * dr + M) + 0.25 * (2 * dr + M)
                    for dr in range(2))
    pl = (Shard(0), Replicate())
    want = local_shard(total, mesh, pl, mesh.get_coordinate())
    out = {}
    for mode in ("partial", "replica"):
        got = _Layout(pl, axes, mode).scatter(g, coord)
        out[mode] = float((got - want).abs().max())
    out["replica_is_data_only"] = bool(torch.equal(
        _Layout(pl, axes, "replica").scatter(g, coord),
        local_shard(data_only, mesh, pl, mesh.get_coordinate())))
    # Shard over "model" too, gathered whole (the fallback's attention
    # weights): reduce-scattered over both axes
    pl2 = (Shard(0), Shard(0))
    got = _Layout(pl2, axes, "partial").scatter(g, coord)
    out["partial_sharded"] = float((got - local_shard(
        total, mesh, pl2, mesh.get_coordinate())).abs().max())
    # "local": the gradient is already this rank's model shard; only the
    # data axis is summed
    pl3 = (Replicate(), Shard(0))
    gl = g[:4]
    want3 = sum((torch.arange(8.) * (1 + 2 * dr + M)
                 + 0.25 * (2 * dr + M))[:4] for dr in range(2))
    out["local"] = float((_Layout(pl3, axes, "local").scatter(gl, coord)
                          - want3).abs().max())
    # the step: a norm scale's gradient against the single-device one,
    # with the "model" sum (the plan's "partial") and without it (forced
    # to "replica", the layout before the repair)
    cfg = cfg_of("stablelm-1.6b")
    batch = make_lm_batch(cfg, 4, 16, 0, 0)
    ref = init_train_state(cfg, init_params(cfg, 0, device="cpu",
                                            param_dtype=torch.float32))
    _, _, rg = loss_and_grads(ref.params, cfg, batch)
    state, _ = ltrain.sharded_state(cfg, 0, mesh, torch.device("cpu"))
    model = state.params
    loc = local_batch(batch, mesh)
    names = [n for n, _ in model.named_parameters() if n.endswith("scale")]
    for tag in ("partial", "replica"):
        with sharding_rules(mesh):
            plan = tpm.make_plan(cfg, mesh)
        sp = ShardedParams(model, mesh, plan=plan)
        if tag == "replica":
            for n in names:
                sp.layouts[n] = _Layout(model.get_parameter(n).placements,
                                        sp.axes, "replica")
        with sp, sharding_rules(mesh):
            _, _, grads = loss_and_grads(model, cfg, loc, 1,
                                         torch.tensor([0.5]), sp.leaves)
        out[f"norm/{tag}"] = max(float((grads[n] - local_shard(
            rg[n], mesh, model.get_parameter(n).placements,
            mesh.get_coordinate())).abs().max()) for n in names)
    return out


def against_jax():
    # JAX's initial parameters, written by its subprocess before its step
    path = os.path.join(OUT, "params.npz")
    deadline = time.monotonic() + 240
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise RuntimeError("JAX's parameters did not appear")
        time.sleep(0.2)
    ref = np.load(path)
    params = {}
    for k in ref.files:
        node = params
        *path_, last = k.split("/")
        for p in path_:
            node = node.setdefault(p, {})
        node[last] = ref[k]
    zeros = lambda t: {k: zeros(v) if isinstance(v, dict) else
                       np.zeros_like(v) for k, v in t.items()}
    state = train_state_from_jax(
        (params, {"m": zeros(params), "v": zeros(params), "step": 0}),
        CFG, "cpu")
    s_shd = shd.sanitize_shardings(shd.train_state_shardings(mesh, CFG),
                                   shd.state_shapes(state), mesh)
    state = shd.shard_train_state(state, s_shd)
    step = make_sharded_train_step(CFG, opt, mesh)
    data = np.load(os.path.join(OUT, "batches.npz"))
    losses = []
    for t in range(2):
        batch = {k: torch.from_numpy(data[f"{k}{t}"])
                 for k in ("tokens", "labels")}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    full = {n: p.full_tensor().numpy()
            for n, p in state.params.named_parameters()}
    if RANK == 0:
        np.savez(os.path.join(OUT, "port.npz"), **full)
    return losses


with sharding_rules(mesh):
    PLAN = tpm.make_plan(CFG, mesh)
with sharding_rules(mesh, {"res_seq": None}):
    PLAN_NOSP = tpm.make_plan(CFG, mesh)
cases = json.loads(os.environ["CASES"])
UNTILED = json.loads(os.environ["UNTILED"])
report(boundaries=boundaries(PLAN, PLAN_NOSP), repair=scatter_repair(),
       untiled={"sp": grads_against_single("minicpm-2b", UNTILED, None),
                "no_sp": grads_against_single("minicpm-2b", UNTILED,
                                              {"res_seq": None})},
       cases={name: compare_tp(a, acc, remat, extra, ov)
              for name, a, acc, remat, extra, ov in cases},
       jax_losses=against_jax())
"""


@pytest.fixture(scope="module")
def tp_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp"))
    rng = np.random.default_rng(29)
    batches = {}
    for t in range(2):
        seq = rng.integers(0, 512, (4, 33)).astype(np.int32)
        batches[f"tokens{t}"] = seq[:, :-1]
        batches[f"labels{t}"] = seq[:, 1:]
    np.savez(os.path.join(out, "batches.npz"), **batches)
    env = _env()
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_STEP, out],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    try:
        reports = run_ranks(RANKS, out, timeout=420, CASES=json.dumps(CASES),
                        UNTILED=json.dumps(UNTILED))
        log = jax_proc.communicate(timeout=300)[0]
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert jax_proc.returncode == 0 and "JAX_TP_OK" in log, log
    return dict(reports=reports, out=out)


def test_the_slice_matches_jax_sharded_step(tp_ranks):
    """(a): the port's tensor-parallel step on the 2 x 2 mesh against
    JAX's jitted sharded step from the same parameters on the same
    numpy-seeded batches."""
    out = tp_ranks["out"]
    after = np.load(os.path.join(out, "after.npz"))
    tree = {}
    for k in after.files:
        if k == "losses":
            continue
        node = tree
        *path, last = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = after[k]
    cfg = dataclasses.replace(get_config("stablelm-1.6b").reduced(),
                              dtype="float32")
    want = named_from_jax(tree, cfg)
    port = np.load(os.path.join(out, "port.npz"))
    err = max(float(np.abs(port[n] - w).max()) for n, w in want.items())
    assert err < 2e-4, err
    for rep in tp_ranks["reports"]:
        assert np.allclose(rep["jax_losses"], after["losses"], rtol=0,
                           atol=1e-5), (rep["jax_losses"], after["losses"])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_each_family_matches_single_device(tp_ranks, case):
    """(b): the heads path, the fallback and `no_sp` against the
    single-device step (`tests/test_torch_mesh_fsdp.py`'s `_check`: the
    parameters and moments after two steps, and the first step's gradient
    shards)."""
    name, arch, _, _, extra, ov = case
    for rep in tp_ranks["reports"]:
        got = rep["cases"][name]
        _check(got)
        assert got["heads"] == ("num_kv_heads" not in extra)
        assert got["sp"] == (ov is None)


@pytest.mark.parametrize("rules", ["sp", "no_sp"])
def test_untiled_dims_match_single_device_gradients(tp_ranks, rules):
    """(b), a padded vocab of 511 that does not tile the model axis' two
    ranks: the tied table and the head stay replicated (as
    `sanitize_shardings` leaves them), the MLP split; every gradient shard
    equals the single-device gradient's to float32 rounding. (The
    parameters after AdamW are not compared here: elements whose gradient
    is rounding noise, ~1e-8 against eps 1e-8, move by up to the learning
    rate.)"""
    for rep in tp_ranks["reports"]:
        got = rep["untiled"][rules]
        assert not got["vocab"], got
        assert got["err"] < 1e-5, got


def test_a_d_ff_that_does_not_tile_is_refused():
    """Every configuration's d_ff tiles the model axis, so the plan has no
    unsplit MLP: a d_ff of 201 on two model ranks is refused, as a sequence
    that does not split is."""
    from repro_torch.models import tensor_parallel as tpm
    from repro_torch.models.sharding_ctx import sharding_rules
    cfg = dataclasses.replace(get_config("minicpm-2b").reduced(), d_ff=201)
    with dryrun.fake_world((1, 2), ("data", "model")) as mesh:
        with sharding_rules(mesh):
            with pytest.raises(ValueError, match="d_ff 201"):
                tpm.make_plan(cfg, mesh)
            assert tpm.make_plan(get_config("minicpm-2b").reduced(),
                                 mesh) is not None


@pytest.mark.parametrize("name", BOUNDARIES)
def test_boundaries_match_the_unsplit_formula(tp_ranks, name):
    """(c): forward and gradient of each boundary at the model axis' two
    ranks against the formula on whole tensors (the collectives move
    float32 values: the gathers and slices exact, one sum of two)."""
    for rep in tp_ranks["reports"]:
        assert rep["boundaries"][name] <= 1e-6, (name, rep["boundaries"])


def test_scatter_sums_a_replicated_gradient_over_model(tp_ranks):
    """(e): a "model"-replicated parameter's gradient is a partial sum on
    each model rank under sequence parallelism; mode "partial" all-reduces
    it over "model" (and a "model"-gathered one is reduce-scattered),
    "replica" — the scatter before the repair — keeps the data sum only.
    In the step a norm scale's gradient equals the single-device one with
    the sum and differs without it."""
    for rep in tp_ranks["reports"]:
        r = rep["repair"]
        assert r["partial"] == 0.0 and r["partial_sharded"] == 0.0, r
        assert r["local"] == 0.0, r
        assert r["replica"] > 1.0 and r["replica_is_data_only"], r
        assert r["norm/partial"] < 1e-6, r
        assert r["norm/replica"] > 1e-3, r


@pytest.mark.parametrize("arch, extra, bound", [
    ("stablelm-1.6b", {}, 0.55),
    ("starcoder2-7b", {"num_kv_heads": 1}, 0.6)])
def test_a_rank_computes_its_share(arch, extra, bound):
    """(d): under the op analyzer on a fake 1 x 2 mesh each model rank
    counts at most `bound` of the 1 x 1 step's operations (the products
    and the flash kernels' formulas): heads, ff and vocabulary columns, or
    on the fallback the rank's queries (rank 0's, the first half, attend a
    quarter of the causal pairs; rank 1's, the last half, three
    quarters)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **extra)
    shape = ShapeConfig("train_tiny", 64, 4, "train")
    flops = {}
    for m, rank in ((1, 0), (2, 0), (2, 1)):
        with dryrun.fake_world((1, m), ("data", "model"), rank) as mesh:
            assert list(mesh.get_coordinate()) == [0, rank]
            rec = dryrun.dry_run_cell(cfg, shape, mesh)
        flops[m, rank] = rec["cost_per_device"]["flops"]
        if m == 2:
            coll = rec["collectives_by_dtype_per_device"]
            # the activations' all-gathers and reduce-scatters over "model"
            assert coll["all-gather"].get(cfg.dtype, 0) > 0, coll
            assert coll["reduce-scatter"].get(cfg.dtype, 0) > 0, coll
    for rank in (0, 1):
        assert flops[2, rank] <= bound * flops[1, 0], flops
