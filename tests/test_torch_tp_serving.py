"""Serving under a mesh (`models/tensor_parallel.py`'s serving plan): the
split prefill, the encoder's split forward and decode on the rank's shard
of the decode state, its kv heads or (split-KV) its slice of the cache's
sequence, in `gloo` processes on the CPU:

  * (a) against JAX: on the 2 x 2 ("data", "model") debug mesh the port's
    split prefill of the reduced stablelm-1.6b (the heads path) and of
    starcoder2-7b with one kv head (the context-parallel fallback and
    split-KV decode), then 4 decode steps, against JAX's jitted `prefill`
    and `decode_step` on four XLA CPU devices at `decode_state_shardings`,
    from JAX's parameters (`models/convert.py`) on the same numpy-seeded
    prompts: the logits within 2e-4 of the largest |logit|;
  * (b) against the single-device path, float32, within 1e-4 of the
    largest |logit|: stablelm-1.6b (heads), minicpm-2b (tied; a padded
    vocab that tiles the axis, and one that does not), chameleon-34b
    (vlm), hubert-xlarge (the encoder's forward), and on the fallback a
    prompt shorter than the cache, a decode that crosses a slice boundary,
    a slice wholly past `pos`, `last_only` (the last position on the last
    rank) and `no_sp`; a prompt that does not split over the model axis
    refused;
  * (c) `combine_partials` against the unsplit softmax, with empty and
    single-slot slices;
  * (d) a rank's decode state shapes against JAX's `shard_shape`s of its
    sanitised `decode_state_shardings` for every dense, vlm, MoE, SSM and
    hybrid config at decode_32k on 16 x 16 (zamba2's Mamba2 conv buffer
    against the port's stated layout);
  * (e) the compute is split: a rank's counted operations in prefill and
    decode on a fake 1 x 2 mesh against the 1 x 1 run, on both ranks.

One module-scoped launch of four ranks runs (a) and (b); JAX's serving
runs in one subprocess beside it, whose parameters the ranks wait for.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jget
from repro.launch import shardings as jshd
from repro.models import model as jm
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import production_layout
from repro_torch.models import tensor_parallel as tpm
from repro_torch.models.attention import _decode_core, decode_partials
from repro_torch.models.model import init_decode_state
from repro_torch.models.sharding_ctx import sharding_rules
from test_torch_dp_step import _env, run_ranks

pytestmark = pytest.mark.multidevice

# the prompts: 4 rows of 16 tokens, 4 decode tokens, 16 frames; caches of
# MAX_LEN slots (16 a model rank)
ROWS, PROMPT, STEPS, MAX_LEN = 4, 16, 4, 32
FALLBACK = {"num_kv_heads": 1}
NO_SP = {"res_seq": None}
# name, arch, config fields, rules' overrides, prompt length, decode steps,
# last_only
CASES = [
    ("stablelm/heads", "stablelm-1.6b", {}, None, 16, STEPS, False),
    ("minicpm/tied", "minicpm-2b", {"vocab_size": 500}, None, 16, STEPS,
     False),
    ("minicpm/untiled", "minicpm-2b", {"vocab_size": 511, "vocab_round": 1},
     None, 16, STEPS, False),
    ("chameleon/vlm", "chameleon-34b", {}, None, 16, STEPS, False),
    ("hubert/encoder", "hubert-xlarge", {}, None, 16, 0, False),
    ("fallback/full", "starcoder2-7b", FALLBACK, None, 16, STEPS, False),
    ("fallback/short", "starcoder2-7b", FALLBACK, None, 8, STEPS, False),
    ("fallback/crossing", "starcoder2-7b", FALLBACK, None, 14, STEPS, False),
    ("stablelm/last_only", "stablelm-1.6b", {}, None, 16, 2, True),
    ("fallback/last_only", "starcoder2-7b", FALLBACK, None, 14, 2, True),
    ("stablelm/no_sp", "stablelm-1.6b", {}, NO_SP, 16, STEPS, False),
    ("fallback/no_sp", "starcoder2-7b", FALLBACK, NO_SP, 14, STEPS, False),
]
# (a): JAX's seed a config
AGAINST_JAX = [("heads", "stablelm-1.6b", {}),
               ("split_kv", "starcoder2-7b", FALLBACK)]
# a model under ShardedParams on a model axis of 2 without a plan, and
# whether it is refused: no family repeats the compute on the model ranks
UNPLANNED = [("stablelm-1.6b", True), ("olmoe-1b-7b", True),
             ("zamba2-2.7b", True)]

JAX_SERVE = """
import dataclasses, json, os, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import ARCHS
from repro.launch import shardings as shd
from repro.launch.mesh import make_debug_mesh
from repro.models import model as M
from repro.models.sharding_ctx import sharding_rules

out_dir, max_len = sys.argv[1], int(sys.argv[2])
data = np.load(os.path.join(out_dir, "prompts.npz"))
mesh = make_debug_mesh(2, 2)


def flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


for i, (tag, arch, extra) in enumerate(json.loads(sys.argv[3])):
    cfg = dataclasses.replace(ARCHS[arch].reduced(), dtype="float32",
                              **extra)
    params = M.init_params(cfg, jax.random.PRNGKey(3 + i))
    tmp = os.path.join(out_dir, f"params_{tag}.tmp.npz")
    np.savez(tmp, **flat(params))
    os.replace(tmp, os.path.join(out_dir, f"params_{tag}.npz"))
    tokens, nxt = data["tokens"], data["next"]
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
        outs = {"prefill": np.asarray(logits)}
        for t in range(nxt.shape[1]):
            logits, state = step(params, state, jnp.asarray(nxt[:, t:t + 1]))
            outs[f"step{t}"] = np.asarray(logits)
    np.savez(os.path.join(out_dir, f"jax_{tag}.npz"), **outs)
print("JAX_SERVE_OK")
"""

RANKS = """
import time
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import tensor_parallel as tpm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.fsdp import ShardedParams
from repro_torch.models.model import (decode_step, forward, init_params,
                                      prefill)
from repro_torch.models.sharding_ctx import local_batch, sharding_rules
torch.set_grad_enabled(False)
mesh = make_debug_mesh(2, 2, device="cpu")
DATA_RANK = mesh.get_coordinate()[0]
MAX_LEN, PROMPT, STEPS = (int(os.environ[k])
                          for k in ("MAX_LEN", "PROMPT", "STEPS"))
DATA = {k: torch.from_numpy(v)
        for k, v in np.load(os.path.join(OUT, "prompts.npz")).items()}


def cfg_of(arch, extra):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               **extra)


def inputs_of(cfg, s):
    if cfg.is_encoder:
        return {"frames": DATA["frames"][:, :s]}
    return {"tokens": DATA["tokens"][:, :s], "next": DATA["next"]}


def serve(model, cfg, inputs, steps, last_only, plan=None):
    # the prefill's (or the encoder forward's) logits, then each decode
    # step's, over the whole padded vocab (the ranks' vocabulary columns
    # gathered where the vocab tiles the model axis)
    gather = (lambda t: t) if plan is None or not plan.vocab else (
        lambda t: tpm.all_gather(t, plan, t.dim() - 1))
    if cfg.is_encoder:
        return [gather(forward(model, cfg, {"frames": inputs["frames"]}))]
    logits, state = prefill(model, cfg, {"tokens": inputs["tokens"]},
                            MAX_LEN, last_only)
    outs = [gather(logits)]
    for t in range(steps):
        logits, state = decode_step(model, cfg, state,
                                    inputs["next"][:, t:t + 1])
        outs.append(gather(logits))
    return outs


def split(model, cfg, inputs, steps, last_only, overrides):
    # the model stored at the sanitised parameter shardings, served under
    # its serving plan on this rank's rows
    dryrun._sharded_params(model, mesh, cfg, overrides)
    with sharding_rules(mesh, overrides):
        plan = tpm.make_plan(cfg, mesh, serving=True)
    loc = local_batch(inputs, mesh)
    with ShardedParams(model, mesh, plan), sharding_rules(mesh, overrides):
        return serve(model, cfg, loc, steps, last_only, plan), plan


def layout(plan):
    return "heads" if plan.heads else "split_kv"


def rel_err(got, want):
    return max(float((g - w).abs().max()) / float(w.abs().max())
               for g, w in zip(got, want))


def against_single(arch, extra, overrides, s, steps, last_only):
    cfg = cfg_of(arch, extra)
    inputs = inputs_of(cfg, s)
    ref = serve(init_params(cfg, 0, device="cpu"), cfg, inputs, steps,
                last_only)
    rows = slice(2 * DATA_RANK, 2 * DATA_RANK + 2)
    got, plan = split(init_params(cfg, 0, device="cpu"), cfg, inputs, steps,
                      last_only, overrides)
    return dict(err=rel_err(got, [r[rows] for r in ref]),
                shapes=[list(t.shape) for t in got], layout=layout(plan),
                sp=plan.sp, vocab=plan.vocab)


def refused():
    cfg = cfg_of("starcoder2-7b", FALLBACK)
    try:
        split(init_params(cfg, 0, device="cpu"), cfg, inputs_of(cfg, 15), 0,
              False, None)
    except ValueError as e:
        return str(e)
    return None


def against_jax(tag, arch, extra):
    path = os.path.join(OUT, f"params_{tag}.npz")
    deadline = time.monotonic() + 240
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise RuntimeError("JAX's parameters did not appear")
        time.sleep(0.2)
    tree = {}
    for k, v in np.load(path).items():
        node = tree
        *path_, last = k.split("/")
        for p in path_:
            node = node.setdefault(p, {})
        node[last] = v
    cfg = cfg_of(arch, extra)
    model = params_from_jax(tree, cfg, device="cpu")
    got, plan = split(model, cfg, inputs_of(cfg, PROMPT), STEPS, False, None)
    np.savez(os.path.join(OUT, f"port_{tag}_rank{RANK}.npz"),
             *[t.numpy() for t in got])
    return layout(plan)


def unplanned(arch):
    # the model's prefill under ShardedParams on the mesh without a plan
    cfg = cfg_of(arch, {})
    model = init_params(cfg, 0, device="cpu")
    dryrun._sharded_params(model, mesh, cfg, None)
    loc = local_batch(inputs_of(cfg, PROMPT), mesh)
    try:
        with ShardedParams(model, mesh), sharding_rules(mesh):
            prefill(model, cfg, {"tokens": loc["tokens"]}, MAX_LEN)
    except ValueError as e:
        return str(e)
    return None


FALLBACK = {"num_kv_heads": 1}
report(cases={c[0]: against_single(*c[1:])
              for c in json.loads(os.environ["CASES"])},
       refused=refused(),
       unplanned={arch: unplanned(arch)
                  for arch, _ in json.loads(os.environ["UNPLANNED"])},
       jax={tag: against_jax(tag, arch, extra)
            for tag, arch, extra in json.loads(os.environ["AGAINST_JAX"])})
"""


@pytest.fixture(scope="module")
def serving_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp_serving"))
    rng = np.random.default_rng(30)
    np.savez(os.path.join(out, "prompts.npz"),
             tokens=rng.integers(0, 500, (ROWS, PROMPT)).astype(np.int32),
             next=rng.integers(0, 500, (ROWS, STEPS)).astype(np.int32),
             frames=rng.standard_normal((ROWS, PROMPT, 128)).astype(
                 np.float32))
    env = _env()
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SERVE, out, str(MAX_LEN),
         json.dumps(AGAINST_JAX)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        reports = run_ranks(RANKS, out, timeout=300, CASES=json.dumps(CASES),
                            AGAINST_JAX=json.dumps(AGAINST_JAX),
                            UNPLANNED=json.dumps(UNPLANNED),
                            MAX_LEN=MAX_LEN, PROMPT=PROMPT, STEPS=STEPS)
        log = jax_proc.communicate(timeout=300)[0]
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert jax_proc.returncode == 0 and "JAX_SERVE_OK" in log, log
    return dict(reports=reports, out=out)


@pytest.mark.parametrize("tag, arch, extra", AGAINST_JAX,
                         ids=[c[0] for c in AGAINST_JAX])
def test_split_serving_matches_jax_sharded_lowering(serving_ranks, tag,
                                                    arch, extra):
    """(a): each rank's prefill logits (its rows, the whole padded vocab
    gathered) and its 4 decode steps' against JAX's sharded `prefill` and
    `decode_step` from the same parameters and prompts, within 2e-4 of the
    largest |logit|; the decode layout is JAX's (kv heads on "model" where
    they tile it, else the cache's sequence)."""
    out = serving_ranks["out"]
    want = np.load(os.path.join(out, f"jax_{tag}.npz"))
    want = [want["prefill"]] + [want[f"step{t}"] for t in range(STEPS)]
    for rank, rep in enumerate(serving_ranks["reports"]):
        assert rep["jax"][tag] == tag
        got = np.load(os.path.join(out, f"port_{tag}_rank{rank}.npz"))
        rows = slice(2 * (rank // 2), 2 * (rank // 2) + 2)
        for i, w in enumerate(want):
            g = got[f"arr_{i}"]
            assert g.shape == w[rows].shape, (g.shape, w.shape)
            err = np.abs(g - w[rows]).max() / np.abs(w[rows]).max()
            assert err <= 2e-4, (tag, i, err)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_serving_matches_single_device(serving_ranks, case):
    """(b): the split prefill (or the encoder's forward) and decode steps
    against the single-device path on the same parameters, float32: the
    logits within 1e-4 of the largest |logit| on every rank, the plan's
    layout as the configuration asks."""
    name, arch, extra, overrides, s, steps, last_only = case
    cfg = dataclasses.replace(get_config(arch).reduced(), **extra)
    for rep in serving_ranks["reports"]:
        got = rep["cases"][name]
        assert got["err"] <= 1e-4, (name, got)
        assert got["layout"] == ("split_kv" if extra.get("num_kv_heads")
                                 else "heads"), got
        assert got["sp"] == (overrides is None), got
        assert got["vocab"] == (cfg.padded_vocab % 2 == 0), got
        want_s = 1 if last_only else s
        assert got["shapes"][0] == [2, want_s, cfg.padded_vocab], got
        assert len(got["shapes"]) == 1 + steps


def test_a_prompt_that_does_not_split_is_refused(serving_ranks):
    """(b): a prompt of 15 tokens on a model axis of 2 raises ValueError
    naming the axis, as a d_ff that does not tile it is refused."""
    for rep in serving_ranks["reports"]:
        assert rep["refused"] is not None and "model axis" in rep["refused"]


@pytest.mark.parametrize("arch, refused", UNPLANNED,
                         ids=[c[0] for c in UNPLANNED])
def test_no_replicated_fallback_without_a_plan(serving_ranks, arch,
                                               refused):
    """(b): a dense, MoE or hybrid model's prefill under `ShardedParams`
    on a model axis of 2 without its serving plan raises ValueError (no
    family gathers and repeats the compute on the model ranks)."""
    for rep in serving_ranks["reports"]:
        msg = rep["unplanned"][arch]
        if refused:
            assert msg is not None and "model axis of 2" in msg, msg
        else:
            assert msg is None, msg


def _slices(n: int, sizes: list[int]) -> list[slice]:
    out, start = [], 0
    for w in sizes:
        out.append(slice(start, start + w))
        start += w
    assert start == n
    return out


@pytest.mark.parametrize("sizes, pos", [
    ([8, 8, 8, 8], 31),        # every slot valid
    ([8, 8, 8, 8], 11),        # the last two slices wholly past pos
    ([8, 8, 8, 8], 0),         # one valid slot, three empty slices
    ([1, 1, 1, 1, 28], 2),     # single-slot slices, the long one empty
    ([16, 1, 15], 16),         # pos on a single-slot slice
], ids=["full", "empty_tail", "one_slot", "single_slots", "single_at_pos"])
def test_combine_matches_the_unsplit_softmax(sizes, pos):
    """(c): the slices' `decode_partials` combined by `combine_partials`
    equal the unsplit masked softmax (`_decode_core`) in float32; an empty
    slice has m = -1e30, l = 0 and adds nothing (not a uniform softmax
    over its unwritten slots)."""
    gen = torch.Generator().manual_seed(sum(sizes) + pos)
    b, hk, g, dh, n = 3, 2, 3, 16, sum(sizes)
    qg = torch.randn((b, 1, hk, g, dh), generator=gen) * 3
    k = torch.randn((b, n, hk, dh), generator=gen)
    v = torch.randn((b, n, hk, dh), generator=gen)
    valid = torch.arange(n) <= pos
    want = _decode_core(qg, k, v, pos, 0)                # (B, 1, Hk, G, Dh)
    parts = [decode_partials(qg, k[:, sl], v[:, sl], valid[sl])
             for sl in _slices(n, sizes)]
    for (m, l, o), sl in zip(parts, _slices(n, sizes)):
        if not valid[sl].any():
            assert bool((m == -1e30).all()) and float(l.abs().max()) == 0.0
            assert float(o.abs().max()) == 0.0
    m, l, o = (torch.stack(t) for t in zip(*parts))
    got = tpm.combine_partials(m, l, o).permute(0, 3, 1, 2, 4)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


DECODE_ARCHS = sorted(n for n, c in ARCHS.items() if c.family in (
    "dense", "vlm", "moe", "ssm", "hybrid"))


def _flat(tree, prefix=""):
    """{"a/b": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _jax_decode_shard_shapes(name: str) -> dict:
    jcfg = jget(name)
    amesh = AbstractMesh((16, 16), ("data", "model"))
    shape = SHAPES["decode_32k"]
    state = jax.eval_shape(lambda: jm.init_decode_state(
        jcfg, shape.global_batch, shape.seq_len))
    st_shd = jshd.sanitize_shardings(jshd.decode_state_shardings(amesh, jcfg),
                                     state, amesh)
    shd_flat, st_flat = _flat(st_shd), _flat(state)
    return {k: tuple(shd_flat[k].shard_shape(st_flat[k].shape))
            for k in st_flat}


@pytest.mark.parametrize("name", DECODE_ARCHS)
def test_decode_state_shards_equal_jax_shard_shapes(name):
    """(d): at decode_32k on 16 x 16 a rank's decode state under the
    serving plan (`init_decode_state(..., tp=plan)` on its 8 rows)
    equals JAX's `shard_shape`s of its sanitised
    `decode_state_shardings`: the kv heads over "model" where
    they tile it, else the cache's 32,768 slots; the Mamba2 heads, the
    mLSTM heads where they tile (xlstm-125m's 4 do not: whole) and its
    conv channels; the sLSTM states whole. The one leaf whose layout is
    the port's own is zamba2's Mamba2 conv buffer: the di/16 + 2n = 448
    channels a rank convolves (its x channels, then B and C whole), where
    JAX's contiguous shard is (di + 2n)/16 = 328 (`state_specs`)."""
    cfg = get_config(name)
    shape = SHAPES["decode_32k"]
    want = _jax_decode_shard_shapes(name)
    with dryrun.fake_world(*production_layout()) as mesh:
        with sharding_rules(mesh):
            plan = tpm.make_plan(cfg, mesh, serving=True)
        assert plan.heads == (cfg.num_kv_heads % 16 == 0)
        with FakeTensorMode(allow_non_fake_inputs=True):
            state = init_decode_state(cfg, shape.global_batch // 16,
                                      shape.seq_len, device="cpu", tp=plan)
    got = {k: () if k == "pos" else tuple(t.shape)
           for k, t in _flat(state).items()}
    if cfg.family == "hybrid":
        n, di = cfg.ssm_state_dim, cfg.d_inner
        conv = got.pop("mamba/conv")
        assert want.pop("mamba/conv")[-1] == (di + 2 * n) // 16
        assert conv == (*want["mamba/h"][:3], cfg.ssm_conv_dim - 1,
                        di // 16 + 2 * n), conv
    assert got == want, (got, want)


@pytest.mark.parametrize("arch, extra, kind", [
    ("stablelm-1.6b", {}, "prefill"), ("stablelm-1.6b", {}, "decode"),
    ("starcoder2-7b", FALLBACK, "prefill"),
    ("starcoder2-7b", FALLBACK, "decode"),
    ("hubert-xlarge", {}, "prefill")],
    ids=["heads/prefill", "heads/decode", "fallback/prefill",
         "split_kv/decode", "encoder/prefill"])
def test_a_rank_serves_its_share(arch, extra, kind):
    """(e): under the op analyzer on a fake 1 x 2 mesh each model rank
    counts at most 0.52 of the 1 x 1 run's operations (the products and
    the flash kernels' formulas): its heads, ff and vocabulary columns, its
    slice of the cache; on the fallback's prefill rank 0's queries attend
    a quarter of the causal pairs, rank 1's three quarters."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **extra)
    shape = ShapeConfig(f"{kind}_tiny", 64, 4, kind)
    flops = {}
    for m, rank in ((1, 0), (2, 0), (2, 1)):
        with dryrun.fake_world((1, m), ("data", "model"), rank) as mesh:
            rec = dryrun.dry_run_cell(cfg, shape, mesh)
        flops[m, rank] = rec["cost_per_device"]["flops"]
        if m == 2:
            coll = rec["collectives_by_dtype_per_device"]
            assert sum(sum(v.values()) for v in coll.values()) > 0, coll
    for rank in (0, 1):
        assert flops[2, rank] <= 0.52 * flops[1, 0], flops
