"""The port's training on a `torch.distributed` mesh, in four `gloo`
processes on the CPU (one process a device, as torchrun starts them),
against the single-device step and the JAX package on four fake XLA
devices (`--xla_force_host_platform_device_count=4`, one subprocess for
the module):

  * `compressed_psum` over four ranks, each fed the draws JAX's
    `compress_tree` makes from its key, bit-equal to JAX's `shard_map`
    version;
  * the DP step's exact twin (`compress=False`) within 2e-4 of the
    single-device step; the compressed step's loss within 10 % of the
    exact one's after 12 steps on one fixed batch (stablelm-1.6b
    reduced, float32, B 8 x S 32: JAX's
    `test_compressed_dp_step_tracks_exact`);
  * the `--mesh debug` step (`make_sharded_train_step` on
    `make_debug_mesh(2, 2)`): each rank's local shards of the parameters
    and moments equal to JAX's `addressable_shards` of the device at the
    same mesh coordinates (bit for bit before the step, within 2e-4
    after one), its placements unchanged by the step; parameters within
    2e-4 and the loss within 1e-3 of the single-device step after two
    (JAX's `test_sharded_train_step_runs_and_matches_single_device`
    bounds), also with grad_accum 2 and masked labels spread unevenly
    over the data ranks; `constrain` redistributes a DTensor;
  * an elastic restore: a checkpoint saved from a 4 x 1 mesh's DTensors
    restored onto 2 x 2, exact, and read by the JAX package;
  * the launcher under `torchrun --nproc-per-node 4 --device cpu --mesh
    debug`, with a checkpoint and a resume;
  * the `--mesh` refusal of a mesh without a process group of its size
    (in this process); MoE architectures train under `--mesh`
    (`tests/test_torch_moe_mesh.py`).
Each multi-process run has a timeout and a 90 s collective timeout.
"""

import argparse
import json
import os
import subprocess
import sys
import textwrap
import time
import uuid

import numpy as np
import pytest

pytestmark = pytest.mark.multidevice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
RANKS = 4

# every rank script starts here: one thread, a gloo group from the
# environment, the results directory
PREAMBLE = """
import dataclasses, datetime, json, os, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=os.environ["RENDEZVOUS"],
                        rank=int(os.environ["RANK"]),
                        world_size=int(os.environ["WORLD_SIZE"]),
                        timeout=datetime.timedelta(seconds=90))
RANK = dist.get_rank()
OUT = os.environ["OUT_DIR"]
from repro_torch.configs import get_config
from repro_torch.data.synthetic import make_lm_batch
from repro_torch.training.optimizer import OptimizerConfig
CFG = dataclasses.replace(get_config("stablelm-1.6b").reduced(),
                          dtype="float32")


def report(**kw):
    with open(os.path.join(OUT, f"rank{RANK}.json"), "w") as f:
        json.dump(kw, f)
"""


def _env(**extra) -> dict:
    env = dict(os.environ)
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               **{k: str(v) for k, v in extra.items()})
    env.pop("XLA_FLAGS", None)
    return env


def run_ranks(script: str, out_dir, n: int = RANKS, timeout: float = 120,
              **extra) -> list[dict]:
    """Run `script` in n processes of one gloo group; returns each rank's
    `report(...)`. A rank that fails ends the others. The ranks meet
    through a file store in `out_dir` (a name of this run's own), so no
    port is bound, released and bound again, which another process could
    take in between."""
    path = os.path.join(out_dir, "ranks.py")
    with open(path, "w") as f:
        f.write(PREAMBLE + textwrap.dedent(script))
    store = os.path.join(os.path.abspath(out_dir),
                         f"rendezvous-{uuid.uuid4().hex}")
    procs = [subprocess.Popen(
        [sys.executable, path], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=_env(
            RANK=r, WORLD_SIZE=n, RENDEZVOUS=f"file://{store}",
            OUT_DIR=out_dir, **extra)) for r in range(n)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} (rc {p.returncode}):\n{logs[r]}"
    out = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


# ------------------------------------------------- the JAX reference run
JAX_REF = """
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.configs import ARCHS
from repro.data.synthetic import make_lm_batch
from repro.launch import shardings as shd
from repro.launch.mesh import make_debug_mesh, make_mesh
from repro.models.model import init_params
from repro.models.sharding_ctx import sharding_rules
from repro.training.compression import compressed_psum
from repro.training.optimizer import OptimizerConfig
from repro.training.train_loop import init_train_state, make_train_step

out = {}
# --- compressed_psum over 4 devices, each with its own key
mesh = make_mesh((4,), ("data",))
rng = np.random.default_rng(0)
grads = {"b": rng.normal(size=(4 * 7,)), "w": rng.normal(size=(4 * 16, 33)),
         "s": rng.normal(scale=1e-3, size=(4, 5, 3)),
         "z": np.zeros((4 * 2, 6))}
grads = {k: jnp.asarray(v, jnp.float32) for k, v in grads.items()}
keys = jax.random.split(jax.random.PRNGKey(1), 4)
fn = shard_map(lambda g, k: compressed_psum(g, "data", k[0]), mesh=mesh,
               in_specs=(P("data"), P("data")), out_specs=P(),
               check_vma=False)
summed = fn(grads, keys)
names = sorted(grads)
for k in names:
    out[f"psum/in/{k}"] = np.asarray(grads[k])
    out[f"psum/out/{k}"] = np.asarray(summed[k])
for r in range(4):
    leaf_keys = jax.random.split(keys[r], len(names))
    for i, k in enumerate(names):
        n = grads[k].shape[0] // 4
        shape = (n,) + grads[k].shape[1:]
        out[f"psum/noise/{r}/{k}"] = np.asarray(jax.random.uniform(
            leaf_keys[i], shape, jnp.float32, -0.5, 0.5))

# --- the sharded train step on a 2 x 2 debug mesh (JAX's own test)
cfg = dataclasses.replace(ARCHS["stablelm-1.6b"].reduced(), dtype="float32")
opt = OptimizerConfig(peak_lr=1e-3, total_steps=10, warmup_steps=0)
params = init_params(cfg, jax.random.PRNGKey(0))
state = init_train_state(cfg, params)
batch = make_lm_batch(cfg, 4, 32, seed=0, step=0)
mesh = make_debug_mesh(2, 2)
s_abs = jax.tree_util.tree_map(
    lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state)
s_shd = shd.sanitize_shardings(shd.train_state_shardings(mesh, cfg), s_abs,
                               mesh)
b_shd = {k: shd.sanitize_shardings(v, batch[k], mesh)
         for k, v in shd.batch_shardings(mesh, cfg).items()}
with mesh, sharding_rules(mesh):
    jstep = jax.jit(make_train_step(cfg, opt), in_shardings=(s_shd, b_shd),
                    out_shardings=(s_shd, None))
    state_d = jax.device_put(state, s_shd)
    s_out, m_out = jstep(state_d, jax.device_put(batch, b_shd))
coord = {d.id: tuple(int(c) for c in np.argwhere(mesh.devices == d)[0])
         for d in mesh.devices.flat}


def dump(tag, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        for sh in leaf.addressable_shards:
            i, j = coord[sh.device.id]
            out[f"{tag}/{i}{j}/{key}"] = np.asarray(sh.data)


dump("before", state_d)
dump("after", s_out)
for path, leaf in jax.tree_util.tree_flatten_with_path(
        jax.device_get(params))[0]:
    key = "/".join(str(getattr(p, "key", p)) for p in path)
    out[f"params/{key}"] = np.asarray(leaf)
out["loss"] = np.asarray(m_out["loss"])
for k, v in batch.items():
    out[f"batch/{k}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
print("JAX_REF_OK")
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax") / "ref.npz")
    env = _env()
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    out = subprocess.run([sys.executable, "-c", JAX_REF, path], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return path


def test_compressed_psum_bit_equal_jax(jax_ref, tmp_path):
    res = run_ranks("""
        from repro_torch.training.compression import _compressed_psum
        ref = np.load(os.environ["JAX_REF"])
        names = sorted(k.split("/")[-1] for k in ref.files
                       if k.startswith("psum/in/"))
        grads = {}
        for k in names:
            full = ref[f"psum/in/{k}"]
            n = full.shape[0] // 4
            grads[k] = torch.from_numpy(full[RANK * n:(RANK + 1) * n].copy())
        # the port's dict in another order than JAX's flatten
        grads = dict(reversed(list(grads.items())))
        noise = {k: torch.from_numpy(ref[f"psum/noise/{RANK}/{k}"])
                 for k in names}
        out = _compressed_psum(grads, dist.group.WORLD,
                               lambda n, g: noise[n])
        report(equal={k: bool(np.array_equal(out[k].numpy(),
                                              ref[f"psum/out/{k}"]))
                      for k in names})
    """, str(tmp_path), JAX_REF=jax_ref)
    for r, rep in enumerate(res):
        assert all(rep["equal"].values()), (r, rep)


def test_dp_exact_twin_matches_single_device(tmp_path):
    res = run_ranks("""
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.models.model import init_params
        from repro_torch.training.dp_step import (
            make_dp_train_step_compressed)
        from repro_torch.training.train_loop import (init_train_state,
                                                     make_train_step)
        opt = OptimizerConfig(peak_lr=1e-3, total_steps=10, warmup_steps=0)
        mesh = make_debug_mesh(4, 1, device="cpu")
        step = make_dp_train_step_compressed(CFG, opt, mesh, compress=False)
        ref_step = make_train_step(CFG, opt)

        def fresh():
            return init_train_state(CFG, init_params(
                CFG, 0, device="cpu", param_dtype=torch.float32))
        s, r = fresh(), fresh()
        gen = torch.Generator().manual_seed(RANK)
        losses = []
        for t in range(3):
            batch = make_lm_batch(CFG, 8, 32, 0, t)
            s, m = step(s, batch, gen)
            r, mr = ref_step(r, batch)
            losses.append((float(m["loss"]), float(mr["loss"])))
        err = max(float((a - b).abs().max()) for a, b in zip(
            s.params.parameters(), r.params.parameters()))
        report(err=err, losses=losses, step=s.opt_state["step"],
               gnorm=[float(m["grad_norm"]), float(mr["grad_norm"])])
    """, str(tmp_path))
    for rep in res:
        assert rep["err"] < 2e-4, rep
        assert all(abs(a - b) < 1e-4 for a, b in rep["losses"]), rep
        assert rep["step"] == 3
        assert abs(rep["gnorm"][0] - rep["gnorm"][1]) < 1e-4
    # replicated: every rank holds the same parameters
    assert len({rep["err"] for rep in res}) == 1


def test_dp_compressed_step_tracks_exact(tmp_path):
    res = run_ranks("""
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.models.model import init_params
        from repro_torch.training.dp_step import (
            make_dp_train_step_compressed)
        from repro_torch.training.train_loop import init_train_state
        opt = OptimizerConfig(peak_lr=1e-3, total_steps=20, warmup_steps=0)
        mesh = make_debug_mesh(4, 1, device="cpu")
        step_c = make_dp_train_step_compressed(CFG, opt, mesh, compress=True)
        step_e = make_dp_train_step_compressed(CFG, opt, mesh,
                                               compress=False)

        def fresh():
            return init_train_state(CFG, init_params(
                CFG, 0, device="cpu", param_dtype=torch.float32))
        sc, se = fresh(), fresh()
        gen = torch.Generator().manual_seed(1 + RANK)
        batch = make_lm_batch(CFG, 8, 32, 0, 0)
        lc, le = [], []
        for t in range(12):
            sc, mc = step_c(sc, batch, gen)
            se, me = step_e(se, batch, gen)
            lc.append(float(mc["loss"]))
            le.append(float(me["loss"]))
        p0 = next(sc.params.parameters()).detach()
        report(lc=lc, le=le, p0=float(p0.double().sum()))
    """, str(tmp_path))
    lc, le = res[0]["lc"], res[0]["le"]
    # both memorise the fixed batch; compressed within 10 % of exact
    assert le[-1] < 6.0 and lc[-1] < 6.0, (lc, le)
    assert lc[-1] < lc[0] and le[-1] < le[0]
    assert abs(lc[-1] - le[-1]) / le[-1] < 0.1, (lc, le)
    # the summed gradients are the same on every rank: replicas agree
    assert len({rep["p0"] for rep in res}) == 1
    assert all(rep["lc"] == lc for rep in res)


SHARDED = """
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.convert import _leaves
from repro_torch.models.sharding_ctx import constrain, sharding_rules
from repro_torch.training.dp_step import make_sharded_train_step
from repro_torch.training.train_loop import (init_train_state,
                                             make_train_step,
                                             train_state_from_jax)
ref = np.load(os.environ["JAX_REF"])
params = {}
for k in ref.files:
    if k.startswith("params/"):
        node = params
        *path, last = k.split("/")[1:]
        for p in path:
            node = node.setdefault(p, {})
        node[last] = ref[k]
zeros = lambda t: {k: zeros(v) if isinstance(v, dict) else np.zeros_like(v)
                   for k, v in t.items()}
jstate = (params, {"m": zeros(params), "v": zeros(params), "step": 0})
opt = OptimizerConfig(peak_lr=1e-3, total_steps=10, warmup_steps=0)
mesh = make_debug_mesh(2, 2, device="cpu")
coord = tuple(mesh.get_coordinate())
state = train_state_from_jax(jstate, CFG, "cpu")
s_shd = shd.sanitize_shardings(shd.train_state_shardings(mesh, CFG),
                               shd.state_shapes(state), mesh)
state = shd.shard_train_state(state, s_shd)


def compare(tag, state):
    # {leaf: max |local shard - JAX's shard at this rank's coordinates|}
    errs = {}
    tree = {"params": dict(state.params.named_parameters()),
            "m": state.opt_state["m"], "v": state.opt_state["v"]}
    prefix = {"params": ".params", "m": ".opt_state/m", "v": ".opt_state/v"}
    for key, tensors in tree.items():
        for name, path, index, transposed in _leaves(CFG):
            want = ref[f"{tag}/{coord[0]}{coord[1]}/{prefix[key]}/"
                       + "/".join(path)]
            want = want[index] if index else want
            want = want.T if transposed else want
            got = tensors[name].to_local().numpy()
            assert got.shape == want.shape, (name, got.shape, want.shape)
            errs[f"{key}/{name}"] = float(np.abs(got - want).max())
    return errs
"""


def test_local_shards_equal_jax_addressable_shards(jax_ref, tmp_path):
    res = run_ranks(SHARDED + textwrap.dedent("""
        before = compare("before", state)
        placements = {n: [str(p) for p in t.placements]
                      for n, t in state.params.named_parameters()}
        step = make_sharded_train_step(CFG, opt, mesh)
        state, m = step(state, {k: torch.from_numpy(ref[f"batch/{k}"])
                                for k in ("tokens", "labels")})
        after = compare("after", state)
        same = all([str(p) for p in t.placements] == placements[n]
                   for n, t in state.params.named_parameters())
        same &= all(state.opt_state[k][n].placements
                    == state.params.get_parameter(n).placements
                    for k in ("m", "v") for n in placements)
        want = {n: [str(p) for p in sh.placements]
                for n, sh in s_shd.params.items()}
        # constrain redistributes a DTensor to its names' placements
        with sharding_rules(mesh):
            x = shd.distribute(torch.arange(64.).reshape(8, 8), mesh,
                               shd.placements_of(mesh, ()))
            y = constrain(x, ("batch", "act_ff"))
        report(before=before, after=after, same=same,
               placements_match=placements == want,
               sharded=sum(any(p.is_shard() for p in t.placements)
                           for _, t in state.params.named_parameters()),
               constrained=[str(p) for p in y.placements],
               full_equal=bool(torch.equal(y.full_tensor(), x.full_tensor())),
               loss=float(m["loss"]))
    """), str(tmp_path), JAX_REF=jax_ref)
    ref = np.load(jax_ref)
    for rep in res:
        assert max(rep["before"].values()) == 0.0, rep["before"]
        assert max(rep["after"].values()) < 2e-4, rep["after"]
        assert rep["same"] and rep["placements_match"]
        assert rep["sharded"] > 0
        assert rep["constrained"] == ["S(0)", "S(1)"]
        assert rep["full_equal"]
        assert abs(rep["loss"] - float(ref["loss"])) < 1e-3


@pytest.mark.parametrize("accum, masked", [(1, False), (2, True)])
def test_mesh_debug_step_matches_single_device(tmp_path, accum, masked):
    """Also with masked labels spread unevenly over the data ranks: the
    step takes one mean over each global microbatch's valid labels, as
    the single-device step does."""
    res = run_ranks(f"""
        from repro_torch.launch import train as ltrain
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.models.model import init_params
        from repro_torch.training.dp_step import make_sharded_train_step
        from repro_torch.training.train_loop import (init_train_state,
                                                     make_train_step)
        opt = OptimizerConfig(peak_lr=1e-3, total_steps=10, warmup_steps=0)
        mesh = make_debug_mesh(2, 2, device="cpu")
        state, _ = ltrain.sharded_state(CFG, 0, mesh, torch.device("cpu"))
        step = make_sharded_train_step(CFG, opt, mesh, {accum})
        ref = init_train_state(CFG, init_params(CFG, 0, device="cpu",
                                                param_dtype=torch.float32))
        ref_step = make_train_step(CFG, opt, {accum})
        losses = []
        for t in range(2):
            batch = make_lm_batch(CFG, 4 * {accum}, 32, 0, t)
            if {masked}:
                # microbatch 0 is rows 0-3 (data rank 0 takes 0-1), 1 is 4-7
                batch["labels"][0:2, :24] = -1
                batch["labels"][6, :] = -1
            state, m = step(state, batch)
            ref, mr = ref_step(ref, batch)
            losses.append((float(m["loss"]), float(mr["loss"]),
                           float(m["grad_norm"]), float(mr["grad_norm"])))
        full = dict(state.params.named_parameters())
        err = max(float((full[n].full_tensor() - p).abs().max())
                  for n, p in ref.params.named_parameters())
        merr = max(float((state.opt_state[k][n].full_tensor()
                          - ref.opt_state[k][n]).abs().max())
                   for k in ("m", "v") for n in ref.opt_state[k])
        local = sum(p.to_local().numel() for p in full.values())
        report(err=err, merr=merr, losses=losses, local=local,
               total=sum(p.numel() for p in full.values()),
               step=state.opt_state["step"])
    """, str(tmp_path))
    for rep in res:
        assert rep["err"] < 2e-4 and rep["merr"] < 1e-5, rep
        assert all(abs(a - b) < 1e-3 and abs(c - d) < 1e-4
                   for a, b, c, d in rep["losses"]), rep
        assert rep["step"] == 2
        # ZeRO-3 over data + the model splits: a rank holds a fraction
        assert rep["local"] < rep["total"] / 2
    assert sum(rep["local"] for rep in res) < 4 * res[0]["total"]


def test_checkpoint_reshards_across_mesh_shapes(tmp_path):
    """Elastic restore: save from a 4 x 1 mesh's DTensors, restore onto
    2 x 2; the JAX package reads the same file."""
    ckpt = tmp_path / "ckpt"
    res = run_ranks(f"""
        from repro_torch.launch import shardings as shd
        from repro_torch.launch import train as ltrain
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.training.checkpoint import (restore_checkpoint,
                                                     save_checkpoint)
        from repro_torch.training.dp_step import make_sharded_train_step
        opt = OptimizerConfig(peak_lr=1e-3, total_steps=10, warmup_steps=0)
        m41 = make_debug_mesh(4, 1, device="cpu")
        m22 = make_debug_mesh(2, 2, device="cpu")
        state, _ = ltrain.sharded_state(CFG, 0, m41, torch.device("cpu"))
        step = make_sharded_train_step(CFG, opt, m41)
        state, _ = step(state, make_lm_batch(CFG, 4, 32, 0, 0))
        full = {{n: p.full_tensor() for n, p in
                state.params.named_parameters()}}
        mfull = {{n: t.full_tensor() for n, t in state.opt_state["m"].items()}}
        save_checkpoint({str(ckpt)!r}, 1, state)
        like, _ = ltrain.sharded_state(CFG, 5, m41, torch.device("cpu"))
        target = shd.sanitize_shardings(shd.train_state_shardings(m22, CFG),
                                        shd.state_shapes(like), m22)
        back = restore_checkpoint({str(ckpt)!r}, 1, like, target)
        exact = all(torch.equal(p.full_tensor(), full[n])
                    for n, p in back.params.named_parameters())
        exact &= all(torch.equal(t.full_tensor(), mfull[n])
                     for n, t in back.opt_state["m"].items())
        placed = all(p.device_mesh is m22 and tuple(p.placements)
                     == target.params[n].placements
                     for n, p in back.params.named_parameters())
        # in place on the writer's mesh, without a target
        again, _ = ltrain.sharded_state(CFG, 6, m41, torch.device("cpu"))
        again = restore_checkpoint({str(ckpt)!r}, 1, again)
        exact_inplace = all(torch.equal(p.full_tensor(), full[n])
                            for n, p in again.params.named_parameters())
        # training goes on on the new mesh
        step22 = make_sharded_train_step(CFG, opt, m22)
        back, m = step22(back, make_lm_batch(CFG, 4, 32, 0, 1))
        report(exact=exact, placed=placed, exact_inplace=exact_inplace,
               step=back.opt_state["step"], loss=float(m["loss"]))
    """, str(tmp_path))
    for rep in res:
        assert rep["exact"] and rep["placed"] and rep["exact_inplace"], rep
        assert rep["step"] == 2 and np.isfinite(rep["loss"])
    import dataclasses

    import jax

    from repro.configs import ARCHS
    from repro.models.model import init_params
    from repro.training.checkpoint import restore_checkpoint
    from repro.training.train_loop import init_train_state
    jcfg = dataclasses.replace(ARCHS["stablelm-1.6b"].reduced(),
                               dtype="float32")
    like = init_train_state(jcfg, init_params(jcfg, jax.random.PRNGKey(1)))
    back = restore_checkpoint(str(ckpt), 1, like)
    assert int(back.opt_state["step"]) == 1


def test_launcher_under_torchrun(tmp_path):
    """`torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh
    debug --device cpu`: 3 steps with a checkpoint at 2, then a resume to
    4."""
    d = str(tmp_path / "ckpt")
    base = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(RANKS), "-m", "repro_torch.launch.train",
            "--arch", "stablelm-1.6b", "--reduced", "--device", "cpu",
            "--mesh", "debug", "--batch", "4", "--seq", "32",
            "--log-every", "1", "--ckpt-dir", d, "--ckpt-every", "2"]
    env = _env()
    out = subprocess.run(base + ["--steps", "3"], env=env, timeout=120,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "mesh=debug" in out.stdout and "step     3 loss" in out.stdout
    names = sorted(os.listdir(d))
    assert "step_00000002.npz" in names and "step_00000003.npz" in names
    out = subprocess.run(base + ["--steps", "4", "--resume"], env=env,
                         timeout=120, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "resumed from step 3" in out.stdout
    assert "step     4 loss" in out.stdout


def _args(**kw):
    base = dict(arch="stablelm-1.6b", reduced=True, steps=2, batch=4, seq=32,
                lr=1e-3, grad_accum=1, seed=0, mesh="debug", multi_pod=False,
                ckpt_dir=None, ckpt_every=3, resume=False, log_every=1,
                device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("mesh, multi_pod, size", [
    ("debug", False, 4), ("production", False, 256),
    ("production", True, 512)])
def test_mesh_needs_a_group_of_its_size(mesh, multi_pod, size):
    import torch.distributed as dist
    from repro_torch.launch import train as ltrain
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match=f"world size {size}"):
        ltrain.run(_args(mesh=mesh, multi_pod=multi_pod))


@pytest.fixture
def one_rank():
    """A one-process gloo group on an in-process store, one torch
    thread."""
    import torch
    import torch.distributed as dist
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)


def test_training_meshes_at_world_size_one(one_rank, monkeypatch):
    import torch
    from repro_torch.launch import mesh as lmesh
    m = lmesh.make_debug_mesh(1, 1, device="cpu")
    assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (1, 1)
    assert lmesh.init_distributed("cpu")
    with pytest.raises(RuntimeError, match="world size 4.*world size 1"):
        lmesh.make_debug_mesh(device="cpu")
    # the card takes NCCL: a gloo group is refused, nothing falls back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="takes nccl"):
        lmesh.make_debug_mesh(1, 1, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lmesh.make_debug_mesh(1, 1)


@pytest.mark.parametrize("arch, accum", [("stablelm-1.6b", 1),
                                         ("minicpm-2b", 2),
                                         ("zamba2-2.7b", 1)])
def test_steps_at_world_size_one_bit_equal_plain(one_rank, arch, accum):
    """On a 1 x 1 mesh the sharded step and the DP exact twin compute the
    single-device step bit for bit (chip_smoke.py's phase 15 (c)/(d) on
    the card)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.launch import train as ltrain
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.model import init_params
    from repro_torch.training.dp_step import (
        make_dp_train_step_compressed, make_sharded_train_step)
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              use_flash_kernel=True)
    opt = OptimizerConfig(peak_lr=1e-3, total_steps=10, warmup_steps=0)
    mesh = make_debug_mesh(1, 1, device="cpu")

    def fresh():
        return init_train_state(cfg, init_params(cfg, 0, device="cpu",
                                                 param_dtype=torch.float32))
    sharded, _ = ltrain.sharded_state(cfg, 0, mesh, torch.device("cpu"))
    dp, ref = fresh(), fresh()
    step = make_sharded_train_step(cfg, opt, mesh, accum)
    dp_step = make_dp_train_step_compressed(cfg, opt, mesh, compress=False)
    ref_step = make_train_step(cfg, opt, accum)
    ref1_step = make_train_step(cfg, opt)
    ref1 = fresh()
    for t in range(2):
        batch = make_lm_batch(cfg, 4, 16, 0, t)
        sharded, m = step(sharded, batch)
        ref, mr = ref_step(ref, batch)
        dp, md = dp_step(dp, batch, torch.Generator())
        ref1, mr1 = ref1_step(ref1, batch)
        assert torch.equal(m["loss"], mr["loss"])
        assert torch.equal(md["loss"], mr1["loss"])
    full = dict(sharded.params.named_parameters())
    for n, p in ref.params.named_parameters():
        assert torch.equal(full[n].full_tensor(), p), n
        for k in ("m", "v"):
            assert torch.equal(sharded.opt_state[k][n].full_tensor(),
                               ref.opt_state[k][n]), (k, n)
    for p, q in zip(dp.params.parameters(), ref1.params.parameters()):
        assert torch.equal(p, q)
