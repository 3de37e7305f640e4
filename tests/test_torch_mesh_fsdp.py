"""The sharded train step's per-unit gather (`models/fsdp.py`, run by
`training/dp_step.py` `make_sharded_train_step`) in `gloo` processes on the
CPU, against the single-device step:

  * four ranks on the 2 x 2 ("data", "model") debug mesh, the reduced
    stablelm-1.6b, zamba2-2.7b (its shared attention block gathered in every
    group) and xlstm-125m, float32, grad_accum 1 and 2, masked labels spread
    unevenly over the data ranks, remat "none" (gathered weights packed for
    the backward) and "full" (gathered again in the recompute): parameters
    and both moments within 2e-4 after two steps, losses within 1e-5, the
    grad norm within 1e-5 relative, and each rank's first-step gradient
    shards within 1e-5 of the single-device gradients, relative to each
    parameter's largest (AdamW's eps can move an element whose gradient is
    rounding noise by a fifth of the learning rate, so the parameters
    alone tell a right split from a slightly wrong one poorly). zamba2
    splits its Mamba2 heads over "model" (its tensor-parallel plan), and
    its float32 step on a split sits on a floor that these bounds do not
    clear, which JAX's own step shows at this config
    (`tests/test_torch_ssm_tp.py`'s witness: JAX's 2 x 2 sharded step
    against its unsplit one, 5.2-6.4e-4 apart in the parameters after two
    steps and 2.0-4.8e-5 in the first step's gradients of a layer's
    a_log): a reordered sum moves the near-zero gradient elements, whose
    AdamW updates are then set by the noise. So zamba2 is held by
    `_check_floor`: the parameters within 2e-4 where their first-step
    gradient exceeds FLOOR_MASK (100 x AdamW's eps), the gradient shards
    within FLOOR_GRAD of each parameter's largest, the second step's grad
    norm within 1e-4 relative, all else as `_check`;
  * eight ranks on 2 x 2 x 2 ("pod", "data", "model"), where the gather
    order over two data axes shows;
  * the backward on another thread than the forward, as CUDA runs it;
  * `_Layout`'s gather equal to `full_tensor()` bit for bit, and its
    scatter equal to the old `sum_over_data` + `local_shard`;
  * memory: at the peak of the step's forward and backward a rank holds no
    more than its parameter and gradient shards, one unit's gathered
    parameters and gradients, and its activations (a whole-model gather
    holds 8 B a parameter).
"""

import json

import pytest

from test_torch_dp_step import run_ranks

pytestmark = pytest.mark.multidevice

ARCHS = ("stablelm-1.6b", "zamba2-2.7b", "xlstm-125m")
CASES = [(f"{a}/{acc}/{remat}", a, acc, remat)
         for a in ARCHS for acc in (1, 2) for remat in ("none", "full")]
# zamba2's float32 step on a model axis (see the module note): the first
# step's gradient shards relative to each parameter's largest, and the
# |gradient| above which a parameter element is held after two steps
FLOOR_GRAD, FLOOR_MASK = 1e-4, 1e-6

STEP = f"FLOOR_MASK = {FLOOR_MASK!r}\n" + """
from repro_torch.configs import get_config
from repro_torch.launch import train as ltrain
from repro_torch.models.model import init_params
from repro_torch.models.sharding_ctx import local_shard
from repro_torch.training import dp_step
from repro_torch.training.dp_step import make_sharded_train_step
from repro_torch.training.train_loop import (init_train_state,
                                             loss_and_grads, make_train_step)


def compare(mesh, arch, accum, remat, n_data, overrides=None, **extra):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              remat=remat, **extra)
    opt = OptimizerConfig(peak_lr=1e-3, total_steps=10, warmup_steps=0)
    state, _ = ltrain.sharded_state(cfg, 0, mesh, torch.device("cpu"))
    step = make_sharded_train_step(cfg, opt, mesh, accum, overrides)
    ref = init_train_state(cfg, init_params(cfg, 0, device="cpu",
                                            param_dtype=torch.float32))
    ref_step = make_train_step(cfg, opt, accum)
    rows = 2 * n_data
    out = []
    # the step's first gradient shards, as its loss_and_grads returns them
    real, first = dp_step.loss_and_grads, []

    def captured(*args, **kwargs):
        got = real(*args, **kwargs)
        if not first:
            first.append({n: g.clone() for n, g in got[2].items()})
        return got
    dp_step.loss_and_grads = captured
    try:
        for t in range(2):
            batch = make_lm_batch(cfg, rows * accum, 16, 0, t)
            # data rank 0's rows of microbatch 0 half masked, one row of
            # the last microbatch masked whole
            batch["labels"][0:rows // n_data, :12] = -1
            batch["labels"][rows * accum - 2, :] = -1
            if t == 0:
                rg = {n: g.clone() for n, g in loss_and_grads(
                    ref.params, cfg, batch, accum)[2].items()}
            state, m = step(state, batch)
            ref, mr = ref_step(ref, batch)
            out.append([float(m[k]) for k in ("loss", "ce", "grad_norm")]
                       + [float(mr[k]) for k in ("loss", "ce", "grad_norm")])
    finally:
        dp_step.loss_and_grads = real
    gerr = max(float((first[0][n] - local_shard(
        rg[n], mesh, state.params.get_parameter(n).placements,
        mesh.get_coordinate())).abs().max())
        / max(float(rg[n].abs().max()), 1e-30) for n in rg)
    full = dict(state.params.named_parameters())
    err = max(float((full[n].full_tensor() - p).abs().max())
              for n, p in ref.params.named_parameters())
    # the elements whose first-step gradient is above AdamW's eps scale
    masked = max(float(((full[n].full_tensor() - p).abs()
                        * (rg[n].abs() > FLOOR_MASK)).max())
                 for n, p in ref.params.named_parameters())
    merr = max(float((state.opt_state[k][n].full_tensor()
                      - ref.opt_state[k][n]).abs().max())
               for k in ("m", "v") for n in ref.opt_state[k])
    return dict(err=err, masked=masked, merr=merr, gerr=gerr, metrics=out,
                step=state.opt_state["step"])
"""


def _check(got):
    assert got["err"] < 2e-4 and got["merr"] < 2e-4, got
    assert got["gerr"] < 1e-5, got
    assert got["step"] == 2
    for loss, ce, gn, rloss, rce, rgn in got["metrics"]:
        assert abs(loss - rloss) < 1e-5 and abs(ce - rce) < 1e-5, got
        assert abs(gn - rgn) <= 1e-5 * rgn, got


def _check_floor(got):
    """`_check` for a step on zamba2's float32 floor (see the module
    note)."""
    assert got["masked"] < 2e-4 and got["merr"] < 2e-4, got
    assert got["gerr"] < FLOOR_GRAD, got
    assert got["step"] == 2
    for t, (loss, ce, gn, rloss, rce, rgn) in enumerate(got["metrics"]):
        assert abs(loss - rloss) < 1e-5 and abs(ce - rce) < 1e-5, got
        # the second step's gradient comes after an AdamW update on the
        # floor
        assert abs(gn - rgn) <= (1e-5 if t == 0 else 1e-4) * rgn, got


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("fsdp4"))
    return run_ranks(STEP + """
from repro_torch.launch.mesh import make_debug_mesh
mesh = make_debug_mesh(2, 2, device="cpu")
cases = json.loads(os.environ["CASES"])
report(**{name: compare(mesh, a, acc, remat, 2)
          for name, a, acc, remat in cases})
""", out, timeout=400, CASES=json.dumps(CASES))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_per_unit_step_matches_single_device(four_ranks, case):
    check = _check_floor if case[1] == "zamba2-2.7b" else _check
    for rep in four_ranks:
        check(rep[case[0]])


def test_pod_data_model_mesh(tmp_path):
    """2 x 2 x 2 over ("pod", "data", "model"): four data shards over two
    axes (the batch split pod-major, as JAX's ("pod", "data") rule)."""
    res = run_ranks(STEP + """
from torch.distributed.device_mesh import init_device_mesh
mesh = init_device_mesh("cpu", (2, 2, 2),
                        mesh_dim_names=("pod", "data", "model"))
report(case=compare(mesh, "stablelm-1.6b", 2, "none", 4))
""", str(tmp_path), n=8, timeout=300)
    for rep in res:
        _check(rep["case"])


def test_backward_on_another_thread(tmp_path):
    """The autograd engine runs a CUDA backward, and so a remat recompute,
    on its own device thread, where the forward's `ShardedParams` and
    sharding rules are not installed: with `Tensor.backward` run on a
    second thread the step (remat "full", stablelm-1.6b and granite-moe's
    global dispatch at capacity factor 0.5) still matches the single-device
    step."""
    res = run_ranks(STEP + """
import threading
real_backward = torch.Tensor.backward


def on_a_thread(self, *args, **kwargs):
    errors = []

    def run():
        try:
            real_backward(self, *args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)
    worker = threading.Thread(target=run)
    worker.start()
    worker.join(timeout=120)
    if worker.is_alive():
        raise RuntimeError("the backward did not finish in 120 s")
    if errors:
        raise errors[0]


torch.Tensor.backward = on_a_thread
from repro_torch.launch.mesh import make_debug_mesh
mesh = make_debug_mesh(2, 2, device="cpu")
report(dense=compare(mesh, "stablelm-1.6b", 2, "full", 2),
       moe=compare(mesh, "granite-moe-1b-a400m", 1, "full", 2,
                   capacity_factor=0.5))
""", str(tmp_path), timeout=300)
    for rep in res:
        _check(rep["dense"])
        _check(rep["moe"])


def test_gather_and_scatter_equal_full_tensor(tmp_path):
    """Every placement of a (8, 12) tensor on the 2 x 2 mesh: the gather
    is `full_tensor()` bit for bit; the scatter of a per-rank gradient is
    its sum over the data ranks sliced to this rank's shard (the old step's
    `sum_over_data` + `local_shard`)."""
    res = run_ranks("""
from torch.distributed.tensor import Replicate, Shard
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.fsdp import _Layout
from repro_torch.models.sharding_ctx import distribute, local_shard
mesh = make_debug_mesh(2, 2, device="cpu")
axes = [(a, 2, mesh.get_group(a)) for a in ("data", "model")]
coord = dict(zip(("data", "model"), mesh.get_coordinate()))
full = torch.arange(96.).reshape(8, 12)
out = {}
for pl in [(Shard(0), Shard(1)), (Shard(1), Shard(0)), (Shard(0), Replicate()),
           (Replicate(), Shard(1)), (Replicate(), Replicate()),
           (Shard(0), Shard(0))]:
    d = distribute(full, mesh, pl)
    lay = _Layout(pl, axes)
    gathered = lay.gather(d.to_local())
    # a gradient that differs across data ranks, equal across model ranks
    g = full * (1 + coord["data"]) + 0.5
    want = local_shard(full * 3 + 1.0, mesh, pl, mesh.get_coordinate())
    out[str(pl)] = dict(
        gather=bool(torch.equal(gathered, d.full_tensor())),
        scatter=bool(torch.equal(lay.scatter(g, coord), want)))
report(**out)
""", str(tmp_path))
    for rep in res:
        assert all(v["gather"] and v["scatter"] for v in rep.values()), rep


MEMORY = """
from torch.distributed._tools.mem_tracker import MemTracker
from repro_torch.configs import get_config
from repro_torch.launch import train as ltrain
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.training import dp_step
mesh = make_debug_mesh(2, 2, device="cpu")
# the tracker follows the step's forward and backward (AdamW's in-place
# update holds nothing a unit gathers)
tracker = None
real = dp_step.loss_and_grads


def tracked(*args, **kwargs):
    with tracker:
        return real(*args, **kwargs)


dp_step.loss_and_grads = tracked
out = {}
for remat, dtype in (("none", "float32"), ("full", "float32"),
                     ("none", "bfloat16")):
    cfg = dataclasses.replace(get_config("stablelm-1.6b").reduced(),
                              dtype=dtype, num_layers=12, remat=remat)
    state, _ = ltrain.sharded_state(cfg, 0, mesh, torch.device("cpu"))
    opt = OptimizerConfig(peak_lr=1e-3, total_steps=10, warmup_steps=0)
    step = dp_step.make_sharded_train_step(cfg, opt, mesh)
    batch = make_lm_batch(cfg, 2, 8, 0, 0)
    tracker = MemTracker()
    state, _ = step(state, batch)
    tracker = MemTracker()
    state, _ = step(state, batch)
    peak = max(v.get("Total", 0)
               for v in tracker.get_tracker_snapshot("peak").values())
    model = state.params
    units = [model.embed, model.final_norm, model.unembed, *model.blocks]
    out[f"{remat}/{dtype}"] = dict(
        peak=peak,
        total=sum(p.numel() for p in model.parameters()),
        local=sum(p.to_local().numel() for p in model.parameters()),
        unit=max(sum(p.numel() for p in u.parameters()) for u in units),
        d=cfg.d_model, vocab=cfg.padded_vocab, layers=cfg.num_layers)
report(**out)
"""


def test_peak_memory_holds_a_unit_not_the_model(tmp_path):
    """At the peak of the step's forward and backward (12 layers of the
    reduced stablelm-1.6b) a rank holds its parameter shards (the leaves,
    which MemTracker counts as the forward first reads them), its gradient
    shards, one unit's gathered float32 parameters and full gradients,
    and its activations: 8 float32 vectors of d_model a token a layer and
    four float32 copies of the logits (about 6.0 MB; 4.8-4.9 MB measured
    on the CPU). The whole-model gather the step replaced held the full
    parameters and gradients, 8 B a parameter (16.8 MB); remat "none"
    without the packed weights holds every unit's weights for the backward
    (11.7 MB), and in bf16 compute without the packed casts
    (`w.to(bfloat16)`, packed as the float32 leaf and a dtype) their
    copies (7.3 MB)."""
    res = run_ranks(MEMORY, str(tmp_path), timeout=300)
    for rep in res:
        for remat, m in rep.items():
            tokens = 1 * 8                         # a rank's rows x seq
            acts = 4 * tokens * (8 * m["d"] * m["layers"] + 4 * m["vocab"])
            bound = 2 * 4 * m["local"] + 8 * m["unit"] + acts
            assert m["peak"] <= bound, (remat, m, bound)
            # the bound is below what a whole-model gather holds
            assert bound < 8 * m["total"]
