"""Multi-pod dry-run: every (arch x shape) cell of the port at the
production mesh, on the CPU, with nothing allocated (PyTorch port of
`repro.launch.dryrun`).

One process poses as rank 0 of the production mesh — 16 x 16 = 256
ranks over ("data", "model"), or 2 x 16 x 16 = 512 over ("pod", "data",
"model") with --multi-pod — on the `fake` process-group backend
(`torch.testing._internal.distributed.fake_pg.FakeStore`: collectives
move nothing), and every tensor is a CPU fake tensor (`FakeTensorMode`).
For every runnable cell it runs the port's own step at full width:

    train      `training.dp_step.make_sharded_train_step` on the DTensor
               state at `launch/shardings.py`'s sanitised train-state
               shardings (float32 masters), the rank's rows of the global
               batch; every family splits its compute over the model
               axis (`models/tensor_parallel.py`: heads or the
               context-parallel fallback, ff and vocabulary columns, a
               MoE rank's experts or token slab, an SSM block's heads or
               channels, a sequence-parallel residual unless `--opt
               no_sp`);
    prefill    the model on the parameter shardings' local shards,
    decode     gathered a unit at a time as the sharded train step
               gathers them (`models/fsdp.py`), on the rank's rows of the
               batch (the whole batch where it does not split over the
               data axes), in the serving storage (bf16 matrices). Every
               family runs under a serving plan
               (`models/tensor_parallel.py`): prefill (the encoder's
               forward too) split as the train step's forward, decode on
               the rank's shard of the decode state, its kv heads or,
               where they do not tile the model axis, its slice of the
               cache's sequence (JAX's split-KV decode), its SSM heads
               and channels: JAX's shard shapes of its
               `decode_state_shardings` but for the Mamba2 conv buffer
               (`models/model.py` `state_specs`);

with `use_flash_kernel=True`, as the port's launchers run. Under
`roofline/op_analyzer.py` the step's ops and each kernel function's
`kernel_costs` formula are counted and
`torch.distributed._tools.mem_tracker.MemTracker` follows its memory.
The record keeps JAX's keys (`memory_per_device`, `cost_per_device`,
`collectives_per_device`, `roofline`, `model_flops_global`,
`model_vs_hlo_flops`), so `launch/report.py` reads both packages'
records alike:

  * argument_bytes: the rank's local shards of the state (parameters, both
    AdamW moments, the step as JAX's 4-byte int32) or of the parameters,
    its decode state, plus its rows of the inputs;
  * temp_bytes: MemTracker's peak over the tensors the step allocates
    (gathered parameters, gradients, activations) — not XLA's buffer
    assignment, and not held to it.

Within a step a rank holds its shards, a unit's gathered parameters and
gradients and its activations (`dp_step.py`, ROADMAP A9.1, A9.4). The
collectives are also split by dtype (`collectives_by_dtype_per_device`:
float32 the parameters' gathers and gradients, bf16 the activations' over
the model axis). MoE cells run
in both of JAX's modes: global dispatch (the configs' default) and, with
`--opt moe_local`, a slab a device (`moe_dispatch_chunks = -1`, JAX's
`_moe_shard_map`; `models/moe.py`), in training, prefill and decode under
the plan: a model rank's experts (global dispatch) or its own token slab. A cell that raises
NotImplementedError is recorded "unsupported" with the reason; any other
exception is an "error", and the run exits 1.

Nothing happens at import: the fake group exists only inside `run_cells`.

Usage:
    python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] \
        [--out results/torch_dryrun]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten

from repro_torch.configs import ARCHS, SHAPES, cell_is_runnable, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import production_layout
from repro_torch.models import model as M
from repro_torch.models.fsdp import ShardedParams
from repro_torch.models.tensor_parallel import make_plan
from repro_torch.models.sharding_ctx import (
    axis_sizes,
    data_rank,
    distribute,
    local_shard,
    set_parameter,
    sharding_rules,
)
from repro_torch.roofline.analysis import H100, model_flops, roofline_terms
from repro_torch.roofline.op_analyzer import OpAnalyzer
from repro_torch.training.dp_step import make_sharded_train_step
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_loop import init_train_state

STEP_BYTES = 4       # the AdamW step, as JAX's int32 scalar


class TensorStruct(NamedTuple):
    """An input's shape and dtype (`jax.ShapeDtypeStruct`'s counterpart)."""

    shape: tuple
    dtype: torch.dtype


def input_structs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The model inputs of one cell, global shapes."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("decode", "long_decode"):
        return {"tokens": TensorStruct((b, 1), torch.int32)}
    if cfg.frontend == "frames":
        return {"frames": TensorStruct((b, s, cfg.d_model), torch.float32),
                "labels": TensorStruct((b, s), torch.int32)}
    base = {"tokens": TensorStruct((b, s), torch.int32)}
    if shape.kind == "train":
        base["labels"] = TensorStruct((b, s), torch.int32)
    return base


def _abstract_params(cfg: ModelConfig, training: bool) -> M.Model:
    """The model's parameters as fake tensors (call under a
    FakeTensorMode): float32 masters to train, the serving storage
    (`cfg.dtype` matrices) to prefill and decode."""
    return M.init_params(cfg, 0, device="cpu",
                         param_dtype=torch.float32 if training else None)


def _active_params(cfg: ModelConfig, n_params: int) -> int:
    """Active params for MODEL_FLOPS (MoE: only routed experts count)."""
    if cfg.family != "moe" or cfg.num_experts == 0:
        return n_params
    # expert weights are 3 matrices of (d_model x moe_d_ff) per expert
    per_expert = 3 * cfg.d_model * (cfg.moe_d_ff or cfg.d_ff)
    inactive = (cfg.num_experts - cfg.experts_per_token) * per_expert \
        * cfg.num_layers
    return n_params - inactive


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local_inputs(inputs: dict, mesh, cfg, overrides) -> dict:
    """This rank's part of each (global) input at the sanitised batch
    shardings (an input whose batch does not split over the data axes is
    replicated), a copy: a view of the global input would make the memory
    tracker count the whole global storage where a step views the rows
    (the frames' sequence slice under sequence parallelism)."""
    b_all = shd.batch_shardings(mesh, cfg, overrides)
    out = {}
    for k, full in inputs.items():
        sh = shd.sanitize_shardings(b_all.get(k, shd.replicated(mesh)),
                                    tuple(full.shape), mesh)
        out[k] = local_shard(full, mesh, sh.placements,
                             mesh.get_coordinate()).clone(
                                 memory_format=torch.contiguous_format)
    return out


def _sharded_params(model, mesh, cfg, overrides):
    """`model`'s parameters stored as DTensors at the sanitised parameter
    shardings; returns the bytes of this rank's shards."""
    p_shd = shd.sanitize_shardings(
        shd.param_shardings(mesh, cfg, overrides),
        {n: tuple(p.shape) for n, p in model.named_parameters()}, mesh)
    total = 0
    with torch.no_grad():
        for n, p in list(model.named_parameters()):
            d = distribute(p.detach(), mesh, p_shd[n].placements)
            total += _nbytes(d.to_local())
            set_parameter(model, n, d)
    return total


def sharded_train_state(model, mesh, cfg, overrides=None) -> tuple:
    """(the train state of `model`'s float32 masters stored at the
    sanitised train-state shardings, the bytes of this rank's shards: its
    parameters and both AdamW moments, and the step as JAX's int32)."""
    state = init_train_state(cfg, model)
    s_shd = shd.sanitize_shardings(
        shd.train_state_shardings(mesh, cfg, overrides),
        shd.state_shapes(state), mesh)
    state = shd.shard_train_state(state, s_shd)
    held = [p.to_local() for p in state.params.parameters()] + [
        t.to_local() for key in ("m", "v")
        for t in state.opt_state[key].values()]
    return state, STEP_BYTES + sum(_nbytes(t) for t in held)


def _peak_bytes(tracker) -> int:
    snap = tracker.get_tracker_snapshot("peak")
    return int(max((v.get("Total", 0) for v in snap.values()), default=0))


def dry_run_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                 grad_accum: int = 1, overrides: dict | None = None,
                 opts: tuple = ()) -> dict:
    """Run one cell's step on fake tensors; return the record.

    opts — the JAX dry-run's switches: "last_logit" (prefill computes
    logits only for the final position), "moe_local" (a MoE config's
    `moe_dispatch_chunks = -1`: a slab a device) and "no_sp" (the
    residual stream whole on every rank of the model axis: "res_seq"
    None, as `src/repro/launch/dryrun.py:85` sets it; the tensor-parallel
    train step then opens and closes its regions with all-reduces).
    """
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    if "no_sp" in opts:
        overrides = {**(overrides or {}), "res_seq": None}
    cfg = dataclasses.replace(cfg, use_flash_kernel=True)
    if "moe_local" in opts and cfg.family == "moe":
        cfg = dataclasses.replace(cfg, moe_dispatch_chunks=-1)
    t0 = time.time()
    n_chips = mesh.size()
    b, s = shape.global_batch, shape.seq_len
    sizes = axis_sizes(mesh)
    result: dict = {
        "arch": cfg.name, "shape": shape.name, "kind": shape.kind,
        "mesh": dict(sizes), "n_chips": int(n_chips),
        "attention": "flash kernels #10-#12 (kernel_costs formulas)",
    }
    training = shape.kind == "train"
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = _abstract_params(cfg, training)
        n_params = M.param_count(model)
        result["n_params"] = n_params
        global_in = {k: torch.zeros(st.shape, dtype=st.dtype)
                     for k, st in input_structs(cfg, shape).items()}
        inputs = _local_inputs(global_in, mesh, cfg, overrides)
        arg_bytes = sum(_nbytes(t) for t in inputs.values())
        tracker = MemTracker()
        if training:
            opt = OptimizerConfig(total_steps=10_000)
            state, state_bytes = sharded_train_state(model, mesh, cfg,
                                                     overrides)
            arg_bytes += state_bytes
            # the step takes the global batch and keeps the rank's rows
            step = make_sharded_train_step(cfg, opt, mesh, grad_accum,
                                           overrides)
            with tracker, OpAnalyzer() as ana:
                step(state, global_in)
            mflops = model_flops(_active_params(cfg, n_params), b * s,
                                 training=True)
        else:
            arg_bytes += _sharded_params(model, mesh, cfg, overrides)
            # the rows are the rank's share where the batch splits over the
            # data axes, else the whole batch (`_local_inputs`)
            split = all(t.shape[0] < global_in[k].shape[0]
                        for k, t in inputs.items()) or data_rank(mesh)[0] == 1
            with sharding_rules(mesh, overrides, split_rows=split):
                plan = make_plan(cfg, mesh, serving=True)
            if shape.kind == "prefill":
                if cfg.is_encoder:
                    def fwd():
                        return M.forward(model, cfg, inputs)
                else:
                    def fwd():
                        return M.prefill(model, cfg, inputs, max_len=s,
                                         last_only="last_logit" in opts)
                mflops = model_flops(_active_params(cfg, n_params), b * s,
                                     training=False)
            else:
                local_b = inputs["tokens"].shape[0]
                dstate = M.init_decode_state(cfg, local_b, s, device="cpu",
                                             tp=plan)
                arg_bytes += sum(_nbytes(t) for t in tree_flatten(dstate)[0]
                                 if isinstance(t, torch.Tensor))

                def fwd():
                    return M.decode_step(model, cfg, dstate,
                                         inputs["tokens"])
                mflops = model_flops(_active_params(cfg, n_params), b,
                                     training=False)
            with torch.no_grad(), tracker, OpAnalyzer() as ana:
                with ShardedParams(model, mesh, plan), sharding_rules(
                        mesh, overrides, split_rows=split):
                    fwd()
        temp = _peak_bytes(tracker)
    result["run_s"] = round(time.time() - t0, 2)
    result["memory_per_device"] = {
        "argument_bytes": int(arg_bytes), "output_bytes": 0,
        "temp_bytes": temp, "alias_bytes": 0, "code_bytes": 0,
        "total_gb": round((arg_bytes + temp) / 2**30, 3)}
    counts = ana.analyze()
    flops, byts = counts["flops"], counts["bytes_accessed"]
    result["cost_per_device"] = {"flops": flops, "bytes_accessed": byts,
                                 "flops_f32": counts["flops_f32"]}
    result["collectives_per_device"] = counts["collectives"]
    result["collectives_by_dtype_per_device"] = counts["collectives_by_dtype"]
    result["kernels_per_device"] = counts["kernels"]
    result["top_ops_by_bytes"] = dict(ana.top_ops(5))
    result["roofline"] = roofline_terms(
        flops, byts, counts["collectives"]["total"]["bytes"], 1, H100,
        f32_flops=counts["flops_f32"])
    result["model_flops_global"] = mflops
    total_flops = flops * n_chips
    result["model_vs_hlo_flops"] = (mflops / total_flops if total_flops
                                    else None)
    return result


@contextlib.contextmanager
def fake_world(shape: tuple, axes: tuple, rank: int = 0):
    """This process as rank `rank` of a `fake` process group of one rank a
    mesh position, and the `DeviceMesh` of `shape` over `axes` on it;
    the group is destroyed on leaving. The launchers' meshes
    (`launch/mesh.py`) refuse this backend: only the dry-run builds a
    mesh on it."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run needs its own process group; one is "
                           "already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=axes)
    finally:
        dist.destroy_process_group()


def run_cells(archs, shapes, *, multi_pod: bool, out_dir: str,
              grad_accum: int = 1, opts: tuple = (),
              tag_suffix: str = "") -> list[dict]:
    tag = ("multipod" if multi_pod else "singlepod") + tag_suffix
    os.makedirs(out_dir, exist_ok=True)
    records = []
    with fake_world(*production_layout(multi_pod)) as mesh:
        for arch in archs:
            cfg = get_config(arch)
            for shape_name in shapes:
                shape = SHAPES[shape_name]
                ok, why = cell_is_runnable(cfg, shape)
                cell = f"{arch}__{shape_name}__{tag}"
                path = os.path.join(out_dir, cell + ".json")
                if not ok:
                    rec = {"arch": arch, "shape": shape_name, "mesh": tag,
                           "status": "skipped", "reason": why}
                    print(f"[skip] {cell}: {why}", flush=True)
                else:
                    print(f"[cell] {cell} ...", flush=True)
                    try:
                        rec = dry_run_cell(cfg, shape, mesh,
                                           grad_accum=grad_accum, opts=opts)
                        rec["status"] = "ok"
                        rec["opts"] = list(opts)
                        rec["grad_accum"] = grad_accum
                        r = rec["roofline"]
                        print(f"  ok: run {rec['run_s']}s mem "
                              f"{rec['memory_per_device']['total_gb']}GB "
                              f"dominant {r['dominant']}", flush=True)
                    except NotImplementedError as e:
                        rec = {"arch": arch, "shape": shape_name,
                               "mesh": tag, "status": "unsupported",
                               "reason": str(e)}
                        print(f"  unsupported: {e}", flush=True)
                    except Exception as e:  # noqa: BLE001 — record, go on
                        rec = {"arch": arch, "shape": shape_name,
                               "mesh": tag, "status": "error",
                               "error": repr(e),
                               "traceback": traceback.format_exc()}
                        print(f"  ERROR: {e!r}", flush=True)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2, default=str)
                records.append(rec)
    return records


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", action="append", default=None,
                    help="arch id (repeatable); default: all")
    ap.add_argument("--shape", action="append", default=None,
                    help="shape name (repeatable); default: all")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--opt", action="append", default=[],
                    choices=["last_logit", "moe_local", "no_sp"],
                    help="the JAX dry-run's switches (repeatable)")
    ap.add_argument("--tag", default="",
                    help="suffix for result filenames (e.g. _opt1)")
    ap.add_argument("--out", default="results/torch_dryrun")
    args = ap.parse_args(argv)

    archs = args.arch or sorted(ARCHS)
    shapes = args.shape or list(SHAPES)
    t0 = time.time()
    recs = run_cells(archs, shapes, multi_pod=args.multi_pod,
                     out_dir=args.out, grad_accum=args.grad_accum,
                     opts=tuple(args.opt), tag_suffix=args.tag)
    n = {k: sum(r["status"] == k for r in recs)
         for k in ("ok", "skipped", "unsupported", "error")}
    print(f"\ndone: {n['ok']} ok, {n['skipped']} skipped, "
          f"{n['unsupported']} unsupported, {n['error']} errors "
          f"({time.time() - t0:.1f} s)")
    if n["error"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
