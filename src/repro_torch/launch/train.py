"""Fault-tolerant training launcher (PyTorch port of `repro.launch.train`).

    python -m repro_torch.launch.train --arch minicpm-2b --steps 4 \
        --batch 4 --seq 4096 --grad-accum 2
    python -m repro_torch.launch.train --arch minicpm-2b --reduced \
        --device cpu --steps 3
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch stablelm-1.6b --reduced --device cpu --mesh debug --steps 2

Trains every family: token batches, or frame batches for an encoder
(hubert-xlarge). Runs on the card unless `--device cpu` is given.
Parameters are random,
from `--seed`, kept as float32 masters and cast to the config's dtype at
use. Full-sequence attention goes through the flash-attention kernels
(`use_flash_kernel=True`): the forward #11 and the backward #12, inside
`torch.autograd.Function`. minicpm takes the WSD schedule, the others
cosine.

Fault tolerance, as in the JAX launcher:
  * checkpoints every --ckpt-every steps, atomic, step-tagged;
  * --resume restarts from the newest complete checkpoint — the data is a
    pure function of (seed, step), so the replay is exact;
  * the step loop retries once from the last checkpoint on a failure.

`--mesh debug|production` trains on a `torch.distributed` mesh, one
process a device, as torchrun starts them (RANK, WORLD_SIZE; NCCL on the
card, `gloo` with `--device cpu`): debug is 2 x 2 over ("data", "model"),
production 16 x 16 (`--multi-pod`: 2 x 16 x 16 with "pod"), so the world
size must be 4, 256 or 512. The step is `training/dp_step.py`'s
`make_sharded_train_step`, the JAX launcher's sharded step
(`src/repro/launch/train.py:51-72`) as DTensors: the parameters and both
AdamW moments are stored at `sanitize_shardings(train_state_shardings(
mesh, cfg))` (ZeRO-3 over "data" plus the "model" splits), so between
steps each rank holds what the JAX device at its mesh coordinates holds.
Within a step a rank gathers one unit's parameters at a time (a block,
the embedding, the head; `models/fsdp.py`) and reduce-scatters each
gradient onto its shard as the backward leaves the unit, so it holds its
shards, a unit's float32 parameters and gradients, and its activations.
No DTensor reaches a hand-written kernel (the flash ops have no DTensor
sharding rule). Every family splits its compute over the model axis as
JAX's rules split it (`models/tensor_parallel.py`): a rank computes its
heads (its slice of the queries against the gathered K/V where the kv
heads do not tile the axis), its ff and vocabulary columns, a MoE
block's experts or token slab, a Mamba2 block's heads, an mLSTM block's
channels and heads, an sLSTM block's feed-forward columns (the
recurrence whole), and carries its slice of the residual sequence.
A MoE architecture trains in either dispatch mode
(`--moe-dispatch-chunks`; -1 is JAX's `_moe_shard_map`, a slab a
device), with the single-device result of its global dispatch
(`models/moe.py`).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data.synthetic import make_lm_batch
from repro_torch.device import resolve_device
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import (
    init_distributed,
    make_debug_mesh,
    make_production_mesh,
)
from repro_torch.models.model import init_params, param_count
from repro_torch.training.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.training.dp_step import make_sharded_train_step
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_loop import init_train_state, make_train_step


def build(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, use_flash_kernel=True)
    # a Namespace built without the option keeps the config's dispatch
    chunks = getattr(args, "moe_dispatch_chunks", None)
    if chunks is not None:
        cfg = dataclasses.replace(cfg, moe_dispatch_chunks=chunks)
    schedule = "wsd" if args.arch.startswith("minicpm") else "cosine"
    opt = OptimizerConfig(peak_lr=args.lr, schedule=schedule,
                          warmup_steps=min(100, args.steps // 10 + 1),
                          total_steps=args.steps)
    step_fn = make_train_step(cfg, opt, grad_accum=args.grad_accum)
    return cfg, opt, step_fn


def sharded_state(cfg, seed: int, mesh, device) -> tuple:
    """(state, its shardings): `init_params` from `seed` on every rank,
    float32 masters, then stored at the sanitized train-state shardings."""
    state = init_train_state(cfg, init_params(
        cfg, seed, device=device, param_dtype=torch.float32))
    s_shd = shd.sanitize_shardings(shd.train_state_shardings(mesh, cfg),
                                   shd.state_shapes(state), mesh)
    return shd.shard_train_state(state, s_shd), s_shd


def _mesh(args, dev):
    if args.mesh == "debug":
        return make_debug_mesh(device=dev)
    return make_production_mesh(multi_pod=args.multi_pod, device=dev)


def run(args) -> dict:
    """Train `args.steps` steps; returns the last step's metrics (floats),
    "steps", and "history": each step's metrics with its "seconds" (host
    clock to a synchronised finish)."""
    cfg, opt, step_fn = build(args)
    dev = resolve_device(args.device)
    s_shd = None
    if args.mesh != "none":
        init_distributed(dev)
        mesh = _mesh(args, dev)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        state, s_shd = sharded_state(cfg, args.seed, mesh, dev)
        step_fn = make_sharded_train_step(cfg, opt, mesh, args.grad_accum)
    else:
        params = init_params(cfg, args.seed, device=dev,
                             param_dtype=torch.float32)
        state = init_train_state(cfg, params)
    # one line per step from rank 0 of a mesh
    say = (print if not dist.is_initialized() or dist.get_rank() == 0
           else lambda *a, **k: None)
    say(f"arch={cfg.name} params={param_count(state.params) / 1e6:.2f}M "
        f"device={dev} mesh={args.mesh}", flush=True)

    start = 0
    if args.resume and args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            state = restore_checkpoint(args.ckpt_dir, last, state, s_shd)
            start = last
            say(f"resumed from step {last}", flush=True)

    metrics, history = {}, []
    t0 = time.perf_counter()
    step = start
    retried = False
    while step < args.steps:
        try:
            t_step = time.perf_counter()
            batch = make_lm_batch(cfg, args.batch, args.seq, args.seed, step)
            state, out = step_fn(state, batch)
            metrics = {k: float(v) for k, v in out.items()}   # synchronises
            history.append(metrics | {"seconds": time.perf_counter() - t_step})
            step += 1
            if step % args.log_every == 0 or step == args.steps:
                dt = (time.perf_counter() - t0) / max(step - start, 1)
                say(f"step {step:5d} loss {metrics['loss']:.4f} "
                    f"ce {metrics['ce']:.4f} lr {metrics['lr']:.2e} "
                    f"gnorm {metrics['grad_norm']:.2f} ({dt:.2f}s/step)",
                    flush=True)
            if args.ckpt_dir and step % args.ckpt_every == 0:
                save_checkpoint(args.ckpt_dir, step, state)
        except (RuntimeError, ValueError):
            # transient-failure path: reload the last checkpoint once
            if retried or not args.ckpt_dir:
                raise
            retried = True
            last = latest_step(args.ckpt_dir)
            if last is None:
                raise
            say(f"step failed; retrying from checkpoint {last}", flush=True)
            state = restore_checkpoint(args.ckpt_dir, last, state, s_shd)
            step = last
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, step, state)
    return metrics | {"steps": step, "history": history}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", choices=["none", "debug", "production"],
                    default="none")
    ap.add_argument("--multi-pod", action="store_true",
                    help="--mesh production over 2 pods (512 processes)")
    ap.add_argument("--moe-dispatch-chunks", type=int, default=None,
                    help="a MoE config's dispatch: 0 global buffers, C > 1 "
                         "chunk-local ones, -1 a slab a device under --mesh "
                         "(JAX's _moe_shard_map; the dry-run's --opt "
                         "moe_local); default: the config's")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
