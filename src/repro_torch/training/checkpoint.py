"""Fault-tolerant checkpointing (PyTorch port of
`repro.training.checkpoint`): atomic, step-tagged.

Layout: <dir>/step_<N>.npz (+ .meta.json), written via tmp + os.replace so
a crash mid-write never corrupts the latest checkpoint; the meta file is
renamed last, and `latest_step` only counts steps that have both. One npz
holds every leaf, keyed by the port's names: "params/<parameter name>",
"opt_state/m/<parameter name>", ..., "opt_state/step". Floating leaves are
stored as float32 (exact for float32 and bfloat16), so the format does
not depend on the device that wrote it. Restore copies INTO a like-state
on any device, in place.
"""

from __future__ import annotations

import json
import os
import re
import threading

import numpy as np
import torch
from torch import nn


def _leaves(tree, prefix: str = ""):
    """(key, leaf) for every tensor or number of a TrainState / dict /
    Module tree."""
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield prefix + name, p
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for field in tree._fields:
            yield from _leaves(getattr(tree, field), f"{prefix}{field}/")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return (t.float() if t.is_floating_point() else t).cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(ckpt_dir: str, step: int, tree,
                    extra_meta: dict | None = None,
                    async_write: bool = False) -> str:
    """Atomic save. Returns the final path. The leaves are copied to the
    host first; async_write then returns and writes the file in a daemon
    thread (done when its meta file exists)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    flat = {key: _to_numpy(leaf) for key, leaf in _leaves(tree)}
    meta = {"step": step, **(extra_meta or {})}

    def write():
        tmp = final + ".tmp.npz"
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, final)
        with open(final + ".meta.json.tmp", "w") as f:
            json.dump(meta, f)
        os.replace(final + ".meta.json.tmp", final + ".meta.json")

    if async_write:
        threading.Thread(target=write, daemon=True).start()
    else:
        write()
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """Newest step with BOTH the npz and its meta present (a crash between
    the two renames leaves a checkpoint that is ignored, not half-read)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)\.npz", f))
             and os.path.exists(os.path.join(ckpt_dir, f + ".meta.json"))]
    return max(steps) if steps else None


@torch.no_grad()
def _restore(tree, data, prefix: str = ""):
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            p.copy_(torch.from_numpy(data[prefix + name]))
        return tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_restore(getattr(tree, f), data, f"{prefix}{f}/")
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _restore(v, data, f"{prefix}{k}/") for k, v in tree.items()}
    key = prefix.rstrip("/")
    if isinstance(tree, torch.Tensor):
        return tree.copy_(torch.from_numpy(data[key]))
    return type(tree)(data[key])


def restore_checkpoint(ckpt_dir: str, step: int, like):
    """Restore into the structure of `like` (a TrainState, dict or
    Module), copying each leaf into `like`'s tensor in place — on the
    device and in the dtype it has there. Returns the restored tree."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(path) as data:
        return _restore(like, data)
