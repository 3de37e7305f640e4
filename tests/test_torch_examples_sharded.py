"""The port's sharded `streaming_updates` modes against the JAX package's,
on eight CPU mesh positions at the `--quick` sizes.

The JAX script's `run_churn(..., sharded=True)` and `run_reshard` run with
their quick arguments, one after the other, in one subprocess with
`XLA_FLAGS=--xla_force_host_platform_device_count=8` (its CI lane; each
op on one thread, so that the subprocess leaves the other test workers
their cores), started before the port runs the same modes in-process on a
mesh of eight CPU positions:

  * sharded churn: each tick's size, deleted, inserted, reused and
    generation equal JAX's bit for bit, recall@10 within 0.05;
  * reshard: the live rows saved at 4 shards and restored at 2 equal, as
    do the translated id count and each churn tick's size and generation;
    r4 and r2 each within 0.05 of JAX's, and each tick's recall too.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.examples import streaming_updates as su

pytestmark = pytest.mark.multidevice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_examples_streaming import (  # noqa: E402
    QUICK_CHURN, RECALL_SLACK, assert_same_ticks, churn_table)

SEPARATOR = "=" * 8 + " reshard"
# the JAX script's two sharded modes, loaded by path, in one process
JAX_RUNS = f"""
import importlib.util, sys
spec = importlib.util.spec_from_file_location("jax_example", sys.argv[1])
su = importlib.util.module_from_spec(spec)
spec.loader.exec_module(su)
su.run_churn(**{QUICK_CHURN!r}, sharded=True)
print({SEPARATOR!r}, flush=True)
su.run_reshard(n0=600, dims=64, quick=True)
"""


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors gain nothing from intra-op threads; one thread keeps
    this file from competing with the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """Start the JAX subprocess, run the port, then wait for JAX."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_cpu_multi_thread_eigen=false")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_RUNS,
         os.path.join(REPO, "examples", "streaming_updates.py")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = {"sharded": su.run_churn(**QUICK_CHURN, sharded=True,
                                        device="cpu"),
                "reshard": su.run_reshard(n0=600, dims=64, quick=True,
                                          device="cpu")}
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    sharded, reshard = stdout.split(SEPARATOR)
    return port, {"sharded": sharded, "reshard": reshard}


def test_sharded_churn_matches_jax(runs):
    port, jax_out = runs
    assert "sharded: 4 row shards x 2-way query axis" in jax_out["sharded"]
    got = port["sharded"]["rows"]
    assert_same_ticks(got, churn_table(jax_out["sharded"]))
    assert sum(r["reused"] for r in got) > 0


def _reshard_numbers(text: str) -> dict:
    saved = re.search(r"saved at 4 shards: (\d+) live rows, recall "
                      r"([\d.]+)", text)
    restored = re.search(r"restored at 2 shards: (\d+) live rows, recall "
                         r"([\d.]+), (\d+) ids translated", text)
    ticks = re.findall(r"tick (\d+): size (\d+) gen (\d+) recall ([\d.]+)",
                       text)
    return {"size4": int(saved[1]), "r4": float(saved[2]),
            "size2": int(restored[1]), "r2": float(restored[2]),
            "translated": int(restored[3]),
            "rows": [{"tick": int(t), "size": int(s), "generation": int(g),
                      "recall": float(r)} for t, s, g, r in ticks]}


def test_reshard_matches_jax(runs):
    port, jax_out = runs
    got, want = port["reshard"], _reshard_numbers(jax_out["reshard"])
    assert "reshard smoke OK" in jax_out["reshard"]
    for key in ("size4", "size2", "translated"):
        assert got[key] == want[key], key
    assert got["size2"] == got["size4"]
    for key in ("r4", "r2"):
        assert abs(got[key] - want[key]) <= RECALL_SLACK, (key, got, want)
    assert got["r2"] >= got["r4"] - 0.05
    assert len(got["rows"]) == len(want["rows"]) == 3
    for g, w in zip(got["rows"], want["rows"]):
        assert (g["tick"], g["size"], g["generation"]) \
            == (w["tick"], w["size"], w["generation"]), (g, w)
        assert abs(g["recall"] - w["recall"]) <= RECALL_SLACK, (g, w)
