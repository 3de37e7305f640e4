"""The port's `streaming_updates` example against the JAX package's, on
the CPU at the `--quick` sizes.

  * churn: the JAX script, loaded by path, runs its own `run_churn` with
    its quick arguments; its printed tick table equals the port's rows bit
    for bit in size, deleted, inserted, reused and generation (the
    integers the mutation engine's book-keeping decides), and each tick's
    recall@10 is within 0.05 of JAX's;
  * grow, serve, tenants and tiered hold their own contracts on the port
    (each `run_*` asserts them as the JAX script does; the rows it returns
    are checked here as well);
  * `--trace` of churn and of serve writes a Chrome trace that
    `scripts/obs_report.py` reads with exit code 0.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.examples import streaming_updates as su

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_examples import load_jax_example  # noqa: E402

RECALL_SLACK = 0.05
INT_COLUMNS = ("size", "deleted", "inserted", "reused", "generation")
QUICK_CHURN = dict(n0=600, rounds=3, batch=60, dims=64, quick=True)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors gain nothing from intra-op threads; one thread keeps
    this file from competing with the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def churn_table(text: str) -> list[dict]:
    """The tick rows of a churn table the JAX script printed."""
    rows, lines = [], text.splitlines()
    head = next(i for i, ln in enumerate(lines) if ln.split()[:2]
                == ["tick", "size"])
    for ln in lines[head + 1:]:
        f = ln.split()
        if len(f) != 8 or not f[0].isdigit():
            break
        rows.append({"tick": int(f[0]), "size": int(f[1]),
                     "deleted": int(f[2]), "inserted": int(f[3]),
                     "reused": int(f[4]), "generation": int(f[6]),
                     "recall": float(f[7])})
    return rows


def assert_same_ticks(got: list, want: list) -> None:
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert {c: g[c] for c in INT_COLUMNS} \
            == {c: w[c] for c in INT_COLUMNS}, (g, w)
        assert abs(g["recall"] - w["recall"]) <= RECALL_SLACK, (g, w)


def test_churn_matches_jax(capsys):
    jmod = load_jax_example("streaming_updates")
    assert jmod.run_churn(**QUICK_CHURN) is None
    want = churn_table(capsys.readouterr().out)
    got = su.run_churn(**QUICK_CHURN, device="cpu")
    assert churn_table(capsys.readouterr().out) == [
        {k: r[k] if k != "recall" else round(r[k], 3) for k in
         ("tick", "size", "deleted", "inserted", "reused", "generation",
          "recall")} for r in got["rows"]]
    assert_same_ticks(got["rows"], want)
    assert sum(r["reused"] for r in got["rows"]) > 0
    assert got["stats"]["n_consolidations"] >= 1
    assert got["metrics"] is None


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """churn and serve at the quick sizes, each with --trace."""
    out = {}
    for mode in ("churn", "serve"):
        path = str(tmp_path_factory.mktemp("trace") / f"{mode}.json")
        res = su.main([f"--{mode}", "--quick", "--trace", path,
                       "--device", "cpu"])
        out[mode] = (res, path)
    return out


@pytest.mark.parametrize("mode", ["churn", "serve"])
def test_trace_passes_obs_report(traced, mode):
    res, path = traced[mode]
    assert res["metrics"], "a traced run serves with its metrics on"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "obs_report.py"),
         path], capture_output=True, text=True, timeout=120, env=env)
    assert done.returncode == 0, done.stderr
    assert "rows_tier=" in done.stdout


def test_traced_churn_keeps_its_contracts(traced):
    res, _ = traced["churn"]
    assert [r["size"] for r in res["rows"]] == [600] * 3
    assert all(r["deleted"] == r["inserted"] == 60 for r in res["rows"])
    assert any(k.startswith("search.") for k in res["metrics"])


def test_serve_keeps_its_contracts(traced):
    res, _ = traced["serve"]
    n = res["n_arrivals"]
    assert n == 200
    for name, rep in res["reports"].items():
        assert rep["completed"] + rep["rejected"] == n, (name, rep)
        assert rep["completed"] == n, (name, rep)


def test_tenants_keep_their_contracts():
    res = su.run_tenants(n0=400, rounds=3, dims=64, quick=True,
                         device="cpu")
    assert len(res["rows"]) == 6
    assert all(r["leaks"] == 0 for r in res["rows"])
    assert {r["tenant"] for r in res["rows"]} == {"acme", "bolt"}
    assert res["quota_refused"]
    assert res["n_plans"] >= 1


def test_tiered_keeps_its_contracts():
    res = su.run_tiered(n0=600, rounds=3, batch=60, dims=64, quick=True,
                        device="cpu")
    assert len(res["rows"]) == 3
    assert all(r["device_rows_bytes"] == 0.0 for r in res["rows"])
    assert all(r["recall"] >= 0.85 for r in res["rows"]), res["rows"]
    assert res["steady_delta"]["traces"] == 0
    assert res["storage"]["fetch_n_fetches"] > 0


def test_grow_keeps_recall():
    res = su.run_streaming(total=3000, batch=750, device="cpu")
    sizes = [r["size"] for r in res["rows"]]
    assert sizes == [750, 1500, 2250, 3000]
    assert all(r["recall"] >= 0.85 for r in res["rows"]), res["rows"]
    assert np.all(np.isfinite([r["inserts_s"] for r in res["rows"]]))
