"""Tables from the port's dry-run records (PyTorch port of
`repro.launch.report`).

    PYTHONPATH=src python -m repro_torch.launch.report > tables.md

Reads `launch/dryrun.py`'s and `launch/dryrun_anns.py`'s JSON records
(default `results/torch_dryrun/` and `results/torch_dryrun_anns/`) and
prints the dry-run, roofline and ANNS tables the JAX package's report
prints; the records keep JAX's keys, so the same tables read either
package's records.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def _load(pattern: str) -> list[dict]:
    out = []
    for f in sorted(glob.glob(pattern)):
        with open(f) as fh:
            rec = json.load(fh)
        rec["_file"] = os.path.basename(f)
        out.append(rec)
    return out


def fmt_seconds(x) -> str:
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    return f"{x * 1000:.1f}ms"


def dryrun_table(records: list[dict], tag: str) -> str:
    """The "compile" column is a JAX record's `compile_s`; the port
    compiles nothing, and shows there its record's `run_s`, the cell's
    wall time under the fake tensors."""
    rows = ["| arch | shape | status | mem/chip | compile | collectives/chip |",
            "|---|---|---|---|---|---|"]
    for r in records:
        if not r["_file"].endswith(f"{tag}.json"):
            continue
        if r["status"] in ("skipped", "unsupported"):
            word = "SKIP" if r["status"] == "skipped" else "UNSUPPORTED"
            rows.append(f"| {r['arch']} | {r['shape']} | {word} "
                        f"({r['reason'][:40]}...) | - | - | - |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | ERROR | - | - | - |")
            continue
        mem = r["memory_per_device"]["total_gb"]
        coll = r["collectives_per_device"]
        abbr = {"all-gather": "ag", "all-reduce": "ar",
                "reduce-scatter": "rs", "all-to-all": "a2a",
                "collective-permute": "cp"}
        parts = [f"{abbr.get(k, k)}:{v['bytes'] / 2**30:.1f}G"
                 for k, v in coll.items()
                 if isinstance(v, dict) and k != "total" and v.get("bytes")]
        rows.append(
            f"| {r['arch']} | {r['shape']} | ok | {mem:.1f} GB | "
            f"{r.get('compile_s', r.get('run_s', '-'))}s | "
            f"{' '.join(parts) or '-'} |")
    return "\n".join(rows)


def roofline_table(records: list[dict], tag: str) -> str:
    rows = ["| arch | shape | compute | memory | collective | dominant | "
            "roofline frac | 6ND/HLO | what would move it |",
            "|---|---|---|---|---|---|---|---|---|"]
    hints = {
        "compute_s": "more chips / lower-precision matmuls",
        "memory_s": "fused kernels (flash/rabitq) cutting intermediate HBM round-trips",
        "collective_s": "manual-SPMD dispatch + bf16/int8 collectives (see #B4)",
    }
    for r in records:
        if not r["_file"].endswith(f"{tag}.json") or r["status"] != "ok":
            continue
        rl = r["roofline"]
        mvh = r.get("model_vs_hlo_flops")
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_seconds(rl['compute_s'])} | "
            f"{fmt_seconds(rl['memory_s'])} | {fmt_seconds(rl['collective_s'])} | "
            f"{rl['dominant'].replace('_s', '')} | "
            f"{rl['roofline_fraction'] * 100:.1f}% | "
            f"{'-' if mvh is None else f'{mvh:.2f}'} | "
            f"{hints[rl['dominant']]} |")
    return "\n".join(rows)


def anns_table(records: list[dict]) -> str:
    rows = ["| dataset | variant | mesh | mem/chip | bound/step | "
            "qps @ roof | dominant |",
            "|---|---|---|---|---|---|---|"]
    for r in records:
        if r["status"] != "ok":
            continue
        rl = r["roofline"]
        tag = r["_file"].rsplit("__", 1)[-1].replace(".json", "")
        rows.append(
            f"| {r['dataset']} | {r['variant']} | {tag} | "
            f"{r['memory_per_device_gb']:.1f} GB | {fmt_seconds(rl['bound_s'])} | "
            f"{r['queries_per_sec_at_roof']:.2e} | "
            f"{rl['dominant'].replace('_s', '')} |")
    return "\n".join(rows)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun", default="results/torch_dryrun")
    ap.add_argument("--anns", default="results/torch_dryrun_anns")
    args = ap.parse_args(argv)
    lm = _load(os.path.join(args.dryrun, "*.json"))
    anns = _load(os.path.join(args.anns, "*.json"))
    print("## Dry-run: single-pod (16x16 = 256 ranks)\n")
    print(dryrun_table(lm, "singlepod"))
    print("\n## Dry-run: multi-pod (2x16x16 = 512 ranks)\n")
    print(dryrun_table(lm, "multipod"))
    print("\n## Roofline: single-pod baseline (H100 peaks)\n")
    print(roofline_table(lm, "singlepod"))
    print("\n## Roofline: single-pod optimized (last_logit; the port "
          "has no moe_local or no_sp)\n")
    print(roofline_table(lm, "singlepod_opt"))
    print("\n## ANNS cells (paper workload at full scale)\n")
    print(anns_table(anns))


if __name__ == "__main__":
    main()
