"""Declarative search configuration: the subset of `repro.core.search_spec`
this slice needs.

  * `SearchSpec` — frozen, hashable, JSON-serialisable description of one
    search configuration. `resolve()` is the single definition site of
    every default formula and validation rule.
  * `ResolvedSearchSpec` — the fully concrete, normalised form
    `core_search` runs.
  * `SearchResult` — ids, dists, per-query hop counts, generation.
  * `Searcher` — the minimal session `JasperIndex.searcher(spec)` returns:
    the spec resolved once, `.search(queries)` -> `SearchResult`.
  * `measure_recall` — recall@k at the exact served configuration.

`PlanCache`, `Searcher.submit/drain`, `SearchSurface` and the bucket
ladder are not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import json
import numbers
from dataclasses import asdict, dataclass, fields, replace
from typing import Any, NamedTuple

import numpy as np

from repro_torch.core.beam_search import MERGE_STRATEGIES
from repro_torch.core.mutations import N_LABELS, filter_to_bytes

SPEC_VERSION = 1

FUSION_MODES = ("none", "hop", "megakernel")

TELEMETRY_MODES = ("off", "on")

# Where the exact rerank reads its f32 rows: "device" (core.vectors),
# "host" (host-tier rows; not ported yet), "none" (estimator distances,
# `SearchResult.estimated`). Quantized rerank=False normalises to "none".
RERANK_SOURCES = ("device", "host", "none")

FILTER_MODES = ("exclude", "traverse")


def check_quantized_backend(index, *, need_codes: bool = True) -> None:
    """The quantized-capability check: the index must be a RaBitQ backend
    and (unless `need_codes=False`) already hold packed codes."""
    if getattr(index, "quantization", None) != "rabitq":
        raise ValueError(
            "quantized=True requires an index built with "
            "quantization='rabitq' (this core has no packed codes)")
    core = getattr(index, "core", None)
    if need_codes and core is not None and core.codes is None:
        raise ValueError(
            "quantized=True on a codeless core: this "
            "quantization='rabitq' index has not trained its quantizer "
            "yet — build or insert data before opening a quantized "
            "search session")


def check_rows_tier(index, rerank_source: str) -> None:
    """The rows-tier check: a resolved `rerank_source` must match where
    the index's f32 rows live."""
    tier = getattr(index, "rows_tier", "device")
    if rerank_source == "host" and tier != "host":
        raise ValueError(
            "rerank_source='host' requires the index's f32 rows to be "
            "evicted to the host tier (index.rows_tier == 'host'; call "
            "evict_rows_to_host()) — this index's rows are "
            "device-resident, so use rerank_source='device' "
            "(bit-identical) or evict first")
    if rerank_source == "device" and tier != "device":
        raise ValueError(
            "rerank_source='device' needs device-resident f32 rows, but "
            "this index's rows are evicted to the host tier — use "
            "rerank_source='host' (bit-identical exact rerank) or "
            "'none' (estimator-only), or call restore_rows_to_device()")


def _as_int(name: str, value, *, floor: int) -> int:
    """Coerce an integral spec field (python or numpy int) to a plain int;
    bool and everything non-integral are configuration errors."""
    if isinstance(value, bool) or not isinstance(value, numbers.Integral):
        raise ValueError(f"{name} must be an int, got {value!r}")
    value = int(value)
    if value < floor:
        raise ValueError(f"{name} must be >= {floor}, got {value}")
    return value


@dataclass(frozen=True)
class SearchSpec:
    """Declarative description of one search configuration (the same
    fields, defaults and meaning as `repro.core.search_spec.SearchSpec`;
    see there for the per-field documentation)."""

    k: int = 10
    beam_width: int | None = None
    max_iters: int | None = None
    expand: int = 1
    quantized: bool = False
    rerank: bool = True
    rerank_source: str = "device"
    rerank_tile: int = 512
    use_kernels: bool = False
    merge: str = "topk"
    traverse_deleted: bool = True
    fusion: str = "none"
    beam_schedule: tuple | None = None
    telemetry: str = "off"
    filter: tuple | int | None = None
    filter_mode: str = "traverse"

    def resolve(self, index: Any = None) -> "ResolvedSearchSpec":
        """Fill defaults, validate, normalise — the one definition site."""
        k = _as_int("k", self.k, floor=1)
        expand = _as_int("expand", self.expand, floor=1)
        if self.merge not in MERGE_STRATEGIES:
            raise ValueError(
                f"merge must be one of {MERGE_STRATEGIES}, "
                f"got {self.merge!r}")
        if self.fusion not in FUSION_MODES:
            raise ValueError(
                f"fusion must be one of {FUSION_MODES}, got {self.fusion!r}")
        if self.telemetry not in TELEMETRY_MODES:
            raise ValueError(
                f"telemetry must be one of {TELEMETRY_MODES}, "
                f"got {self.telemetry!r}")
        if self.filter_mode not in FILTER_MODES:
            raise ValueError(
                f"filter_mode must be one of {FILTER_MODES}, "
                f"got {self.filter_mode!r}")
        filt = self.filter
        if filt is not None:
            if isinstance(filt, bool) or (
                    not isinstance(filt, numbers.Integral)
                    and not hasattr(filt, "__iter__")):
                raise ValueError(
                    f"filter must be a label id, a sequence of label ids, "
                    f"or None, got {filt!r}")
            labels = ((filt,) if isinstance(filt, numbers.Integral)
                      else tuple(filt))
            if not labels:
                raise ValueError(
                    "filter must be a non-empty label set or None (an "
                    "empty filter would match no rows; pass None to "
                    "search unfiltered)")
            for lab in labels:
                lab = _as_int("filter labels", lab, floor=0)
                if lab >= N_LABELS:
                    raise ValueError(
                        f"filter label {lab} out of range "
                        f"[0, {N_LABELS})")
        filtered = filt is not None
        filter_mode = self.filter_mode if filtered else "traverse"
        schedule = self.beam_schedule
        if schedule is not None:
            try:
                schedule = tuple(_as_int("beam_schedule entries", w, floor=1)
                                 for w in schedule)
            except TypeError:
                raise ValueError(
                    f"beam_schedule must be a sequence of ints, "
                    f"got {self.beam_schedule!r}") from None
            if not schedule:
                raise ValueError("beam_schedule must be non-empty or None")
            if min(schedule) < k:
                raise ValueError(
                    f"every beam_schedule entry must be >= k={k}, got "
                    f"{schedule} (a hop narrower than k cannot carry k "
                    "results to the output)")
        bw = (max(schedule) if schedule is not None
              else max(k, 32) if self.beam_width is None
              else _as_int("beam_width", self.beam_width, floor=1))
        if self.beam_width is not None and schedule is not None:
            bw = _as_int("beam_width", self.beam_width, floor=1)
            if max(schedule) > bw:
                raise ValueError(
                    f"beam_schedule entries must be <= beam_width={bw}, "
                    f"got {schedule} (the frontier buffer is beam_width "
                    "wide; a hop cannot be wider than the buffer)")
        if bw < k:
            raise ValueError(
                f"beam_width must be an int >= k={k}, got {bw!r} "
                "(the final frontier is the result buffer: a beam narrower "
                "than k cannot hold k results)")
        mi = ((2 * bw + 8) // expand + 4 if self.max_iters is None
              else _as_int("max_iters", self.max_iters, floor=1))
        rerank_tile = _as_int("rerank_tile", self.rerank_tile, floor=1)
        source = self.rerank_source
        if source not in RERANK_SOURCES:
            raise ValueError(
                f"rerank_source must be one of {RERANK_SOURCES}, "
                f"got {source!r}")
        if not self.quantized:
            if source != "device":
                raise ValueError(
                    f"rerank_source={source!r} requires quantized=True: "
                    "the exact path scores device-resident rows directly "
                    "(there is no estimator to serve and no separate "
                    "rerank stage to redirect)")
            rerank = True
        else:
            rerank = bool(self.rerank)
            if source == "none":
                rerank = False
            elif not rerank:
                if source == "host":
                    raise ValueError(
                        "rerank_source='host' with rerank=False is "
                        "contradictory: the host tier exists to feed the "
                        "exact rerank — use rerank_source='none' for "
                        "code-only serving")
                source = "none"
        if index is not None:
            if self.quantized:
                check_quantized_backend(index)
            check_rows_tier(index, source)
        if not (self.quantized and rerank):
            rerank_tile = 512
        merge = self.merge
        if self.fusion != "none":
            if expand != 1:
                raise ValueError(
                    f"fusion={self.fusion!r} supports expand=1 only "
                    f"(got expand={expand}): the fused kernels expand one "
                    "frontier node per hop — use fusion='none' for "
                    "multi-expansion")
            merge = "topk"
        return ResolvedSearchSpec(
            k=k, beam_width=bw, max_iters=mi, expand=expand,
            quantized=bool(self.quantized), rerank=rerank,
            rerank_source=source,
            rerank_tile=rerank_tile, use_kernels=bool(self.use_kernels),
            merge=merge, traverse_deleted=bool(self.traverse_deleted),
            fusion=self.fusion, beam_schedule=schedule,
            telemetry=self.telemetry, filtered=filtered,
            filter_mode=filter_mode)

    # ------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return {"version": SPEC_VERSION, **asdict(self)}

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: dict) -> "SearchSpec":
        d = dict(d)
        version = d.pop("version", SPEC_VERSION)
        if version > SPEC_VERSION:
            raise ValueError(f"SearchSpec version {version} is newer than "
                             f"this build supports ({SPEC_VERSION})")
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown SearchSpec fields: {sorted(unknown)}")
        if d.get("beam_schedule") is not None:
            d["beam_schedule"] = tuple(d["beam_schedule"])
        filt = d.get("filter")
        if filt is not None and not isinstance(filt, numbers.Integral):
            d["filter"] = tuple(filt)
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "SearchSpec":
        return cls.from_dict(json.loads(s))

    def with_(self, **kw) -> "SearchSpec":
        """Functional update (specs are frozen)."""
        return replace(self, **kw)

    def filter_bytes(self) -> np.ndarray | None:
        """The runtime operand for `filter`: a uint8[N_LABEL_BYTES] byte
        mask (or None when unfiltered)."""
        if self.filter is None:
            return None
        labels = (self.filter,) if isinstance(
            self.filter, numbers.Integral) else tuple(self.filter)
        return filter_to_bytes(labels)


@dataclass(frozen=True)
class ResolvedSearchSpec:
    """Fully concrete, validated, normalised search configuration.
    `filtered` records filter presence only; the value is a runtime
    operand (`SearchSpec.filter_bytes()`)."""

    k: int
    beam_width: int
    max_iters: int
    expand: int
    quantized: bool
    rerank: bool
    rerank_source: str
    rerank_tile: int
    use_kernels: bool
    merge: str
    traverse_deleted: bool
    fusion: str
    beam_schedule: tuple | None
    telemetry: str
    filtered: bool
    filter_mode: str

    def to_spec(self) -> SearchSpec:
        """Back to declarative form (lossy for filtered specs)."""
        d = asdict(self)
        d.pop("filtered")
        d["filter"] = None
        d["filter_mode"] = "traverse"
        return SearchSpec(**d)


class SearchResult(NamedTuple):
    """One served search batch."""

    ids: Any        # (Q, k) int32, -1 padded, never tombstoned
    dists: Any      # (Q, k) f32
    n_hops: Any     # (Q,) int32 — greedy-walk hops per query
    generation: int
    telemetry: Any = None   # SearchTelemetry iff spec.telemetry == "on"
    estimated: bool = False  # True iff dists are estimator values


class Searcher:
    """A search session over one index: the spec is resolved (validated,
    defaults filled) once, at construction."""

    def __init__(self, index, spec: SearchSpec):
        self.index = index
        self.spec = spec
        self.resolved = spec.resolve(index)
        self._filter_bytes = spec.filter_bytes()

    def search(self, queries) -> SearchResult:
        """Synchronous search at the current generation."""
        idx = self.index
        out = idx._run_search(self.resolved, queries, self._filter_bytes)
        ids, dists, n_hops = out[:3]
        tel = out[3] if len(out) > 3 else None
        return SearchResult(ids=ids, dists=dists, n_hops=n_hops,
                            generation=idx.generation, telemetry=tel,
                            estimated=self.resolved.rerank_source == "none")


def measure_recall(index, queries, spec: SearchSpec) -> float:
    """Recall@k vs the index's own brute force (paper's Recall k@k), at the
    exact configuration described by `spec`."""
    gt, _ = index.brute_force(queries, spec.resolve(index).k)
    res = index.searcher(spec).search(queries)
    ids = np.asarray(res.ids.cpu())
    gt = np.asarray(gt.cpu())
    hits = (ids[:, :, None] == gt[:, None, :]) & (ids >= 0)[:, :, None]
    return float(np.mean(hits.any(axis=2).sum(axis=1) / gt.shape[1]))
