"""JasperIndex — thin host-side layer over one IndexCore (PyTorch port).

Port of `repro.core.index.JasperIndex`: bulk build, the mutation
lifecycle ("built for change": streaming insert with slot reuse and
auto-grow, tombstone delete, consolidate, grow), exact and
RaBitQ-quantized search through the session surface it inherits from
`SearchSurface` (`searcher(spec)` sessions over the index's `PlanCache`
of search plans, `recall`), brute force, the host rows tier
(`rows_tier="host"`, `evict_rows_to_host`, core/storage.py), the
deprecated PQ baseline (`quantization="pq"`, `search_pq`), memory and
storage statistics, and save/load in the JAX package's `.npz` +
`.meta.json` format (an index either package saved, on either tier, with
RaBitQ or PQ, loads in the other).

Search plans (core/plans.py) are captured CUDA graphs on the card's
megakernel lanes. So that a graph stays valid, mutations that keep the
buffers' shapes write into the core's existing buffers (`keep_buffers`),
and the core's `n_valid` and `medoid` reach a captured search through
device mirrors (`scalars`).

    build/insert -> LIVE -> delete (tombstone) -> consolidate (graph
    repair, slot freed) -> insert reuses the slot; capacity doubles by
    copy-extension when the tail runs out.

The index lives on the card unless `device="cpu"` is given; with no GPU
and no explicit CPU device the constructor raises.
"""

from __future__ import annotations

import json
import os
import warnings
from dataclasses import asdict

import numpy as np
import torch

from repro_torch.core.beam_search import beam_search, make_exact_scorer
from repro_torch.core.construction import ConstructionParams
from repro_torch.core.distances import mips_augment_query
from repro_torch.core.index_core import (
    IndexCore,
    attach_quantizer,
    core_brute_force,
    bitmap_test_np,
    core_build,
    core_consolidate,
    core_search,
    core_delete,
    core_encode_rows,
    core_from_arrays,
    core_grow,
    core_insert_at,
    core_live_mask,
    core_set_labels,
    core_size,
    core_take_free_slots,
    core_to_arrays,
    init_core,
    tombstoned_lookup,
)
from repro_torch.core.mutations import (MutationState, grow_rows,
                                        pack_label_rows)
from repro_torch.core.pq import PQParams, make_pq_scorer, pq_encode, pq_train
from repro_torch.core.rabitq import (
    RaBitQCodes,
    RaBitQParams,
    packed_bytes_per_vector,
    rabitq_train,
)
from repro_torch.core.plans import (DeviceScalars, HostRerankPlan,
                                    HostTierPlan, keep_buffers, make_plan,
                                    target_of)
from repro_torch.core.search_spec import PlanCache, SearchSpec, SearchSurface
from repro_torch.core.storage import (
    TIER_STAT_KEYS,
    VectorStore,
    rows_staged,
    tier_memory_stats,
)
from repro_torch.core.vamana import VamanaGraph
from repro_torch.device import resolve_device
from repro_torch.obs.tracing import span as obs_span


class JasperIndex(SearchSurface):
    """Updatable ANNS index (Vamana graph + optional RaBitQ) on one card."""

    def __init__(self, dims: int, capacity: int, *, metric: str = "l2",
                 quantization: str | None = None, bits: int = 4,
                 construction: ConstructionParams | None = None,
                 seed: int = 0, plan_cache_capacity: int | None = None,
                 rows_tier: str = "device", device=None):
        if metric not in ("l2", "mips"):
            raise ValueError(f"metric must be l2|mips, got {metric!r}")
        if quantization not in (None, "rabitq", "pq"):
            raise ValueError(
                "quantization must be None, 'rabitq', or 'pq' "
                "(explicit opt-in; PQ is deprecated)")
        if quantization == "pq":
            warnings.warn(
                "quantization='pq' is the paper's NEGATIVE result: the "
                "unpacked LUT-based PQ path scatters over memory and has no "
                "kernel backing. It is kept only as a comparison baseline — "
                "use quantization='rabitq' for the kernel-backed quantized "
                "search path.", DeprecationWarning, stacklevel=2)
        self.device = resolve_device(device)
        self.dims = dims
        self.metric = metric
        # MIPS reduces to L2 with one augmented dimension (paper §6.3)
        self.store_dims = dims + 1 if metric == "mips" else dims
        self.quantization = quantization
        self.bits = bits
        self.params = construction or ConstructionParams()
        self.seed = seed
        self._core: IndexCore = init_core(capacity, self.store_dims,
                                          self.params.degree_bound,
                                          self.device)
        # search plans keyed on (resolved spec, query shape, liveness
        # mode); sessions and the legacy calls share them.
        # plan_cache_capacity bounds the cache LRU-style (None = unbounded)
        self.plans = PlanCache(capacity=plan_cache_capacity)
        self._scalars: DeviceScalars | None = None
        self._mips_max_sqnorm: float | None = None
        # PQ is the deprecated comparison baseline: side tensors outside
        # the core (the kernels and the search plans only see RaBitQ)
        self.pq_params: PQParams | None = None
        self.pq_codes: torch.Tensor | None = None
        # the rows tier (core/storage.py): "device" keeps the f32 rows on
        # the core; "host" moves them to pinned host memory, so only the
        # packed codes stay on the card
        self.store = VectorStore(pin=self.device.type == "cuda")
        if rows_tier == "host":
            self.evict_rows_to_host()
        elif rows_tier != "device":
            raise ValueError(
                f"rows_tier must be device|host, got {rows_tier!r}")

    @property
    def core(self) -> IndexCore:
        return self._core

    @core.setter
    def core(self, new: IndexCore) -> None:
        """Install a mutated core, its shape-preserving buffers written into
        the current ones (see `keep_buffers`)."""
        self._core = keep_buffers(self._core, new)

    @property
    def scalars(self) -> DeviceScalars:
        """The device mirrors of the core's n_valid and medoid."""
        if self._scalars is None:
            self._scalars = DeviceScalars(self.device)
        return self._scalars

    # -------------------------------------------------------- core delegation
    @property
    def capacity(self) -> int:
        return self.core.capacity

    @property
    def vectors(self) -> torch.Tensor | None:
        return self.core.vectors

    @property
    def vec_sqnorm(self) -> torch.Tensor | None:
        return self.core.vec_sqnorm

    @property
    def graph(self) -> VamanaGraph:
        return self.core.graph

    @property
    def mut(self) -> MutationState:
        return self.core.mut

    @property
    def rabitq_codes(self) -> RaBitQCodes | None:
        return self.core.codes

    @property
    def rabitq_params(self) -> RaBitQParams | None:
        return self.core.rq_params

    # ---------------------------------------------------------- tiered rows
    @property
    def rows_tier(self) -> str:
        """Where the f32 rows live: "device" (core tensors) or "host"
        (evicted to `self.store`; traversal runs on packed codes only and
        the rerank fetches the frontier's rows from the host)."""
        return self.store.tier

    def evict_rows_to_host(self) -> "JasperIndex":
        """device -> host: move the f32 rows off the device, leaving only
        packed codes (+ graph/metadata) device-resident. Searches must
        then use `rerank_source="host"` (bit-identical) or "none";
        mutations keep working through write-through staging. The plans
        are dropped (with them the captured graphs that read the rows)."""
        if self.quantization != "rabitq":
            raise ValueError(
                "evict_rows_to_host requires quantization='rabitq': "
                "without device-resident packed codes there is nothing "
                "left to traverse on (an exact-only core cannot serve "
                "any search with its rows evicted)")
        self.core = self.store.evict(self.core)
        self.plans.clear()
        return self

    def restore_rows_to_device(self) -> "JasperIndex":
        """host -> device: re-attach the f32 rows as core tensors."""
        self.core = self.store.restore(self.core)
        self.plans.clear()
        return self

    @property
    def size(self) -> int:
        """Number of LIVE rows."""
        return core_size(self.core)

    @property
    def generation(self) -> int:
        """Monotonic mutation counter."""
        return self.core.mut.generation

    @property
    def n_deleted(self) -> int:
        """Tombstoned-but-not-yet-consolidated rows."""
        return self.core.mut.n_deleted

    @property
    def deleted_fraction(self) -> float:
        """Tombstone load factor — serving layers consolidate past a bound."""
        n = self.core.n_valid - self.core.mut.n_free
        return self.core.mut.n_deleted / n if n else 0.0

    def live_mask(self) -> np.ndarray:
        """bool[capacity] of currently live rows (host copy)."""
        return core_live_mask(self.core)

    def tombstoned(self, ids) -> np.ndarray:
        """Host-side per-id deadness test (serving-contract check): True
        where an id is tombstoned/freed or past the high-water mark."""
        return tombstoned_lookup(self.core.mut.tombstone_bits.cpu().numpy(),
                                 self.core.n_valid, ids)

    @property
    def _filter_tombstones(self) -> bool:
        """False while no bit can be set (nothing tombstoned or freed)."""
        return self.core.mut.n_deleted != 0 or self.core.mut.n_free != 0

    def _as_tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(x, dtype=np.float32),
                               device=self.device)

    def _prep_data(self, x) -> torch.Tensor:
        x = self._as_tensor(x)
        if self.metric == "mips":
            # a fixed global max-norm keeps streaming inserts consistent;
            # when a later batch RAISES it, every written row is
            # re-augmented in place (_reaugment_mips)
            sq = (x * x).sum(dim=-1)
            m2 = float(sq.max())
            if self._mips_max_sqnorm is None:
                self._mips_max_sqnorm = m2
            elif m2 > self._mips_max_sqnorm:
                old = self._mips_max_sqnorm
                self._mips_max_sqnorm = m2
                self._reaugment_mips(old, m2)
            extra = torch.sqrt(torch.clamp(self._mips_max_sqnorm - sq,
                                           min=0.0))
            x = torch.cat([x, extra[:, None]], dim=-1)
        return x

    def _reaugment_mips(self, old_m2: float, new_m2: float) -> None:
        """Re-augment all written rows, in place, after the global
        max-norm rose: e' = sqrt(e^2 + delta), |row'|^2 = |row|^2 + delta,
        codes re-encoded from the updated rows (the quantizer itself is
        untouched)."""
        core = self.core
        n = core.n_valid
        if n == 0:
            return
        delta = new_m2 - old_m2
        last = core.vectors[:n, -1]
        core.vectors[:n, -1] = torch.sqrt(last * last + delta)
        core.vec_sqnorm[:n] += delta
        core_encode_rows(core, torch.arange(n, device=self.device),
                         core.vectors[:n])
        self._pq_write(torch.arange(n, device=self.device), core.vectors[:n])

    def _prep_query(self, q) -> torch.Tensor:
        if self.device.type == "cuda" and not isinstance(q, torch.Tensor):
            # through pinned memory, without waiting for the stream: a
            # dispatch then never blocks on the searches in flight
            q = torch.from_numpy(np.ascontiguousarray(q, dtype=np.float32))
            q = q.pin_memory().to(self.device, non_blocking=True)
        q = self._as_tensor(q)
        if self.metric == "mips":
            q = mips_augment_query(q)
        return q

    def _ensure_quantizer(self, rows: torch.Tensor) -> None:
        """Lazy quantizer training on the first written batch."""
        if self.quantization == "rabitq" and self.core.rq_params is None:
            gen = torch.Generator().manual_seed(self.seed)
            self.core = attach_quantizer(
                self.core, rabitq_train(gen, rows, bits=self.bits))
        elif self.quantization == "pq" and self.pq_params is None:
            for nsub in (16, 8, 4, 2, 1):
                if self.store_dims % nsub == 0:
                    break
            gen = torch.Generator().manual_seed(self.seed)
            self.pq_params = pq_train(gen, rows, n_subspaces=nsub)
            self.pq_codes = torch.zeros(
                (self.capacity, self.pq_params.n_subspaces),
                dtype=torch.uint8, device=self.device)

    def _pq_write(self, ids, rows: torch.Tensor) -> None:
        if self.pq_codes is not None:
            ids = torch.as_tensor(ids, device=self.device).long()
            self.pq_codes[ids] = pq_encode(self.pq_params, rows)

    # ------------------------------------------------------------- build
    def build(self, data, *, labels=None, refine: bool = False,
              progress_fn=None) -> "JasperIndex":
        """Bulk construction over `data` (rows 0..N). Resets the graph and
        all mutation state. `labels`: optional per-row label ids (scalar
        or per-row sets) for filtered search."""
        with obs_span("index.build", n=int(np.shape(data)[0]),
                      sharded=False), rows_staged(self):
            x = self._prep_data(data)
            self._ensure_quantizer(x)
            self.core = core_build(self.core, x, params=self.params,
                                   refine=refine, progress_fn=progress_fn)
            if labels is not None:
                self.set_labels(np.arange(x.shape[0], dtype=np.int32),
                                labels)
            self._pq_write(torch.arange(x.shape[0], device=self.device), x)
        return self

    def _grow_to_fit(self, n_rows: int) -> None:
        """Double capacity until n_rows fit (no-op when they already do)."""
        if n_rows <= self.capacity:
            return
        new_cap = self.capacity
        while n_rows > new_cap:
            new_cap *= 2
        self.grow(new_cap)

    def _allocate_slots(self, b: int) -> np.ndarray:
        """Claim b slot ids: freed slots first (ascending), then fresh tail
        ids past the high-water mark; the capacity auto-doubles when the
        tail runs out. Popped slots' tombstone bits are cleared."""
        self.core, reused = core_take_free_slots(self.core, b)
        fresh_needed = b - reused.size
        hw = self.core.n_valid
        self._grow_to_fit(hw + fresh_needed)
        fresh = np.arange(hw, hw + fresh_needed, dtype=np.int32)
        return np.concatenate([reused, fresh])

    def insert(self, data, *, labels=None) -> np.ndarray:
        """Streaming batch insertion ("built for change").

        Freed slots are reused before the tail advances; the index grows
        by buffer doubling if the batch would overflow capacity. Returns
        the assigned row ids, int32[B] (the ids searches will report).
        `labels`: optional label ids for the batch (scalar = every row, or
        one entry/set per row), set with the rows.
        """
        if np.shape(data)[0] == 0:       # empty tick from a stream: no-op
            return np.empty((0,), np.int32)
        with rows_staged(self):
            x = self._prep_data(data)
            b = x.shape[0]
            if self.size == 0:
                # empty index (fresh, or everything was deleted): a clean
                # build over this batch beats stitching onto a dead graph
                self._grow_to_fit(b)
                self._ensure_quantizer(x)
                self.core = core_build(self.core, x, params=self.params)
                ids = np.arange(b, dtype=np.int32)
            else:
                ids = self._allocate_slots(b)
                self.core = core_insert_at(
                    self.core, torch.as_tensor(ids, device=self.device), x,
                    params=self.params)
            if labels is not None:
                self.set_labels(ids, labels)
            self._pq_write(ids, x)
        return ids

    def set_labels(self, ids, labels) -> None:
        """Assign per-row label bitsets (filtered search)."""
        ids = np.atleast_1d(np.asarray(ids)).astype(np.int32).ravel()
        self.core = core_set_labels(self.core, ids,
                                    pack_label_rows(labels, ids.size))

    # ------------------------------------------------------ delete/repair
    def delete(self, ids) -> int:
        """Batched tombstone delete. Returns the number of rows deleted.

        No graph work: rows are tombstoned in the packed bitmap, stay
        traversable but are never returned by any search; `consolidate()`
        later repairs the graph and recycles the slots. Raises on ids that
        are not currently live (checked against a host copy of the packed
        bytes; the bitmap never unpacks on this path).
        """
        ids_np = np.atleast_1d(np.asarray(ids)).astype(np.int64).ravel()
        if ids_np.size == 0:
            return 0
        hw = self.core.n_valid
        bad = ids_np[(ids_np < 0) | (ids_np >= hw)]
        if bad.size:
            raise ValueError(f"ids out of range [0, {hw}): {bad[:8].tolist()}")
        bits = self.core.mut.tombstone_bits.cpu().numpy()
        dead = ids_np[bitmap_test_np(bits, ids_np)]
        if dead.size:
            raise ValueError(
                f"ids already deleted or freed: {dead[:8].tolist()}")
        self.core, n = core_delete(self.core,
                                   torch.as_tensor(ids_np, device=self.device))
        return n

    def consolidate(self, *, refine: bool = True) -> dict:
        """Batched graph repair over neighbourhoods touched by deleted rows.

        refine=True (default) re-links every touched row by snapshot beam
        search against the tombstoned graph; refine=False does the cheaper
        one-hop local repair. Deleted rows then lose their adjacency, their
        slots join the free pool, and the medoid refreshes over live rows.
        Returns {"n_freed", "n_repaired"}.
        """
        with rows_staged(self):
            self.core, stats = core_consolidate(self.core,
                                                params=self.params,
                                                refine=refine)
        return stats

    def grow(self, new_capacity: int | None = None) -> "JasperIndex":
        """Grow capacity by copy-extension (default: doubling). Nothing
        re-encodes: the resident prefix of every buffer is byte-identical
        after the grow."""
        new_cap = new_capacity or 2 * self.capacity
        if new_cap < self.capacity:
            raise ValueError(f"cannot shrink {self.capacity} -> {new_cap}")
        if new_cap == self.capacity:
            return self
        with rows_staged(self):
            self.core = core_grow(self.core, new_cap)
            if self.pq_codes is not None:
                self.pq_codes = grow_rows(self.pq_codes, new_cap, 0)
        return self

    # ------------------------------------------------------------ search
    # searcher()/recall() come from SearchSurface
    def _sync_mirrors(self, core: IndexCore) -> None:
        """Bring the device mirrors up to `core`'s scalars (a plan, before
        a replay)."""
        self.scalars.sync(core)

    def _plan_search(self, core: IndexCore, queries, rspec, filt: bool,
                     filter_bytes, *, mirrors: bool) -> tuple:
        """What a plan runs: `core_search` on `core`, reading n_valid and
        medoid through the device mirrors when `mirrors` (a captured
        plan)."""
        if mirrors:
            core = self.scalars.view(core)
        return core_search(core, queries, spec=rspec, filter_tombstones=filt,
                           filter_bytes=filter_bytes)

    def _search_plan(self, rspec, q_shape, filt: bool):
        """Plan-cache lookup/build: `(queries, filter_bytes) -> (ids,
        dists, n_hops[, telemetry])`. The filter value is a run-time
        operand: the key carries only its presence (in `rspec.filtered`),
        so every filter value shares one plan."""
        q_shape = tuple(q_shape)
        plan = self.plans.get(("search", rspec, q_shape, filt),
                              lambda: make_plan(target_of(self), rspec,
                                                q_shape, filt))
        if rspec.rerank_source == "host":
            # two-stage host-tier plan: the traversal above returns the
            # full-width estimator frontier, then the frontier's rows are
            # fetched from the host tier and reranked by a separately
            # keyed plan (core/storage.py, core/plans.py)
            rerank = self.plans.get(
                ("rerank_host", rspec, q_shape),
                lambda: HostRerankPlan(rspec, store=self.store,
                                       on_trace=self.plans.count_trace))
            return HostTierPlan(plan, rerank)
        return plan

    def search(self, queries, k: int = 10, *, beam_width: int | None = None,
               max_iters: int | None = None, expand: int = 1,
               use_kernels: bool = False, merge: str = "topk",
               traverse_deleted: bool = True):
        """Exact-distance beam search; returns (ids (Q,k), dists (Q,k))."""
        res = self.searcher(SearchSpec(
            k=k, beam_width=beam_width, max_iters=max_iters, expand=expand,
            use_kernels=use_kernels, merge=merge,
            traverse_deleted=traverse_deleted)).search(queries)
        return res.ids, res.dists

    def search_rabitq(self, queries, k: int = 10, *,
                      beam_width: int | None = None,
                      max_iters: int | None = None, rerank: bool = True,
                      expand: int = 1, use_kernels: bool = False,
                      merge: str = "topk", traverse_deleted: bool = True):
        """RaBitQ estimated-distance beam search (the paper's §5.1 path)."""
        if self.core.codes is None:
            raise RuntimeError("index was not built with quantization='rabitq'")
        res = self.searcher(SearchSpec(
            k=k, beam_width=beam_width, max_iters=max_iters, expand=expand,
            quantized=True, rerank=rerank, use_kernels=use_kernels,
            merge=merge, traverse_deleted=traverse_deleted)).search(queries)
        return res.ids, res.dists

    def search_pq(self, queries, k: int = 10, *,
                  beam_width: int | None = None,
                  max_iters: int | None = None, rerank: bool = True,
                  expand: int = 1, merge: str = "topk",
                  traverse_deleted: bool = True):
        """PQ LUT-based beam search — DEPRECATED comparison baseline.

        The paper's negative result (§5, Fig 12): scattered 256-entry
        table lookups, no kernel of its own, kept only so benchmarks can
        reproduce the comparison. Needs the explicit quantization='pq'
        opt-in. Not a core op or a SearchSpec mode: it runs eagerly, with
        no plan. rerank: exact distances of the final frontier from the
        rows, then a stable sort.
        """
        if self.pq_codes is None:
            raise RuntimeError("index was not built with quantization='pq'")
        warnings.warn(
            "search_pq is deprecated (the paper's negative-result baseline); "
            "use quantization='rabitq' with searcher(SearchSpec(quantized="
            "True)) for the kernel-backed quantized path.",
            DeprecationWarning, stacklevel=2)
        # defaults resolve through the one definition site (SearchSpec)
        rspec = SearchSpec(
            k=k, beam_width=beam_width, max_iters=max_iters, expand=expand,
            merge=merge, traverse_deleted=traverse_deleted).resolve()
        q = self._prep_query(queries)
        core = self.core
        tomb = core.mut.tombstone_bits if self._filter_tombstones else None
        res = beam_search(core.graph, make_pq_scorer(self.pq_params,
                                                     self.pq_codes, q),
                          q.shape[0], beam_width=rspec.beam_width,
                          max_iters=rspec.max_iters, expand_per_iter=expand,
                          merge_strategy=merge, tombstone_bits=tomb,
                          traverse_deleted=traverse_deleted)
        f_ids, f_dists = res.frontier_ids, res.frontier_dists
        if rerank:
            exact = make_exact_scorer(core.vectors, q, core.n_valid,
                                      core.vec_sqnorm)(f_ids)
            exact = torch.where(f_ids >= 0, exact,
                                torch.full_like(exact, float("inf")))
            f_dists, order = torch.sort(exact, dim=1, stable=True)
            f_ids = torch.gather(f_ids, 1, order)
        return f_ids[:, :k], f_dists[:, :k]

    def brute_force(self, queries, k: int = 10):
        """Exact top-k by full scan over LIVE rows (recall ground truth);
        on the host tier over the staged rows."""
        q = self._prep_query(queries)
        with rows_staged(self):
            out = core_brute_force(self.core, q, k=k)
            if self.device.type == "cuda":
                torch.cuda.current_stream().synchronize()  # before detach
        return out

    # ------------------------------------------------------------ memory
    def memory_stats(self) -> dict[str, float]:
        full = self.store_dims * 4
        mut = self.core.mut
        stats = {
            "vector_bytes_per_row": float(full),
            "graph_bytes_per_row": float(self.params.degree_bound * 4),
            "tombstone_bitmap_bytes": float(mut.tombstone_bits.numel()),
            "free_pool_bytes": float(mut.free_ids.numel() * 4),
        }
        if self.quantization == "rabitq":
            stats["rabitq_bytes_per_row"] = float(
                packed_bytes_per_vector(self.store_dims, self.bits))
            stats["compression_ratio"] = full / stats["rabitq_bytes_per_row"]
            c = self.core.codes
            if c is not None:
                resident = sum(t.numel() * t.element_size()
                               for t in (c.packed, c.data_add,
                                         c.data_rescale))
                stats["rabitq_resident_bytes"] = float(resident)
                stats["rabitq_resident_bytes_per_row"] = (
                    resident / self.capacity)
        stats.update(tier_memory_stats(
            self.core, self.store, capacity=self.capacity,
            store_dims=self.store_dims))
        return stats

    def storage_stats(self) -> dict:
        """Tier residence + host-fetch counters for the `storage.*`
        metrics namespace (obs/metrics.py `storage_stats_collector`)."""
        ms = self.memory_stats()
        out = {k: ms[k] for k in TIER_STAT_KEYS if k in ms}
        out.update({f"fetch_{k}": v
                    for k, v in self.store.fetch_stats.as_dict().items()})
        return out

    # --------------------------------------------------------- save/load
    def _meta(self) -> dict:
        return {
            "dims": self.dims, "metric": self.metric,
            "capacity": self.capacity,
            "quantization": self.quantization, "bits": self.bits,
            "seed": self.seed, "construction": asdict(self.params),
            "mips_max_sqnorm": self._mips_max_sqnorm,
            "rows_tier": self.rows_tier,
        }

    def save(self, path: str) -> None:
        """Atomic checkpoint (tmp + rename) in the JAX package's format.
        Host-tier rows stage back in, so the payload keeps the one form
        both packages read; the meta records the tier and load re-evicts."""
        with rows_staged(self):
            arrays = core_to_arrays(self.core)
        if self.pq_codes is not None:
            arrays |= {
                "pq_codes": self.pq_codes.cpu().numpy(),
                "pq_codebooks": self.pq_params.codebooks.cpu().numpy(),
            }
        save_npz_atomic(path, arrays, self._meta())

    @classmethod
    def load(cls, path: str, device=None) -> "JasperIndex":
        """Load a checkpoint either package saved, onto `device`, on the
        rows tier it was saved from."""
        with open(path + ".meta.json") as f:
            meta = json.load(f)
        with warnings.catch_warnings():
            # loading a PQ checkpoint does not re-fire the opt-in warning
            warnings.simplefilter("ignore", DeprecationWarning)
            idx = cls(meta["dims"], meta["capacity"], metric=meta["metric"],
                      quantization=meta["quantization"], bits=meta["bits"],
                      construction=ConstructionParams(**meta["construction"]),
                      seed=meta["seed"], device=device)
        idx._mips_max_sqnorm = meta["mips_max_sqnorm"]
        with np.load(path) as data:
            idx.core = core_from_arrays(
                data, bits=meta["bits"], store_dims=idx.store_dims,
                quantized=meta["quantization"] == "rabitq",
                device=idx.device)
            if meta["quantization"] == "pq" and "pq_codes" in data:
                idx.pq_params = PQParams(codebooks=torch.from_numpy(
                    np.array(data["pq_codebooks"])).to(idx.device))
                idx.pq_codes = torch.from_numpy(
                    np.array(data["pq_codes"])).to(idx.device)
        if meta.get("rows_tier", "device") == "host":
            idx.evict_rows_to_host()    # the checkpoint's tier
        return idx


def save_npz_atomic(path: str, arrays: dict, meta: dict) -> None:
    """Atomic .npz + .meta.json checkpoint write (tmp + rename)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)
