"""IndexCore — the state of one Jasper index and the ops over it.

Port of `repro.core.index_core`. One capacity-allocated frozen dataclass
of tensors holds everything a search needs — f32 rows, packed RaBitQ
codes, adjacency, tombstone bitmap, label plane, medoid — and plain
functions operate on it: `core_build`, `core_bootstrap` (the sharded
build's base case), `core_search`, `core_brute_force` and the mutation
lifecycle `core_insert_at`, `core_delete`, `core_consolidate`,
`core_take_free_slots`, `core_grow`. Rows, codes and
adjacency are written in place; `core_grow` allocates the larger buffers
and copies the resident prefix. `JasperIndex` is a thin host-side layer
over one core.

`core_to_arrays` / `core_from_arrays` are the `.npz` checkpoint form,
with the same keys and dtypes as the JAX package's, so an index either
package saved loads in the other.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.beam_search import (
    beam_search,
    beam_search_quantized,
    make_exact_scorer,
    rerank_frontier,
    sort_frontier,
)
from repro_torch.core.construction import (
    ConstructionParams,
    batch_insert_at,
    bootstrap_graph,
    build_graph,
)
from repro_torch.core.mutations import (
    N_LABEL_BYTES,
    MutationState,
    consolidate as consolidate_graph,
    delete_rows,
    grow_rows,
    grow_state,
    init_mutation_state,
    take_free_slots,
    unpack_bitmap,
)
from repro_torch.core.rabitq import (
    RaBitQCodes,
    RaBitQParams,
    pack_codes,
    packed_dim,
    rabitq_encode,
    rabitq_preprocess_query,
)
from repro_torch.core.vamana import VamanaGraph
from repro_torch.device import resolve_device

_INF = float("inf")

# rows encoded per batch on a write: bounds the encoder's (chunk, D) temps
_ENCODE_CHUNK = 65536


@dataclass(frozen=True)
class IndexCore:
    """One index's complete state.

    vectors:    f32[cap, D]|None full-precision rows (rerank / exact path);
                                 None with the rows on the host tier
    vec_sqnorm: f32[cap]|None    cached |row|^2 (None with the rows)
    adjacency:  int32[cap, R]    Vamana out-edges, -1 padded
    n_valid:    int              high-water mark (prefix of written rows)
    medoid:     int              search/construction entry point
    mut:        MutationState    tombstone bitmap + label plane + free pool
    codes:      RaBitQCodes|None packed quantized rows
    rq_params:  RaBitQParams|None dataset-level quantizer
    """

    vectors: torch.Tensor | None
    vec_sqnorm: torch.Tensor | None
    adjacency: torch.Tensor
    n_valid: int
    medoid: int
    mut: MutationState
    codes: RaBitQCodes | None
    rq_params: RaBitQParams | None

    @property
    def capacity(self) -> int:
        return self.adjacency.shape[0]

    @property
    def store_dims(self) -> int:
        if self.vectors is None:        # rows evicted to the host tier
            return self.codes.dims
        return self.vectors.shape[1]

    @property
    def degree_bound(self) -> int:
        return self.adjacency.shape[1]

    @property
    def device(self) -> torch.device:
        return self.adjacency.device

    @property
    def graph(self) -> VamanaGraph:
        return VamanaGraph(adjacency=self.adjacency, n_valid=self.n_valid,
                           medoid=self.medoid)


def init_core(capacity: int, store_dims: int, degree_bound: int,
              device=None) -> IndexCore:
    """Empty core on `device` (the card unless "cpu" is given)."""
    dev = resolve_device(device)
    return IndexCore(
        vectors=torch.zeros((capacity, store_dims), dtype=torch.float32,
                            device=dev),
        vec_sqnorm=torch.zeros((capacity,), dtype=torch.float32, device=dev),
        adjacency=torch.full((capacity, degree_bound), -1, dtype=torch.int32,
                             device=dev),
        n_valid=0, medoid=0, mut=init_mutation_state(capacity, dev),
        codes=None, rq_params=None)


def with_graph(core: IndexCore, graph: VamanaGraph) -> IndexCore:
    return replace(core, adjacency=graph.adjacency, n_valid=graph.n_valid,
                   medoid=graph.medoid)


def attach_quantizer(core: IndexCore, params: RaBitQParams) -> IndexCore:
    """Install a trained quantizer + capacity-allocated packed buffers."""
    cap = core.capacity
    dev = core.device
    codes = RaBitQCodes(
        packed=torch.zeros((cap, packed_dim(core.store_dims, params.bits)),
                           dtype=torch.uint8, device=dev),
        data_add=torch.zeros((cap,), dtype=torch.float32, device=dev),
        data_rescale=torch.zeros((cap,), dtype=torch.float32, device=dev),
        bits=params.bits, dims=core.store_dims)
    return replace(core, codes=codes, rq_params=params)


def core_write_rows(core: IndexCore, ids: torch.Tensor,
                    rows: torch.Tensor) -> IndexCore:
    """Write vector rows (+ encode into the packed code buffer).

    Rows are written into the core's buffers in place (the JAX version's
    `.at[ids].set` returns new arrays; at a million rows a copy of every
    buffer per write buys nothing).
    """
    ids = ids.to(device=core.device, dtype=torch.long)
    rows = rows.to(device=core.device, dtype=torch.float32)
    core.vectors[ids] = rows
    core.vec_sqnorm[ids] = (rows * rows).sum(dim=-1)
    core_encode_rows(core, ids, rows)
    return core


def core_encode_rows(core: IndexCore, ids: torch.Tensor,
                     rows: torch.Tensor) -> None:
    """Encode `rows` into the packed code buffer at `ids`, in place
    (no-op without a quantizer)."""
    codes = core.codes
    if codes is None:
        return
    for s in range(0, rows.shape[0], _ENCODE_CHUNK):
        enc = rabitq_encode(core.rq_params, rows[s:s + _ENCODE_CHUNK])
        sl = ids[s:s + _ENCODE_CHUNK]
        codes.packed[sl] = enc.packed
        codes.data_add[sl] = enc.data_add
        codes.data_rescale[sl] = enc.data_rescale


def core_set_labels(core: IndexCore, ids, label_rows) -> IndexCore:
    """Write per-row label bitsets (uint8[B, N_LABEL_BYTES]) for `ids`,
    in place."""
    ids = torch.as_tensor(np.asarray(ids), dtype=torch.long,
                          device=core.device)
    core.mut.labels[ids] = torch.as_tensor(np.asarray(label_rows),
                                           dtype=torch.uint8,
                                           device=core.device)
    return core


def core_insert_at(core: IndexCore, ids: torch.Tensor, rows: torch.Tensor,
                   *, params: ConstructionParams) -> IndexCore:
    """Write + graph-link a batch of (already slot-allocated) rows.

    ids need not be contiguous (`JasperIndex.insert` reuses freed
    slots). n_valid advances to the high-water mark; the generation
    counter bumps once.
    """
    ids = ids.to(device=core.device, dtype=torch.int32)
    core = core_write_rows(core, ids, rows)
    graph = batch_insert_at(core.vectors, core.graph, ids, params=params,
                            vec_sqnorm=core.vec_sqnorm,
                            tombstone_bits=core.mut.tombstone_bits)
    core = with_graph(core, graph)
    return replace(core, mut=replace(core.mut,
                                     generation=core.mut.generation + 1))


def core_bootstrap(core: IndexCore, rows: torch.Tensor, *, n0: int,
                   params: ConstructionParams) -> IndexCore:
    """All-pairs bootstrap over the first n0 rows (the empty-core base
    case of the sharded build): write rows 0..n0, then `bootstrap_graph`.
    The generation is left as it is, as in the JAX version."""
    core = core_write_rows(
        core, torch.arange(n0, dtype=torch.int32, device=core.device), rows)
    return with_graph(core, bootstrap_graph(core.vectors, core.graph, n0=n0,
                                            params=params))


def core_build(core: IndexCore, data: torch.Tensor, *,
               params: ConstructionParams, refine: bool = False,
               progress_fn=None) -> IndexCore:
    """Bulk construction: reset mutation state, write rows 0..N, bootstrap
    + prefix-doubling batch insertion."""
    n = data.shape[0]
    if n > core.capacity:
        raise ValueError(f"data size {n} exceeds capacity {core.capacity}")
    core = replace(core, mut=replace(
        init_mutation_state(core.capacity, core.device),
        generation=core.mut.generation + 1))
    core = core_write_rows(
        core, torch.arange(n, device=core.device), data)
    graph = build_graph(core.vectors, n, params=params, refine=refine,
                        progress_fn=progress_fn)
    return with_graph(core, graph)


def core_search(core: IndexCore, queries: torch.Tensor, *, spec,
                filter_tombstones: bool = True,
                filter_bytes: torch.Tensor | None = None) -> tuple:
    """The search path — exact and quantized, kernel and plain.

    spec: a `ResolvedSearchSpec`. queries are already metric-prepped.
    Returns (ids (Q,k), dists (Q,k), n_hops (Q,)) — plus a
    `SearchTelemetry` with spec.telemetry == "on".

    spec.fusion == "megakernel": the whole beam search in one launch of
    the CUDA `fused_search` kernel (plain version on CPU tensors); then,
    quantized, the exact rerank through `gather_l2` (use_kernels) and a
    stable sort. fusion == "hop": one `fused_hop` launch a hop behind a
    host convergence check. fusion == "none": the unfused loop, scoring
    through the `rabitq_search_step` / `gather_l2` kernels when
    spec.use_kernels. rerank_source == "host" (quantized): the full-width
    estimator frontier, for the host tier's rerank outside (the core's
    rows may be evicted).

    filter_bytes: the uint8[4] filter value, as numpy or as a tensor (a
    device tensor is used as it is, so a captured plan reads its static
    buffer). `core.n_valid` and `core.medoid` may be 0-d int32 device
    tensors in place of ints (a captured plan's mirrors).
    """
    k = spec.k
    tomb = core.mut.tombstone_bits if filter_tombstones else None
    graph = core.graph
    tel_on = spec.telemetry == "on"
    filtered = spec.filtered
    if filtered != (filter_bytes is not None):
        raise ValueError(
            "spec.filtered and the filter_bytes operand must agree: "
            f"filtered={filtered}, filter_bytes "
            f"{'present' if filter_bytes is not None else 'absent'}")
    labels = core.mut.labels if filtered else None
    fb = None
    if filtered:
        fb = (filter_bytes.to(device=core.device, dtype=torch.uint8)
              if isinstance(filter_bytes, torch.Tensor) else
              torch.as_tensor(np.asarray(filter_bytes), dtype=torch.uint8,
                              device=core.device))
    filter_exclude = filtered and spec.filter_mode == "exclude"

    def _out(ids, dists, res):
        if tel_on:
            return ids, dists, res.n_hops, res.telemetry
        return ids, dists, res.n_hops

    def _rerank(res):
        exact_d = rerank_frontier(core.vectors, core.vec_sqnorm, queries,
                                  res.frontier_ids, tile_q=spec.rerank_tile,
                                  use_kernels=spec.use_kernels)
        return _out(*sort_frontier(exact_d, res.frontier_ids, k), res)

    if spec.fusion != "none":
        from repro_torch.kernels.search_step.ops import fused_beam_search
        if spec.quantized:
            if core.codes is None:
                raise ValueError("core has no quantized codes")
            rq = rabitq_preprocess_query(core.rq_params, queries)
            res = fused_beam_search(
                graph, mode=spec.fusion, beam_width=spec.beam_width,
                max_iters=spec.max_iters, beam_schedule=spec.beam_schedule,
                codes=core.codes, rq_query=rq, tombstone_bits=tomb,
                traverse_deleted=spec.traverse_deleted,
                labels=labels, filter_bytes=fb,
                filter_exclude=filter_exclude, telemetry=tel_on)
            if spec.rerank_source == "host":
                # host-tier rerank: core.vectors may be evicted (None), so
                # hand the index the full-width estimator frontier; the
                # gather + exact rerank run outside (core/storage.py)
                return _out(res.frontier_ids, res.frontier_dists, res)
            if spec.rerank:
                return _rerank(res)
        else:
            res = fused_beam_search(
                graph, mode=spec.fusion, beam_width=spec.beam_width,
                max_iters=spec.max_iters, beam_schedule=spec.beam_schedule,
                queries=queries, vectors=core.vectors,
                vec_sqnorm=core.vec_sqnorm, tombstone_bits=tomb,
                traverse_deleted=spec.traverse_deleted,
                labels=labels, filter_bytes=fb,
                filter_exclude=filter_exclude, telemetry=tel_on)
        return _out(res.frontier_ids[:, :k], res.frontier_dists[:, :k], res)
    if spec.quantized:
        if core.codes is None:
            raise ValueError("core has no quantized codes")
        rq = rabitq_preprocess_query(core.rq_params, queries)
        res = beam_search_quantized(
            graph, core.codes, rq, beam_width=spec.beam_width,
            max_iters=spec.max_iters, expand_per_iter=spec.expand,
            use_kernels=spec.use_kernels, merge_strategy=spec.merge,
            tombstone_bits=tomb, traverse_deleted=spec.traverse_deleted,
            labels=labels, filter_bytes=fb, filter_exclude=filter_exclude,
            beam_schedule=spec.beam_schedule, telemetry=tel_on)
        if spec.rerank_source == "host":
            # the full-width frontier for the host rerank (see above)
            return _out(res.frontier_ids, res.frontier_dists, res)
        if spec.rerank:
            return _rerank(res)
    else:
        if spec.use_kernels:
            from repro_torch.kernels.distance.ops import make_kernel_scorer
            score = make_kernel_scorer(
                core.vectors, queries, graph.n_valid, core.vec_sqnorm,
                tombstone_bits=(None if spec.traverse_deleted else tomb),
                labels=(labels if filter_exclude else None),
                filter_bytes=(fb if filter_exclude else None))
        else:
            score = make_exact_scorer(core.vectors, queries, graph.n_valid,
                                      core.vec_sqnorm)
        res = beam_search(graph, score, queries.shape[0],
                          beam_width=spec.beam_width,
                          max_iters=spec.max_iters,
                          expand_per_iter=spec.expand,
                          merge_strategy=spec.merge,
                          tombstone_bits=tomb,
                          traverse_deleted=spec.traverse_deleted,
                          labels=labels, filter_bytes=fb,
                          filter_exclude=filter_exclude,
                          beam_schedule=spec.beam_schedule,
                          telemetry=tel_on)
    return _out(res.frontier_ids[:, :k], res.frontier_dists[:, :k], res)


def core_brute_force(core: IndexCore, queries: torch.Tensor, *, k: int,
                     chunk: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k full scan over LIVE rows (recall ground truth), `chunk`
    queries at a time so the (chunk, capacity) distance block stays
    bounded. Ties between equal distances may order differently from the
    JAX version's `lax.top_k`."""
    from repro_torch.core.distances import pairwise_l2_squared
    cap = core.capacity
    mask = ((torch.arange(cap, device=core.device) < core.n_valid)
            & ~unpack_bitmap(core.mut.tombstone_bits, cap))
    ids_out, d_out = [], []
    for s in range(0, queries.shape[0], chunk):
        d = pairwise_l2_squared(queries[s:s + chunk], core.vectors,
                                core.vec_sqnorm)
        d = torch.where(mask[None, :], d, torch.full_like(d, _INF))
        dists, ids = torch.topk(d, k, dim=1, largest=False, sorted=True)
        ids_out.append(ids.to(torch.int32))
        d_out.append(dists)
    if not ids_out:
        return (torch.empty((0, k), dtype=torch.int32, device=core.device),
                torch.empty((0, k), dtype=torch.float32, device=core.device))
    return torch.cat(ids_out), torch.cat(d_out)


def core_delete(core: IndexCore, ids: torch.Tensor
                ) -> tuple[IndexCore, int]:
    """Tombstone a batch of row ids (-1 = ignored). No graph work."""
    mut, n_new = delete_rows(core.mut, ids, core.n_valid)
    return replace(core, mut=mut), n_new


def core_consolidate(core: IndexCore, *, params: ConstructionParams,
                     refine: bool = True) -> tuple[IndexCore, dict]:
    """Graph repair around tombstoned rows; frees their slots."""
    graph, mut, stats = consolidate_graph(
        core.vectors, core.graph, core.mut, params=params, refine=refine,
        vec_sqnorm=core.vec_sqnorm)
    return replace(with_graph(core, graph), mut=mut), stats


def core_take_free_slots(core: IndexCore, want: int
                         ) -> tuple[IndexCore, np.ndarray]:
    """Pop up to `want` reusable slots (ascending host ids)."""
    mut, taken = take_free_slots(core.mut, want)
    return replace(core, mut=mut), taken


def core_grow(core: IndexCore, new_capacity: int) -> IndexCore:
    """Copy-extend every buffer to a larger capacity. Nothing re-encodes:
    all tensors are capacity-major, so the resident prefix (packed codes
    included) is byte-identical after the grow."""
    if new_capacity == core.capacity:
        return core
    codes = core.codes
    if codes is not None:
        codes = RaBitQCodes(
            packed=grow_rows(codes.packed, new_capacity, 0),
            data_add=grow_rows(codes.data_add, new_capacity, 0.0),
            data_rescale=grow_rows(codes.data_rescale, new_capacity, 0.0),
            bits=codes.bits, dims=codes.dims)
    return replace(
        core,
        vectors=grow_rows(core.vectors, new_capacity, 0.0),
        vec_sqnorm=grow_rows(core.vec_sqnorm, new_capacity, 0.0),
        adjacency=grow_rows(core.adjacency, new_capacity, -1),
        mut=grow_state(core.mut, new_capacity),
        codes=codes)


def core_size(core: IndexCore) -> int:
    """Number of LIVE rows (high-water mark minus tombstoned/freed)."""
    return core.n_valid - core.mut.n_deleted - core.mut.n_free


def core_live_mask(core: IndexCore) -> np.ndarray:
    """bool[capacity] of currently live rows (host copy)."""
    dense = unpack_bitmap(core.mut.tombstone_bits, core.capacity).cpu()
    return (np.arange(core.capacity) < core.n_valid) & ~dense.numpy()


def core_live_locals(core: IndexCore) -> np.ndarray:
    """Ascending local ids of the live rows (host copy)."""
    return np.where(core_live_mask(core))[0].astype(np.int64)


def bitmap_test_np(tombstone_bits: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Host-side per-id bit test over the PACKED bytes. Out-of-domain ids
    (the -1 sentinel, ids past the bitmap) read as NOT SET."""
    ids = np.asarray(ids)
    bits = np.asarray(tombstone_bits)
    n_bits = bits.size * 8
    in_domain = (ids >= 0) & (ids < n_bits)
    safe = np.clip(ids, 0, max(n_bits - 1, 0))
    return (((bits[safe >> 3] >> (safe & 7)) & 1) == 1) & in_domain


def tombstoned_lookup(tombstone_bits: np.ndarray, n_valid: int,
                      ids: np.ndarray) -> np.ndarray:
    """Host-side per-id deadness test: True where an id is tombstoned or
    freed, past the high-water mark, or not a real row at all (negative
    sentinel). The bitmap never unpacks densely."""
    ids = np.asarray(ids)
    return bitmap_test_np(tombstone_bits, ids) | (ids >= n_valid) | (ids < 0)


# ---------------------------------------------------------------------------
# Checkpoint form — the same array dict as the JAX package
# ---------------------------------------------------------------------------

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def core_to_arrays(core: IndexCore) -> dict[str, np.ndarray]:
    """The canonical .npz payload (same keys and dtypes as
    `repro.core.index_core.core_to_arrays`)."""
    arrays = {
        "vectors": _np(core.vectors),
        "adjacency": _np(core.adjacency),
        "n_valid": np.asarray(core.n_valid, np.int32),
        "medoid": np.asarray(core.medoid, np.int32),
        "tombstone_bits": _np(core.mut.tombstone_bits),
        "labels": _np(core.mut.labels),
        "free_ids": _np(core.mut.free_ids),
        "n_free": np.asarray(core.mut.n_free, np.int32),
        "n_deleted": np.asarray(core.mut.n_deleted, np.int32),
        "generation": np.asarray(core.mut.generation, np.int32),
    }
    if core.codes is not None:
        arrays |= {
            "rq_packed": _np(core.codes.packed),
            "rq_add": _np(core.codes.data_add),
            "rq_rescale": _np(core.codes.data_rescale),
            "rq_rotation": _np(core.rq_params.rotation),
            "rq_centroid": _np(core.rq_params.centroid),
        }
    return arrays


def core_from_arrays(data: Mapping, *, bits: int, store_dims: int,
                     quantized: bool, device=None) -> IndexCore:
    """Inverse of core_to_arrays, onto `device` (the card unless "cpu" is
    given). Accepts the legacy unpacked `rq_codes` key and checkpoints
    without a label plane or without mutation state."""
    dev = resolve_device(device)

    def t(key):
        return torch.from_numpy(np.array(data[key])).to(dev)

    vectors = t("vectors").to(torch.float32)
    if "tombstone_bits" in data:
        mut = MutationState(
            tombstone_bits=t("tombstone_bits"),
            # pre-label-plane checkpoints: all-zero rows (match no filter)
            labels=(t("labels") if "labels" in data
                    else torch.zeros((vectors.shape[0], N_LABEL_BYTES),
                                     dtype=torch.uint8, device=dev)),
            free_ids=t("free_ids"),
            n_free=int(np.asarray(data["n_free"])),
            n_deleted=int(np.asarray(data["n_deleted"])),
            generation=int(np.asarray(data["generation"])))
    else:   # pre-mutation-engine checkpoint: everything is prefix-live
        mut = init_mutation_state(vectors.shape[0], dev)
    codes = rq_params = None
    has_codes = "rq_packed" in data or "rq_codes" in data
    if quantized and has_codes:
        rq_params = RaBitQParams(rotation=t("rq_rotation"),
                                 centroid=t("rq_centroid"), bits=bits)
        if "rq_packed" in data:
            packed = t("rq_packed")
        else:   # legacy checkpoint with unpacked uint8[N, D] codes
            packed = pack_codes(t("rq_codes"), bits)
        codes = RaBitQCodes(packed=packed, data_add=t("rq_add"),
                            data_rescale=t("rq_rescale"), bits=bits,
                            dims=store_dims)
    return IndexCore(
        vectors=vectors,
        vec_sqnorm=(vectors * vectors).sum(dim=-1),
        adjacency=t("adjacency"),
        n_valid=int(np.asarray(data["n_valid"])),
        medoid=int(np.asarray(data["medoid"])),
        mut=mut, codes=codes, rq_params=rq_params)
