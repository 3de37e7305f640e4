"""ShardedJasperIndex — the IndexCore driver over row shards (port of
`repro.core.distributed`, the same names and API).

There is one index implementation, the core ops of `core.index_core`.
An S-shard index is S independent cores plus a k-way merge, and every
op of this driver is the single-device one run a shard at a time:
`core_search`, `core_bootstrap`, `core_insert_at`, `core_delete`,
`core_consolidate`. No search or insert logic lives here.

Layout (the JAX package's stacked form, a mesh position at a time):

  * database rows are dealt to shards; each shard owns an INDEPENDENT
    core (graph edges never cross shards). The mesh's positions
    (launch/mesh.py) hold them: a mesh of one device has one position
    holding all S shards, a mesh over a list of devices a position an
    entry, and position (r, m) holds a replica of row shard r (r the
    row-major index over the row axes, as JAX's `_shard_index` computes
    it) and searches query slice m (its index along the query axis; with
    no query axis, every replica searches all queries — replicas along an
    axis that neither shards rows nor splits queries are kept equal and
    not searched). A position keeps its shards' capacity-major buffers
    stacked, each one tensor on its device — rows (S'*cap, D), packed
    RaBitQ codes (S'*cap, P), adjacency (S'*cap, R), the tombstone bitmap
    (S'*cap/8,) — and `shard_core(s)` is an IndexCore of zero-copy slices
    of them with shard s's host scalars, which the index keeps once a
    shard. A shard op runs on each replica's slices, as JAX's shard_map
    runs it on each device that holds the shard (O(batch) a replica, no
    copy between replicas), so the buffers keep their addresses and a
    captured search plan stays valid;
  * `rq_params` (rotation/centroid) is dataset-level state, shared (a
    copy a device);
  * search: each position's `core_search` of each of its shards (the
    fused kernels over its packed codes, its tombstone bits, its exact
    rerank), on the position's device and its current stream, for its
    query slice -> local top-k -> gathered onto the home device (the mesh's
    first position's) in shard order, the query slices concatenated ->
    global ids -> `merge_topk`, hierarchical over the row axes.

One process drives every position, as JAX's single controller does:
"the merge as a collective" is here the gather of each position's (Q_m,
k) ids and dists onto the home device, then the same merge. Adjacency
entries and free pools hold SHARD-LOCAL ids; global ids are `shard *
id_stride + local`, int32, with `id_stride` FIXED at construction
(default 4x the initial per-shard capacity), so ids handed to clients
survive a grow. Growing past the stride raises.

Search plans come from core/plans.py with this driver's `_plan_search`:
on the card a megakernel-lane search of a one-position mesh over all S
shards and the merge is ONE captured CUDA graph (each shard reads its
n_valid/medoid through its own device mirrors); a mesh of several
positions captures one graph a position (`PositionsPlan`); other lanes
and the CPU run eager plans.
"""

from __future__ import annotations

import json
from contextlib import contextmanager
from dataclasses import asdict, dataclass, replace
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.core.construction import ConstructionParams
from repro_torch.core.distances import mips_augment_query, pairwise_l2_squared
from repro_torch.core.index_core import (
    IndexCore,
    attach_quantizer,
    bitmap_test_np,
    core_bootstrap,
    core_consolidate,
    core_delete,
    core_encode_rows,
    core_from_arrays,
    core_insert_at,
    core_live_locals,
    core_search,
    core_set_labels,
    core_take_free_slots,
    core_to_arrays,
    init_core,
)
from repro_torch.core.index import save_npz_atomic
from repro_torch.core.mutations import (N_LABEL_BYTES, MutationState,
                                        pack_bitmap, pack_label_rows,
                                        unpack_bitmap)
from repro_torch.core.plans import (DeviceScalars, HostTierPlan,
                                    PlanTarget, PositionsPlan,
                                    ShardedRerankPlan, keep_buffers,
                                    make_plan, target_of)
from repro_torch.core.rabitq import RaBitQCodes, RaBitQParams, rabitq_train
from repro_torch.core.resharding import (IdTranslation, pow2_rung,
                                         rebalance_plan, reshard_cores)
from repro_torch.core.search_spec import PlanCache, SearchSpec, SearchSurface
from repro_torch.core.storage import (VectorStore, rows_resident,
                                      strip_rows, tier_memory_stats)
from repro_torch.device import on_device
from repro_torch.obs.tracing import span as obs_span

_INF = float("inf")

# distances held at once by brute_force: query chunks of this many
# (query, row) pairs (4 GiB of float32)
_BRUTE_FORCE_PAIRS = 1 << 30

# the per-shard host scalars, kept once a shard by the index
_SCALARS = ("n_valid", "medoid", "n_free", "n_deleted", "generation")


def _pow2_pad_pairs(ids: np.ndarray, rows: torch.Tensor
                    ) -> tuple[np.ndarray, torch.Tensor]:
    """Pad an (ids, rows) insert batch to a power-of-two rung by repeating
    the first pair, as the JAX package does (the duplicate takes part in
    the batch's link exactly as it does there)."""
    extra = pow2_rung(ids.size) - ids.size
    return (np.concatenate([ids, np.repeat(ids[:1], extra)]),
            torch.cat([rows, rows[:1].expand(extra, -1)]))


@dataclass(frozen=True)
class ShardSpec:
    """Static sharding geometry.

    row_axes:   mesh axes that shard database rows (e.g. ("pod", "data"))
    query_axis: mesh axis that shards the query batch (e.g. "model"); a
                search's query count must be divisible by its size
    """

    row_axes: tuple[str, ...] = ("data",)
    query_axis: str | None = "model"


def merge_topk(gids: torch.Tensor, dists: torch.Tensor, axis_sizes,
               k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Hierarchical shard merge of per-shard top-k lists.

    gids, dists: (S, Q, kk), S stacked row-major over the row axes, whose
    sizes `axis_sizes` gives in order. One row axis at a time, leading
    first, each query's candidates are laid out (axis index)-major — as
    the JAX package's all_gather + moveaxis + reshape leave them — and
    the k smallest kept by a stable sort: among equal distances the lower
    position first, `lax.top_k`'s order. Returns (ids (Q, k), dists (Q,
    k)); empty slots keep +inf and id -1.
    """
    sizes = tuple(int(a) for a in axis_sizes)
    q_n, kk = gids.shape[1], gids.shape[2]
    d = dists.reshape(sizes + (q_n, kk))
    i = gids.reshape(sizes + (q_n, kk))
    for _ in sizes:
        d = torch.movedim(d, 0, -2)
        i = torch.movedim(i, 0, -2)
        d = d.reshape(d.shape[:-2] + (-1,))
        i = i.reshape(i.shape[:-2] + (-1,))
        d, order = torch.sort(d, dim=-1, stable=True)
        d, order = d[..., :k], order[..., :k]
        i = torch.gather(i, -1, order)
    return i, d


def _lowest_topk(d: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries of each row of d, ascending, ties to the
    lower position (`lax.top_k(-d, k)`'s order): (positions, values)."""
    vals, pos = torch.topk(d, k, dim=1, largest=False, sorted=True)
    thr = vals[:, -1:]
    tie = torch.nonzero((d == thr).sum(1) > (vals == thr).sum(1)).flatten()
    if tie.numel():
        # the cut falls inside a run of equal values: take its lowest
        # positions (rows of d in pieces, to bound the cumsum)
        for s in range(0, tie.numel(), 64):
            rows = tie[s:s + 64]
            dt, tt = d[rows], thr[rows]
            lt, eq = dt < tt, dt == tt
            need = k - lt.sum(1, keepdim=True)
            sel = lt | (eq & (eq.cumsum(1) <= need))
            p = torch.nonzero(sel)[:, 1].reshape(-1, k)
            pos[rows] = p
            vals[rows] = torch.gather(dt, 1, p)
    pos, order = torch.sort(pos, dim=1)
    vals = torch.gather(vals, 1, order)
    vals, order = torch.sort(vals, dim=1, stable=True)
    return torch.gather(pos, 1, order), vals


def _shard_of(core: IndexCore, s: int, cap: int) -> IndexCore:
    """Shard s of a stacked core: zero-copy slices + its host scalars."""
    rows = slice(s * cap, (s + 1) * cap)
    bits = slice(s * (cap // 8), (s + 1) * (cap // 8))

    def r(t):
        return None if t is None else t[rows]

    codes = None
    if core.codes is not None:
        c = core.codes
        codes = RaBitQCodes(packed=c.packed[rows], data_add=c.data_add[rows],
                            data_rescale=c.data_rescale[rows], bits=c.bits,
                            dims=c.dims)
    m = core.mut
    return IndexCore(
        vectors=r(core.vectors), vec_sqnorm=r(core.vec_sqnorm),
        adjacency=core.adjacency[rows], n_valid=int(core.n_valid[s]),
        medoid=int(core.medoid[s]),
        mut=MutationState(tombstone_bits=m.tombstone_bits[bits],
                          labels=m.labels[rows], free_ids=m.free_ids[rows],
                          n_free=int(m.n_free[s]),
                          n_deleted=int(m.n_deleted[s]),
                          generation=int(m.generation[s])),
        codes=codes, rq_params=core.rq_params)


def _row_tensors(core: IndexCore) -> list:
    """A core's capacity-major tensors (None where absent), in one order:
    what a shard op writes and what a shard's slices are."""
    codes = core.codes
    return [core.vectors, core.vec_sqnorm, core.adjacency,
            core.mut.tombstone_bits, core.mut.labels, core.mut.free_ids,
            *((codes.packed, codes.data_add, codes.data_rescale)
              if codes is not None else (None,) * 3)]


def _stacked_like(core: IndexCore, n: int, device,
                  rq: RaBitQParams | None) -> IndexCore:
    """An uninitialised stacked core of n shards shaped as `core` (a
    shard), on `device`, with no host scalars: `_place_cores` fills it."""

    def e(t):
        return None if t is None else torch.empty(
            (n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
            device=device)

    c = core.codes
    codes = None if c is None else RaBitQCodes(
        packed=e(c.packed), data_add=e(c.data_add),
        data_rescale=e(c.data_rescale), bits=c.bits, dims=c.dims)
    m = core.mut
    return IndexCore(
        vectors=e(core.vectors), vec_sqnorm=e(core.vec_sqnorm),
        adjacency=e(core.adjacency), n_valid=None, medoid=None,
        mut=MutationState(tombstone_bits=e(m.tombstone_bits),
                          labels=e(m.labels), free_ids=e(m.free_ids),
                          n_free=None, n_deleted=None, generation=None),
        codes=codes, rq_params=rq)


def _bare(core: IndexCore) -> IndexCore:
    """A position's stored core: its buffers, no host scalars (the index
    keeps those once a shard)."""
    return replace(core, n_valid=None, medoid=None,
                   mut=replace(core.mut, n_free=None, n_deleted=None,
                               generation=None))


def _rq_on(rq: RaBitQParams | None, device) -> RaBitQParams | None:
    if rq is None or rq.rotation.device == torch.device(device):
        return rq
    return replace(rq, rotation=rq.rotation.to(device),
                   centroid=rq.centroid.to(device))


def _sync_devices(devices) -> None:
    """Wait for the current stream of every card among `devices`."""
    for dev in {d for d in devices if d.type == "cuda"}:
        torch.cuda.current_stream(dev).synchronize()


class _Position:
    """One mesh position: its device, the row shards it holds (consecutive;
    stacked in `core`'s buffers), the query slice it searches (of
    `n_slices`), whether it searches, and its shards' device mirrors."""

    def __init__(self, device: torch.device, shards: range,
                 query_slice: int, n_slices: int, searches: bool) -> None:
        self.device = device
        self.shards = shards
        self.query_slice = query_slice
        self.n_slices = n_slices
        self.searches = searches
        self.core: IndexCore | None = None
        self.mirrors: list[DeviceScalars] | None = None


class ShardedJasperIndex(SearchSurface):
    """Row-sharded Jasper index: the IndexCore driver over S shards on the
    mesh's positions."""

    def __init__(self, mesh, dims: int, capacity_per_shard: int, *,
                 spec: ShardSpec | None = None, metric: str = "l2",
                 construction: ConstructionParams | None = None,
                 quantization: str | None = None, bits: int = 4,
                 seed: int = 0, id_stride: int | None = None,
                 plan_cache_capacity: int | None = None,
                 rows_tier: str = "device"):
        """id_stride: global ids are shard*id_stride + local, fixed for the
        index's lifetime (default 4x capacity_per_shard) — capacity can
        grow up to the stride without invalidating outstanding ids."""
        self._configure(mesh, dims, capacity_per_shard, spec=spec,
                        metric=metric, construction=construction,
                        quantization=quantization, bits=bits, seed=seed,
                        id_stride=id_stride,
                        plan_cache_capacity=plan_cache_capacity)
        for p in self._positions:
            p.core = _bare(init_core(len(p.shards) * self.cap,
                                     self.store_dims,
                                     self.params.degree_bound, p.device))
        if rows_tier == "host":
            self.evict_rows_to_host()
        elif rows_tier != "device":
            raise ValueError(
                f"rows_tier must be device|host, got {rows_tier!r}")

    def _configure(self, mesh, dims: int, capacity_per_shard: int, *,
                   spec, metric, construction, quantization, bits, seed,
                   id_stride, plan_cache_capacity) -> None:
        """Everything but the positions' buffers (`__init__` allocates
        them empty; `load` deals a checkpoint's shards into them)."""
        if metric not in ("l2", "mips"):
            raise ValueError(f"metric must be l2|mips, got {metric!r}")
        if quantization not in (None, "rabitq"):
            raise ValueError(
                "sharded quantization must be None or 'rabitq' "
                "(PQ is a deprecated single-device comparison baseline)")
        if capacity_per_shard % 8:
            raise ValueError(
                "capacity_per_shard must be a multiple of 8 so per-shard "
                f"tombstone bitmaps stack cleanly, got {capacity_per_shard}")
        self.id_stride = id_stride or 4 * capacity_per_shard
        if self.id_stride < capacity_per_shard:
            raise ValueError(
                f"id_stride {self.id_stride} < capacity_per_shard "
                f"{capacity_per_shard}")
        self.mesh = mesh
        self.device = mesh.device       # home: queries in, the merge
        self.spec = spec or ShardSpec(
            row_axes=tuple(a for a in mesh.axis_names if a != "model")
            or (mesh.axis_names[0],),
        )
        if (self.spec.query_axis is not None
                and self.spec.query_axis not in mesh.axis_names):
            # replicated queries on meshes without a model axis
            self.spec = ShardSpec(self.spec.row_axes, None)
        self.dims = dims
        self.metric = metric
        # MIPS reduces to L2 with one augmented dimension (paper §6.3),
        # against the GLOBAL max-norm, so every shard augments against the
        # same bound
        self.store_dims = dims + 1 if metric == "mips" else dims
        self._mips_max_sqnorm: float | None = None
        self.cap = capacity_per_shard
        self.params = construction or ConstructionParams()
        self.quantization = quantization
        self.bits = bits
        self.seed = seed
        self.axis_sizes = tuple(mesh.shape[ax] for ax in self.spec.row_axes)
        self.n_shards = int(np.prod(self.axis_sizes))

        self._positions = self._layout()
        self._owners = [next(p for p in self._positions if s in p.shards)
                        for s in range(self.n_shards)]
        z = np.zeros((self.n_shards,), np.int64)
        self._sc = {name: z.copy() for name in _SCALARS}
        # search plans + the mutation steps (insert/boot/delete), keyed as
        # the JAX package keys them; Searcher sessions share it
        self.plans = PlanCache(capacity=plan_cache_capacity)
        # old->new IdTranslation of the last shard-count-changing load
        self.reshard_translation = None
        # the rows tier (core/storage.py): host rows are the stacked
        # (S*cap, D) tensor, once a shard, so a frontier row is at
        # shard*cap + local
        self.store = VectorStore(pin=self.device.type == "cuda")

    # ------------------------------------------------------- the positions
    def _layout(self) -> list[_Position]:
        """The mesh's positions: one holding every shard on a mesh of one
        device; else one a device, (r, m) as the module docstring says."""
        mesh, spec = self.mesh, self.spec
        qa = spec.query_axis
        n_slices = mesh.shape[qa] if qa is not None else 1
        if len(mesh.devices) == 1:
            return [_Position(mesh.devices[0], range(self.n_shards), 0, 1,
                              True)]
        out = []
        for i, dev in enumerate(mesh.devices):
            c = mesh.coords(i)
            r = 0
            for ax in spec.row_axes:
                r = r * mesh.shape[ax] + c[ax]
            others = [a for a in mesh.axis_names
                      if a not in spec.row_axes and a != qa]
            out.append(_Position(dev, range(r, r + 1),
                                 c[qa] if qa is not None else 0, n_slices,
                                 all(c[a] == 0 for a in others)))
        return out

    @property
    def multi_position(self) -> bool:
        """Whether the shards lie on several mesh positions."""
        return len(self._positions) > 1

    @property
    def n_positions(self) -> int:
        return len(self._positions)

    def position_devices(self) -> list[torch.device]:
        """Each position's device, in mesh order."""
        return [p.device for p in self._positions]

    def searching_positions(self) -> list[_Position]:
        """The positions that search, in mesh order."""
        return [p for p in self._positions if p.searches]

    def slice_shape(self, p: _Position, q_shape: tuple) -> tuple:
        """The shape of position p's slice of a query batch."""
        return (q_shape[0] // p.n_slices,) + tuple(q_shape[1:])

    def query_slice(self, p: _Position, queries: torch.Tensor
                    ) -> torch.Tensor:
        """Position p's slice of the queries, on its device."""
        n = queries.shape[0] // p.n_slices
        m = p.query_slice
        return queries[m * n:(m + 1) * n].to(p.device)

    def position_target(self, p: _Position, on_trace) -> PlanTarget:
        """What a plan of position p searches (core/plans.py): its stacked
        core, on its device, each of its shards' `core_search`
        (`_shard_searches`), its mirrors; `on_trace` counts its traces."""
        return PlanTarget(
            p.device, lambda: self._pos_core(p),
            lambda core, queries, rspec, filt, fb, *, mirrors:
                self._shard_searches(p, core, queries, rspec, filt, fb,
                                     mirrors=mirrors),
            lambda core: self._sync_position_mirrors(p, core), on_trace)

    def _pos_core(self, p: _Position) -> IndexCore:
        sl = slice(p.shards.start, p.shards.stop)
        sc = {k: v[sl].copy() for k, v in self._sc.items()}
        return replace(p.core, n_valid=sc["n_valid"], medoid=sc["medoid"],
                       mut=replace(p.core.mut, n_free=sc["n_free"],
                                   n_deleted=sc["n_deleted"],
                                   generation=sc["generation"]))

    def _set_pos(self, p: _Position, core: IndexCore) -> None:
        """Install a position's core: buffers kept where shapes allow
        (`keep_buffers`), its scalar vectors into the index's."""
        p.core = _bare(keep_buffers(self._pos_core(p), core))
        sl = slice(p.shards.start, p.shards.stop)
        self._sc["n_valid"][sl] = core.n_valid
        self._sc["medoid"][sl] = core.medoid
        for name in ("n_free", "n_deleted", "generation"):
            self._sc[name][sl] = getattr(core.mut, name)

    def _owner_positions(self) -> list[_Position]:
        """One replica of every shard, in shard order."""
        out, s = [], 0
        while s < self.n_shards:
            out.append(self._owners[s])
            s = self._owners[s].shards.stop
        return out

    def _replicas(self, s: int) -> list[_Position]:
        return [p for p in self._positions if s in p.shards]

    def _shard_device(self, s: int) -> torch.device:
        return self._owners[s].device

    # ------------------------------------------------------------ the core
    @property
    def core(self) -> IndexCore:
        """The stacked core of a one-position mesh: (S*cap, ...) buffers,
        (S,) host scalars. A mesh of several positions has none: its
        shards are `shard_core(s)` and `shard_replicas(s)`."""
        self._one_position("core")
        return self._pos_core(self._positions[0])

    @core.setter
    def core(self, new: IndexCore) -> None:
        """Install a stacked core, its shape-preserving buffers written
        into the current ones (`keep_buffers`)."""
        self._one_position("core")
        self._set_pos(self._positions[0], new)

    def _one_position(self, what: str) -> None:
        if self.multi_position:
            raise RuntimeError(
                f"{what}: the shards of this index lie on "
                f"{self.n_positions} mesh positions, with no one stacked "
                "core (shard_core(s) and shard_replicas(s) give its shards)")

    def shard_core(self, s: int) -> IndexCore:
        """Shard s as a plain (local-id) IndexCore of zero-copy slices of
        its first replica's stacked buffers — the unit of every shard op
        and of checkpoint I/O."""
        p = self._owners[s]
        return _shard_of(self._pos_core(p), s - p.shards.start, self.cap)

    def shard_replicas(self, s: int) -> list[IndexCore]:
        """Shard s as each position that holds it holds it: zero-copy
        views, in mesh order (the first is `shard_core(s)`'s)."""
        return [_shard_of(self._pos_core(p), s - p.shards.start, self.cap)
                for p in self._replicas(s)]

    def _view(self, p: _Position, s: int) -> IndexCore:
        """Shard s as position p holds it: zero-copy slices of p's
        buffers, shard s's host scalars."""
        return _shard_of(self._pos_core(p), s - p.shards.start, self.cap)

    def _apply(self, s: int, op):
        """Shard s's core op run on each of its replicas, as JAX's
        shard_map runs it on each device that holds the shard: `op(view)`
        takes a replica's zero-copy view (on that replica's device) and
        returns (the shard's new core, a result). Each replica's core is
        installed in its own slices (`_install`), the scalars once, after
        every replica ran on the same ones. Returns the first replica's
        result."""
        first = None
        for p in self._replicas(s):
            core, res = op(self._view(p, s))
            self._install(p, s, core)
            if first is None:
                first = (core, res)
        core, res = first
        self._sc["n_valid"][s] = int(core.n_valid)
        self._sc["medoid"][s] = int(core.medoid)
        for name in ("n_free", "n_deleted", "generation"):
            self._sc[name][s] = int(getattr(core.mut, name))
        return res

    def _install(self, p: _Position, s: int, local: IndexCore) -> None:
        """Shard s's new core written into position p's slices of it,
        where the op did not already write in place."""
        for a, b in zip(_row_tensors(self._view(p, s)), _row_tensors(local)):
            if a is None or b is None:
                if (a is None) != (b is None):
                    raise ValueError("a shard op changed the core's "
                                     "structure")
                continue
            if a.shape != b.shape:
                raise ValueError(f"a shard op changed a buffer's shape "
                                 f"{tuple(a.shape)} -> {tuple(b.shape)}")
            if a.data_ptr() != b.data_ptr():
                a.copy_(b)

    def _place_cores(self, read) -> None:
        """Deal S per-shard (local-id) cores onto the positions: shard s's
        core `read(s)` (on any device — the host for a load onto several
        positions) is read once and copied into its slices of every
        position that holds it, whose stacked buffers are allocated on its
        device at its first shard (`_stacked_like`); `rq_params` a copy a
        device. No position holds more than its own shards' buffers."""
        rq: dict = {}
        for s in range(self.n_shards):
            local = read(s)
            for p in self._replicas(s):
                if s == p.shards.start:
                    key = str(p.device)
                    if key not in rq:
                        rq[key] = _rq_on(local.rq_params, p.device)
                    p.core = _stacked_like(local, len(p.shards), p.device,
                                           rq[key])
                i = s - p.shards.start
                for a, b in zip(_row_tensors(p.core), _row_tensors(local)):
                    if a is not None:
                        n = a.shape[0] // len(p.shards)
                        a[i * n:(i + 1) * n].copy_(b)
            self._sc["n_valid"][s] = int(local.n_valid)
            self._sc["medoid"][s] = int(local.medoid)
            for name in ("n_free", "n_deleted", "generation"):
                self._sc[name][s] = int(getattr(local.mut, name))
        _sync_devices(self.position_devices())

    # ---------------------------------------------------------- tiered rows
    @property
    def rows_tier(self) -> str:
        """Where the f32 rows live ("device" | "host")."""
        return self.store.tier

    def evict_rows_to_host(self) -> "ShardedJasperIndex":
        """device -> host across every shard: packed codes, graph and
        metadata stay on the positions' devices; the f32 rows move to one
        stacked host tensor, once a shard (pinned on the card). The plans
        are dropped."""
        if self.quantization != "rabitq":
            raise ValueError(
                "evict_rows_to_host requires quantization='rabitq': "
                "without device-resident packed codes there is nothing "
                "left to traverse on (an exact-only core cannot serve "
                "any search with its rows evicted)")
        self.store.hold(*(p.core for p in self._owner_positions()))
        for p in self._positions:
            p.core = strip_rows(p.core)
        self.plans.clear()
        return self

    def restore_rows_to_device(self) -> "ShardedJasperIndex":
        """host -> device: re-attach the stacked rows to every position."""
        if self.store.tier != "host":
            raise ValueError("rows are already device-resident")
        self._attach_rows()
        _sync_devices(self.position_devices())
        self.store.release()
        self.plans.clear()
        return self

    def _attach_rows(self) -> None:
        for p in self._positions:
            p.core = self.store.attach(p.core, at=p.shards.start * self.cap)

    @contextmanager
    def _staged(self):
        """Write-through staging for mutations on the host tier
        (`storage.rows_staged` for every position): the host rows attached
        to each position's core, the mutation runs the unchanged core
        ops, then the host tier is synced from the result and the rows
        stripped off again. Re-entrant."""
        if (self.store.tier != "host"
                or rows_resident(self._positions[0].core)):
            yield
            return
        self._attach_rows()
        try:
            yield
        finally:
            self.store.sync_from(*(p.core for p in self._owner_positions()))
            for p in self._positions:
                p.core = strip_rows(p.core)

    # ----------------------------------------------------------------- util
    @property
    def size(self) -> int:
        sc = self._sc
        return int(sc["n_valid"].sum() - sc["n_deleted"].sum()
                   - sc["n_free"].sum())

    @property
    def capacity(self) -> int:
        """Total row capacity across shards."""
        return self.n_shards * self.cap

    @property
    def generation(self) -> int:
        """Sum of the per-shard generation counters."""
        return int(self._sc["generation"].sum())

    @property
    def n_deleted(self) -> int:
        return int(self._sc["n_deleted"].sum())

    @property
    def deleted_fraction(self) -> float:
        n = int(self._sc["n_valid"].sum()) - int(self._sc["n_free"].sum())
        return self.n_deleted / n if n else 0.0

    @property
    def _filter_tombstones(self) -> bool:
        return self.n_deleted != 0 or int(self._sc["n_free"].sum()) != 0

    def shard_live_counts(self) -> np.ndarray:
        """int64[S] live rows per shard (skewed deletes drift these apart;
        `rebalance` levels them)."""
        sc = self._sc
        return (sc["n_valid"] - sc["n_deleted"] - sc["n_free"]).astype(
            np.int64)

    @property
    def shard_imbalance(self) -> float:
        """(max - min) / mean of the per-shard live counts (0.0 = level)."""
        c = self.shard_live_counts()
        m = float(c.mean())
        return float(c.max() - c.min()) / m if m > 0 else 0.0

    def global_row(self, shard: int, local_id: int) -> int:
        return shard * self.id_stride + local_id

    def tombstoned(self, ids) -> np.ndarray:
        """Host-side deadness test for GLOBAL ids (the serving-contract
        check): the bit at shard*cap + local of the stacked bitmap, or
        an id whose local part is past its shard's capacity or
        high-water mark."""
        ids = np.asarray(ids)
        shard, local = ids // self.id_stride, ids % self.id_stride
        in_cap = local < self.cap
        bit_pos = shard * self.cap + np.minimum(local, self.cap - 1)
        bits = torch.cat([p.core.mut.tombstone_bits.cpu()
                          for p in self._owner_positions()])
        dead = bitmap_test_np(bits.numpy(), bit_pos)
        n_valid = self._sc["n_valid"]
        return dead | ~in_cap | (local >= n_valid[shard])

    def label_rows(self, ids) -> np.ndarray:
        """uint8[len(ids), NB] label rows of GLOBAL ids (each read from
        its shard's first replica; ids out of range clamp into it)."""
        ids = np.asarray(ids, np.int64).ravel()
        pos = np.clip((ids // self.id_stride) * self.cap
                      + ids % self.id_stride, 0, self.capacity - 1)
        shard, local = pos // self.cap, pos % self.cap
        out = np.zeros((ids.size, N_LABEL_BYTES), np.uint8)
        for s in np.unique(shard):
            out[shard == s] = self.shard_core(int(s)).mut.labels[
                torch.as_tensor(local[shard == s],
                                device=self._shard_device(int(s)))
            ].cpu().numpy()
        return out

    def _as_tensor(self, x) -> torch.Tensor:
        """x as float32 on the home device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(x, dtype=np.float32),
                               device=self.device)

    def _rows_tensor(self, x) -> torch.Tensor:
        """Rows to build or insert, as float32: on the home device on a
        one-position mesh (every shard lives there); on a mesh of several
        positions where they lie — a tensor stays on its device, an array
        becomes a host tensor — so each shard's rows go straight to its
        own positions and the home device never holds the whole batch."""
        if not self.multi_position:
            return self._as_tensor(x)
        if isinstance(x, torch.Tensor):
            return x.to(torch.float32)
        return torch.as_tensor(np.asarray(x, dtype=np.float32))

    # ----------------------------------------------------------------- mips
    def _prep_data(self, x) -> torch.Tensor:
        """Metric prep BEFORE rows deal to shards: for MIPS, augment
        against the GLOBAL max-norm of everything inserted so far; a batch
        that raises it re-augments every written row of every shard."""
        x = self._rows_tensor(x)
        if self.metric != "mips":
            return x
        sq = (x * x).sum(dim=-1)
        m2 = float(sq.max())
        if self._mips_max_sqnorm is None:
            self._mips_max_sqnorm = m2
        elif m2 > self._mips_max_sqnorm:
            old = self._mips_max_sqnorm
            self._mips_max_sqnorm = m2
            self._reaugment_mips(old, m2)
        extra = torch.sqrt(torch.clamp(self._mips_max_sqnorm - sq, min=0.0))
        return torch.cat([x, extra[..., None]], dim=-1)

    def _reaugment_mips(self, old_m2: float, new_m2: float) -> None:
        """Re-augment every written row of every shard, in place on each
        replica: e' = sqrt(e^2 + delta), |row'|^2 = |row|^2 + delta, codes
        re-encoded (the quantizer itself is untouched)."""
        delta = new_m2 - old_m2
        for s in range(self.n_shards):
            n = int(self._sc["n_valid"][s])
            if n == 0:
                continue
            for p in self._replicas(s):
                c = p.core
                lo = (s - p.shards.start) * self.cap
                last = c.vectors[lo:lo + n, -1]
                c.vectors[lo:lo + n, -1] = torch.sqrt(last * last + delta)
                c.vec_sqnorm[lo:lo + n] += delta
                core_encode_rows(c, torch.arange(lo, lo + n,
                                                 device=p.device),
                                 c.vectors[lo:lo + n])

    def _prep_query(self, q) -> torch.Tensor:
        if self.device.type == "cuda" and not isinstance(q, torch.Tensor):
            q = torch.from_numpy(np.ascontiguousarray(q, dtype=np.float32))
            q = q.pin_memory().to(self.device, non_blocking=True)
        q = self._as_tensor(q)
        if self.metric == "mips":
            q = mips_augment_query(q)
        return q

    # --------------------------------------------------------- build/insert
    def _ensure_quantizer(self, rows: torch.Tensor) -> None:
        """Train the quantizer on the first build's rows, where they lie
        (the home device on a one-position mesh; see `_rows_tensor`), and
        attach it, a copy a device, to every position."""
        if (self.quantization == "rabitq"
                and self._positions[0].core.rq_params is None):
            gen = torch.Generator().manual_seed(self.seed)
            rq = rabitq_train(gen, rows, bits=self.bits)
            on: dict = {}
            for p in self._positions:
                key = str(p.device)
                if key not in on:
                    on[key] = _rq_on(rq, p.device)
                self._set_pos(p, attach_quantizer(self._pos_core(p),
                                                  on[key]))
            self.plans.clear()          # core structure changed

    def build(self, data, *, labels=None) -> "ShardedJasperIndex":
        """Bulk build. data: (N, D) with N divisible by n_shards — shard s
        owns data[s*per:(s+1)*per]. labels: optional per-row label sets
        (see `set_labels`), in the same dealt order."""
        with obs_span("index.build", n=int(np.shape(data)[0]),
                      sharded=True), self._staged():
            self._build_impl(data)
            if labels is not None:
                n = int(np.shape(data)[0])
                per = n // self.n_shards
                gids = (np.arange(self.n_shards)[:, None] * self.id_stride
                        + np.arange(per)[None, :]).astype(np.int64)
                self.set_labels(gids.reshape(-1), labels)
        return self

    def _build_impl(self, data) -> None:
        data = self._prep_data(data)
        n = data.shape[0]
        if n % self.n_shards:
            raise ValueError(f"N={n} not divisible by n_shards={self.n_shards}")
        per = n // self.n_shards
        if per > self.cap:
            raise ValueError(f"{per} rows/shard exceed capacity {self.cap}")
        self._ensure_quantizer(data)
        # reset graph + mutation state (generation keeps advancing), keep
        # the trained quantizer and the buffers
        for p in self._positions:
            c = p.core
            c.adjacency.fill_(-1)
            c.mut.tombstone_bits.zero_()
            c.mut.labels.zero_()
            c.mut.free_ids.fill_(-1)
        for name in ("n_valid", "medoid", "n_free", "n_deleted"):
            self._sc[name] = np.zeros((self.n_shards,), np.int64)
        self._sc["generation"] = self._sc["generation"] + 1
        dealt = data.reshape(self.n_shards, per, -1)

        n0 = min(1024, per)
        self._fn("boot", n0=n0)(dealt[:, :n0])
        # prefix-doubling schedule, every rung inserted into EVERY shard
        inserted = n0
        while inserted < per:
            remaining = per - inserted
            b = min(max(256, 1 << (inserted.bit_length() - 1)), remaining)
            if b != remaining:
                b = 1 << (b.bit_length() - 1)
            ids = torch.arange(inserted, inserted + b, dtype=torch.int32,
                               device=self.device)
            self._fn("insert", b=b)(ids.expand(self.n_shards, b),
                                    dealt[:, inserted:inserted + b])
            inserted += b
        self._sync()

    def _sync(self) -> None:
        _sync_devices(self.position_devices())

    def insert(self, data, *, labels=None) -> np.ndarray:
        """Streaming insert of (S, b, D) — b rows per shard — or (N, D)
        with N divisible by n_shards (dealt contiguously).

        Slot ids come from each shard's own free pool and high-water mark;
        every shard grows when any tail overflows. Returns the GLOBAL row
        ids (int32), shaped like the input batch ((S, b) or (N,)).
        labels: optional label sets for the batch, in the flat dealt order.
        """
        data = self._rows_tensor(data)
        flat_in = data.dim() == 2
        if flat_in:
            n = data.shape[0]
            if n % self.n_shards:
                raise ValueError(
                    f"insert size {n} must be divisible by n_shards "
                    f"{self.n_shards}")
            data = data.reshape(self.n_shards, n // self.n_shards, -1)
        elif data.shape[0] != self.n_shards:
            raise ValueError(
                f"(S, b, D) insert must have S == n_shards "
                f"{self.n_shards}, got {data.shape[0]}")
        if self.size == 0:
            # empty index: a clean per-shard build (as the single-device
            # driver does)
            s, b = data.shape[0], data.shape[1]
            self.build(data.reshape(s * b, -1), labels=labels)
            ids = (np.arange(s)[:, None] * self.id_stride
                   + np.arange(b)[None, :]).astype(np.int32)
            return ids.reshape(-1) if flat_in else ids
        with self._staged():
            data = self._prep_data(data)   # (S, b, D[+1]): global augment
            local_ids, global_ids = self._allocate_slots_per_shard(
                data.shape[1])
            self._fn("insert", b=data.shape[1])(
                torch.as_tensor(local_ids, device=self.device), data)
            if labels is not None:
                self.set_labels(global_ids.reshape(-1), labels)
            self._sync()
        return global_ids.reshape(-1) if flat_in else global_ids

    def set_labels(self, ids, labels) -> None:
        """Assign label bitsets to GLOBAL ids: one label id, one sequence
        of label ids per row, or one shared set for the batch
        (`core.mutations.pack_label_rows`), on every replica of their
        shards. Rows keep their labels through consolidate, grow,
        rebalance and reshard."""
        ids = np.atleast_1d(np.asarray(ids)).astype(np.int64).ravel()
        rows = pack_label_rows(labels, ids.size)
        shard = ids // self.id_stride
        for p in self._positions:
            mine = (shard >= p.shards.start) & (shard < p.shards.stop)
            if not mine.any():
                continue
            pos = ((shard[mine] - p.shards.start) * self.cap
                   + ids[mine] % self.id_stride)
            p.core.mut.labels[torch.as_tensor(pos, device=p.device)] = \
                torch.as_tensor(rows[mine], dtype=torch.uint8,
                                device=p.device)

    def _allocate_slots_per_shard(self, b: int
                                  ) -> tuple[np.ndarray, np.ndarray]:
        """Per-shard slot allocation: each shard pops its OWN free pool
        (ascending), clearing the popped slots' tombstone bits and label
        rows, then advances its OWN tail. Returns (local (S, b), global
        (S, b)) int32 ids. Grows every shard when any tail overflows."""
        s = self.n_shards
        n_free = self._sc["n_free"].copy()
        n_valid = self._sc["n_valid"].copy()
        take = np.minimum(b, n_free)
        need = n_valid + (b - take)
        if need.max() > self.cap:
            new_cap = self.cap
            while need.max() > new_cap:
                new_cap *= 2
            self.grow(new_cap)
        cap = self.cap
        local = np.empty((s, b), np.int32)
        for i in range(s):
            t = int(take[i])
            for p in self._replicas(i) if t else ():
                # every replica pops its own copy of the pool alike
                view = self._view(p, i)
                fi = view.mut.free_ids
                reused = fi[:t].clone()
                local[i, :t] = reused.cpu().numpy()
                fi[:cap - t] = fi[t:].clone()
                fi[cap - t:] = -1
                dense = unpack_bitmap(view.mut.tombstone_bits, cap)
                dense[reused.long()] = False
                view.mut.tombstone_bits.copy_(pack_bitmap(dense))
                view.mut.labels[reused.long()] = 0
            local[i, t:] = n_valid[i] + np.arange(b - t, dtype=np.int32)
        self._sc["n_free"] = n_free - take
        global_ids = local + (np.arange(s, dtype=np.int32)
                              * self.id_stride)[:, None]
        return local, global_ids

    # -------------------------------------------------------- delete/repair
    def delete(self, ids) -> int:
        """Batched tombstone delete of GLOBAL ids: each shard tombstones
        its own rows in its own bitmap slice. Raises on ids that are not
        live. Returns the rows deleted."""
        ids_np = np.atleast_1d(np.asarray(ids)).astype(np.int64).ravel()
        if ids_np.size == 0:
            return 0
        bad = ids_np[(ids_np < 0)
                     | (ids_np >= self.n_shards * self.id_stride)]
        if bad.size:
            raise ValueError(f"ids out of range: {bad[:8].tolist()}")
        dead = ids_np[self.tombstoned(ids_np)]
        if dead.size:
            raise ValueError(
                f"ids already deleted, freed, or unwritten: "
                f"{dead[:8].tolist()}")
        shard = ids_np // self.id_stride
        local = ids_np % self.id_stride
        counts = np.bincount(shard, minlength=self.n_shards)
        # every shard's batch padded to one power-of-two rung (-1 ignored)
        rung = pow2_rung(int(counts.max()))
        padded = np.full((self.n_shards, rung), -1, np.int32)
        for i in range(self.n_shards):
            mine = local[shard == i]
            padded[i, :mine.size] = mine
        return self._fn("delete", rung=rung)(
            torch.as_tensor(padded, device=self.device))

    def consolidate(self, *, refine: bool = True) -> dict:
        """Per-shard graph repair: each shard with tombstones runs the
        single-device `core_consolidate`; repair never crosses shards."""
        n_del = self._sc["n_deleted"].copy()
        total = {"n_freed": 0, "n_repaired": 0}
        if not n_del.any():
            return total
        with self._staged():
            for s in range(self.n_shards):
                if n_del[s]:
                    stats = self._apply(s, lambda v: core_consolidate(
                        v, params=self.params, refine=refine))
                    total["n_freed"] += stats["n_freed"]
                    total["n_repaired"] += stats["n_repaired"]
        return total

    def grow(self, new_capacity_per_shard: int | None = None
             ) -> "ShardedJasperIndex":
        """Grow every shard's capacity by copy-extension. Each shard's
        buffers (packed codes included) keep their resident prefix byte
        for byte, and GLOBAL ids are untouched; growing past the fixed
        id_stride raises."""
        new_cap = new_capacity_per_shard or 2 * self.cap
        if new_cap < self.cap:
            raise ValueError(f"cannot shrink {self.cap} -> {new_cap}")
        if new_cap % 8:
            raise ValueError("capacity_per_shard must be a multiple of 8")
        if new_cap > self.id_stride:
            raise ValueError(
                f"capacity_per_shard {new_cap} would exceed id_stride "
                f"{self.id_stride}: outstanding global ids would collide "
                "across shards. Construct the index with a larger "
                "id_stride for more growth headroom.")
        if new_cap == self.cap:
            return self
        with self._staged():
            self._grow_impl(new_cap)
        return self

    def _grow_impl(self, new_cap: int) -> None:
        cap = self.cap
        for p in self._positions:
            s = len(p.shards)

            def pad(t, fill):
                # rows (cap -> new_cap) and the bitmap (cap/8 -> new_cap/8)
                tail = tuple(t.shape[1:])
                shaped = t.reshape((s, -1) + tail)
                out = torch.full((s, shaped.shape[1] * new_cap // cap) + tail,
                                 fill, dtype=t.dtype, device=t.device)
                out[:, :shaped.shape[1]] = shaped
                return out.reshape((-1,) + tail)

            c = p.core
            codes = c.codes
            if codes is not None:
                codes = RaBitQCodes(packed=pad(codes.packed, 0),
                                    data_add=pad(codes.data_add, 0.0),
                                    data_rescale=pad(codes.data_rescale, 0.0),
                                    bits=codes.bits, dims=codes.dims)
            m = c.mut
            p.core = replace(
                c, vectors=pad(c.vectors, 0.0),
                vec_sqnorm=pad(c.vec_sqnorm, 0.0),
                adjacency=pad(c.adjacency, -1),
                mut=replace(m, tombstone_bits=pad(m.tombstone_bits, 0),
                            labels=pad(m.labels, 0),
                            free_ids=pad(m.free_ids, -1)),
                codes=codes)
        self._sc["generation"] = self._sc["generation"] + 1
        self.cap = new_cap
        self.plans.clear()              # row offsets / shapes changed

    def rebalance(self, *, tolerance: float = 0.05) -> dict:
        """Level per-shard live counts: live rows move off overfull shards
        onto underfull ones (`rebalance_plan`), through the core ops —
        `core_insert_at` on the receiver (its encode re-derives the packed
        code bit for bit: the quantizer is shared) and `core_delete` +
        `core_consolidate` on the donor. Host-driven, as JAX's is: the
        moved rows come to the host from their donor's device and go to
        the receiver's. Moved rows get new global ids; the returned
        ``translation`` (IdTranslation, identity off-table) remaps
        outstanding tickets. No-op inside `tolerance`."""
        with self._staged():
            return self._rebalance_impl(tolerance)

    def _moved_rows(self, pairs) -> tuple[torch.Tensor, torch.Tensor]:
        """(rows, label rows) on the host of (shard, local) pairs, in
        order, each read from its shard's first replica."""
        pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
        rows = torch.empty((len(pairs), self.store_dims), dtype=torch.float32)
        labs = None
        for s in np.unique(pairs[:, 0]):
            at = np.flatnonzero(pairs[:, 0] == s)
            sc = self.shard_core(int(s))
            lo = torch.as_tensor(pairs[at, 1], device=sc.device)
            lab = sc.mut.labels[lo].cpu()
            if labs is None:
                labs = torch.empty((len(pairs), lab.shape[1]),
                                   dtype=torch.uint8)
            rows[torch.as_tensor(at)] = sc.vectors[lo].cpu()
            labs[torch.as_tensor(at)] = lab
        return rows, labs

    def _rebalance_impl(self, tolerance: float) -> dict:
        s_n = self.n_shards
        live = [core_live_locals(self.shard_core(s)) for s in range(s_n)]
        plan = rebalance_plan(live, tolerance=tolerance)
        base = {"counts_before": plan.counts_before.tolist(),
                "counts_after": plan.counts_after.tolist(),
                "imbalance": self.shard_imbalance}
        if plan.n_moved == 0:
            return base | {"n_moved": 0, "translation": None}
        if self.n_deleted:
            # tombstoned slots cannot receive rows — free them first
            self.consolidate()
        old_gids, new_gids = [], []
        # 1. receivers first (rows must exist somewhere at every point);
        # donors and receivers are disjoint, so a receiver's writes never
        # touch a row still to be read
        for dst, pairs in plan.moves.items():
            rows, lab_rows = self._moved_rows(pairs)

            def receive(view, rows=rows, lab_rows=lab_rows, n=len(pairs)):
                core, reused = core_take_free_slots(view, n)
                hw = core.n_valid
                fresh = np.arange(hw, hw + n - reused.size, dtype=np.int32)
                ids = np.concatenate([reused, fresh]).astype(np.int32)
                pad_ids, pad_rows = _pow2_pad_pairs(ids, rows.to(view.device))
                core = core_insert_at(
                    core, torch.as_tensor(pad_ids, device=view.device),
                    pad_rows, params=self.params)
                # moved rows keep their label rows bit for bit
                return core_set_labels(core, ids, lab_rows.numpy()), ids

            ids = self._apply(dst, receive)
            old_gids += [sh * self.id_stride + lo for sh, lo in pairs]
            new_gids += (dst * self.id_stride + ids.astype(np.int64)).tolist()
        # 2. tombstone the moved-out rows on their donors, then repair
        by_src: dict[int, list[int]] = {}
        for pairs in plan.moves.values():
            for sh, lo in pairs:
                by_src.setdefault(sh, []).append(lo)
        for src_shard, locs in by_src.items():
            ids = np.asarray(sorted(locs), np.int32)
            padded = np.full((pow2_rung(ids.size),), -1, np.int32)
            padded[:ids.size] = ids

            def give(view, padded=padded):
                core, _ = core_delete(
                    view, torch.as_tensor(padded, device=view.device))
                return core_consolidate(core, params=self.params)

            self._apply(src_shard, give)
        return base | {
            "n_moved": plan.n_moved,
            "translation": IdTranslation.build(old_gids, new_gids,
                                               default="identity")}

    # -------------------------------------------------------------- search
    # searcher()/recall() come from SearchSurface
    def _mirrors_of(self, p: _Position) -> list[DeviceScalars]:
        """Position p's device mirrors of its shards' n_valid and medoid
        (made at first use)."""
        if p.mirrors is None:
            p.mirrors = [DeviceScalars(p.device) for _ in p.shards]
        return p.mirrors

    def _sync_position_mirrors(self, p: _Position, core: IndexCore) -> None:
        for i, m in enumerate(self._mirrors_of(p)):
            m.sync(SimpleNamespace(n_valid=int(core.n_valid[i]),
                                   medoid=int(core.medoid[i])))

    def _sync_mirrors(self, core: IndexCore) -> None:
        self._sync_position_mirrors(self._positions[0], core)

    def _shard_searches(self, p: _Position, core: IndexCore, queries, rspec,
                        filt: bool, filter_bytes, *, mirrors: bool) -> tuple:
        """Position p's `core_search` of each of its shards on its slices
        of `core` (reading n_valid and medoid through its device mirrors
        when `mirrors`), stacked: (local ids (S', Q, k), dists, n_hops
        (S', Q)[, telemetry stacked the same way]); with
        rerank_source="host" the ids and dists are the estimator frontier
        (S', Q, L)."""
        outs = []
        for i in range(len(p.shards)):
            local = _shard_of(core, i, self.cap)
            if mirrors:
                local = self._mirrors_of(p)[i].view(local)
            outs.append(core_search(local, queries, spec=rspec,
                                    filter_tombstones=filt,
                                    filter_bytes=filter_bytes))
        out = (torch.stack([o[0] for o in outs]),
               torch.stack([o[1] for o in outs]),
               torch.stack([o[2] for o in outs]))
        if rspec.telemetry == "on":
            out += (type(outs[0][3])(*(torch.stack(ts) for ts in
                                       zip(*(o[3] for o in outs)))),)
        return out

    def _merge(self, out: tuple, rspec) -> tuple:
        """Stacked per-shard outputs (all S shards, in order) -> the local
        ids made global and `merge_topk`; n_hops the max over shards;
        telemetry the int32 sum over shards (occupancy per hop too). With
        rerank_source="host" the stacked frontiers are returned as they
        are, for the host tier's gather and rerank."""
        if rspec.rerank_source == "host":
            return out
        ids = out[0]
        row0 = (torch.arange(self.n_shards, dtype=torch.int32,
                             device=ids.device) * self.id_stride)
        gids = torch.where(ids >= 0, ids + row0[:, None, None],
                           torch.full_like(ids, -1))
        return self._merge_global(gids, out[1], out[2],
                                  out[3] if len(out) > 3 else None, rspec.k)

    def _merge_global(self, gids, dists, hops, tel, k: int) -> tuple:
        gids, dists = merge_topk(gids, dists, self.axis_sizes, k)
        out = (gids, dists, hops.amax(0))
        if tel is not None:
            out += (type(tel)(*(t.sum(0, dtype=t.dtype) for t in tel)),)
        return out

    def _plan_search(self, core: IndexCore, queries, rspec, filt: bool,
                     filter_bytes, *, mirrors: bool) -> tuple:
        """What a plan runs on a one-position mesh: every shard's
        `core_search` on its slices of `core`, then `_merge`. With
        rerank_source="host" the per-shard frontiers come back stacked,
        (S, Q, L), for the host tier's gather and rerank
        (`ShardedRerankPlan`)."""
        return self._merge(self._shard_searches(
            self._positions[0], core, queries, rspec, filt, filter_bytes,
            mirrors=mirrors), rspec)

    def _gather(self, positions, outs) -> tuple:
        """Each searching position's stacked outputs gathered onto the home
        device: shards in order, each shard's query slices concatenated.
        On the card the home stream waits for an event recorded on each
        other device's stream before the copies."""
        home = self.device
        if home.type == "cuda":
            for dev in {p.device for p in positions} - {home}:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                torch.cuda.current_stream(home).wait_event(ev)
        by_shard: dict = {}
        for p, o in sorted(zip(positions, outs), key=lambda po: (
                po[0].shards.start, po[0].query_slice)):
            by_shard.setdefault(p.shards.start, []).append(o)

        def cat(parts):
            if isinstance(parts[0], torch.Tensor):
                if len(parts) == 1:
                    return parts[0].to(home)
                return torch.cat([t.to(home) for t in parts], dim=1)
            return type(parts[0])(*(cat(list(f)) for f in zip(*parts)))

        per_shard = [tuple(cat(list(f)) for f in zip(*group))
                     for _, group in sorted(by_shard.items())]

        def stack(parts):
            if isinstance(parts[0], torch.Tensor):
                return torch.cat(parts, dim=0)
            return type(parts[0])(*(stack(list(f)) for f in zip(*parts)))

        return tuple(stack(list(f)) for f in zip(*per_shard))

    def _eager_search(self, queries, rspec, filt: bool, filter_bytes
                      ) -> tuple:
        """A search run eagerly at every searching position, gathered and
        merged: what a plan's replay must equal."""
        if not self.multi_position:
            return self._plan_search(self.core, queries, rspec, filt,
                                     filter_bytes, mirrors=False)
        positions = self.searching_positions()
        outs = []
        for p in positions:
            with on_device(p.device):
                outs.append(self._shard_searches(
                    p, self._pos_core(p), self.query_slice(p, queries),
                    rspec, filt, filter_bytes, mirrors=False))
        return self._merge(self._gather(positions, outs), rspec)

    def _search_plan(self, rspec, q_shape, filt: bool):
        """Plan-cache lookup/build: `(queries, filter_bytes) -> (GLOBAL
        ids, dists, n_hops[, telemetry])`, keyed ("search", cap, spec,
        query shape, liveness) as the JAX package keys it (a grow changes
        cap: one new plan a spec). The filter value is a run-time
        operand. A one-position mesh's search is one plan over the stacked
        core (one captured graph on the card's megakernel lanes); a mesh
        of several positions' a `PositionsPlan`."""
        q_shape = tuple(q_shape)
        qa = self.spec.query_axis
        if qa is not None and q_shape[0] % self.mesh.shape[qa]:
            raise ValueError(
                f"{q_shape[0]} queries are not divisible by the size "
                f"{self.mesh.shape[qa]} of the query axis {qa!r}")

        def build():
            if self.multi_position:
                return PositionsPlan(self, rspec, q_shape, filt)
            return make_plan(target_of(self), rspec, q_shape, filt)

        plan = self.plans.get(("search", self.cap, rspec, q_shape, filt),
                              build)
        if rspec.rerank_source == "host":
            # two-stage: the traversal's per-shard frontiers, one gather
            # of their rows from the host tier, then each position's
            # rerank and the merge, separately keyed
            rerank = self.plans.get(("rerank_host", self.cap, rspec, q_shape),
                                    lambda: ShardedRerankPlan(self, rspec))
            traversal = (plan.local if self.multi_position
                         else lambda q, fb=None: [plan(q, fb)])
            return HostTierPlan(traversal, rerank)
        return plan

    def search(self, queries, k: int = 10, *, beam_width: int | None = None,
               max_iters: int | None = None, expand: int = 1,
               quantized: bool = False, rerank: bool = True,
               use_kernels: bool = False, merge: str = "topk",
               traverse_deleted: bool = True):
        """Global top-k over all shards — the legacy keyword form of
        `searcher(SearchSpec(...))`. Returns (GLOBAL ids (Q, k), dists)."""
        res = self.searcher(SearchSpec(
            k=k, beam_width=beam_width, max_iters=max_iters, expand=expand,
            quantized=quantized, rerank=rerank, use_kernels=use_kernels,
            merge=merge, traverse_deleted=traverse_deleted)).search(queries)
        return res.ids, res.dists

    def search_rabitq(self, queries, k: int = 10, **kw):
        """Quantized search (symmetry with JasperIndex)."""
        if self._positions[0].core.codes is None:
            raise RuntimeError("index was not built with quantization='rabitq'")
        return self.search(queries, k, quantized=True, **kw)

    def brute_force(self, queries, k: int = 10):
        """Exact top-k over all LIVE rows of all shards (recall ground
        truth): a chunked scan of each position's stacked rows (one replica
        of each shard), each position's top-k gathered home and merged,
        ties to the lower stacked position as in the JAX package. Returns
        (GLOBAL ids (Q, k) int32, dists (Q, k))."""
        q = self._prep_query(queries)
        with self._staged():
            out = self._brute_force_impl(q, k)
            self._sync()                  # computed before the rows detach
        return out

    def _scan_position(self, p: _Position, q, k):
        """(stacked positions (Q, k), dists) of the k nearest live rows of
        position p's shards: a chunk of queries at a time, ties to the
        lower position."""
        c = self._pos_core(p)
        rows = len(p.shards) * self.cap
        local = torch.arange(rows, device=p.device) % self.cap
        nv = torch.as_tensor(c.n_valid, device=p.device).repeat_interleave(
            self.cap)
        mask = (local < nv) & ~unpack_bitmap(c.mut.tombstone_bits, rows)
        chunk = max(1, _BRUTE_FORCE_PAIRS // rows)
        pos_out, d_out = [], []
        for s in range(0, q.shape[0], chunk):
            d = pairwise_l2_squared(q[s:s + chunk], c.vectors, c.vec_sqnorm)
            d = torch.where(mask[None, :], d, torch.full_like(d, _INF))
            pos, vals = _lowest_topk(d, k)
            pos_out.append(pos)
            d_out.append(vals)
            del d
        return torch.cat(pos_out) + p.shards.start * self.cap, \
            torch.cat(d_out)

    def _brute_force_impl(self, q, k):
        owners = self._owner_positions()
        parts = []
        for p in owners:
            with on_device(p.device):
                parts.append(self._scan_position(p, q.to(p.device), k))
        if len(parts) == 1:
            pos, dists = parts[0]
        else:
            # each position's k in ascending positions: the columns'
            # order is the stacked positions' order among equal values
            cand = torch.cat([t.to(self.device) for t, _ in parts], dim=1)
            col, dists = _lowest_topk(
                torch.cat([d.to(self.device) for _, d in parts], dim=1), k)
            pos = torch.gather(cand, 1, col)
        gids = (torch.div(pos, self.cap, rounding_mode="floor")
                * self.id_stride + pos % self.cap)
        return gids.to(torch.int32), dists

    # --------------------------------------------------------------- memory
    def memory_stats(self) -> dict[str, float]:
        """Per-tier resident bytes over the stacked (all-shard) buffers,
        one replica a shard — the TIER_STAT_KEYS of `JasperIndex`."""
        return dict(tier_memory_stats(
            [p.core for p in self._owner_positions()], self.store,
            capacity=self.capacity, store_dims=self.store_dims))

    def storage_stats(self) -> dict:
        """Tier residence + host-fetch counters (the `storage.*` metrics)."""
        out = dict(self.memory_stats())
        out.update({f"fetch_{k}": v
                    for k, v in self.store.fetch_stats.as_dict().items()})
        return out

    # ----------------------------------------------------------- plan cache
    def _fn(self, kind: str, **key):
        """The mutation steps (insert/boot/delete), in the shared PlanCache
        under the JAX package's keys; each runs its core op a shard at a
        time, on each of the shard's replicas (`_apply`)."""
        ck = (kind, self.cap, tuple(sorted(key.items())))

        def build():
            if kind == "insert":
                return self._insert_step
            if kind == "boot":
                return lambda rows: self._boot_step(rows, n0=key["n0"])
            if kind == "delete":
                return self._delete_step
            raise ValueError(kind)

        return self.plans.get(ck, build)

    def _insert_step(self, ids: torch.Tensor, rows: torch.Tensor) -> None:
        for s in range(self.n_shards):
            self._apply(s, lambda v: (core_insert_at(
                v, ids[s].to(v.device), rows[s].to(v.device),
                params=self.params), None))

    def _boot_step(self, rows: torch.Tensor, *, n0: int) -> None:
        for s in range(self.n_shards):
            self._apply(s, lambda v: (core_bootstrap(
                v, rows[s].to(v.device), n0=n0, params=self.params), None))

    def _delete_step(self, padded: torch.Tensor) -> int:
        total = 0
        for s in range(self.n_shards):
            total += int(self._apply(s, lambda v: core_delete(
                v, padded[s].to(v.device))))
        return total

    # ------------------------------------------------------------ save/load
    def save(self, path: str) -> None:
        """Checkpoint: one single-device-format .npz a shard
        (`{path}.shard{K}`, each readable by `JasperIndex.load`) plus a
        `{path}.meta.json` manifest, with the JAX package's keys."""
        meta = {
            "n_shards": self.n_shards, "dims": self.dims,
            "metric": self.metric,
            "capacity_per_shard": self.cap, "id_stride": self.id_stride,
            "quantization": self.quantization, "bits": self.bits,
            "seed": self.seed,
            "construction": asdict(self.params),
            "row_axes": list(self.spec.row_axes),
            "query_axis": self.spec.query_axis,
            "mips_max_sqnorm": self._mips_max_sqnorm,
            "rows_tier": self.rows_tier,
        }
        shard_meta = {
            "dims": self.dims, "metric": self.metric, "capacity": self.cap,
            "quantization": self.quantization, "bits": self.bits,
            "seed": self.seed,
            "construction": asdict(self.params),
            "mips_max_sqnorm": self._mips_max_sqnorm,
            "rows_tier": self.rows_tier,
        }
        with self._staged():
            for s in range(self.n_shards):
                save_npz_atomic(f"{path}.shard{s}",
                                core_to_arrays(self.shard_core(s)),
                                shard_meta)
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, mesh, path: str, *, spec: ShardSpec | None = None,
             n_shards: int | None = None) -> "ShardedJasperIndex":
        """Restore a checkpoint either package saved, at the shard count
        the mesh provides, onto the mesh's positions.

        Same count as saved -> bit-exact restore: each shard's payload is
        read to the host and copied into its slices of every position
        that holds it, so no device holds more than its own shards. Another
        count -> elastic reshard (core/resharding.py), on the mesh's one
        device for a one-position mesh, on the host for a mesh of several
        positions, then dealt alike; the old->new id map lands on
        ``idx.reshard_translation`` (None on an exact restore). `n_shards`
        is a guard: raise rather than reshard to an unintended count.
        """
        with open(path + ".meta.json") as f:
            meta = json.load(f)
        metric = meta.get("metric", "l2")
        store_dims = meta["dims"] + 1 if metric == "mips" else meta["dims"]
        if (spec is None and meta.get("row_axes")
                and all(a in mesh.axis_names for a in meta["row_axes"])):
            qa = meta["query_axis"]
            spec = ShardSpec(row_axes=tuple(meta["row_axes"]),
                             query_axis=qa if qa in mesh.axis_names else None)
        params = ConstructionParams(**meta["construction"])
        quantized = meta["quantization"] == "rabitq"

        def read(s, device):
            with np.load(f"{path}.shard{s}") as data:
                return core_from_arrays(
                    data, bits=meta["bits"], store_dims=store_dims,
                    quantized=quantized, device=device)

        row_axes = (spec.row_axes if spec is not None
                    else (tuple(a for a in mesh.axis_names if a != "model")
                          or (mesh.axis_names[0],)))
        target = 1
        for ax in row_axes:
            target *= mesh.shape[ax]
        if n_shards is not None and target != n_shards:
            raise ValueError(
                f"mesh provides {target} row shards but n_shards="
                f"{n_shards} was requested — pass a mesh/spec with "
                f"{n_shards} row shards")
        translation = None
        cap, stride = meta["capacity_per_shard"], meta.get("id_stride")
        shard = (lambda s: read(s, "cpu"))
        if target != meta["n_shards"]:
            at = mesh.device if len(mesh.devices) == 1 else "cpu"
            res = reshard_cores([read(s, at) for s in range(meta["n_shards"])],
                                old_id_stride=stride or 4 * cap,
                                n_shards=target, params=params)
            cap, stride = res.capacity_per_shard, res.id_stride
            translation = res.translation
            shard = res.cores.__getitem__
        idx = cls.__new__(cls)
        idx._configure(mesh, meta["dims"], cap, spec=spec, metric=metric,
                       construction=params,
                       quantization=meta["quantization"], bits=meta["bits"],
                       seed=meta["seed"], id_stride=stride,
                       plan_cache_capacity=None)
        idx._mips_max_sqnorm = meta.get("mips_max_sqnorm")
        idx._place_cores(shard)
        idx.reshard_translation = translation
        if meta.get("rows_tier", "device") == "host":
            idx.evict_rows_to_host()    # the checkpoint's tier
        return idx
