"""ShardedJasperIndex — the IndexCore driver over row shards (port of
`repro.core.distributed`, the same names and API).

There is one index implementation, the core ops of `core.index_core`.
An S-shard index is S independent cores plus a k-way merge, and every
op of this driver is the single-device one run a shard at a time:
`core_search`, `core_bootstrap`, `core_insert_at`, `core_delete`,
`core_consolidate`. No search or insert logic lives here.

Layout (the JAX package's stacked form):

  * database rows are dealt to shards; each shard owns an INDEPENDENT
    core (graph edges never cross shards). Every capacity-major buffer is
    one stacked tensor — rows (S*cap, D), packed RaBitQ codes (S*cap, P),
    adjacency (S*cap, R), the tombstone bitmap (S*cap/8,) — and
    `shard_core(s)` is an IndexCore of zero-copy slices of them with
    shard s's host scalars. A shard op writes into those slices, so the
    buffers keep their addresses and a captured search plan stays valid;
  * `rq_params` (rotation/centroid) is dataset-level state, shared;
  * search: each shard's `core_search` (the fused kernels over its
    packed codes, its tombstone bits, its exact rerank) -> local top-k ->
    global ids -> `merge_topk`, hierarchical over the row axes.

All S shards live on the mesh's one device (launch/mesh.py): the merge
is a stable sort on that device, not a collective. Adjacency entries and
free pools hold SHARD-LOCAL ids; global ids are `shard * id_stride +
local`, int32, with `id_stride` FIXED at construction (default 4x the
initial per-shard capacity), so ids handed to clients survive a grow.
Growing past the stride raises.

Search plans come from core/plans.py with this driver's `_plan_search`:
on the card a megakernel-lane search over all S shards and the merge is
ONE captured CUDA graph (each shard reads its n_valid/medoid through its
own device mirrors); other lanes and the CPU run eager plans.
"""

from __future__ import annotations

import json
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
from repro_torch.core.mutations import (MutationState, pack_bitmap,
                                        pack_label_rows, unpack_bitmap)
from repro_torch.core.plans import (DeviceScalars, HostRerankPlan,
                                    ShardedHostTierPlan, keep_buffers,
                                    make_plan, searched_tensors)
from repro_torch.core.rabitq import RaBitQCodes, rabitq_train
from repro_torch.core.resharding import (IdTranslation, pow2_rung,
                                         rebalance_plan, reshard_cores)
from repro_torch.core.search_spec import PlanCache, SearchSpec, SearchSurface
from repro_torch.core.storage import (VectorStore,
                                      build_sharded_host_rerank_plan,
                                      rows_staged, tier_memory_stats)
from repro_torch.obs.tracing import span as obs_span

_INF = float("inf")

# distances held at once by brute_force: query chunks of this many
# (query, row) pairs (4 GiB of float32)
_BRUTE_FORCE_PAIRS = 1 << 30


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


def _buffers(core: IndexCore) -> list:
    return searched_tensors(core) + [core.mut.free_ids]


class ShardedJasperIndex(SearchSurface):
    """Row-sharded Jasper index: the IndexCore driver over S shards on the
    mesh's device."""

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
        self.device = mesh.device
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

        self._core = self._empty_stacked_core()
        # search plans + the mutation steps (insert/boot/delete), keyed as
        # the JAX package keys them; Searcher sessions share it
        self.plans = PlanCache(capacity=plan_cache_capacity)
        self._mirrors: list[DeviceScalars] | None = None
        # old->new IdTranslation of the last shard-count-changing load
        self.reshard_translation = None
        # the rows tier (core/storage.py): host rows are the stacked
        # (S*cap, D) tensor, so a frontier row is at shard*cap + local
        self.store = VectorStore(pin=self.device.type == "cuda")
        if rows_tier == "host":
            self.evict_rows_to_host()
        elif rows_tier != "device":
            raise ValueError(
                f"rows_tier must be device|host, got {rows_tier!r}")

    # ------------------------------------------------------------ the core
    @property
    def core(self) -> IndexCore:
        """The stacked core: (S*cap, ...) buffers, (S,) host scalars."""
        return self._core

    @core.setter
    def core(self, new: IndexCore) -> None:
        """Install a stacked core, its shape-preserving buffers written
        into the current ones (`keep_buffers`)."""
        self._core = keep_buffers(self._core, new)

    def _empty_stacked_core(self) -> IndexCore:
        s, cap = self.n_shards, self.cap
        core = init_core(s * cap, self.store_dims, self.params.degree_bound,
                         self.device)
        z = np.zeros((s,), np.int64)
        return replace(core, n_valid=z, medoid=z.copy(),
                       mut=replace(core.mut, n_free=z.copy(),
                                   n_deleted=z.copy(), generation=z.copy()))

    def shard_core(self, s: int) -> IndexCore:
        """Shard s as a plain (local-id) IndexCore of zero-copy slices of
        the stacked buffers — the unit of every shard op and of
        checkpoint I/O."""
        return _shard_of(self._core, s, self.cap)

    def _set_shard(self, s: int, local: IndexCore) -> None:
        """Install shard s's result of a core op: its buffers written into
        the stacked slices (where the op did not write in place), its
        scalars into the (S,) vectors."""
        view = self.shard_core(s)
        for a, b in zip(_buffers(view), _buffers(local)):
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
        c = self._core

        def put(vec, value):
            vec = vec.copy()
            vec[s] = int(value)
            return vec

        m = c.mut
        self._core = replace(
            c, n_valid=put(c.n_valid, local.n_valid),
            medoid=put(c.medoid, local.medoid),
            mut=replace(m, n_free=put(m.n_free, local.mut.n_free),
                        n_deleted=put(m.n_deleted, local.mut.n_deleted),
                        generation=put(m.generation, local.mut.generation)))

    def _stack_cores(self, locals_: list[IndexCore]) -> IndexCore:
        """Assemble S per-shard (local-id) cores into one stacked core —
        one concatenation a buffer."""
        def cat(get):
            return torch.cat([get(c) for c in locals_])

        def vec(get):
            return np.asarray([int(get(c)) for c in locals_], np.int64)

        codes = None
        if locals_[0].codes is not None:
            c0 = locals_[0].codes
            codes = RaBitQCodes(
                packed=cat(lambda c: c.codes.packed),
                data_add=cat(lambda c: c.codes.data_add),
                data_rescale=cat(lambda c: c.codes.data_rescale),
                bits=c0.bits, dims=c0.dims)
        return IndexCore(
            vectors=cat(lambda c: c.vectors),
            vec_sqnorm=cat(lambda c: c.vec_sqnorm),
            adjacency=cat(lambda c: c.adjacency),
            n_valid=vec(lambda c: c.n_valid),
            medoid=vec(lambda c: c.medoid),
            mut=MutationState(
                tombstone_bits=cat(lambda c: c.mut.tombstone_bits),
                labels=cat(lambda c: c.mut.labels),
                free_ids=cat(lambda c: c.mut.free_ids),
                n_free=vec(lambda c: c.mut.n_free),
                n_deleted=vec(lambda c: c.mut.n_deleted),
                generation=vec(lambda c: c.mut.generation)),
            codes=codes, rq_params=locals_[0].rq_params)

    # ---------------------------------------------------------- tiered rows
    @property
    def rows_tier(self) -> str:
        """Where the f32 rows live ("device" | "host")."""
        return self.store.tier

    def evict_rows_to_host(self) -> "ShardedJasperIndex":
        """device -> host across every shard: packed codes, graph and
        metadata stay on the device; the f32 rows move to one stacked
        host tensor (pinned on the card). The plans are dropped."""
        if self.quantization != "rabitq":
            raise ValueError(
                "evict_rows_to_host requires quantization='rabitq': "
                "without device-resident packed codes there is nothing "
                "left to traverse on (an exact-only core cannot serve "
                "any search with its rows evicted)")
        self.core = self.store.evict(self.core)
        self.plans.clear()
        return self

    def restore_rows_to_device(self) -> "ShardedJasperIndex":
        """host -> device: re-attach the stacked rows."""
        self.core = self.store.restore(self.core)
        self.plans.clear()
        return self

    # ----------------------------------------------------------------- util
    @property
    def size(self) -> int:
        c = self._core
        return int(c.n_valid.sum() - c.mut.n_deleted.sum()
                   - c.mut.n_free.sum())

    @property
    def capacity(self) -> int:
        """Total row capacity across shards."""
        return self.n_shards * self.cap

    @property
    def generation(self) -> int:
        """Sum of the per-shard generation counters."""
        return int(self._core.mut.generation.sum())

    @property
    def n_deleted(self) -> int:
        return int(self._core.mut.n_deleted.sum())

    @property
    def deleted_fraction(self) -> float:
        n = int(self._core.n_valid.sum()) - int(self._core.mut.n_free.sum())
        return self.n_deleted / n if n else 0.0

    @property
    def _filter_tombstones(self) -> bool:
        return self.n_deleted != 0 or int(self._core.mut.n_free.sum()) != 0

    def shard_live_counts(self) -> np.ndarray:
        """int64[S] live rows per shard (skewed deletes drift these apart;
        `rebalance` levels them)."""
        c = self._core
        return (c.n_valid - c.mut.n_deleted - c.mut.n_free).astype(np.int64)

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
        dead = bitmap_test_np(
            self._core.mut.tombstone_bits.cpu().numpy(), bit_pos)
        n_valid = self._core.n_valid
        return dead | ~in_cap | (local >= n_valid[shard])

    def _as_tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(x, dtype=np.float32),
                               device=self.device)

    # ----------------------------------------------------------------- mips
    def _prep_data(self, x) -> torch.Tensor:
        """Metric prep BEFORE rows deal to shards: for MIPS, augment
        against the GLOBAL max-norm of everything inserted so far; a batch
        that raises it re-augments every written row of every shard."""
        x = self._as_tensor(x)
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
        """Re-augment every written row of every shard, in place:
        e' = sqrt(e^2 + delta), |row'|^2 = |row|^2 + delta, codes
        re-encoded (the quantizer itself is untouched)."""
        c = self._core
        delta = new_m2 - old_m2
        for s in range(self.n_shards):
            n = int(c.n_valid[s])
            if n == 0:
                continue
            lo = s * self.cap
            last = c.vectors[lo:lo + n, -1]
            c.vectors[lo:lo + n, -1] = torch.sqrt(last * last + delta)
            c.vec_sqnorm[lo:lo + n] += delta
            core_encode_rows(c, torch.arange(lo, lo + n, device=self.device),
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
        if self.quantization == "rabitq" and self._core.rq_params is None:
            gen = torch.Generator().manual_seed(self.seed)
            self.core = attach_quantizer(
                self._core, rabitq_train(gen, rows, bits=self.bits))
            self.plans.clear()          # core structure changed

    def build(self, data, *, labels=None) -> "ShardedJasperIndex":
        """Bulk build. data: (N, D) with N divisible by n_shards — shard s
        owns data[s*per:(s+1)*per]. labels: optional per-row label sets
        (see `set_labels`), in the same dealt order."""
        with obs_span("index.build", n=int(np.shape(data)[0]),
                      sharded=True), rows_staged(self):
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
        c = self._core
        c.adjacency.fill_(-1)
        c.mut.tombstone_bits.zero_()
        c.mut.labels.zero_()
        c.mut.free_ids.fill_(-1)
        z = np.zeros((self.n_shards,), np.int64)
        self._core = replace(
            c, n_valid=z, medoid=z.copy(),
            mut=replace(c.mut, n_free=z.copy(), n_deleted=z.copy(),
                        generation=c.mut.generation + 1))
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
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def insert(self, data, *, labels=None) -> np.ndarray:
        """Streaming insert of (S, b, D) — b rows per shard — or (N, D)
        with N divisible by n_shards (dealt contiguously).

        Slot ids come from each shard's own free pool and high-water mark;
        every shard grows when any tail overflows. Returns the GLOBAL row
        ids (int32), shaped like the input batch ((S, b) or (N,)).
        labels: optional label sets for the batch, in the flat dealt order.
        """
        data = self._as_tensor(data)
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
        with rows_staged(self):
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
        (`core.mutations.pack_label_rows`). Rows keep their labels through
        consolidate, grow, rebalance and reshard."""
        ids = np.atleast_1d(np.asarray(ids)).astype(np.int64).ravel()
        rows = pack_label_rows(labels, ids.size)
        pos = (ids // self.id_stride) * self.cap + ids % self.id_stride
        self._core.mut.labels[torch.as_tensor(pos, device=self.device)] = \
            torch.as_tensor(rows, dtype=torch.uint8, device=self.device)

    def _allocate_slots_per_shard(self, b: int
                                  ) -> tuple[np.ndarray, np.ndarray]:
        """Per-shard slot allocation: each shard pops its OWN free pool
        (ascending), clearing the popped slots' tombstone bits and label
        rows, then advances its OWN tail. Returns (local (S, b), global
        (S, b)) int32 ids. Grows every shard when any tail overflows."""
        s = self.n_shards
        c = self._core
        n_free = c.mut.n_free.copy()
        n_valid = c.n_valid.copy()
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
            if t:
                view = self.shard_core(i)
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
        c = self._core
        self._core = replace(c, mut=replace(c.mut, n_free=n_free - take))
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
        n_del = self._core.mut.n_deleted.copy()
        total = {"n_freed": 0, "n_repaired": 0}
        if not n_del.any():
            return total
        with rows_staged(self):
            for s in range(self.n_shards):
                if n_del[s]:
                    local, stats = core_consolidate(
                        self.shard_core(s), params=self.params, refine=refine)
                    self._set_shard(s, local)
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
        with rows_staged(self):
            self._grow_impl(new_cap)
        return self

    def _grow_impl(self, new_cap: int) -> None:
        s, cap = self.n_shards, self.cap

        def pad(t, fill):
            # rows (cap -> new_cap) and the bitmap (cap/8 -> new_cap/8)
            tail = tuple(t.shape[1:])
            shaped = t.reshape((s, -1) + tail)
            out = torch.full((s, shaped.shape[1] * new_cap // cap) + tail,
                             fill, dtype=t.dtype, device=t.device)
            out[:, :shaped.shape[1]] = shaped
            return out.reshape((-1,) + tail)

        c = self._core
        codes = c.codes
        if codes is not None:
            codes = RaBitQCodes(packed=pad(codes.packed, 0),
                                data_add=pad(codes.data_add, 0.0),
                                data_rescale=pad(codes.data_rescale, 0.0),
                                bits=codes.bits, dims=codes.dims)
        m = c.mut
        self._core = replace(
            c, vectors=pad(c.vectors, 0.0),
            vec_sqnorm=pad(c.vec_sqnorm, 0.0),
            adjacency=pad(c.adjacency, -1),
            mut=replace(m, tombstone_bits=pad(m.tombstone_bits, 0),
                        labels=pad(m.labels, 0),
                        free_ids=pad(m.free_ids, -1),
                        generation=m.generation + 1),
            codes=codes)
        self.cap = new_cap
        self.plans.clear()              # row offsets / shapes changed

    def rebalance(self, *, tolerance: float = 0.05) -> dict:
        """Level per-shard live counts: live rows move off overfull shards
        onto underfull ones (`rebalance_plan`), through the core ops —
        `core_insert_at` on the receiver (its encode re-derives the packed
        code bit for bit: the quantizer is shared) and `core_delete` +
        `core_consolidate` on the donor. Moved rows get new global ids;
        the returned ``translation`` (IdTranslation, identity off-table)
        remaps outstanding tickets. No-op inside `tolerance`."""
        with rows_staged(self):
            return self._rebalance_impl(tolerance)

    def _rebalance_impl(self, tolerance: float) -> dict:
        s_n, cap = self.n_shards, self.cap
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
            src = torch.as_tensor([sh * cap + lo for sh, lo in pairs],
                                  device=self.device)
            rows = self._core.vectors[src]
            lab_rows = self._core.mut.labels[src]
            core, reused = core_take_free_slots(self.shard_core(dst),
                                                len(pairs))
            hw = core.n_valid
            fresh = np.arange(hw, hw + len(pairs) - reused.size,
                              dtype=np.int32)
            ids = np.concatenate([reused, fresh]).astype(np.int32)
            pad_ids, pad_rows = _pow2_pad_pairs(ids, rows)
            core = core_insert_at(
                core, torch.as_tensor(pad_ids, device=self.device), pad_rows,
                params=self.params)
            # moved rows keep their label rows bit for bit
            core = core_set_labels(core, ids, lab_rows.cpu().numpy())
            self._set_shard(dst, core)
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
            core, _ = core_delete(self.shard_core(src_shard),
                                  torch.as_tensor(padded, device=self.device))
            core, _ = core_consolidate(core, params=self.params)
            self._set_shard(src_shard, core)
        return base | {
            "n_moved": plan.n_moved,
            "translation": IdTranslation.build(old_gids, new_gids,
                                               default="identity")}

    # -------------------------------------------------------------- search
    # searcher()/recall() come from SearchSurface
    @property
    def mirrors(self) -> list[DeviceScalars]:
        """Each shard's device mirrors of its n_valid and medoid."""
        if self._mirrors is None:
            self._mirrors = [DeviceScalars(self.device)
                             for _ in range(self.n_shards)]
        return self._mirrors

    def _sync_mirrors(self, core: IndexCore) -> None:
        for s, m in enumerate(self.mirrors):
            m.sync(SimpleNamespace(n_valid=int(core.n_valid[s]),
                                   medoid=int(core.medoid[s])))

    def _plan_search(self, core: IndexCore, queries, rspec, filt: bool,
                     filter_bytes, *, mirrors: bool) -> tuple:
        """What a plan runs: every shard's `core_search` on its slices of
        `core` (reading n_valid and medoid through its device mirrors when
        `mirrors`), then the local ids made global and `merge_topk`.
        n_hops is the max over shards; telemetry the int32 sum over shards
        (occupancy per hop too). With rerank_source="host" the per-shard
        frontiers come back stacked, (S, Q, L), for the host tier's
        gather and rerank (`ShardedHostTierPlan`)."""
        outs = []
        for s in range(self.n_shards):
            local = _shard_of(core, s, self.cap)
            if mirrors:
                local = self.mirrors[s].view(local)
            outs.append(core_search(local, queries, spec=rspec,
                                    filter_tombstones=filt,
                                    filter_bytes=filter_bytes))
        ids = torch.stack([o[0] for o in outs])
        dists = torch.stack([o[1] for o in outs])
        hops = torch.stack([o[2] for o in outs])
        tel = None
        if rspec.telemetry == "on":
            tel = type(outs[0][3])(*(torch.stack(ts)
                                     for ts in zip(*(o[3] for o in outs))))
        if rspec.rerank_source == "host":
            return (ids, dists, hops) + ((tel,) if tel is not None else ())
        row0 = (torch.arange(self.n_shards, dtype=torch.int32,
                             device=ids.device) * self.id_stride)
        gids = torch.where(ids >= 0, ids + row0[:, None, None],
                           torch.full_like(ids, -1))
        gids, dists = merge_topk(gids, dists, self.axis_sizes, rspec.k)
        out = (gids, dists, hops.amax(0))
        if tel is not None:
            out += (type(tel)(*(t.sum(0, dtype=t.dtype) for t in tel)),)
        return out

    def _search_plan(self, rspec, q_shape, filt: bool):
        """Plan-cache lookup/build: `(queries, filter_bytes) -> (GLOBAL
        ids, dists, n_hops[, telemetry])`, keyed ("search", cap, spec,
        query shape, liveness) as the JAX package keys it (a grow changes
        cap: one new plan a spec). The filter value is a run-time
        operand."""
        q_shape = tuple(q_shape)
        qa = self.spec.query_axis
        if qa is not None and q_shape[0] % self.mesh.shape[qa]:
            raise ValueError(
                f"{q_shape[0]} queries are not divisible by the size "
                f"{self.mesh.shape[qa]} of the query axis {qa!r}")
        plan = self.plans.get(("search", self.cap, rspec, q_shape, filt),
                              lambda: make_plan(self, rspec, q_shape, filt))
        if rspec.rerank_source == "host":
            # two-stage: the traversal's per-shard frontiers, one gather
            # of their rows from the host tier, then the sharded rerank +
            # merge (core/storage.py), separately keyed
            rerank = self.plans.get(
                ("rerank_host", self.cap, rspec, q_shape),
                lambda: HostRerankPlan(self, rspec,
                                       build_sharded_host_rerank_plan(
                                           rspec, axis_sizes=self.axis_sizes,
                                           id_stride=self.id_stride)))
            return ShardedHostTierPlan(self, plan, rerank)
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
        if self._core.codes is None:
            raise RuntimeError("index was not built with quantization='rabitq'")
        return self.search(queries, k, quantized=True, **kw)

    def brute_force(self, queries, k: int = 10):
        """Exact top-k over all LIVE rows of all shards (recall ground
        truth): a full scan of the stacked rows, a chunk of queries at a
        time, ties to the lower stacked position as in the JAX package.
        Returns (GLOBAL ids (Q, k) int32, dists (Q, k))."""
        q = self._prep_query(queries)
        with rows_staged(self):
            out = self._brute_force_impl(q, k)
            self._sync()                  # computed before the rows detach
        return out

    def _brute_force_impl(self, q, k):
        c = self._core
        rows = self.n_shards * self.cap
        local = torch.arange(rows, device=self.device) % self.cap
        nv = torch.as_tensor(c.n_valid, device=self.device).repeat_interleave(
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
        pos = torch.cat(pos_out)
        gids = (torch.div(pos, self.cap, rounding_mode="floor")
                * self.id_stride + pos % self.cap)
        return gids.to(torch.int32), torch.cat(d_out)

    # --------------------------------------------------------------- memory
    def memory_stats(self) -> dict[str, float]:
        """Per-tier resident bytes over the stacked (all-shard) buffers —
        the TIER_STAT_KEYS of the single-device driver."""
        return dict(tier_memory_stats(
            self._core, self.store, capacity=self.capacity,
            store_dims=self.store_dims))

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
        time."""
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
            self._set_shard(s, core_insert_at(self.shard_core(s), ids[s],
                                              rows[s], params=self.params))

    def _boot_step(self, rows: torch.Tensor, *, n0: int) -> None:
        for s in range(self.n_shards):
            self._set_shard(s, core_bootstrap(self.shard_core(s), rows[s],
                                              n0=n0, params=self.params))

    def _delete_step(self, padded: torch.Tensor) -> int:
        total = 0
        for s in range(self.n_shards):
            core, n_new = core_delete(self.shard_core(s), padded[s])
            self._set_shard(s, core)
            total += int(n_new)
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
        with rows_staged(self):
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
        the mesh provides, onto the mesh's device.

        Same count as saved -> bit-exact restore. Another count -> elastic
        reshard (core/resharding.py); the old->new id map lands on
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
        locals_ = []
        for s in range(meta["n_shards"]):
            with np.load(f"{path}.shard{s}") as data:
                locals_.append(core_from_arrays(
                    data, bits=meta["bits"], store_dims=store_dims,
                    quantized=quantized, device=mesh.device))
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
        if target != meta["n_shards"]:
            res = reshard_cores(locals_, old_id_stride=stride or 4 * cap,
                                n_shards=target, params=params)
            cap, stride = res.capacity_per_shard, res.id_stride
            locals_, translation = res.cores, res.translation
        idx = cls(mesh, meta["dims"], cap, id_stride=stride, spec=spec,
                  metric=metric, construction=params,
                  quantization=meta["quantization"], bits=meta["bits"],
                  seed=meta["seed"])
        idx._mips_max_sqnorm = meta.get("mips_max_sqnorm")
        idx.core = idx._stack_cores(locals_)
        del locals_
        idx.reshard_translation = translation
        idx.plans.clear()
        if meta.get("rows_tier", "device") == "host":
            idx.evict_rows_to_host()    # the checkpoint's tier
        return idx
