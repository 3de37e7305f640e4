"""Tiered vector storage — device-resident packed codes, host-resident rows.

Port of `repro.core.storage`. `VectorStore` manages where one index's
f32 rows live (for a `ShardedJasperIndex`, the stacked rows of all its
shards, (S*cap, D), once a shard however many positions hold it):

  * tier "device" — the rows are core tensors (`core.vectors` /
    `core.vec_sqnorm`) and the exact rerank runs inside the search.
  * tier "host"   — the rows live here as CPU tensors, pinned when the
    index is on the card; `core.vectors is None`. Traversal runs on the
    device-resident packed codes only; the final frontier's rows are
    gathered here (`gather`) and copied to the card for the exact rerank.

The search-time knob is `SearchSpec(rerank_source=...)`: "device" reranks
from core.vectors (tier "device"), "host" from this store (tier "host"),
"none" serves estimator distances on either tier (`SearchResult.estimated`).

Write-through contract: mutations run the unchanged core ops on staged
rows — `rows_staged(index)` attaches the host rows to the core, the op
runs exactly as on the device tier (so the graph evolves bit for bit as
it would there), and detach syncs the host tier from the result and
strips the rows off the device again. A grow syncs for free: detach
copies whatever shape the op produced.

Bit identity of the two tiers (`build_host_rerank_plan`): the device
tier reranks with `rerank_frontier(core.vectors, core.vec_sqnorm,
queries, frontier_ids)`; the host tier gathers those same rows into a
(Q*L, D) table, relabels candidate (q, j) to table row q*L + j (-1 stays
-1) and calls the same `rerank_frontier` on the table, then the same
stable sort. Every candidate meets the same row bits through the same
ops, on the plain path and through the `gather_l2` kernel.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core.beam_search import rerank_frontier, sort_frontier

__all__ = [
    "FetchStats", "VectorStore", "rows_resident", "strip_rows",
    "attach_rows", "rows_staged", "build_host_rerank_plan",
    "build_shard_rerank", "tier_memory_stats",
    "TIER_STAT_KEYS",
]

# The per-tier residence keys memory_stats() reports: device codes vs
# device rows vs host rows, and the device-memory compression eviction buys.
TIER_STAT_KEYS = ("rows_tier", "device_rows_bytes", "device_codes_bytes",
                  "host_rows_bytes", "device_compression_ratio")


def tier_memory_stats(core, store, *, capacity: int,
                      store_dims: int) -> dict:
    """Per-tier resident bytes for one core (or a list of cores: a sharded
    index's shards, one replica each) + its VectorStore.

    device_compression_ratio is the effective device-memory compression:
    what the vector payload (f32 rows + sqnorm + packed codes) would cost
    fully device-resident, over what is device-resident now — 1.0 on the
    device tier, (rows+codes)/codes after eviction.
    """
    cores = list(core) if isinstance(core, (list, tuple)) else [core]
    rows_full = float(capacity * (store_dims + 1) * 4)  # f32 rows + sqnorm
    device_rows = rows_full if rows_resident(cores[0]) else 0.0
    codes = 0.0
    for c in (c.codes for c in cores if c.codes is not None):
        codes += float(sum(t.numel() * t.element_size()
                           for t in (c.packed, c.data_add, c.data_rescale)))
    stats = {"rows_tier": store.tier,
             "device_rows_bytes": device_rows,
             "device_codes_bytes": codes,
             "host_rows_bytes": float(store.host_bytes)}
    device_vec = device_rows + codes
    if device_vec:
        stats["device_compression_ratio"] = (rows_full + codes) / device_vec
    return stats


# ---------------------------------------------------------------------------
# Fetch accounting
# ---------------------------------------------------------------------------

@dataclass
class FetchStats:
    """Monotonic host-fetch counters (one per VectorStore).

    n_fetches counts gather calls (one per served host-tier batch);
    n_rows/n_bytes count only valid frontier entries (-1 slots cost
    nothing).
    """

    n_fetches: int = 0
    n_rows: int = 0
    n_bytes: int = 0
    total_s: float = 0.0
    last_s: float = 0.0
    last_rows: int = 0

    def record(self, rows: int, nbytes: int, dt: float) -> None:
        self.n_fetches += 1
        self.n_rows += int(rows)
        self.n_bytes += int(nbytes)
        self.total_s += float(dt)
        self.last_s = float(dt)
        self.last_rows = int(rows)

    def as_dict(self) -> dict:
        d = dict(self.__dict__)
        d["bytes_per_fetch"] = (self.n_bytes / self.n_fetches
                                if self.n_fetches else 0.0)
        return d


# ---------------------------------------------------------------------------
# Core row-residence helpers
# ---------------------------------------------------------------------------

def rows_resident(core) -> bool:
    """True when the core's f32 rows are device-resident tensors."""
    return core.vectors is not None


def strip_rows(core):
    """Evicted form of a core: rows become None."""
    return replace(core, vectors=None, vec_sqnorm=None)


def attach_rows(core, vectors: torch.Tensor, vec_sqnorm: torch.Tensor):
    """Inverse of `strip_rows` (staging / restore): copies of the rows on
    the core's device (non-blocking from pinned memory)."""
    dev = core.device
    return replace(core,
                   vectors=vectors.to(dev, torch.float32, non_blocking=True,
                                      copy=True),
                   vec_sqnorm=vec_sqnorm.to(dev, torch.float32,
                                            non_blocking=True, copy=True))


def _sync(t: torch.Tensor) -> None:
    """Wait for the current stream of `t`'s card (no-op on the CPU)."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


# ---------------------------------------------------------------------------
# The tier manager
# ---------------------------------------------------------------------------

class VectorStore:
    """Residence manager for one index's f32 rows (see module docstring).

    On tier "device" it holds nothing. On tier "host" it holds the
    canonical f32 rows + cached |row|^2 as CPU tensors — pinned when
    `pin` (an index on the card; a failed pin raises) — synced from every
    mutation through the staged write-through, and serves the rerank's
    fetch through `gather`.

    `fetch_hist` is an optional observability hook (the serving layer
    puts a `Histogram` there): every gather observes its latency in µs.
    """

    def __init__(self, tier: str = "device", *, pin: bool = False) -> None:
        if tier not in ("device", "host"):
            raise ValueError(f"rows tier must be device|host, got {tier!r}")
        self.tier = tier
        self.pin = pin
        self._vectors: torch.Tensor | None = None
        self._sqnorm: torch.Tensor | None = None
        # gather's pinned staging buffers by row count: [rows, sqnorm, the
        # events recorded after the copies that read them]
        self._staging: dict = {}
        self.fetch_stats = FetchStats()
        self.fetch_hist = None          # optional obs Histogram (us/gather)

    def _empty(self, shape) -> torch.Tensor:
        return torch.empty(shape, dtype=torch.float32, pin_memory=self.pin)

    # ------------------------------------------------------------- residence
    def sync_from(self, *cores) -> None:
        """Write-through: refresh the host rows from (staged) cores, whose
        rows laid end to end are the host rows (one core; or a sharded
        index's shard cores in order, each on its own device).
        Same-shaped rows are written into the existing buffers; new shapes
        (a grow) allocate new ones. Returns once the host copy is whole."""
        n = sum(c.vectors.shape[0] for c in cores)
        d = cores[0].vectors.shape[1]
        if self._vectors is None or self._vectors.shape != (n, d):
            self._vectors = self._empty((n, d))
            self._sqnorm = self._empty((n,))
        at = 0
        for c in cores:
            m = c.vectors.shape[0]
            self._vectors[at:at + m].copy_(c.vectors, non_blocking=True)
            self._sqnorm[at:at + m].copy_(c.vec_sqnorm, non_blocking=True)
            at += m
        for c in cores:
            _sync(c.vectors)

    def hold(self, *cores) -> None:
        """device -> host: copy the cores' rows here (`sync_from`) and
        take the host tier; the caller strips the rows off the cores."""
        if not all(rows_resident(c) for c in cores):
            raise ValueError("core rows are already evicted")
        self.sync_from(*cores)
        self.tier = "host"

    def release(self) -> None:
        """Back to the device tier, once the caller re-attached the rows:
        the host copy is dropped."""
        if self.tier != "host":
            raise ValueError("rows are already device-resident")
        self.tier = "device"
        self._vectors = self._sqnorm = None
        self._staging.clear()

    def evict(self, core):
        """device -> host: copy the rows here, return the stripped core."""
        self.hold(core)
        return strip_rows(core)

    def restore(self, core):
        """host -> device: re-attach the rows, drop the host copy."""
        if self.tier != "host":
            raise ValueError("rows are already device-resident")
        core = attach_rows(core, self._vectors, self._sqnorm)
        _sync(core.vectors)
        self.release()
        return core

    def attach(self, core, at: int = 0):
        """Staging attach (tier stays "host"; detach must follow): the
        host rows from row `at` on, as many as the core holds."""
        n = core.capacity
        return attach_rows(core, self._vectors[at:at + n],
                           self._sqnorm[at:at + n])

    def detach(self, core):
        """Staging detach: sync the host tier from the mutated core
        (write-through; capacity growth syncs for free) and strip."""
        self.sync_from(core)
        return strip_rows(core)

    # ----------------------------------------------------------- fetch path
    def _staging_for(self, m: int, d: int) -> list:
        """The pinned staging buffers for m rows, once no copy reads them."""
        buf = self._staging.get(m)
        if buf is None or buf[0].shape[1] != d:
            buf = self._staging[m] = [self._empty((m, d)), self._empty((m,)),
                                      []]
        for ev in buf[2]:
            ev.synchronize()
        buf[2] = []
        return buf

    def gather(self, positions) -> tuple[torch.Tensor, torch.Tensor]:
        """Fetch frontier rows for the host-tier rerank.

        positions: int array or CPU tensor (any shape) of row ids; -1
        marks invalid frontier slots. Returns (rows f32[M, D], sqnorm
        f32[M]) with M = positions.size, in flat order — invalid slots
        come back as zero rows (the rerank masks them to +inf). With
        pinned rows the result lies in a staging buffer kept for M rows,
        valid until the next gather of M rows (`upload` makes that gather
        wait for the copies that read it). Records fetch latency / bytes
        in `fetch_stats`.
        """
        if self.tier != "host":
            raise ValueError("gather on a device-tier store")
        t0 = time.perf_counter()
        pos = torch.as_tensor(np.asarray(positions)).reshape(-1).long()
        valid = pos >= 0
        safe = pos.clamp(min=0)
        if self.pin:
            rows, sq, _ = self._staging_for(pos.numel(),
                                            self._vectors.shape[1])
            torch.index_select(self._vectors, 0, safe, out=rows)
            torch.index_select(self._sqnorm, 0, safe, out=sq)
        else:
            rows = self._vectors.index_select(0, safe)
            sq = self._sqnorm.index_select(0, safe)
        bad = torch.nonzero(~valid).reshape(-1)
        if bad.numel():
            rows.index_fill_(0, bad, 0.0)
            sq.index_fill_(0, bad, 0.0)
        dt = time.perf_counter() - t0
        n_valid = pos.numel() - bad.numel()
        nbytes = n_valid * (self._vectors.shape[1] + 1) * 4
        self.fetch_stats.record(n_valid, nbytes, dt)
        if self.fetch_hist is not None:
            self.fetch_hist.observe(dt * 1e6)
        return rows, sq

    def upload(self, rows: torch.Tensor, sq: torch.Tensor,
               table: torch.Tensor, table_sq: torch.Tensor) -> None:
        """Copy gathered rows (a staging buffer, or a slice of one) into
        device tensors without blocking; the next gather into the same
        staging buffer waits for these copies."""
        table.copy_(rows, non_blocking=True)
        table_sq.copy_(sq, non_blocking=True)
        if not table.is_cuda:
            return
        held = rows.untyped_storage().data_ptr()
        for buf in self._staging.values():
            if buf[0].untyped_storage().data_ptr() == held:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(table.device))
                buf[2].append(ev)

    # ------------------------------------------------------------ accounting
    @property
    def host_bytes(self) -> int:
        """Host-resident row bytes (0 on the device tier)."""
        if self._vectors is None:
            return 0
        return int((self._vectors.numel() + self._sqnorm.numel()) * 4)

    def stats(self) -> dict:
        return {"tier": self.tier, "host_rows_bytes": self.host_bytes,
                **{f"fetch_{k}": v
                   for k, v in self.fetch_stats.as_dict().items()}}


@contextmanager
def rows_staged(index):
    """Write-through staging for mutations on a host-tier index.

    Attaches the host rows to `index.core`, yields (the mutation runs the
    unchanged core ops), then syncs the host tier from the result and
    strips the rows back off. Re-entrant: a no-op when the rows are
    already resident (device tier, or an outer staging block).
    """
    store = getattr(index, "store", None)
    if (store is None or store.tier != "host"
            or rows_resident(index.core)):
        yield
        return
    index.core = store.attach(index.core)
    try:
        yield
    finally:
        index.core = store.detach(index.core)


# ---------------------------------------------------------------------------
# The host-tier rerank (see the module docstring for its bit identity)
# ---------------------------------------------------------------------------

def build_host_rerank_plan(rspec):
    """The single-device host-tier rerank: (queries (Q, D), frontier ids
    (Q, L), gathered rows (Q*L, D), gathered sqnorm (Q*L,)) -> (ids (Q,
    k), dists (Q, k)), the exact epilogue `core_search` runs on the device
    tier. `core/plans.py` makes it a plan (captured on the card)."""

    def rerank(queries, frontier_ids, table, table_sqnorm):
        q_n, l = frontier_ids.shape
        flat = torch.arange(q_n * l, dtype=torch.int32,
                            device=frontier_ids.device).reshape(q_n, l)
        local = torch.where(frontier_ids >= 0, flat, torch.full_like(flat, -1))
        exact_d = rerank_frontier(table, table_sqnorm, queries, local,
                                  tile_q=rspec.rerank_tile,
                                  use_kernels=rspec.use_kernels)
        return sort_frontier(exact_d, frontier_ids, rspec.k)

    return rerank


def build_shard_rerank(rspec, *, id_stride: int, first_shard: int = 0):
    """The host-tier rerank of consecutive shards, unmerged: (queries (Q,
    D), their stacked frontier local ids (S', Q, L), gathered rows
    (S'*Q*L, D), gathered sqnorm (S'*Q*L,)) -> each shard's (GLOBAL ids,
    dists), stacked ((S', Q, k), (S', Q, k)); the first is shard
    `first_shard`.

    Each shard's block of the table is reranked by the single-device body
    (`build_host_rerank_plan`), exactly as that shard's device-tier search
    reranks (one `gather_l2` a shard with use_kernels), and its local ids
    become global."""
    single = build_host_rerank_plan(rspec)

    def rerank(queries, frontier_ids, table, table_sqnorm):
        s, q_n, l = frontier_ids.shape
        block = q_n * l
        ids, dists = [], []
        for i in range(s):
            a, b = single(queries, frontier_ids[i],
                          table[i * block:(i + 1) * block],
                          table_sqnorm[i * block:(i + 1) * block])
            ids.append(torch.where(a >= 0, a + (first_shard + i) * id_stride,
                                   torch.full_like(a, -1)))
            dists.append(b)
        return torch.stack(ids), torch.stack(dists)

    return rerank
