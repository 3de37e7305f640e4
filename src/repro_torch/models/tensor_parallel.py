"""Tensor-parallel compute on the "model" mesh axis for every family: the
attention-and-MLP families (dense, vlm, audio), the MoE family and the
SSM and hybrid families (xLSTM, Mamba2 with zamba2's shared attention):
the sharded train step, and serving (prefill, the encoder forward,
decode) under a serving plan.

JAX has no module of this name. There the models call `constrain` with
logical axis names (`src/repro/models/attention.py:55-65,153`,
`layers.py:88-90,105,122`, `model.py:164`), the rules table
(`src/repro/models/sharding_ctx.py:27-66`) maps "act_heads", "act_kv",
"act_ff", "act_vocab", "res_seq" and the fallback "attn_seq" to "model",
and XLA's partitioner inserts the collectives that split each block's
compute. The port's activations are plain local tensors (no DTensor
reaches a hand-written kernel), so this module is the counterpart of what
the partitioner inserts: the boundary operations, written by hand as
`torch.autograd.Function`s, each called at the port's counterpart of a
JAX `constrain` site (the call's comment cites it).

With the residual sequence-parallel ("res_seq" on "model", Megatron SP) a
rank carries (B, S/tp, D) between blocks:

  * `gather_seq`: all-gather of the sequence before a column-parallel
    projection (q/k/v on this rank's heads, the MLP's gate and up on its ff
    columns, the head on its vocabulary columns); the backward
    reduce-scatters the partial gradients. With `split_grad` the backward
    takes this rank's slice instead, for a gradient every rank holds whole;
  * `scatter_seq`: reduce-scatter of the sequence after a row-parallel
    projection (`wo`, `w_down`): the partial sums onto this rank's slice;
    the backward all-gathers;
  * where the kv heads do not tile the axis, attention is context parallel:
    q, k and v come from the rank's own slice and K/V are all-gathered
    (`gather_seq`), the queries at their global positions.

Under `no_sp` ("res_seq" None) the residual is whole on every rank:
`copy_to_region` (identity; the backward all-reduces) opens a
column-parallel region, `reduce_from_region` (all-reduce; identity
backward) closes a row-parallel one, and `split_seq` (this rank's slice;
the backward all-gathers) feeds the context-parallel attention.

The vocabulary is split too: `vocab_parallel_embed` looks up only this
rank's rows of the table (zeros elsewhere, then summed over the ranks), and
`vocab_parallel_cross_entropy` takes each row's max, sum of exponentials
and gold logit over the ranks' columns.

A MoE block splits its attention as the other families do and its experts
by JAX's two modes (`models/moe.py`): under global dispatch each rank runs
its E/tp experts on every token of its rows (the expert weights "local",
JAX's "expert" on "model"), under manual SPMD its own token slab with the
experts gathered whole; the router is gathered whole in both, and each
rank's share of the aux loss is summed over "model" (`reduce_from_region`)
so that its gradient counts once.

The SSM blocks split their inner width as JAX's rules split it
("ssm_inner" and "act_ssm" on "model", `src/repro/models/ssm.py:152-162,
264-273`), on the whole sequence (all-gathered under SP, since the
causal conv and the scans read all of it):

  * Mamba2: a rank computes its H/tp heads, i.e. its z, x and dt columns
    of the fused `in_proj`, plus the B and C columns that every head
    reads, whole; `in_proj` and the conv are gathered whole ("partial":
    their contiguous "model" shards are not a set of heads), the per-head
    vectors, the norm scale and `out_proj` stay on the rank's shard,
    which is exactly its heads ("local");
  * mLSTM: `w_up`, the conv and `w_o_gate` column-parallel on the rank's
    di/tp channels, `w_q`, `w_k`, `w_v`, `w_i` and `w_f` row-parallel:
    their partial sums reduce-scatter onto the rank's heads where the
    heads tile the axis (`Plan.ssm_heads`), else they are all-reduced and
    the cell runs whole on every rank, as JAX's `sanitize_shardings`
    leaves it (4 heads on 16), the rank then taking its di/tp channels of
    the cell's output (`split`, whose backward all-gathers, so the whole
    region sees the same gradient on every rank);
  * sLSTM: the recurrence whole on every rank (JAX: `("embed", None)`),
    its feed-forward column/row-parallel on the rank's ff/tp columns,
    entered with `copy_to_region`, so the recurrence's gradient is the
    summed one on every rank and its parameters are "replica".

The gated RMSNorm after a split cell covers all di channels: each rank's
sum of squares over its channels is summed over "model"
(`layers.rmsnorm` with `channel_sum`), and so is its backward's sum over
the channels (every rank's output reads the statistic).

`Plan` says what a unit splits and how each parameter's gradient sums over
"model" (`Plan.mode`, read by `models/fsdp.py`). At a "model" axis of size
1 there is no plan, and the step is the single-device step op for op.

Serving (`make_plan(..., serving=True)`) splits prefill as the train step
splits its forward, and decode as JAX's sharded `decode_step` lowers
(`src/repro/launch/shardings.py:63-73`): the decode state is this rank's
shard (`Plan.cache_shape`), its kv heads where they tile the axis
(`Plan.heads`), else its slice of the cache's sequence (split-KV). A
decode position is one token, so the residual is whole on every rank
(`Plan.whole`: the `no_sp` regions); on split-KV each rank scores the
new query against its slice and returns the partial softmax terms (m, l,
o), which `combine_over_model` all-gathers and
`combine_partials` merges. On the fallback the serving plan keeps the
attention weights' "model" shards too ("local"): decode projects q, k
and v column-parallel on them and all-gathers the columns, and prefill,
which projects its slice of the sequence, gathers the weights whole.
The decode state is the rank's shard (`Plan.ssm_state_shape`): its
Mamba2 heads, its mLSTM heads where they tile the axis, its channels of
the mLSTM conv; a Mamba2 conv state holds the channels the rank
convolves (its di/tp of x, then B and C whole), not JAX's contiguous
(di + 2n)/tp. A model of any family under `ShardedParams` on a model
axis larger than 1 without a plan is refused (`current`): it never
repeats the compute on the model ranks.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.models import fsdp
from repro_torch.models.sharding_ctx import (
    all_gather_tensor,
    model_group,
    model_rank,
    reduce_scatter_tensor,
    seq_parallel,
)

# the families whose units split their compute over the model axis: all
TP_FAMILIES = ("dense", "vlm", "audio", "moe", "ssm", "hybrid")


@dataclass(frozen=True)
class Plan:
    """The split of one sharded step over the "model" axis: its process
    group, size and this rank's coordinate; `sp`: the residual is
    sequence-parallel; `heads`: the kv heads tile the axis (else attention
    is context parallel); `vocab`: the padded vocab tiles it (d_ff, or a
    MoE config's expert count, always does: `make_plan` refuses a config
    where it does not); `experts`: a MoE rank computes on its E/tp experts
    (global dispatch) rather than its token slab with every expert
    (manual SPMD); `ssm_heads`: the SSM heads tile the axis, so a Mamba2
    or mLSTM cell runs on the rank's heads (an mLSTM cell whose heads do
    not runs whole on every rank; a Mamba2 one always tiles)."""

    group: object
    size: int
    rank: int
    sp: bool
    heads: bool
    vocab: bool
    serving: bool = False
    experts: bool = False
    ssm_heads: bool = False

    def mode(self, name: str) -> str:
        """How parameter `name` is used over "model": "local" (the unit
        computes on its "model" shard, which is not gathered), "partial"
        (gathered whole; each rank's gradient is a partial sum over its
        part of the sequence, summed over "model") or "replica" (every
        rank computes the same, as without a plan). Serving keeps the
        fallback's attention weights "local" too (decode projects on
        them). The expert weights are "local" under global dispatch, else
        "partial", as is the router. Mamba2's fused `in_proj` and its conv
        are "partial" (their shards are not heads), its other parameters
        "local"; the mLSTM's are "local" but for `f_bias`, "partial" where
        the cell splits by heads and "replica" where it runs whole; the
        sLSTM's recurrence is "replica", its feed-forward "local"."""
        parts = name.split(".")
        if "attn" in parts:
            return "local" if self.heads or self.serving else "partial"
        if "mlp" in parts:
            return "local"
        if "moe" in parts:
            return ("local" if self.experts and "router" not in parts
                    else "partial")
        if "mamba" in parts:
            return ("partial" if {"in_proj", "conv_w", "conv_b"} & set(parts)
                    else "local")
        if "mlstm" in parts:
            if "f_bias" in parts:
                return "partial" if self.ssm_heads else "replica"
            return "local"
        if "slstm" in parts:
            return ("local" if {"w_ff_up", "w_ff_down"} & set(parts)
                    else "replica")
        if parts[0] in ("embed", "unembed"):
            return "local" if self.vocab else "replica"
        # the norm scales and the frames projection
        return self._by_seq()

    def _by_seq(self) -> str:
        return "partial" if self.sp else "replica"

    def seq_slice(self, s: int) -> tuple[int, int]:
        """(start, length) of this rank's slice of a sequence of s."""
        if s % self.size:
            raise ValueError(f"sequence {s} does not split over a model axis "
                             f"of {self.size}")
        n = s // self.size
        return self.rank * n, n

    def whole(self) -> "Plan":
        """The plan with the residual whole on every rank (a decode
        position, a prefill's last one)."""
        return replace(self, sp=False)

    def cache_shape(self, shape: tuple) -> tuple:
        """This rank's shard of a (n, B, S_cache, Hk, Dh) cache: Hk/tp
        heads, or S_cache/tp slots (a cache that does not split over the
        axis is refused)."""
        n, b, s, hk, dh = shape
        if self.heads:
            return (n, b, s, hk // self.size, dh)
        if s % self.size:
            raise ValueError(f"a cache of {s} slots does not split over a "
                             f"model axis of {self.size}")
        return (n, b, s // self.size, hk, dh)

    def ssm_state_shape(self, cfg: ModelConfig, block: str, key: str,
                        shape: tuple) -> tuple:
        """This rank's shard of one layer's decode state leaf `key` of an
        SSM `block` ("mamba", "mlstm", "slstm"), rows first: Mamba2's "h"
        (B, H, N, P) its H/tp heads; its "conv" (B, K-1, di + 2n) the
        channels it convolves, di/tp + 2n (its x channels, then B and C
        whole: JAX's contiguous (di + 2n)/tp are not heads); the mLSTM's
        "c", "n", "m" (B, H, ...) its H/tp heads where they tile the axis,
        else whole; its "conv" (B, 3, di) its di/tp channels; the sLSTM's
        whole."""
        if block == "slstm":
            return shape
        if key == "conv":
            ch = shape[-1]
            whole = 2 * cfg.ssm_state_dim if block == "mamba" else 0
            return (*shape[:-1], (ch - whole) // self.size + whole)
        if block == "mamba" or self.ssm_heads:
            return (shape[0], shape[1] // self.size, *shape[2:])
        return shape


def _tiles(cfg: ModelConfig) -> list[tuple[str, int]]:
    """The widths the family's plan splits over the model axis."""
    if cfg.family == "moe":
        return [("the expert count", cfg.num_experts)]
    if cfg.family == "hybrid":
        return [("the SSM head count", cfg.n_ssm_heads),
                ("d_inner", cfg.d_inner),
                ("the kv head count", cfg.num_kv_heads)]
    if cfg.family == "ssm":
        from repro_torch.models.ssm import slstm_ff_width
        return [("the mLSTM width", 2 * cfg.d_model),
                ("the sLSTM feed-forward width", slstm_ff_width(cfg))]
    return [("d_ff", cfg.d_ff)]


def make_plan(cfg: ModelConfig, mesh, serving: bool = False) -> Plan | None:
    """The plan of `cfg` on `mesh` under the installed sharding rules (call
    within `sharding_rules`); None where the "model" axis has size 1 or
    the family is not split. A width the family splits that does not tile
    the axis is refused, as a sequence that does not split is
    (`seq_slice`): d_ff; a MoE config's expert count; zamba2's SSM heads,
    d_inner and the shared block's kv heads; xLSTM's mLSTM width (2·D)
    and sLSTM feed-forward width. Every configuration's tile 16.
    `serving`: the plan of prefill and decode (see the module note)."""
    size, rank = model_rank(mesh)
    if size == 1 or cfg.family not in TP_FAMILIES:
        return None
    for what, n in _tiles(cfg):
        if n % size:
            raise ValueError(f"{what} {n} does not split over a model axis "
                             f"of {size}")
    return Plan(group=model_group(mesh), size=size, rank=rank,
                sp=seq_parallel(), heads=cfg.num_kv_heads % size == 0,
                vocab=cfg.padded_vocab % size == 0, serving=serving,
                experts=(cfg.family == "moe"
                         and cfg.moe_dispatch_chunks != -1),
                ssm_heads=(cfg.family in ("ssm", "hybrid")
                           and cfg.n_ssm_heads % size == 0))


def current(cfg: ModelConfig) -> Plan | None:
    """The active `ShardedParams`' plan (`models/fsdp.py`) for a model of
    `cfg`; None outside the sharded step or without one. A model of any
    family (`TP_FAMILIES`) on a model axis larger than 1 without a plan is
    refused: it would repeat the whole compute on every model rank."""
    sp = fsdp.active()
    if sp is None:
        return None
    size = dict((a, s) for a, s, _ in sp.axes).get("model", 1)
    if sp.plan is None and size > 1 and cfg.family in TP_FAMILIES:
        raise ValueError(f"a {cfg.family} model on a model axis of {size} "
                         "needs its tensor-parallel plan (make_plan)")
    return sp.plan


# ------------------------------------------------------------ collectives
def all_gather(x: torch.Tensor, plan: Plan, dim: int) -> torch.Tensor:
    """The model ranks' blocks of `x` concatenated along `dim` in rank
    order (no autograd: the train step's regions wrap it)."""
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((plan.size * moved.shape[0], *moved.shape[1:]))
    all_gather_tensor(out, moved, group=plan.group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, plan: Plan, dim: int) -> torch.Tensor:
    if x.shape[dim] % plan.size:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split over a model axis of {plan.size}")
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // plan.size, *moved.shape[1:]))
    reduce_scatter_tensor(out, moved, group=plan.group)
    return out.movedim(0, dim)


def _slice(x: torch.Tensor, plan: Plan, dim: int) -> torch.Tensor:
    start, n = plan.seq_slice(x.shape[dim])
    return x.narrow(dim, start, n).contiguous()


def all_reduce(x: torch.Tensor, plan: Plan) -> torch.Tensor:
    """x summed over the model ranks, a copy (no autograd)."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=plan.group)
    return out


def channel_sum(plan: Plan | None):
    """`layers.rmsnorm`'s `reduce` for a width split over "model": a
    channel sum summed over the model ranks; None without a plan."""
    return None if plan is None else partial(all_reduce, plan=plan)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan, split_grad):
        ctx.plan, ctx.split_grad = plan, split_grad
        return all_gather(x, plan, 1)

    @staticmethod
    def backward(ctx, g):
        op = _slice if ctx.split_grad else _reduce_scatter
        return op(g, ctx.plan, 1), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan, dim):
        ctx.plan, ctx.dim = plan, dim
        return _reduce_scatter(x, plan, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.plan, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan, dim):
        ctx.plan, ctx.dim = plan, dim
        return _slice(x, plan, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.plan, ctx.dim), None, None


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.plan), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan):
        return all_reduce(x, plan)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_seq(x: torch.Tensor, plan: Plan, split_grad: bool = False
               ) -> torch.Tensor:
    """(B, S/tp, ...) -> (B, S, ...): the sequence all-gathered over
    "model"; the backward reduce-scatters the gradient (`split_grad`:
    takes this rank's slice of it, where every rank holds it whole)."""
    return _GatherSeq.apply(x, plan, split_grad)


def scatter_seq(x: torch.Tensor, plan: Plan) -> torch.Tensor:
    """(B, S, ...) partial sums -> (B, S/tp, ...): reduce-scattered over
    "model"; the backward all-gathers."""
    return reduce_scatter(x, plan, 1)


def reduce_scatter(x: torch.Tensor, plan: Plan, dim: int) -> torch.Tensor:
    """Partial sums -> this rank's block of their sum over "model" along
    `dim`; the backward all-gathers."""
    return _ReduceScatter.apply(x, plan, dim)


def split_seq(x: torch.Tensor, plan: Plan) -> torch.Tensor:
    """(B, S, ...) whole on every rank -> this rank's (B, S/tp, ...) slice;
    the backward all-gathers."""
    return split(x, plan, 1)


def split(x: torch.Tensor, plan: Plan, dim: int) -> torch.Tensor:
    """A tensor whole on every rank -> this rank's block along `dim`; the
    backward all-gathers, so the region that computed it whole sees the
    same (whole) gradient on every rank."""
    return _Split.apply(x, plan, dim)


def copy_to_region(x: torch.Tensor, plan: Plan) -> torch.Tensor:
    """The identity; the backward all-reduces over "model" (no_sp)."""
    return _CopyToRegion.apply(x, plan)


def reduce_from_region(x: torch.Tensor, plan: Plan) -> torch.Tensor:
    """The sum over "model"; the backward is the identity (no_sp)."""
    return _ReduceFromRegion.apply(x, plan)


def enter_columns(x: torch.Tensor, plan: Plan) -> torch.Tensor:
    """The residual stream (this rank's slice under SP, else whole) as the
    whole-sequence input of a column-parallel projection."""
    return gather_seq(x, plan) if plan.sp else copy_to_region(x, plan)


def leave_rows(x: torch.Tensor, plan: Plan) -> torch.Tensor:
    """A row-parallel projection's partial sums as the residual stream."""
    return scatter_seq(x, plan) if plan.sp else reduce_from_region(x, plan)


# ---------------------------------------------------------------- serving
def last_position(x: torch.Tensor, plan: Plan) -> torch.Tensor:
    """(B, 1, D): the residual's last position, on every rank; under SP
    it is the last rank's last row (`src/repro/models/model.py:455`)."""
    last = x[:, -1:]
    return all_gather(last, plan, 1)[:, -1:] if plan.sp else last


def combine_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor
                     ) -> torch.Tensor:
    """Softmax-weighted V over a sequence from its slices' partial terms,
    stacked on a leading axis of R slices, float32: m (R, ...) a slice's
    row max of the scores (-1e30 where none of its slots is valid), l (R,
    ...) its sum of exp(s - m) over the valid slots (0 for an empty
    slice), o (R, ..., Dh) its sum of exp(s - m)·v. A slice weighs
    exp(m_r - max m), so an empty one adds nothing. Returns (..., Dh)."""
    top = m.amax(0)
    w = torch.exp(m - top)
    total = (w * l).sum(0)
    acc = (w[..., None] * o).sum(0)
    return acc / torch.clamp(total, min=1e-30)[..., None]


def combine_over_model(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                       plan: Plan) -> torch.Tensor:
    """`combine_partials` of every model rank's (m, l, o), all-gathered in
    one collective (2 + Dh floats a row and head)."""
    packed = torch.cat([m[..., None], l[..., None], o], -1)
    parts = all_gather(packed[None], plan, 0)
    return combine_partials(parts[..., 0], parts[..., 1], parts[..., 2:])


# ------------------------------------------------------------- vocabulary
def vocab_parallel_embed(table: torch.Tensor, tokens: torch.Tensor,
                         dtype: torch.dtype, plan: Plan) -> torch.Tensor:
    """The embedding of `tokens` (B, S) from this rank's rows of the table
    ((padded V / tp, D)): its own tokens looked up, the others zeros,
    summed over "model" onto the rank's slice of the sequence (whole under
    no_sp). A negative id counts from the end, as the whole table's
    lookup takes it."""
    n = table.shape[0]
    ids = tokens.long()
    ids = torch.where(ids < 0, ids + n * plan.size, ids) - plan.rank * n
    own = (ids >= 0) & (ids < n)
    out = table.to(dtype)[ids.clamp(0, n - 1)].masked_fill(~own[..., None],
                                                           0)
    return leave_rows(out, plan)


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 vocab_size: int, plan: Plan,
                                 chunk_bytes: int) -> torch.Tensor:
    """Mean cross-entropy over the labels >= 0 from this rank's columns of
    the logits ((B, S, padded V / tp), the whole sequence), in float32,
    the padding columns past `vocab_size` (global indices) at -1e30, in
    row chunks of at most `chunk_bytes` of float32 logits. The same loss on
    every rank of "model"."""
    return _VocabParallelCE.apply(logits, labels, vocab_size, plan,
                                  chunk_bytes)


class _VocabParallelCE(torch.autograd.Function):
    """Each chunk's row max and sum of exponentials are all-reduced over
    "model" (max, then sum), the gold logit comes from the rank that owns
    its column; the backward needs no collective: a rank's gradient is
    its own columns'."""

    @staticmethod
    def _spans(rows: torch.Tensor, chunk_bytes: int):
        step = max(1, chunk_bytes // (4 * rows.shape[-1]))
        return [(i, min(i + step, len(rows)))
                for i in range(0, len(rows), step)]

    @staticmethod
    def _float(chunk, lo, vocab_size):
        cols = torch.arange(chunk.shape[-1], device=chunk.device) + lo
        return chunk.float().masked_fill(cols >= vocab_size, -1e30)

    @staticmethod
    def forward(ctx, logits, labels, vocab_size, plan, chunk_bytes):
        labels = labels.long()
        rows = logits.reshape(-1, logits.shape[-1])
        n = rows.shape[-1]
        lo = plan.rank * n
        flat = labels.reshape(-1)
        local = flat.clamp(min=0) - lo
        own = (local >= 0) & (local < n)
        logz = torch.empty(len(rows), dtype=torch.float32,
                           device=logits.device)
        gold = torch.empty_like(logz)
        for a, b in _VocabParallelCE._spans(rows, chunk_bytes):
            lf = _VocabParallelCE._float(rows[a:b], lo, vocab_size)
            m = lf.amax(-1)
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=plan.group)
            sums = torch.stack([
                torch.exp(lf - m[:, None]).sum(-1),
                torch.gather(lf, -1, local[a:b].clamp(0, n - 1)[:, None]
                             )[:, 0].masked_fill(~own[a:b], 0)])
            dist.all_reduce(sums, group=plan.group)
            logz[a:b] = m + torch.log(sums[0])
            gold[a:b] = sums[1]
            del lf
        valid = (labels >= 0).float()
        count = valid.sum().clamp(min=1.0)
        loss = ((logz.reshape(labels.shape) - gold.reshape(labels.shape))
                * valid).sum() / count
        ctx.save_for_backward(logits, labels, logz, count)
        ctx.vocab_size, ctx.plan, ctx.chunk_bytes = (vocab_size, plan,
                                                     chunk_bytes)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, logz, count = ctx.saved_tensors
        rows = logits.reshape(-1, logits.shape[-1])
        n = rows.shape[-1]
        lo = ctx.plan.rank * n
        flat = labels.reshape(-1)
        local = flat.clamp(min=0) - lo
        own = (local >= 0) & (local < n)
        w = (g / count) * (flat >= 0).float()
        grad = torch.empty_like(rows)
        for a, b in _VocabParallelCE._spans(rows, ctx.chunk_bytes):
            lf = _VocabParallelCE._float(rows[a:b], lo, ctx.vocab_size)
            d = w[a:b, None] * torch.exp(lf - logz[a:b, None])
            del lf
            d = d + torch.zeros_like(d).scatter_add_(
                -1, local[a:b].clamp(0, n - 1)[:, None],
                (-w[a:b] * own[a:b].float())[:, None])
            cols = torch.arange(n, device=d.device) + lo
            grad[a:b] = d.masked_fill_(cols >= ctx.vocab_size, 0)
        return grad.reshape(logits.shape), None, None, None, None
