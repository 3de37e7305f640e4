"""Model assembly: init / forward / loss / prefill / decode for all ten
architectures (PyTorch port of `repro.models.model`).

Families, as in the JAX package:
  dense/vlm/audio  pre-norm GQA attention + SwiGLU MLP (`blocks`); vlm
                   reads token ids (its image frontend is a stub of the
                   spec), audio precomputed frames through `frontend.proj`
                   and attends bidirectionally (an encoder: no decode)
  moe              pre-norm GQA attention + top-k routed experts
                   (`models/moe.py`); the loss adds AUX_LOSS_WEIGHT x the
                   summed load-balance losses
  ssm (xlstm)      (mLSTM, sLSTM) pairs (`pairs`, `models/ssm.py`)
  hybrid (zamba2)  groups of `attn_every` Mamba2 blocks (`mamba_groups`),
                   each group followed by ONE attention block shared by
                   every group (`shared_attn`), with a KV cache per
                   application
The JAX package stacks the layers along leading axes and scans them; here
they are `nn.ModuleList`s walked by Python loops (`models/convert.py`
splits JAX's stacked trees). `cfg.remat == "full"` wraps each block, pair
or group in `torch.utils.checkpoint` under autograd, as `_maybe_remat`
wraps the scan body. Each such unit, the embedding and the head run
inside `models/fsdp.py`'s `gathered`, which in the sharded train step
swaps in the unit's parameters gathered from their shards (a no-op
elsewhere). There every family also splits its compute over the model
axis (`models/tensor_parallel.py`'s plan, JAX's `constrain` sites; a MoE
rank its experts or its token slab, `models/moe.py`; an SSM block its
heads or channels, `models/ssm.py`): the residual between units is this
rank's slice of the sequence, and the logits are this rank's vocabulary
columns, which `loss_fn` reduces with the vocab-parallel cross-entropy.

Decode threads an explicit state dict, the JAX package's: {"k", "v": (L,
B, S_cache, Hk, Dh) caches in `cfg.dtype`, "pos": int} for the attention
families; {"mlstm", "slstm": dicts of (L/2, ...) float32 states, "pos"}
for ssm; {"mamba": dict of (groups, attn_every, ...) float32 states, "k",
"v": (groups, ...) caches, "pos"} for hybrid. `prefill` and `decode_step`
write the caches and states in place (see `decode_attention`).

Entry points that create state (`init_params`, `init_decode_state`) run on
the card unless given `device="cpu"`; with no GPU they raise.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import fsdp
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import tensor_parallel as tpm
from repro_torch.models.fsdp import gathered
from repro_torch.models.attention import (
    Attention,
    attention,
    attention_init,
    attention_spec,
    decode_attention,
)
from repro_torch.models.layers import (
    MLP,
    Embedding,
    RMSNorm,
    Unembed,
    _init_linear,
    dense,
    embed,
    embedding_init,
    embedding_spec,
    mlp,
    mlp_init,
    mlp_spec,
    rmsnorm,
    rmsnorm_init,
    rmsnorm_spec,
    torch_dtype,
    unembed,
    unembed_init,
    unembed_spec,
)
from repro_torch.models.moe import MoE, moe_init, moe_spec, moe_with_aux

FAMILIES = ("dense", "vlm", "audio", "moe", "ssm", "hybrid")
AUX_LOSS_WEIGHT = 0.01


class Block(nn.Module):
    """Attention + MLP (dense, vlm, audio) or + routed experts (moe)."""

    def __init__(self, ln1: RMSNorm, attn: Attention, ln2: RMSNorm,
                 mlp: MLP | None = None, moe: MoE | None = None):
        super().__init__()
        self.ln1, self.attn, self.ln2 = ln1, attn, ln2
        self.mlp, self.moe = mlp, moe


class Pair(nn.Module):
    """One xLSTM pair: an mLSTM block, then an sLSTM block."""

    def __init__(self, ln1: RMSNorm, mlstm: ssm_mod.MLSTM, ln2: RMSNorm,
                 slstm: ssm_mod.SLSTM):
        super().__init__()
        self.ln1, self.mlstm, self.ln2, self.slstm = ln1, mlstm, ln2, slstm


class MambaLayer(nn.Module):
    def __init__(self, ln: RMSNorm, mamba: ssm_mod.Mamba2):
        super().__init__()
        self.ln, self.mamba = ln, mamba


class SharedAttention(nn.Module):
    def __init__(self, ln: RMSNorm, attn: Attention):
        super().__init__()
        self.ln, self.attn = ln, attn


class Frontend(nn.Module):
    """The frames frontend: one (D, D) projection of precomputed frame
    embeddings."""

    def __init__(self, proj: nn.Linear):
        super().__init__()
        self.proj = proj


class Model(nn.Module):
    """The parameters of one architecture: `embed` (token frontends) or
    `frontend` (frames); the family's layers (`blocks`, `pairs`, or
    `mamba_groups` + `shared_attn`); `final_norm`; `unembed` (None when
    the embeddings are tied). `cfg` is the configuration the layout
    follows."""

    def __init__(self, cfg: ModelConfig, final_norm: RMSNorm,
                 unembed: Unembed | None, *, embed: Embedding | None = None,
                 frontend: Frontend | None = None, blocks=None, pairs=None,
                 mamba_groups=None,
                 shared_attn: SharedAttention | None = None):
        super().__init__()
        self.cfg = cfg
        self.embed, self.frontend = embed, frontend
        self.blocks = None if blocks is None else nn.ModuleList(blocks)
        self.pairs = None if pairs is None else nn.ModuleList(pairs)
        self.mamba_groups = (None if mamba_groups is None else nn.ModuleList(
            nn.ModuleList(g) for g in mamba_groups))
        self.shared_attn = shared_attn
        self.final_norm = final_norm
        self.unembed = unembed

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device


# ================================================================== init
def init_params(cfg: ModelConfig, generator: torch.Generator | int = 0,
                device=None, param_dtype: torch.dtype | None = None) -> Model:
    """Random parameters from a seed (or a generator on `device`), frozen:
    matrices in `param_dtype` (None: `cfg.dtype`, the serving storage;
    torch.float32: training's master weights, the same draws); norm
    scales, and what the JAX package reads in float32 (the MoE router, the
    SSM blocks' conv kernels and vectors), float32."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on "
                         f"{dev}")
    gen, dt = generator, param_dtype

    def norm():
        return rmsnorm_init(cfg, device=dev)

    kw: dict = {}
    if cfg.frontend == "frames":
        kw["frontend"] = Frontend(_init_linear(gen, cfg, cfg.d_model,
                                               cfg.d_model, dt))
    else:
        kw["embed"] = embedding_init(gen, cfg, dt)
    unemb = None if cfg.tie_embeddings else unembed_init(gen, cfg, dt)
    fam = cfg.family
    if fam == "moe":
        kw["blocks"] = [Block(norm(), attention_init(gen, cfg, dt), norm(),
                              moe=moe_init(gen, cfg, dt))
                        for _ in range(cfg.num_layers)]
    elif fam == "ssm":
        kw["pairs"] = [Pair(norm(), ssm_mod.mlstm_init(gen, cfg, dt), norm(),
                            ssm_mod.slstm_init(gen, cfg, dt))
                       for _ in range(cfg.num_layers // 2)]
    elif fam == "hybrid":
        kw["mamba_groups"] = [
            [MambaLayer(norm(), ssm_mod.mamba2_init(gen, cfg, dt))
             for _ in range(cfg.attn_every)]
            for _ in range(cfg.num_layers // cfg.attn_every)]
        kw["shared_attn"] = SharedAttention(norm(),
                                            attention_init(gen, cfg, dt))
    else:
        kw["blocks"] = [Block(norm(), attention_init(gen, cfg, dt), norm(),
                              mlp=mlp_init(gen, cfg, dtype=dt))
                        for _ in range(cfg.num_layers)]
    return Model(cfg, norm(), unemb, **kw)


def param_count(params: Model) -> int:
    return sum(p.numel() for p in params.parameters())


# ============================================ logical sharding names
def _prepend_spec(tree, axis_name=None):
    """Every spec of `tree` with one leading (stacked-axis) name."""
    if isinstance(tree, dict):
        return {k: _prepend_spec(v, axis_name) for k, v in tree.items()}
    return (axis_name,) + tuple(tree)


def param_specs(cfg: ModelConfig) -> dict:
    """Logical-axis names of every parameter, in the JAX package's tree
    (layers stacked, (in, out) matrices): `repro.models.param_specs`.
    `models/convert.py` `named_specs` keys them by the port's names."""
    specs: dict = {"final_norm": rmsnorm_spec(cfg)}
    if cfg.frontend == "frames":
        specs["frontend"] = {"proj": ("embed", None)}
    else:
        specs["embed"] = embedding_spec(cfg)
    if not cfg.tie_embeddings:
        specs["unembed"] = unembed_spec(cfg)
    fam = cfg.family
    if fam in ("dense", "vlm", "audio", "moe"):
        blk = {"ln1": rmsnorm_spec(cfg), "ln2": rmsnorm_spec(cfg),
               "attn": attention_spec(cfg)}
        blk["moe" if fam == "moe" else "mlp"] = (
            moe_spec(cfg) if fam == "moe" else mlp_spec(cfg))
        specs["blocks"] = _prepend_spec(blk)
    elif fam == "ssm":
        specs["pairs"] = _prepend_spec({
            "ln1": rmsnorm_spec(cfg), "mlstm": ssm_mod.mlstm_spec(cfg),
            "ln2": rmsnorm_spec(cfg), "slstm": ssm_mod.slstm_spec(cfg)})
    elif fam == "hybrid":
        mam = {"ln": rmsnorm_spec(cfg), "mamba": ssm_mod.mamba2_spec(cfg)}
        specs["mamba_groups"] = _prepend_spec(_prepend_spec(mam))
        specs["shared_attn"] = {"ln": rmsnorm_spec(cfg),
                                "attn": attention_spec(cfg)}
    return specs


# ================================================================ forward
def _embed_inputs(params: Model, cfg: ModelConfig, batch: dict,
                  tp: "tpm.Plan | None" = None) -> torch.Tensor:
    """The residual stream's start; under a sequence-parallel plan this
    rank's slice of it."""
    if cfg.frontend == "frames":
        x = torch.as_tensor(batch["frames"], device=params.device)
        if tp is not None and tp.sp:
            # src/repro/models/model.py:164: the projection's output on
            # "res_seq", so this rank projects its own frames
            x = x.narrow(1, *tp.seq_slice(x.shape[1]))
        with gathered(params.frontend):
            return dense(x.to(torch_dtype(cfg)), params.frontend.proj)
    tokens = torch.as_tensor(batch["tokens"], device=params.device)
    with gathered(params.embed):
        return embed(params.embed, tokens, cfg, tp)


def _logits(params: Model, cfg: ModelConfig, x: torch.Tensor,
            tp: "tpm.Plan | None" = None) -> torch.Tensor:
    """The final norm (on this rank's slice under SP) and the head: under
    a plan, this rank's vocabulary columns over the whole sequence."""
    tied = params.embed if cfg.tie_embeddings else None
    with gathered(params.final_norm, params.unembed, tied):
        x = rmsnorm(params.final_norm, x, cfg.norm_eps)
        return unembed(params.unembed, x, cfg, embed_params=params.embed,
                       tp=tp)


def _positions(s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None, :]


def _ffn(blk: Block, x: torch.Tensor, cfg: ModelConfig,
         tp: "tpm.Plan | None" = None):
    """The block's second half on its normed input: (out, aux loss or
    None)."""
    h = rmsnorm(blk.ln2, x, cfg.norm_eps)
    if blk.moe is not None:
        return moe_with_aux(blk.moe, h, cfg, tp)
    return mlp(blk.mlp, h, cfg, tp), None


def _block(blk: Block, x, cfg: ModelConfig, positions, tp=None):
    """Under a tensor-parallel plan x is the residual as the plan carries
    it (this rank's slice under SP); the norms run on it as it is."""
    x = x + attention(blk.attn, rmsnorm(blk.ln1, x, cfg.norm_eps), cfg,
                      positions, tp=tp)
    h, aux = _ffn(blk, x, cfg, tp)
    return x + h, aux


def _pair(pair: Pair, x, cfg: ModelConfig, positions, tp=None):
    eps = cfg.norm_eps
    x = x + ssm_mod.mlstm_forward(pair.mlstm, rmsnorm(pair.ln1, x, eps), cfg,
                                  tp=tp)
    x = x + ssm_mod.slstm_forward(pair.slstm, rmsnorm(pair.ln2, x, eps), cfg,
                                  tp=tp)
    return x, None


def _group(group: nn.ModuleList, shared: SharedAttention, x,
           cfg: ModelConfig, positions, tp=None):
    eps = cfg.norm_eps
    for layer in group:
        x = x + ssm_mod.mamba2_forward(layer.mamba, rmsnorm(layer.ln, x, eps),
                                       cfg, tp=tp)
    x = x + attention(shared.attn, rmsnorm(shared.ln, x, eps), cfg, positions,
                      tp=tp)
    return x, None


def _layers(params: Model) -> list[tuple]:
    """(apply fn, its leading arguments) for each remat unit, in order."""
    if params.pairs is not None:
        return [(_pair, (p,)) for p in params.pairs]
    if params.mamba_groups is not None:
        return [(_group, (g, params.shared_attn))
                for g in params.mamba_groups]
    return [(_block, (b,)) for b in params.blocks]


def _unit(fn, args, x, cfg: ModelConfig, positions, pack: bool,
          ctx: tuple):
    """One remat unit with its parameters gathered (`models/fsdp.py`; a
    no-op outside the sharded train step), under `ctx`, the forward's
    `fsdp.context()`: a remat recompute may run on another thread, and
    replays the forward's collectives under it."""
    with fsdp.restored(ctx), fsdp.gathered(*args, pack=pack):
        return fn(*args, x, cfg, positions, tpm.current(cfg))


def forward(params: Model, cfg: ModelConfig, batch: dict,
            with_aux: bool = False, return_hidden: bool = False):
    """Full-sequence forward. batch: {"tokens": (B, S)} or {"frames": (B,
    S, D)}. Returns logits (B, S, padded V) [, the summed MoE aux loss,
    float32, 0 for the other families]; return_hidden=True returns the
    final-norm hidden states instead (retrieval embeddings for
    serving/rag.py). Under a tensor-parallel plan (the sharded train
    step) the logits are this rank's vocabulary columns."""
    tp = tpm.current(cfg)
    x = _embed_inputs(params, cfg, batch, tp)
    # the units under a plan place their own positions
    positions = _positions(x.shape[1], x.device)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ctx = fsdp.context()
    for fn, args in _layers(params):
        if remat:
            # the recompute in the backward re-runs the unit's forward
            # (and so relaunches the flash forward #11, and gathers again)
            x, a = checkpoint(_unit, fn, args, x, cfg, positions, False, ctx,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = _unit(fn, args, x, cfg, positions, True, ctx)
        if a is not None:
            aux = aux + a
    if return_hidden:
        out = rmsnorm(params.final_norm, x, cfg.norm_eps)
        if tp is not None and tp.sp:
            out = tpm.gather_seq(out, tp, split_grad=True)
    else:
        out = _logits(params, cfg, x, tp)
    return (out, aux) if with_aux else out


def loss_fn(params: Model, cfg: ModelConfig, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """Mean next-token (or frame-label) cross-entropy + AUX_LOSS_WEIGHT *
    aux (JAX `model.py:233-252`). batch: {"tokens" or "frames", "labels":
    (B, S) int}; negative labels are masked out. Logits in float32, the
    vocab padding columns at -1e30. Returns (total, {"ce", "aux"})."""
    logits, aux = forward(params, cfg, batch, with_aux=True)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    loss = cross_entropy(logits, labels, cfg.vocab_size, tpm.current(cfg))
    return loss + AUX_LOSS_WEIGHT * aux, {"ce": loss, "aux": aux}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int, tp: "tpm.Plan | None" = None
                  ) -> torch.Tensor:
    """Mean cross-entropy over the labels >= 0, in float32, the padding
    columns past `vocab_size` at -1e30 (`_CrossEntropy`); under a plan
    whose padded vocab tiles the model axis, from this rank's columns
    (`tensor_parallel.vocab_parallel_cross_entropy`)."""
    if tp is not None and tp.vocab:
        return tpm.vocab_parallel_cross_entropy(logits, labels, vocab_size,
                                                tp, CE_CHUNK_BYTES)
    return _CrossEntropy.apply(logits, labels, vocab_size)


# rows of float32 logits a chunk of `_CrossEntropy` may hold (1 GiB)
CE_CHUNK_BYTES = 1 << 30


class _CrossEntropy(torch.autograd.Function):
    """The cross-entropy in chunks of rows, so that no float32 copy of the
    whole (B, S, V) logits is held: the forward keeps the logits as given
    (bf16 in training) and each row's log-partition, and the backward
    recomputes each chunk's softmax in float32 and writes its gradient in
    the logits' dtype. With one chunk it does the ops autograd does on the
    plain formula (float32 copy, logsumexp, gather; their gradients
    exp(l - logz)·w and the gold column's -w, summed, then cast), so the
    values are the same bit for bit."""

    @staticmethod
    def _chunks(logits: torch.Tensor):
        rows = logits.reshape(-1, logits.shape[-1])
        step = max(1, CE_CHUNK_BYTES // (4 * rows.shape[-1]))
        return rows, [(i, min(i + step, len(rows)))
                      for i in range(0, len(rows), step)]

    @staticmethod
    def _float(chunk: torch.Tensor, vocab_size: int) -> torch.Tensor:
        pad = torch.arange(chunk.shape[-1], device=chunk.device) >= vocab_size
        return chunk.float().masked_fill(pad, -1e30)

    @staticmethod
    def forward(ctx, logits, labels, vocab_size):
        labels = labels.long()
        rows, spans = _CrossEntropy._chunks(logits)
        flat = labels.reshape(-1)
        logz = torch.empty(len(rows), dtype=torch.float32,
                           device=logits.device)
        gold = torch.empty_like(logz)
        for a, b in spans:
            lf = _CrossEntropy._float(rows[a:b], vocab_size)
            logz[a:b] = torch.logsumexp(lf, dim=-1)
            gold[a:b] = torch.gather(lf, -1, flat[a:b].clamp(min=0)[:, None]
                                     )[:, 0]
            del lf
        valid = (labels >= 0).float()
        count = valid.sum().clamp(min=1.0)
        loss = ((logz.reshape(labels.shape) - gold.reshape(labels.shape))
                * valid).sum() / count
        ctx.save_for_backward(logits, labels, logz, count)
        ctx.vocab_size = vocab_size
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, logz, count = ctx.saved_tensors
        rows, spans = _CrossEntropy._chunks(logits)
        flat = labels.reshape(-1)
        # d loss / d (logz - gold) a row, as autograd forms it
        w = (g / count) * (flat >= 0).float()
        grad = torch.empty_like(rows)
        for a, b in spans:
            lf = _CrossEntropy._float(rows[a:b], ctx.vocab_size)
            d = w[a:b, None] * torch.exp(lf - logz[a:b, None])
            del lf
            d = d + torch.zeros_like(d).scatter_add_(
                -1, flat[a:b].clamp(min=0)[:, None], -w[a:b, None])
            pad = torch.arange(d.shape[-1], device=d.device) \
                >= ctx.vocab_size
            grad[a:b] = d.masked_fill_(pad, 0)
        return grad.reshape(logits.shape), None, None


# ================================================================= decode
def _kv_shape(cfg: ModelConfig, batch: int, max_len: int, n_stack: int):
    window = cfg.sliding_window
    s = min(max_len, window) if window else max_len
    return (n_stack, batch, s, cfg.num_kv_heads, cfg.head_dim)


def _stacked(one: dict, *lead: int) -> dict:
    """A layer's state dict stacked along leading axes of sizes `lead`."""
    return {k: v.expand(*lead, *v.shape).clone() for k, v in one.items()}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device=None, tp: "tpm.Plan | None" = None) -> dict:
    """The family's zero decode state at pos 0: KV caches (n, B, S_cache,
    Hk, Dh) in cfg.dtype, recurrent states float32. Under a serving plan
    (`tp`; None: the active one, `tensor_parallel.current`) only this
    rank's shard: Hk/tp heads or S_cache/tp slots of the caches
    (`Plan.cache_shape`), its heads and channels of the SSM states
    (`Plan.ssm_state_shape`); `batch` is the rows the rank runs."""
    if cfg.is_encoder:
        raise ValueError(f"{cfg.name} is encoder-only: no decode state")
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return _decode_state(cfg, batch, max_len, resolve_device(device),
                         tp if tp is not None else tpm.current(cfg))


def _decode_state(cfg: ModelConfig, batch: int, max_len: int, dev,
                  tp: "tpm.Plan | None") -> dict:
    def kv(n_stack):
        shape = _kv_shape(cfg, batch, max_len, n_stack)
        if tp is not None:
            shape = tp.cache_shape(shape)
        dt = torch_dtype(cfg)
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev)}

    def ssm(block, init, *lead):
        one = init(cfg, batch, dev)
        if tp is not None:
            # the rank's shard: a leaf's initial values are uniform, so its
            # leading block will do
            one = {k: v[tuple(map(slice, tp.ssm_state_shape(cfg, block, k,
                                                            v.shape)))]
                   for k, v in one.items()}
        return _stacked(one, *lead)

    if cfg.family == "ssm":
        n = cfg.num_layers // 2
        return {"mlstm": ssm("mlstm", ssm_mod.mlstm_state_init, n),
                "slstm": ssm("slstm", ssm_mod.slstm_state_init, n),
                "pos": 0}
    if cfg.family == "hybrid":
        groups = cfg.num_layers // cfg.attn_every
        return {"mamba": ssm("mamba", ssm_mod.mamba2_state_init, groups,
                             cfg.attn_every),
                **kv(groups), "pos": 0}
    return {**kv(cfg.num_layers), "pos": 0}


def decode_state_shapes(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The shapes of `init_decode_state`'s whole (unsplit) tree, allocating
    nothing: a tuple a tensor, () for "pos"."""
    state = _decode_state(cfg, batch, max_len, torch.device("meta"), None)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape) if isinstance(tree, torch.Tensor) else ()
    return shapes(state)


def state_specs(cfg: ModelConfig) -> dict:
    """Logical sharding names of the decode state (`init_decode_state`'s
    tree, the JAX package's): `repro.models.state_specs`. The cache
    sequence axis is "kv_seq", remapped to the model axis by
    `launch/shardings.py` where the kv heads do not tile it (split-KV).
    Under a serving plan a rank's state is these specs' shard for every
    leaf but the Mamba2 conv buffer's: its "ssm_inner" axis holds the
    di/tp + 2n channels the rank convolves (its x channels, then B and C
    whole), not the contiguous (di + 2n)/tp that JAX's sharding gives
    (`tensor_parallel.Plan.ssm_state_shape`)."""
    fam = cfg.family
    kv = (None, "batch", "kv_seq", "kv_heads", None)
    if fam in ("dense", "vlm", "moe"):
        return {"k": kv, "v": kv, "pos": ()}
    if fam == "ssm":
        ml = {"c": (None, "batch", "heads", None, None),
              "n": (None, "batch", "heads", None),
              "m": (None, "batch", "heads"),
              "conv": (None, "batch", None, "ssm_inner")}
        sl = {k: (None, "batch", None) for k in ("c", "n", "h", "m")}
        return {"mlstm": ml, "slstm": sl, "pos": ()}
    if fam == "hybrid":
        mam = {"h": (None, None, "batch", "heads", None, None),
               "conv": (None, None, "batch", None, "ssm_inner")}
        return {"mamba": mam, "k": kv, "v": kv, "pos": ()}
    raise ValueError(fam)


def _store(states: dict, index: tuple, new: dict) -> None:
    """Write one layer's new recurrent state into the stacked state."""
    for key, val in new.items():
        states[key][index].copy_(val)


def decode_step(params: Model, cfg: ModelConfig, state: dict,
                tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One token for the whole batch. tokens: (B, 1) int. Returns (logits
    (B, 1, V), new state); the caches and states are updated in place.
    Under a serving plan (`tensor_parallel.current`) the state is this
    rank's shard (`init_decode_state`), the residual is whole on every rank
    (one position: JAX's `("batch", None, "act_embed")`,
    `src/repro/models/attention.py:198`), the MLP (a MoE block its experts
    or its token slab, an SSM block its heads or channels) and the head
    split their ff and vocabulary columns (the `no_sp` regions), and the
    logits are the rank's vocabulary columns, as in `prefill`."""
    tp = tpm.current(cfg)
    tp = None if tp is None else tp.whole()
    x = _embed_inputs(params, cfg, {"tokens": tokens}, tp)
    pos = int(state["pos"])
    eps = cfg.norm_eps

    def attend(attn, ln, x, i):
        h, _, _ = decode_attention(attn, rmsnorm(ln, x, eps), cfg,
                                   state["k"][i], state["v"][i], pos,
                                   window=cfg.sliding_window, tp=tp)
        return x + h

    if params.pairs is not None:
        ml, sl = state["mlstm"], state["slstm"]
        for i, pair in enumerate(params.pairs):
            with gathered(pair):
                h, new = ssm_mod.mlstm_step(
                    pair.mlstm, rmsnorm(pair.ln1, x, eps),
                    {k: v[i] for k, v in ml.items()}, cfg, tp)
                _store(ml, (i,), new)
                x = x + h
                h, new = ssm_mod.slstm_step(
                    pair.slstm, rmsnorm(pair.ln2, x, eps),
                    {k: v[i] for k, v in sl.items()}, cfg, tp)
                _store(sl, (i,), new)
                x = x + h
    elif params.mamba_groups is not None:
        mam, shared = state["mamba"], params.shared_attn
        for g, group in enumerate(params.mamba_groups):
            with gathered(group, shared):
                for j, layer in enumerate(group):
                    h, new = ssm_mod.mamba2_step(
                        layer.mamba, rmsnorm(layer.ln, x, eps),
                        {k: v[g, j] for k, v in mam.items()}, cfg, tp)
                    _store(mam, (g, j), new)
                    x = x + h
                x = attend(shared.attn, shared.ln, x, g)
    else:
        for i, blk in enumerate(params.blocks):
            with gathered(blk):
                x = attend(blk.attn, blk.ln1, x, i)
                x = x + _ffn(blk, x, cfg, tp)[0]
    return _logits(params, cfg, x, tp), {**state, "pos": pos + 1}


def _place_kv(cache: torch.Tensor, kv: torch.Tensor) -> None:
    """Write one layer's prompt K or V (B, S, Hk, Dh) at slots [0, S);
    windowed caches keep the tail (ring slots align when S % window == 0)."""
    s_cache = cache.shape[1]
    if kv.shape[1] > s_cache:
        kv = kv[:, -s_cache:]
    cache[:, :kv.shape[1]] = kv.to(cache.dtype)


@torch.no_grad()
def prefill(params: Model, cfg: ModelConfig, batch: dict, max_len: int,
            last_only: bool = False) -> tuple[torch.Tensor, dict]:
    """Process a prompt, returning (logits, primed decode state).

    Assumes prompt length <= cache capacity; a windowed cache keeps the
    prompt's last `window` positions. last_only=True computes logits ONLY
    for the final position: serving samples from it alone, and the (B, S,
    V) logits go away. It runs without autograd (serving).

    Under a serving plan (`tensor_parallel.current`) it runs as the train
    step's split forward runs (heads or the context-parallel fallback, ff
    and vocabulary columns, an SSM block's heads or channels, the
    residual sequence-parallel unless `no_sp`), priming this rank's shard
    of the
    decode state in the layout `decode_step` reads; a prompt whose length
    does not split over the model axis is refused. The logits are then
    the rank's vocabulary columns, as JAX's prefill leaves them
    ("act_vocab"), and under SP `last_only`'s position comes from the
    last rank.
    """
    tp = tpm.current(cfg)
    if tp is not None:
        tp.seq_slice(torch.as_tensor(batch["tokens"]).shape[1])
    x = _embed_inputs(params, cfg, batch, tp)
    b, s = x.shape[:2]
    if tp is not None and tp.sp:
        s *= tp.size        # x is this rank's slice of the prompt
    positions = _positions(s, x.device)
    eps = cfg.norm_eps
    state = init_decode_state(cfg, b, max_len, device=x.device, tp=tp)

    def attend(attn, ln, x, i):
        h, (k, v) = attention(attn, rmsnorm(ln, x, eps), cfg, positions,
                              return_kv=True, tp=tp,
                              cache_slots=state["k"].shape[2])
        _place_kv(state["k"][i], k)
        _place_kv(state["v"][i], v)
        return x + h

    if params.pairs is not None:
        for i, pair in enumerate(params.pairs):
            with gathered(pair):
                h, new = ssm_mod.mlstm_forward(
                    pair.mlstm, rmsnorm(pair.ln1, x, eps), cfg,
                    return_state=True, tp=tp)
                _store(state["mlstm"], (i,), new)
                x = x + h
                h, new = ssm_mod.slstm_forward(
                    pair.slstm, rmsnorm(pair.ln2, x, eps), cfg,
                    return_state=True, tp=tp)
                _store(state["slstm"], (i,), new)
                x = x + h
    elif params.mamba_groups is not None:
        shared = params.shared_attn
        for g, group in enumerate(params.mamba_groups):
            with gathered(group, shared):
                for j, layer in enumerate(group):
                    h, new = ssm_mod.mamba2_forward(
                        layer.mamba, rmsnorm(layer.ln, x, eps), cfg,
                        return_state=True, tp=tp)
                    _store(state["mamba"], (g, j), new)
                    x = x + h
                x = attend(shared.attn, shared.ln, x, g)
    else:
        for i, blk in enumerate(params.blocks):
            with gathered(blk):
                x = attend(blk.attn, blk.ln1, x, i)
                x = x + _ffn(blk, x, cfg, tp)[0]
    state["pos"] = s
    if last_only:
        if tp is not None:
            x, tp = tpm.last_position(x, tp), tp.whole()
        else:
            x = x[:, -1:]
    return _logits(params, cfg, x, tp), state
