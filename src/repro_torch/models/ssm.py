"""State-space and recurrent blocks: Mamba2 (SSD) and xLSTM (mLSTM /
sLSTM) (PyTorch port of `repro.models.ssm`).

Mamba2 uses the chunked SSD algorithm (Dao & Gu 2024): quadratic (chunk x
chunk) products inside a chunk, the state carried between chunks by a
short loop over the chunks. xLSTM (Beck et al. 2024): the mLSTM in
parallel chunks with the JAX package's log-space stabiliser, term for
term; the sLSTM a true recurrence, a Python loop over time (the
counterpart of the JAX package's `lax.scan`; the JAX package has no
kernel here and neither has the port).

Every block has a full-sequence forward (optionally returning the decode
state), a single step carrying that state, and init / state-init. Decode
states are float32, as in the JAX package.

Under a tensor-parallel plan (`models/tensor_parallel.py`, the sharded
train step and serving on a model axis) every forward and step takes
`tp` and computes this rank's share, as JAX's rules split the blocks
("ssm_inner", "act_ssm" on "model"): a Mamba2 block its heads (the z, x
and dt columns of the fused `in_proj`, with B and C whole), an mLSTM
block its di/tp channels of the projections and its heads of the cell
(the whole cell where the heads do not tile the axis), an sLSTM block its
feed-forward columns with the recurrence whole. The split width's gated
RMSNorm sums the ranks' sums of squares (`layers.rmsnorm` with
`tensor_parallel.channel_sum`). Mamba2's two pieces between the
collectives (`mamba2_gated`, `mamba2_project`) take a rank and a size, or
the norm's reduce, and no process group, so a single process can run
each rank's share and sum them.

Storage: projections are bias-free `nn.Linear`s in the parameter dtype
(`layers.py`); what the JAX package reads in float32 somewhere (the conv
kernels, whose decode step is float32, the gate and decay vectors, the
norm scales, the sLSTM's recurrent matrices and bias) is stored float32
whatever the parameter dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import tensor_parallel as tpm
from repro_torch.models.layers import (
    RMSNorm,
    _frozen,
    _init_linear,
    dense,
    dense_init,
    rmsnorm,
)


def _f32(t: torch.Tensor) -> nn.Parameter:
    return _frozen(t.to(torch.float32))


def _left_tail(u: torch.Tensor, n: int) -> torch.Tensor:
    """The last `n` positions of u (B, S, C), left-padded with zeros when
    S < n, as float32: a conv state of the pre-conv inputs."""
    tail = u[:, max(u.shape[1] - n, 0):].float()
    return F.pad(tail, (0, 0, n - tail.shape[1], 0))


# ------------------------------------------------------------- causal conv
def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                  ) -> torch.Tensor:
    """Depthwise causal conv in x's dtype. x: (B, S, C), w: (K, C), b:
    (C,)."""
    k, c = w.shape
    xp = F.pad(x.transpose(1, 2), (k - 1, 0))                 # (B, C, S+K-1)
    out = F.conv1d(xp, w.to(x.dtype).t()[:, None, :], groups=c)
    return out.transpose(1, 2) + b.to(x.dtype)


def conv_step(x_t: torch.Tensor, buf: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step of the causal conv, in float32. x_t: (B, C); buf:
    (B, K-1, C) the previous inputs. Returns (y_t in x_t's dtype, new
    buf)."""
    window = torch.cat([buf.float(), x_t.float()[:, None, :]], dim=1)
    y = torch.einsum("bkc,kc->bc", window, w.float()) + b
    return y.to(x_t.dtype), window[:, 1:]


# ===================================================================== SSD
def _fit_chunk(s: int, chunk: int) -> int:
    """Largest divisor of s that is <= chunk (ragged smoke-test shapes)."""
    c = min(chunk, s)
    while s % c:
        c -= 1
    return c


def _segsum(log_a: torch.Tensor) -> torch.Tensor:
    """(..., Q) per-step log decays -> (..., Q, Q) lower-triangular
    cumulative log decays: out[t, s] = sum_{u=s+1..t} log_a[u] for s <= t,
    -inf above the diagonal."""
    q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=log_a.device).tril()
    return torch.where(mask, diff, -torch.inf)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b_in: torch.Tensor, c_in: torch.Tensor, chunk: int,
             h_init: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. x: (B, S, H, P); dt: (B, S, H); a_log: (H,) (A =
    -exp(a_log)); b_in/c_in: (B, S, N). Returns (y (B, S, H, P) in x's
    dtype, h_final (B, H, N, P) float32)."""
    b, s, h, p = x.shape
    n = b_in.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd_scan: chunk {chunk} does not divide {s}")
    nc = s // chunk
    xf = x.float().reshape(b, nc, chunk, h, p)
    dtf = dt.float().reshape(b, nc, chunk, h)
    bf = b_in.float().reshape(b, nc, chunk, n)
    cf = c_in.float().reshape(b, nc, chunk, n)

    a = -torch.exp(a_log.float())                             # (H,)
    la = dtf * a                                              # log decays
    la_cs = torch.cumsum(la, dim=2)

    # intra-chunk (quadratic): M[t, s] = CB[t, s] * exp(seg) * dt[s]
    seg = _segsum(la.movedim(2, -1))                          # (b,nc,h,q,q)
    cb = torch.einsum("bcqn,bckn->bcqk", cf, bf)
    m = cb[:, :, None] * torch.exp(seg) * dtf.movedim(2, -1)[:, :, :, None, :]
    del seg
    y = torch.einsum("bchqk,bckhp->bcqhp", m, xf)
    del m

    # chunk states: S_c = sum_s exp(la_end - la_cs[s]) dt_s B_s x_s
    rem = torch.exp(la_cs[:, :, -1:, :] - la_cs)
    dbx = torch.einsum("bckn,bckh,bckhp->bchnp", bf, dtf * rem, xf)
    chunk_decay = torch.exp(la_cs[:, :, -1, :])               # (b, nc, h)
    state = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if h_init is None else h_init.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(state)
        state = chunk_decay[:, c, :, None, None] * state + dbx[:, c]

    # inter-chunk: y_t += exp(la_cs[t]) * C_t . h_prev
    y = y + (torch.einsum("bcqn,bchnp->bcqhp", cf,
                          torch.stack(h_prevs, dim=1))
             * torch.exp(la_cs)[..., None])
    return y.reshape(b, s, h, p).to(x.dtype), state


def ssd_step(x_t: torch.Tensor, dt_t: torch.Tensor, a_log: torch.Tensor,
             b_t: torch.Tensor, c_t: torch.Tensor, h: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step. x_t: (B, H, P); dt_t: (B, H); b_t/c_t: (B, N); h:
    (B, H, N, P) -> (y (B, H, P) in x_t's dtype, h')."""
    a = -torch.exp(a_log.float())
    decay = torch.exp(dt_t.float() * a)                       # (B, H)
    dbx = torch.einsum("bn,bh,bhp->bhnp", b_t.float(), dt_t.float(),
                       x_t.float())
    h = decay[..., None, None] * h + dbx
    y = torch.einsum("bn,bhnp->bhp", c_t.float(), h)
    return y.to(x_t.dtype), h


# ------------------------------------------------------------ Mamba2 block
class Mamba2(nn.Module):
    def __init__(self, in_proj: nn.Linear, conv_w, conv_b, a_log, d_skip,
                 dt_bias, norm: RMSNorm, out_proj: nn.Linear):
        super().__init__()
        self.in_proj = in_proj
        self.conv_w, self.conv_b = _f32(conv_w), _f32(conv_b)
        self.a_log, self.d_skip = _f32(a_log), _f32(d_skip)
        self.dt_bias = _f32(dt_bias)
        self.norm = norm
        self.out_proj = out_proj


def mamba2_init(generator, cfg: ModelConfig,
                dtype: torch.dtype | None = None) -> Mamba2:
    d, di = cfg.d_model, cfg.d_inner
    n, h = cfg.ssm_state_dim, cfg.n_ssm_heads
    conv_ch = di + 2 * n
    dev = generator.device
    return Mamba2(
        _init_linear(generator, cfg, d, 2 * di + 2 * n + h, dtype),
        dense_init(generator, (cfg.ssm_conv_dim, conv_ch)) * 0.1,
        torch.zeros((conv_ch,), device=dev),
        torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        torch.ones((h,), device=dev),
        torch.zeros((h,), device=dev),
        RMSNorm(torch.ones((di,), device=dev)),
        _init_linear(generator, cfg, di, d, dtype))


def mamba2_spec(cfg: ModelConfig) -> dict:
    return {"in_proj": ("embed", "ssm_inner"), "conv_w": (None, "ssm_inner"),
            "conv_b": ("ssm_inner",), "a_log": ("ssm_inner",),
            "d_skip": ("ssm_inner",), "dt_bias": ("ssm_inner",),
            "norm_scale": ("ssm_inner",), "out_proj": ("ssm_inner", "embed")}


def mamba2_columns(params: Mamba2, cfg: ModelConfig, rank: int = 0,
                   size: int = 1) -> tuple:
    """(in_proj's weight rows, conv_w, conv_b) that model rank `rank` of
    `size` computes with, from the whole `in_proj` and conv: its z, x and
    dt columns (its H/size heads) and the B and C columns whole, in the
    whole layout's order [z | x | B | C | dt]; the conv's channels [x | B
    | C] to match. The whole tensors at size 1."""
    if size == 1:
        return params.in_proj.weight, params.conv_w, params.conv_b
    di, n, h = cfg.d_inner, cfg.ssm_state_dim, cfg.n_ssm_heads
    c, hh = di // size, h // size
    chans = ((rank * c, c), (di, 2 * n))                 # in [x | B | C]
    rows = ((rank * c, c), *((di + a, k) for a, k in chans),
            (2 * di + 2 * n + rank * hh, hh))
    return (torch.cat([params.in_proj.weight.narrow(0, a, k)
                       for a, k in rows]),
            torch.cat([params.conv_w.narrow(1, a, k) for a, k in chans], 1),
            torch.cat([params.conv_b.narrow(0, a, k) for a, k in chans]))


def _mamba2_split(zxbcdt: torch.Tensor, di: int, n: int, h: int):
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n],
            zxbcdt[..., -h:])


def _mamba2_gate(params: Mamba2, y, x_in, z, shape) -> torch.Tensor:
    """The skip and the SiLU gate: the norm's input."""
    y = y.float() + params.d_skip[:, None] * x_in.float()
    return y.reshape(shape).to(z.dtype) * F.silu(z)


def mamba2_project(params: Mamba2, g: torch.Tensor, cfg: ModelConfig,
                   reduce=None) -> torch.Tensor:
    """`out_proj` of the gated RMSNorm of g, the norm's input: the layer's
    output where g is whole; a model rank's partial sums where g holds its
    channels and `reduce` sums a channel sum over the ranks
    (`tensor_parallel.channel_sum`)."""
    return dense(rmsnorm(params.norm, g, 1e-5, reduce, cfg.d_inner),
                 params.out_proj)


def _mamba2_out(params: Mamba2, g, cfg: ModelConfig,
                tp: "tpm.Plan | None") -> torch.Tensor:
    out = mamba2_project(params, g, cfg, tpm.channel_sum(tp))
    return out if tp is None else tpm.leave_rows(out, tp)


def _share(tp: "tpm.Plan | None") -> tuple[int, int]:
    return (0, 1) if tp is None else (tp.rank, tp.size)


def mamba2_gated(params: Mamba2, x: torch.Tensor, cfg: ModelConfig,
                 rank: int = 0, size: int = 1, return_state: bool = False):
    """Model rank `rank` of `size`'s part of the block on the whole
    sequence x (B, S, D), with `params` as the rank holds them under a
    plan (`in_proj` and the conv whole, the per-head vectors, the norm
    scale and `out_proj` their contiguous shards, which are its heads):
    its heads' gated SSD output (B, S, d_inner/size), the norm's input
    [, its decode state {"h": its heads, "conv": the channels it
    convolves}]."""
    b, s, _ = x.shape
    di, n, h = cfg.d_inner // size, cfg.ssm_state_dim, cfg.n_ssm_heads // size
    w, conv_w, conv_b = mamba2_columns(params, cfg, rank, size)
    z, xbc_raw, dt_pre = _mamba2_split(F.linear(x, w.to(x.dtype)), di, n, h)
    xbc = F.silu(causal_conv1d(xbc_raw, conv_w, conv_b))
    x_in = xbc[..., :di].reshape(b, s, h, di // h)
    dt = F.softplus(dt_pre.float() + params.dt_bias)
    y, h_final = ssd_scan(x_in, dt, params.a_log, xbc[..., di:di + n],
                          xbc[..., di + n:], _fit_chunk(s, cfg.ssm_chunk))
    g = _mamba2_gate(params, y, x_in, z, (b, s, di))
    if not return_state:
        return g, None
    # the conv state holds the last K-1 PRE-conv inputs
    return g, {"h": h_final,
               "conv": _left_tail(xbc_raw, cfg.ssm_conv_dim - 1)}


def mamba2_forward(params: Mamba2, x: torch.Tensor, cfg: ModelConfig,
                   return_state: bool = False,
                   tp: "tpm.Plan | None" = None):
    """x: (B, S, D) -> (B, S, D) [, decode state {"h", "conv"}]. Under a
    plan x and the result are the residual as the plan carries it; the
    rank computes its heads on the whole sequence (`mamba2_gated`) and
    its `out_proj` rows (`src/repro/models/ssm.py:187,195,197`:
    "act_ssm", "res_seq")."""
    if tp is not None:
        x = tpm.enter_columns(x, tp)
    g, state = mamba2_gated(params, x, cfg, *_share(tp), return_state)
    out = _mamba2_out(params, g, cfg, tp)
    return (out, state) if return_state else out


def mamba2_state_init(cfg: ModelConfig, batch: int, device=None) -> dict:
    di, n, h = cfg.d_inner, cfg.ssm_state_dim, cfg.n_ssm_heads
    return {"h": torch.zeros((batch, h, n, di // h), device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv_dim - 1, di + 2 * n),
                                device=device)}


def mamba2_step(params: Mamba2, x_t: torch.Tensor, state: dict,
                cfg: ModelConfig, tp: "tpm.Plan | None" = None
                ) -> tuple[torch.Tensor, dict]:
    """x_t: (B, 1, D) -> (y (B, 1, D), state'). Under a serving plan (the
    residual whole) the state is the rank's shard and it computes its
    heads."""
    b = x_t.shape[0]
    rank, size = _share(tp)
    di, n, h = cfg.d_inner // size, cfg.ssm_state_dim, cfg.n_ssm_heads // size
    if tp is not None:
        x_t = tpm.enter_columns(x_t, tp)
    w, conv_w, conv_b = mamba2_columns(params, cfg, rank, size)
    z, xbc, dt_pre = _mamba2_split(F.linear(x_t, w.to(x_t.dtype)), di, n, h)
    xbc_t, conv = conv_step(xbc[:, 0], state["conv"], conv_w, conv_b)
    xbc_t = F.silu(xbc_t)
    x_in = xbc_t[..., :di].reshape(b, h, di // h)
    dt = F.softplus(dt_pre[:, 0].float() + params.dt_bias)
    y, h_new = ssd_step(x_in, dt, params.a_log, xbc_t[..., di:di + n],
                        xbc_t[..., di + n:], state["h"])
    g = _mamba2_gate(params, y, x_in, z, (b, 1, di))
    return _mamba2_out(params, g, cfg, tp), {"h": h_new, "conv": conv}


# =================================================================== mLSTM
class MLSTM(nn.Module):
    def __init__(self, w_up, conv_w, conv_b, w_q, w_k, w_v, w_i, w_f,
                 f_bias, w_o_gate, norm: RMSNorm, w_down):
        super().__init__()
        self.w_up = w_up
        self.conv_w, self.conv_b = _f32(conv_w), _f32(conv_b)
        self.w_q, self.w_k, self.w_v = w_q, w_k, w_v
        self.w_i, self.w_f = w_i, w_f
        self.f_bias = _f32(f_bias)
        self.w_o_gate = w_o_gate
        self.norm = norm
        self.w_down = w_down


def mlstm_init(generator, cfg: ModelConfig,
               dtype: torch.dtype | None = None) -> MLSTM:
    d, h = cfg.d_model, cfg.n_ssm_heads
    di = 2 * d                                            # up-projection x2
    dev = generator.device

    def lin(i, o):
        return _init_linear(generator, cfg, i, o, dtype)
    return MLSTM(lin(d, di), dense_init(generator, (4, di)) * 0.1,
                 torch.zeros((di,), device=dev), lin(di, di), lin(di, di),
                 lin(di, di), lin(di, h), lin(di, h),
                 torch.full((h,), 3.0, device=dev), lin(d, di),
                 RMSNorm(torch.ones((di,), device=dev)), lin(di, d))


def mlstm_spec(cfg: ModelConfig) -> dict:
    return {
        "w_up": ("embed", "ssm_inner"), "conv_w": (None, "ssm_inner"),
        "conv_b": ("ssm_inner",), "w_q": ("ssm_inner", None),
        "w_k": ("ssm_inner", None), "w_v": ("ssm_inner", None),
        "w_i": ("ssm_inner", None), "w_f": ("ssm_inner", None),
        "f_bias": (None,), "w_o_gate": ("embed", "ssm_inner"),
        "norm_scale": ("ssm_inner",), "w_down": ("ssm_inner", "embed")}


def mlstm_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  i_pre: torch.Tensor, f_pre: torch.Tensor, chunk: int,
                  state: tuple | None = None
                  ) -> tuple[torch.Tensor, tuple]:
    """Exact log-space stabilised chunked mLSTM.

    q/k/v: (B, S, H, Dk|Dv); i_pre/f_pre: (B, S, H) raw gate
    pre-activations. state: (C (B, H, Dk, Dv), n (B, H, Dk), m (B, H)) or
    None. Returns (y (B, S, H, Dv) in q's dtype, final state)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if s % chunk:
        raise ValueError(f"mlstm_chunked: chunk {chunk} does not divide {s}")
    nc = s // chunk
    qf = (q.float() * dk ** -0.5).reshape(b, nc, chunk, h, dk)
    kf = k.float().reshape(b, nc, chunk, h, dk)
    vf = v.float().reshape(b, nc, chunk, h, dv)
    logf = F.logsigmoid(f_pre.float()).reshape(b, nc, chunk, h)
    itil = i_pre.float().reshape(b, nc, chunk, h)

    f_cs = torch.cumsum(logf, dim=2)                          # (b,nc,q,h)
    f_tot = f_cs[:, :, -1, :]                                 # (b,nc,h)
    # intra log weights: D[t, s] = f_cs[t] - f_cs[s] + itil[s], s <= t
    dlog = _segsum(logf.movedim(2, -1)) + itil.movedim(2, -1)[:, :, :, None, :]
    m_intra = dlog.amax(dim=-1)                               # (b,nc,h,q)

    if state is None:
        c_p = torch.zeros((b, h, dk, dv), device=q.device)
        n_p = torch.zeros((b, h, dk), device=q.device)
        m_p = torch.full((b, h), -torch.inf, device=q.device)
    else:
        c_p, n_p, m_p = state

    ys = []
    for idx in range(nc):
        f_c, dl, qc = f_cs[:, idx], dlog[:, idx], qf[:, idx]
        kc, vc = kf[:, idx], vf[:, idx]
        # the combined stabiliser of each step t
        m_inter = f_c.movedim(1, -1) + m_p[:, :, None]        # (b,h,q)
        m_t = torch.maximum(m_intra[:, idx], m_inter)
        m_t = torch.clamp(m_t, min=-1e30)                     # no -inf - -inf
        w_intra = torch.exp(dl - m_t[..., None])              # (b,h,q,s)
        scores = torch.einsum("bqhk,bshk->bhqs", qc, kc)
        y_intra = torch.einsum("bhqs,bshd->bqhd", w_intra * scores, vc)
        n_intra = torch.einsum("bhqs,bshk->bqhk", w_intra, kc)
        w_inter = torch.exp(m_inter - m_t).movedim(1, -1)     # (b,q,h)
        y_inter = (torch.einsum("bqhk,bhkd->bqhd", qc, c_p)
                   * w_inter[..., None])
        qn_intra = torch.einsum("bqhk,bqhk->bqh", qc, n_intra)
        qn_inter = torch.einsum("bqhk,bhk->bqh", qc, n_p) * w_inter
        denom = torch.maximum(torch.abs(qn_intra + qn_inter),
                              torch.exp(-m_t.movedim(1, -1)))
        ys.append((y_intra + y_inter) / (denom[..., None] + 1e-30))

        # the state at the end of the chunk
        ft = f_tot[:, idx]                                    # (b,h)
        m_state_in = (ft[:, None, :] - f_c + itil[:, idx]).movedim(1, -1)
        m_new = torch.maximum(m_p + ft, m_state_in.amax(dim=-1))
        m_new = torch.clamp(m_new, min=-1e30)
        w_state = torch.exp(m_state_in - m_new[..., None])    # (b,h,q)
        carry = torch.exp(m_p + ft - m_new)
        c_p = (carry[..., None, None] * c_p
               + torch.einsum("bhs,bshk,bshd->bhkd", w_state, kc, vc))
        n_p = carry[..., None] * n_p + torch.einsum("bhs,bshk->bhk",
                                                    w_state, kc)
        m_p = m_new
    y = torch.stack(ys, dim=1).reshape(b, s, h, dv)
    return y.to(q.dtype), (c_p, n_p, m_p)


def _mlstm_heads(params: MLSTM, u: torch.Tensor, uc: torch.Tensor,
                 cfg: ModelConfig, tp: "tpm.Plan | None"):
    """q, k, v (..., H, dk) and the gate pre-activations i, f (..., H)
    from the up-projection u and its conv uc. Under a plan u and uc are
    the rank's channels and the row-parallel products partial sums,
    reduce-scattered onto its heads where they tile the axis, else summed
    whole on every rank (H then the rank's heads or all of them)."""
    h = cfg.n_ssm_heads
    dk = 2 * cfg.d_model // h
    q, k = dense(uc, params.w_q), dense(uc, params.w_k)
    v = dense(u, params.w_v)
    i_pre, f_pre = dense(uc, params.w_i), dense(uc, params.w_f)
    bias = params.f_bias
    if tp is not None:
        qkv, gates = torch.stack([q, k, v]), torch.stack([i_pre, f_pre])
        if tp.ssm_heads:
            qkv = tpm.reduce_scatter(qkv, tp, -1)
            gates = tpm.reduce_scatter(gates, tp, -1)
            h //= tp.size
            bias = bias.narrow(0, tp.rank * h, h)
        else:
            qkv = tpm.reduce_from_region(qkv, tp)
            gates = tpm.reduce_from_region(gates, tp)
        (q, k, v), (i_pre, f_pre) = qkv.unbind(0), gates.unbind(0)
    lead = q.shape[:-1]
    return (q.reshape(*lead, h, dk), k.reshape(*lead, h, dk),
            v.reshape(*lead, h, dk), i_pre, f_pre + bias)


def _mlstm_out(params: MLSTM, x: torch.Tensor, y: torch.Tensor,
               cfg: ModelConfig, tp: "tpm.Plan | None") -> torch.Tensor:
    """The norm over the whole 2·D width, the output gate and `w_down`
    on the cell's output y (..., H·dk); under a plan on the rank's
    channels (taken from a whole cell's y by `split`), the partial sums
    back onto the residual."""
    if tp is not None and not tp.ssm_heads:
        y = tpm.split(y, tp, -1)
    y = rmsnorm(params.norm, y, 1e-5, tpm.channel_sum(tp), 2 * cfg.d_model)
    out = dense(y * torch.sigmoid(dense(x, params.w_o_gate)), params.w_down)
    return out if tp is None else tpm.leave_rows(out, tp)


def mlstm_forward(params: MLSTM, x: torch.Tensor, cfg: ModelConfig,
                  return_state: bool = False, tp: "tpm.Plan | None" = None):
    """x: (B, S, D) -> (B, S, D) [, decode state {"c", "n", "m",
    "conv"}]. Under a plan x and the result are the residual as the plan
    carries it, and the state is the rank's shard (its heads or all of
    them, its conv channels)."""
    if tp is not None:
        x = tpm.enter_columns(x, tp)
    b, s, _ = x.shape
    u = dense(x, params.w_up)                                 # (B, S, 2D)
    uc = F.silu(causal_conv1d(u, params.conv_w, params.conv_b))
    q, k, v, i_pre, f_pre = _mlstm_heads(params, u, uc, cfg, tp)
    y, (c_f, n_f, m_f) = mlstm_chunked(q, k, v, i_pre, f_pre,
                                       _fit_chunk(s, cfg.ssm_chunk))
    out = _mlstm_out(params, x, y.reshape(b, s, -1), cfg, tp)
    if not return_state:
        return out
    return out, {"c": c_f, "n": n_f, "m": m_f,
                 "conv": _left_tail(u, params.conv_w.shape[0] - 1)}


def mlstm_state_init(cfg: ModelConfig, batch: int, device=None) -> dict:
    h = cfg.n_ssm_heads
    di = 2 * cfg.d_model
    dk = di // h
    return {"c": torch.zeros((batch, h, dk, dk), device=device),
            "n": torch.zeros((batch, h, dk), device=device),
            "m": torch.full((batch, h), -1e30, device=device),
            "conv": torch.zeros((batch, 3, di), device=device)}


def mlstm_step(params: MLSTM, x_t: torch.Tensor, state: dict,
               cfg: ModelConfig, tp: "tpm.Plan | None" = None
               ) -> tuple[torch.Tensor, dict]:
    """x_t: (B, 1, D) -> (y (B, 1, D), state'). Under a serving plan (the
    residual whole) the state is the rank's shard."""
    b = x_t.shape[0]
    if tp is not None:
        x_t = tpm.enter_columns(x_t, tp)
    u = dense(x_t, params.w_up)
    uc_t, conv = conv_step(u[:, 0], state["conv"], params.conv_w,
                           params.conv_b)
    uc_t = F.silu(uc_t)
    q, k, v, itil, ftil = _mlstm_heads(params, u[:, 0], uc_t, cfg, tp)
    q = q.float() * q.shape[-1] ** -0.5
    k, v, itil = k.float(), v.float(), itil.float()
    logf = F.logsigmoid(ftil.float())
    m_new = torch.maximum(state["m"] + logf, itil)
    fw = torch.exp(state["m"] + logf - m_new)
    iw = torch.exp(itil - m_new)
    c = (fw[..., None, None] * state["c"]
         + iw[..., None, None] * torch.einsum("bhk,bhd->bhkd", k, v))
    n = fw[..., None] * state["n"] + iw[..., None] * k
    qn = torch.einsum("bhk,bhk->bh", q, n)
    denom = torch.maximum(torch.abs(qn), torch.exp(-m_new)) + 1e-30
    y = torch.einsum("bhk,bhkd->bhd", q, c) / denom[..., None]
    out = _mlstm_out(params, x_t, y.reshape(b, 1, -1).to(x_t.dtype), cfg,
                     tp)
    return out, {"c": c, "n": n, "m": m_new, "conv": conv}


# =================================================================== sLSTM
SLSTM_HEADS = 4                                           # the spec's 4 heads


class SLSTM(nn.Module):
    """w_in (4D from D) and the feed-forward pair are `nn.Linear`s; r
    (heads, Dh, 4 Dh), the block-diagonal recurrent weights, and the gate
    bias (4D) are float32."""

    def __init__(self, w_in: nn.Linear, r, bias, w_ff_up: nn.Linear,
                 w_ff_down: nn.Linear):
        super().__init__()
        self.w_in = w_in
        self.r, self.bias = _f32(r), _f32(bias)
        self.w_ff_up, self.w_ff_down = w_ff_up, w_ff_down


def slstm_ff_width(cfg: ModelConfig) -> int:
    """The sLSTM block's feed-forward width (4/3 of D, a multiple of 8)."""
    return max(8, int(cfg.d_model * 4 / 3) // 8 * 8)


def slstm_init(generator, cfg: ModelConfig,
               dtype: torch.dtype | None = None) -> SLSTM:
    d = cfg.d_model
    dh = d // SLSTM_HEADS
    ff = slstm_ff_width(cfg)
    bias = torch.zeros((4 * d,), device=generator.device)
    bias[d:2 * d] = 3.0                                   # forget-gate bias
    return SLSTM(_init_linear(generator, cfg, d, 4 * d, dtype),
                 dense_init(generator, (SLSTM_HEADS, dh, 4 * dh), in_axis=1),
                 bias, _init_linear(generator, cfg, d, ff, dtype),
                 _init_linear(generator, cfg, ff, d, dtype))


def slstm_spec(cfg: ModelConfig) -> dict:
    return {"w_in": ("embed", None), "r": (None, None, None),
            "bias": (None,), "w_ff_up": ("embed", "ff"),
            "w_ff_down": ("ff", "embed")}


def _slstm_cell(params: SLSTM, g_x: torch.Tensor, carry: tuple, d: int):
    """One timestep. g_x: (B, 4D) input part; carry: (c, n, h, m) each
    (B, D) float32. Returns (carry', h')."""
    c, n, hid, m = carry
    hh = hid.reshape(-1, SLSTM_HEADS, d // SLSTM_HEADS)
    rec = torch.einsum("bhd,hde->bhe", hh, params.r.to(hid.dtype))
    g = g_x + rec.reshape(-1, 4 * d) + params.bias.to(hid.dtype)
    gi, gf, gz, go = torch.chunk(g.float(), 4, dim=-1)
    m_new = torch.maximum(gf + m, gi)
    i = torch.exp(gi - m_new)
    f = torch.exp(gf + m - m_new)
    c_new = f * c + i * torch.tanh(gz)
    n_new = f * n + i
    h_new = torch.sigmoid(go) * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new, m_new), h_new


def _slstm_ff(params: SLSTM, y: torch.Tensor,
              tp: "tpm.Plan | None" = None) -> torch.Tensor:
    """The feed-forward on the recurrence's output y. Under a plan y is
    whole on every rank and the rank runs its ff columns: `copy_to_region`
    sums their gradients, so the whole recurrence sees the same gradient
    on every rank; the partial sums go back onto the residual."""
    if tp is not None:
        y = tpm.copy_to_region(y, tp)
    out = dense(F.silu(dense(y, params.w_ff_up)), params.w_ff_down)
    return out if tp is None else tpm.leave_rows(out, tp)


def slstm_forward(params: SLSTM, x: torch.Tensor, cfg: ModelConfig,
                  return_state: bool = False, tp: "tpm.Plan | None" = None):
    """x: (B, S, D) -> (B, S, D) [, decode state {"c", "n", "h", "m"}].
    Under a plan x and the result are the residual as the plan carries
    it; the recurrence runs on the whole sequence on every rank
    (`gather_seq` with a split gradient under SP: every rank's gradient
    is whole)."""
    if tp is not None and tp.sp:
        x = tpm.gather_seq(x, tp, split_grad=True)
    b, s, d = x.shape
    g_all = dense(x, params.w_in)                             # (B, S, 4D)
    zero = torch.zeros((b, d), device=x.device)
    carry = (zero, zero, zero, zero)
    hs = []
    for t in range(s):
        carry, h_t = _slstm_cell(params, g_all[:, t], carry, d)
        hs.append(h_t)
    out = _slstm_ff(params, torch.stack(hs, dim=1).to(x.dtype), tp)
    if not return_state:
        return out
    return out, dict(zip(("c", "n", "h", "m"), carry))


def slstm_state_init(cfg: ModelConfig, batch: int, device=None) -> dict:
    return {key: torch.zeros((batch, cfg.d_model), device=device)
            for key in ("c", "n", "h", "m")}


def slstm_step(params: SLSTM, x_t: torch.Tensor, state: dict,
               cfg: ModelConfig, tp: "tpm.Plan | None" = None
               ) -> tuple[torch.Tensor, dict]:
    """x_t: (B, 1, D) -> (y (B, 1, D), state'); the state is whole under
    a serving plan too."""
    carry = (state["c"], state["n"], state["h"], state["m"])
    carry, h_out = _slstm_cell(params, dense(x_t[:, 0], params.w_in), carry,
                               cfg.d_model)
    out = _slstm_ff(params, h_out[:, None, :].to(x_t.dtype), tp)
    return out, dict(zip(("c", "n", "h", "m"), carry))
