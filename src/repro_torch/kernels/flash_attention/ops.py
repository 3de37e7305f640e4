"""GQA flash attention: the CUDA kernels #10, #11 and #12, their plain
versions, the `torch.autograd.Function` that joins #11 and #12, and the
tile-traffic model.

Replaces `flash_attention_pallas` (`repro/kernels/flash_attention/
flash_kernel.py:83`), `flash_attention_fwd_pallas` (`:257`) and
`flash_attention_bwd_pallas` (`:302`), the kernels behind
`repro.kernels.flash_attention.ops.flash_attention` and its custom_vjp.
The forwards come from one source, `csrc/flash_attention.cu`, templated
on whether the row log-sum-exp is written; the backward from
`csrc/flash_attention_bwd.cu`. Each source has two paths, picked by
dtype: bfloat16 runs on the tensor cores (`mma.sync`, the path serving and
training take), float32 on SIMT FMAs. Head dims 32, 64, 80 and 128.

Layout is the JAX wrapper's: q (B, Sq, H, Dh), k/v (B, Skv, Hk, Dh) in,
o (B, Sq, H, Dh) out, and lse (B, H, Sq) float32; query head `hi` reads
KV head `hi // (H // Hk)`. The kernels read q, k, v (and the backward dO)
through their strides (the last dimension contiguous), so no transpose is
copied.

The forward arithmetic is the Pallas kernel's (`flash_kernel.py:36-80`):
  * s = dot(q, k) in float32, times Dh^-0.5 after the dot;
  * masked scores (causal `k_pos <= q_pos`, window `k_pos > q_pos -
    window`, `q_pos = row + q_offset`) are -1e30, not -inf, and the
    running max starts at -1e30;
  * l sums the float32 p; the PV product takes p rounded to the value
    dtype, with float32 accumulation;
  * o = acc / max(l, 1e-30) in the input dtype; lse = m + log(max(l,
    1e-30)).
The backward's is the Pallas backward's (`:174-254`): p = exp(s - lse)
where visible and 0 elsewhere, delta = rowsum(dO * o) in float32 outside
the kernel (`:313`), ds = p * (dp - delta) * Dh^-0.5; ds is rounded to
k's dtype before dS.K, p^T to dO's dtype before P^T.dO and ds^T to q's
dtype before dS^T.Q. A row that sees no key therefore gets no gradient,
though the forward averaged every masked key for it.
Any Sq and Skv: the ragged edges are masked inside the kernels, and a key
past the end is no key at all. The Pallas wrapper's `Sq % block_q == 0` is
the TPU's constraint; here block_q/block_kv are the plain versions' block
loop, and the kernels tile by 64 rows and 64 keys whatever they are.

`flash_attention` takes the autograd Function (#11 forward saving q, k,
v, o and lse; #12 backward) when grad mode is on and q, k or v requires a
gradient, and #10 otherwise.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.roofline import kernel_costs
from repro_torch.roofline import op_analyzer as _oa

_NEG = -1e30
HEAD_DIMS = (32, 64, 80, 128)        # the kernels' template instances
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ------------------------------------------------------------ plain version
def _blocks(n: int, size: int) -> list[tuple[int, int]]:
    return [(s, min(s + size, n)) for s in range(0, n, size)]


def _visible(q_pos, k_pos, causal, window) -> torch.Tensor:
    """(len(q_pos), len(k_pos)) mask of the pairs the Pallas kernels keep."""
    mask = torch.ones((len(q_pos), len(k_pos)), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > (q_pos[:, None] - window)
    return mask


def _flash_plain(q, k, v, causal, window, q_offset, block_q, block_kv):
    """The Pallas kernel's block loop at (block_q, block_kv), any device;
    returns (o (B, Sq, H, Dh) in q's dtype, lse (B, H, Sq) float32)."""
    b, sq, h, dh = q.shape
    skv, hk = k.shape[1], k.shape[2]
    g = h // hk
    scale = dh ** -0.5
    dev = q.device
    block_q = max(1, min(block_q, sq))
    block_kv = max(1, min(block_kv, skv))
    qt = q.reshape(b, sq, hk, g, dh).permute(0, 2, 3, 1, 4)  # (B,Hk,G,Sq,Dh)
    kt = k.permute(0, 2, 1, 3)                               # (B,Hk,Skv,Dh)
    vt = v.permute(0, 2, 1, 3)
    o = torch.empty((b, hk, g, sq, dh), dtype=q.dtype, device=dev)
    lse = torch.empty((b, hk, g, sq), dtype=torch.float32, device=dev)
    for qs, qe in _blocks(sq, block_q):
        qb = qt[:, :, :, qs:qe].float()
        q_pos = torch.arange(qs, qe, device=dev) + q_offset
        m = torch.full((b, hk, g, qe - qs), _NEG, dtype=torch.float32,
                       device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hk, g, qe - qs, dh), dtype=torch.float32,
                          device=dev)
        for ks, ke in _blocks(skv, block_kv):
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb,
                             kt[:, :, ks:ke].float()) * scale
            mask = _visible(q_pos, torch.arange(ks, ke, device=dev), causal,
                            window)
            s = torch.where(mask, s, _NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(),
                              vt[:, :, ks:ke].float())
            acc = acc * corr[..., None] + pv
            m = m_new
        lf = torch.clamp(l, min=1e-30)
        o[:, :, :, qs:qe] = (acc / lf[..., None]).to(q.dtype)
        lse[:, :, :, qs:qe] = m + torch.log(lf)
    return (o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh),
            lse.reshape(b, h, sq))


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = 0, block_q: int = 256,
                          block_kv: int = 512) -> torch.Tensor:
    """Plain PyTorch version of #10 (any device): (B, Sq, H, Dh)."""
    _check_shapes(q, k, v)
    return _flash_plain(q, k, v, causal, window, q_offset, block_q,
                        block_kv)[0]


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True,
                              window: int = 0, q_offset: int = 0,
                              block_q: int = 256, block_kv: int = 512
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of #11 (any device): (o, lse (B, H, Sq))."""
    _check_shapes(q, k, v)
    return _flash_plain(q, k, v, causal, window, q_offset, block_q, block_kv)


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * o) in float32, (B, H, Sq) contiguous (`flash_kernel.py
    :313`, outside the kernel there too)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: int = 0, q_offset: int = 0,
                              block_q: int = 256, block_kv: int = 512
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain PyTorch version of #12 (any device): the Pallas backward's
    block loops at (block_q, block_kv) — dq over KV blocks (`flash_kernel.py
    :174-209`), then dk/dv over (group member, query block) pairs
    (`:212-254`). Returns (dq, dk, dv) in the (B, S, H|Hk, Dh) layout and
    the input dtypes."""
    _check_shapes(q, k, v)
    b, sq, h, dh = q.shape
    skv, hk = k.shape[1], k.shape[2]
    g = h // hk
    scale = dh ** -0.5
    dev = q.device
    block_q = max(1, min(block_q, sq))
    block_kv = max(1, min(block_kv, skv))
    delta = _delta(o, do).reshape(b, hk, g, sq)
    lse = lse.reshape(b, hk, g, sq)
    qt = q.reshape(b, sq, hk, g, dh).permute(0, 2, 3, 1, 4).float()
    dot = do.reshape(b, sq, hk, g, dh).permute(0, 2, 3, 1, 4).float()
    kt = k.permute(0, 2, 1, 3).float()                       # (B,Hk,Skv,Dh)
    vt = v.permute(0, 2, 1, 3).float()
    pos = torch.arange(sq, device=dev) + q_offset

    dq = torch.empty((b, hk, g, sq, dh), dtype=q.dtype, device=dev)
    for qs, qe in _blocks(sq, block_q):
        acc = torch.zeros((b, hk, g, qe - qs, dh), dtype=torch.float32,
                          device=dev)
        for ks, ke in _blocks(skv, block_kv):
            mask = _visible(pos[qs:qe], torch.arange(ks, ke, device=dev),
                            causal, window)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qt[..., qs:qe, :],
                             kt[:, :, ks:ke]) * scale
            p = torch.where(mask, torch.exp(s - lse[..., qs:qe, None]), 0.0)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", dot[..., qs:qe, :],
                              vt[:, :, ks:ke])
            ds = p * (dp - delta[..., qs:qe, None]) * scale
            acc += torch.einsum("bhgqk,bhkd->bhgqd", ds.to(k.dtype).float(),
                                kt[:, :, ks:ke])
        dq[..., qs:qe, :] = acc.to(q.dtype)

    dk = torch.empty((b, hk, skv, dh), dtype=k.dtype, device=dev)
    dv = torch.empty((b, hk, skv, dh), dtype=v.dtype, device=dev)
    for ks, ke in _blocks(skv, block_kv):
        dk_acc = torch.zeros((b, hk, ke - ks, dh), dtype=torch.float32,
                             device=dev)
        dv_acc = torch.zeros_like(dk_acc)
        for gi in range(g):
            for qs, qe in _blocks(sq, block_q):
                mask_t = _visible(pos[qs:qe], torch.arange(ks, ke, device=dev),
                                  causal, window).T
                qb, dob = qt[:, :, gi, qs:qe], dot[:, :, gi, qs:qe]
                st = torch.einsum("bhkd,bhqd->bhkq", kt[:, :, ks:ke],
                                  qb) * scale
                pt = torch.where(mask_t, torch.exp(
                    st - lse[:, :, gi, None, qs:qe]), 0.0)
                dv_acc += torch.einsum("bhkq,bhqd->bhkd",
                                       pt.to(do.dtype).float(), dob)
                dpt = torch.einsum("bhkd,bhqd->bhkq", vt[:, :, ks:ke], dob)
                dst = pt * (dpt - delta[:, :, gi, None, qs:qe]) * scale
                dk_acc += torch.einsum("bhkq,bhqd->bhkd",
                                       dst.to(q.dtype).float(), qb)
        dk[:, :, ks:ke] = dk_acc.to(k.dtype)
        dv[:, :, ks:ke] = dv_acc.to(v.dtype)
    return (dq.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh),
            dk.permute(0, 2, 1, 3).contiguous(),
            dv.permute(0, 2, 1, 3).contiguous())


# ---------------------------------------------------------------- wrappers
def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, Sq, H, Dh), k/v (B, Skv, Hk, Dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or h % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)} (H must be a multiple of Hk)")


def _fits(t: torch.Tensor) -> bool:
    """Can the kernels read t through its strides? The last dimension
    contiguous, and every row start aligned: the float32 kernels read
    element pairs (the batch/seq/head strides even, the base 8-byte
    aligned), the bf16 kernels copy 16-byte chunks with cp.async (those
    strides multiples of 8 elements, the base 16-byte aligned)."""
    elems = 8 if t.dtype == torch.bfloat16 else 2
    return (t.stride(3) == 1 and all(s % elems == 0 for s in t.stride()[:3])
            and t.data_ptr() % (elems * t.element_size()) == 0)


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """t itself where the kernels can read it in place, else a contiguous
    copy (aligned: Dh is a multiple of 8 and PyTorch's allocations are
    256-byte aligned); raises if even that does not fit."""
    if _fits(t):
        return t
    t = t.contiguous() if not t.is_contiguous() else t.clone()
    if not _fits(t):
        raise ValueError(f"flash_attention: a {t.dtype} operand of shape "
                         f"{tuple(t.shape)} at {t.data_ptr():#x} has rows "
                         "the kernels cannot read aligned")
    return t


def _launch(q, k, v, causal, window, q_offset, with_lse):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got "
                         f"{dev}")
    _check_shapes(q, k, v)
    for name, t in (("k", k), ("v", v)):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; q is "
                             f"{q.dtype} on {dev}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention takes float32 or bfloat16, got "
                         f"{q.dtype}")
    b, sq, h, dh = q.shape
    skv, hk = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} above the grid's 65535")
    if skv == 0:
        raise ValueError("flash_attention needs at least one key")
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    o = torch.empty((b, sq, h, dh), dtype=q.dtype, device=dev)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=dev)
           if with_lse else None)
    if b == 0 or sq == 0 or h == 0:
        return o, lse
    fn = build.entry(
        "flash_attention", "flash_attention_launch",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
        + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3 + [ctypes.c_float,
                                                           ctypes.c_void_p])
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    err = build.call(fn, dev, build.ptr(q), build.ptr(k), build.ptr(v),
                     build.ptr(o), build.ptr(lse), _DTYPES[q.dtype], dh, b, h,
                     hk, sq, skv, *strides, int(causal), int(window),
                     int(q_offset), dh ** -0.5)
    build.check(err, "flash_attention")
    return o, lse


def _cost_of(formula):
    """A kernel function's cost from its (B, Sq, H, Dh) q and (B, Skv,
    Hk, Dh) k: `formula` (`kernel_costs.flash_attention*`) at this call's
    shapes, masking and element size."""
    def cost(out, q, k, *rest, causal, window, q_offset, fake, **blocks):
        b, sq, h, dh = q.shape
        return formula(b, sq, k.shape[1], h, k.shape[2], dh, causal=causal,
                       window=window, q_offset=q_offset,
                       itemsize=q.element_size())
    return cost


_flash_cost = _cost_of(kernel_costs.flash_attention)
_fwd_cost = _cost_of(kernel_costs.flash_attention_fwd)
_bwd_cost = _cost_of(kernel_costs.flash_attention_bwd)


def _o_out(q, k, v, **kw):
    return torch.empty_like(q)


def _fwd_out(q, k, v, **kw):
    b, sq, h, _ = q.shape
    return torch.empty_like(q), torch.empty((b, h, sq), dtype=torch.float32,
                                            device=q.device)


def _bwd_out(q, k, v, o, lse, do, **kw):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    block_q: int = 256, block_kv: int = 512) -> torch.Tensor:
    """(B, Sq, H, Dh) x (B, Skv, Hk, Dh) -> (B, Sq, H, Dh).

    Differentiable: with grad mode on and q, k or v requiring a gradient,
    it runs `FlashAttentionFn` (forward #11, backward #12). Otherwise CUDA
    tensors launch kernel #10 (or raise), and CPU tensors take the plain
    version at (block_q, block_kv)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, window, q_offset,
                                      block_q, block_kv)
    if _oa.ACTIVE is not None:
        return _oa.ACTIVE.kernel(
            "flash_attention", flash_attention, _flash_cost, _o_out, q, k, v,
            causal=causal, window=window, q_offset=q_offset,
            block_q=block_q, block_kv=block_kv)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, block_q=block_q,
                                     block_kv=block_kv)
    o, _ = _launch(q, k, v, causal, window, q_offset, with_lse=False)
    if o.numel():                     # an empty output launches nothing
        flash_attention.launches += 1
    return o


flash_attention.launches = 0


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, block_q: int = 256,
                        block_kv: int = 512
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward that also returns the row log-sum-exp (the residual a
    backward pass saves): (o (B, Sq, H, Dh), lse (B, H, Sq) float32).
    CUDA tensors launch kernel #11 (or raise); CPU tensors take the plain
    version."""
    if _oa.ACTIVE is not None:
        return _oa.ACTIVE.kernel(
            "flash_attention_fwd", flash_attention_fwd, _fwd_cost, _fwd_out,
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            block_q=block_q, block_kv=block_kv)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         window=window, q_offset=q_offset,
                                         block_q=block_q, block_kv=block_kv)
    o, lse = _launch(q, k, v, causal, window, q_offset, with_lse=True)
    if o.numel():
        flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def _launch_bwd(q, k, v, o, lse, do, causal, window, q_offset):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu tensors, "
                         f"got {dev}")
    _check_shapes(q, k, v)
    for name, t in (("k", k), ("v", v), ("o", o), ("do", do)):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; q is "
                             f"{q.dtype} on {dev}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention_bwd takes float32 or bfloat16, "
                         f"got {q.dtype}")
    b, sq, h, dh = q.shape
    skv, hk = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 \
            or lse.device != dev:
        raise ValueError(f"lse must be float32 (B, H, Sq) = {(b, h, sq)} on "
                         f"{dev}, got {lse.dtype} {tuple(lse.shape)} on "
                         f"{lse.device}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} above the grid's 65535")
    if skv == 0:
        raise ValueError("flash_attention_bwd needs at least one key")
    dq = torch.empty((b, sq, h, dh), dtype=q.dtype, device=dev)
    dk = torch.empty((b, skv, hk, dh), dtype=k.dtype, device=dev)
    dv = torch.empty((b, skv, hk, dh), dtype=v.dtype, device=dev)
    if b == 0 or sq == 0 or h == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = _delta(o, do)
    lse = lse.contiguous()
    q, k, v, do = (_kernel_operand(t) for t in (q, k, v, do))
    fn = build.entry(
        "flash_attention_bwd", "flash_attention_bwd_launch",
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
        + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
    strides = [s for t in (q, k, v, do) for s in t.stride()[:3]]
    err = build.call(fn, dev, build.ptr(q), build.ptr(k), build.ptr(v),
                     build.ptr(do), build.ptr(lse), build.ptr(delta),
                     build.ptr(dq), build.ptr(dk), build.ptr(dv),
                     _DTYPES[q.dtype], dh, b, h, hk, sq, skv, *strides,
                     int(causal), int(window), int(q_offset), dh ** -0.5)
    build.check(err, "flash_attention_bwd")
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, block_q: int = 256,
                        block_kv: int = 512
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward from the forward's o and lse and the cotangent do:
    (dq (B, Sq, H, Dh), dk, dv (B, Skv, Hk, Dh)) in the input dtype. CUDA
    tensors launch kernel #12 (or raise); CPU tensors take the plain
    version."""
    if _oa.ACTIVE is not None:
        return _oa.ACTIVE.kernel(
            "flash_attention_bwd", flash_attention_bwd, _bwd_cost, _bwd_out,
            q, k, v, o, lse, do, causal=causal, window=window,
            q_offset=q_offset, block_q=block_q, block_kv=block_kv)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window, q_offset=q_offset,
                                         block_q=block_q, block_kv=block_kv)
    dq, dk, dv = _launch_bwd(q, k, v, o, lse, do, causal, window, q_offset)
    if dq.numel():
        flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """The custom_vjp of `repro/kernels/flash_attention/ops.py:28-54`: the
    forward runs #11 and saves (q, k, v, o, lse); the backward runs #12.
    Arguments after v: causal, window, q_offset, block_q, block_kv."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, block_q, block_kv):
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  block_q=block_q, block_kv=block_kv)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_inference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, **kw) -> torch.Tensor:
    """Forward-only variant (no LSE output buffer): kernel #10."""
    return flash_attention(q, k, v, **kw)


def flash_traffic_bytes(b: int, h: int, hk: int, sq: int, skv: int, dh: int,
                        *, block_q: int = 256, itemsize: int = 2) -> int:
    """HBM traffic of one flash-attention call (the TPU kernel's model).

    Reads: q once; k/v re-fetched once per q-block PER Q HEAD (the GQA
    index map shares fetches only via cache locality — count worst case).
    Writes: output once. Score blocks never leave on-chip memory.
    """
    nq = max(sq // block_q, 1)
    q_bytes = b * h * sq * dh
    kv_bytes = 2 * b * h * nq * skv * dh      # per-q-head, per-q-block sweep
    o_bytes = b * h * sq * dh
    return (q_bytes + kv_bytes + o_bytes) * itemsize
