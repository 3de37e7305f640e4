"""GQA flash-attention forward: the CUDA kernels #10 and #11 and their
plain versions, plus the tile-traffic model.

Replaces `flash_attention_pallas` (`repro/kernels/flash_attention/
flash_kernel.py:83`) and `flash_attention_fwd_pallas` (`:257`), the
kernels behind `repro.kernels.flash_attention.ops.flash_attention`. Both
come from one source, `csrc/flash_attention.cu`, templated on the element
type and on whether the row log-sum-exp is written.

Layout is the JAX wrapper's: q (B, Sq, H, Dh), k/v (B, Skv, Hk, Dh) in,
o (B, Sq, H, Dh) out, and lse (B, H, Sq) float32; query head `hi` reads
KV head `hi // (H // Hk)`. The kernel reads q, k and v through their
strides (the last dimension contiguous), so no transpose is copied.

The arithmetic is the Pallas kernel's (`flash_kernel.py:36-80`):
  * s = dot(q, k) in float32, times Dh^-0.5 after the dot;
  * masked scores (causal `k_pos <= q_pos`, window `k_pos > q_pos -
    window`, `q_pos = row + q_offset`) are -1e30, not -inf, and the
    running max starts at -1e30;
  * l sums the float32 p; the PV product takes p rounded to the value
    dtype, with float32 accumulation;
  * o = acc / max(l, 1e-30) in the input dtype; lse = m + log(max(l,
    1e-30)).
Any Sq and Skv: the ragged edges are masked inside the kernel, and a key
past the end is no key at all. The Pallas wrapper's `Sq % block_q == 0` is
the TPU's constraint; here block_q/block_kv are the plain version's block
loop, and the kernel tiles by 64 rows and 64 keys whatever they are.

The tensors carry no gradient in this slice: the backward kernel (#12)
and the `torch.autograd.Function` around it belong to the training slice,
so the wrappers refuse inputs that require a gradient.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_NEG = -1e30
HEAD_DIMS = (32, 64, 128)            # the kernel's template instances
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ------------------------------------------------------------ plain version
def _blocks(n: int, size: int) -> list[tuple[int, int]]:
    return [(s, min(s + size, n)) for s in range(0, n, size)]


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
            k_pos = torch.arange(ks, ke, device=dev)
            mask = torch.ones((qe - qs, ke - ks), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= k_pos[None, :] <= q_pos[:, None]
            if window > 0:
                mask &= k_pos[None, :] > (q_pos[:, None] - window)
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


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """The kernel reads element pairs through the batch/seq/head strides:
    the last dimension contiguous, those strides even, the base aligned
    to a pair. Anything else is copied into a contiguous tensor."""
    pair = 2 * t.element_size()
    if (t.stride(3) == 1 and all(s % 2 == 0 for s in t.stride()[:3])
            and t.data_ptr() % pair == 0):
        return t
    return t.contiguous() if not t.is_contiguous() else t.clone()


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention has no backward in this slice "
                           "(kernel #12 comes with training)")
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
    err = fn(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(o),
             build.ptr(lse), _DTYPES[q.dtype], dh, b, h, hk, sq, skv,
             *strides, int(causal), int(window), int(q_offset), dh ** -0.5,
             ctypes.c_void_p(build.stream_handle()))
    build.check(err, "flash_attention")
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    block_q: int = 256, block_kv: int = 512) -> torch.Tensor:
    """(B, Sq, H, Dh) x (B, Skv, Hk, Dh) -> (B, Sq, H, Dh). CUDA tensors
    launch kernel #10 (or raise); CPU tensors take the plain version at
    (block_q, block_kv)."""
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
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         window=window, q_offset=q_offset,
                                         block_q=block_q, block_kv=block_kv)
    o, lse = _launch(q, k, v, causal, window, q_offset, with_lse=True)
    if o.numel():
        flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


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
