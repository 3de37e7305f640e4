"""The arithmetic of the RaBitQ estimator kernels, on the CPU.

`rabitq_distance` (#6, csrc/rabitq_distance.cu) takes its products on the
tensor cores: codes (integers below 2^bits <= 256, exact in bf16) times a
float32 query split exactly into three bf16 parts, q = h0 + h1 + h2, each
of 8 significant bits, so every product is exact; mma.sync adds 16
products a k-step into a float32 accumulator, the finest part first.
Here, written in torch:

  (a) the split: h0 + h1 + h2 == q exactly, each part a bf16 value with no
      rounding left, on a small build's rotated queries, negatives, zeros
      and values near 2^-100;
  (b) the kernel's sums emulated (float32 products, float32 sums of 16 in
      k-steps, parts 2, 1, 0): bit-equal to `rabitq_distance_plain` and to
      JAX's `rabitq_distance_ref` on integer operands; within
      chip_smoke.py's `within` bound (rtol 1e-4 plus 1e-6 of the magnitude
      the estimator cancels) on real ones, at bits 1, 2, 4 and 8 and
      ragged D;
  (c) the shapes `rabitq_search_step` (#3) takes: a query's shared slot
      (`step_smem_bytes`) within SMEM_PER_BLOCK, held at its edge by
      `check_step_shape`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rabitq_dot.ref import rabitq_distance_ref
from repro_torch.core import rabitq as tr
from repro_torch.kernels.rabitq_dot.ops import (
    SMEM_PER_BLOCK, STEP_WARPS_PER_BLOCK, check_step_shape,
    rabitq_distance_plain, step_smem_bytes)


def split3(q: torch.Tensor):
    """float32 q -> three bf16 parts, each the remainder rounded to
    nearest even, as the kernel's `split_queries` does."""
    h0 = q.to(torch.bfloat16)
    r1 = q - h0.float()
    h1 = r1.to(torch.bfloat16)
    r2 = r1 - h1.float()
    return h0, h1, r2.to(torch.bfloat16), r2


def rotated_queries(seed=0, n=256, nq=64, d=96, bits=4):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32) * 30)
    q = torch.as_tensor(rng.normal(size=(nq, d)).astype(np.float32) * 30)
    params = tr.rabitq_train(torch.Generator().manual_seed(seed), x,
                             bits=bits)
    return params, x, tr.rabitq_preprocess_query(params, q)


def _queries(kind: str) -> torch.Tensor:
    rng = np.random.default_rng(len(kind))
    if kind == "rotated":
        return rotated_queries()[2].q_rot
    if kind == "negative":
        return torch.as_tensor(-np.abs(rng.normal(size=(32, 100)))
                               .astype(np.float32) * 1e3)
    if kind == "zeros":
        q = rng.normal(size=(16, 64)).astype(np.float32)
        q[:, ::3] = 0.0
        q[3] = 0.0
        return torch.as_tensor(q)
    # near 2^-100: every part stays a normal bf16 value
    return torch.as_tensor((rng.normal(size=(16, 64)) * 2.0 ** -100)
                           .astype(np.float32))


@pytest.mark.parametrize("kind", ["rotated", "negative", "zeros", "tiny"])
def test_three_bf16_parts_sum_to_the_query_exactly(kind):
    q = _queries(kind)
    h0, h1, h2, r2 = split3(q)
    for h in (h0, h1, h2):
        assert h.dtype == torch.bfloat16
    assert torch.equal(h2.float(), r2)              # nothing left to round
    assert torch.equal((h0.float() + h1.float()) + h2.float(), q)
    assert torch.equal(h0.double() + h1.double() + h2.double(), q.double())
    assert bool((h1.float().abs() <= h0.float().abs()).all())
    assert bool((h2.float().abs() <= h1.float().abs()).all())


def test_the_split_keeps_all_24_bits():
    # one part, or two, would lose the low mantissa bits of these queries
    q = _queries("rotated")
    h0, h1, h2, _ = split3(q)
    assert not torch.equal(h0.float(), q)
    assert not torch.equal(h0.float() + h1.float(), q)
    assert bool((h2 != 0).any())


def emulated_distance(packed, add, rescale, q_rot, qa, qs, *, bits):
    """#6's arithmetic: bf16 codes x the three bf16 parts, float32 products,
    float32 sums of 16 a k-step into one accumulator, parts 2, 1, 0 each
    k-step; then the epilogue in the plain version's order."""
    q, d = q_rot.shape
    codes = tr.unpack_codes(packed, bits, d).to(torch.bfloat16).float()
    parts = split3(q_rot.to(torch.float32))[:3]
    dpad = -(-d // 16) * 16
    codes = torch.nn.functional.pad(codes, (0, dpad - d))
    parts = [torch.nn.functional.pad(h.float(), (0, dpad - d)) for h in parts]
    acc = torch.zeros((q, codes.shape[0]), dtype=torch.float32)
    for k0 in range(0, dpad, 16):
        c = codes[None, :, k0:k0 + 16]
        for part in (2, 1, 0):
            acc = acc + (parts[part][:, None, k0:k0 + 16] * c).sum(-1)
    est = add[None, :] + qa[:, None] + rescale[None, :] * (acc - qs[:, None])
    return torch.clamp(est, min=0.0)


# (Q, C, D): D ragged against the k-step of 16 and the chunk of 64
SHAPES = [(5, 7, 33), (9, 40, 64), (3, 17, 100), (12, 31, 130)]


def _operands(rng, shape, bits, integer):
    q, c, d = shape
    p = tr.packed_dim(d, bits)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32))
    packed = torch.as_tensor(rng.integers(0, 256, (c, p)).astype(np.uint8))
    if integer:
        return (packed, t(rng.integers(0, 4000, c)),
                t(rng.choice([-2., -1., 1., 2.], c)),
                t(rng.integers(-3, 4, (q, d))), t(rng.integers(0, 500, q)),
                t(rng.integers(-50, 50, q)))
    return (packed, t(rng.normal(size=c) * 100), t(rng.normal(size=c)),
            t(rng.normal(size=(q, d))), t(rng.normal(size=q) * 100),
            t(rng.normal(size=q) * 10))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s))
                                               for s in SHAPES])
def test_emulated_kernel_is_bit_equal_on_integer_operands(bits, shape):
    args = _operands(np.random.default_rng(bits * 10 + shape[2]), shape,
                     bits, True)
    got = emulated_distance(*args, bits=bits)
    assert torch.equal(got, rabitq_distance_plain(*args, bits=bits))
    want = rabitq_distance_ref(*(jnp.asarray(a.numpy()) for a in args),
                               bits=bits, dims=shape[2])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s))
                                               for s in SHAPES])
def test_emulated_kernel_within_the_bound_on_real_operands(bits, shape):
    args = _operands(np.random.default_rng(bits * 10 + shape[2] + 1), shape,
                     bits, False)
    got = emulated_distance(*args, bits=bits)
    want = rabitq_distance_plain(*args, bits=bits)
    _, add, rescale, q_rot, qa, qs = args
    qmag = q_rot.abs().sum(1) * (2 ** bits - 1) + qs.abs()
    terms = (add.abs()[None, :] + qa.abs()[:, None]
             + rescale.abs()[None, :] * qmag[:, None])
    assert bool(((got - want).abs() <= 1e-4 * want.abs() + 1e-6 * terms)
                .all())


def test_emulated_kernel_on_a_small_builds_codes():
    # real codes and rotated queries of the port's own quantizer
    params, x, rq = rotated_queries(seed=3, d=128)
    codes = tr.rabitq_encode(params, x)
    args = (codes.packed, codes.data_add, codes.data_rescale, rq.q_rot,
            rq.query_add, rq.query_sumq)
    got = emulated_distance(*args, bits=4)
    want = rabitq_distance_plain(*args, bits=4)
    qmag = rq.q_rot.abs().sum(1) * 15 + rq.query_sumq.abs()
    terms = (codes.data_add.abs()[None, :] + rq.query_add.abs()[:, None]
             + codes.data_rescale.abs()[None, :] * qmag[:, None])
    assert bool(((got - want).abs() <= 1e-4 * want.abs() + 1e-6 * terms)
                .all())


# ---- (c) the shapes rabitq_search_step takes
def test_step_slot_at_the_main_shape():
    # 64 rows of 64 B + the ids and dots of 64 rows; 16 words a row, so
    # the query stays in registers
    assert step_smem_bytes(64, 64, 4) == 64 * 64 + 2 * 4 * 64


def test_step_slot_holds_the_query_past_32_units():
    # 33 words a row (D = 264 at 4 bits): the query's 264 floats join
    assert step_smem_bytes(64, 132, 4) == 264 * 4 + 64 * 144 + 2 * 4 * 64
    # 33 bytes a row (not a multiple of 4), likewise
    assert step_smem_bytes(64, 33, 4) == 66 * 4 + 8 + 64 * 48 + 2 * 4 * 64


def test_step_slot_stages_the_rag_rows_in_rounds():
    # D = 4,608 at 4 bits: 2,304-byte rows, 7 a round (16,384 B of stage)
    assert step_smem_bytes(64, 2304, 4) == 4608 * 4 + 7 * 2304 + 7 * 8 + 8


def test_step_slot_stops_at_its_rows():
    # 64-byte rows: the slot grows a row (and its two words) up to 128 rows
    # a round; past that K takes more rounds, not more memory
    assert step_smem_bytes(128, 64, 4) == 128 * (64 + 8)
    assert step_smem_bytes(126, 64, 4) == 126 * (64 + 8)
    assert step_smem_bytes(129, 64, 4) == step_smem_bytes(128, 64, 4)
    assert step_smem_bytes(4096, 64, 4) == step_smem_bytes(128, 64, 4)


@pytest.mark.parametrize("k, p, bits", [
    (64, 64, 4),          # the main path: bigann-1M, R = 64, 4 bits
    (1, 64, 4),           # the medoid's launch
    (128, 64, 4),         # K = 128: one round of 128 rows
    (64, 16, 1),          # 1 bit at D = 128
    (64, 128, 8),         # 8 bits at D = 128
    (64, 18, 4),          # D = 36: rows of 18 B, byte copies
    (64, 2304, 4),        # the RAG index, D = 4,608
    (64, 46480, 8),       # the widest 8-bit rows: one row a round
    (64, 6832, 1),        # the widest 1-bit rows: two a round
])
def test_step_shapes_accepted(k, p, bits):
    check_step_shape(k, p, bits)
    assert step_smem_bytes(k, p, bits) <= SMEM_PER_BLOCK
    # the main path holds STEP_WARPS_PER_BLOCK queries a block
    if (k, p, bits) == (64, 64, 4):
        assert (STEP_WARPS_PER_BLOCK * step_smem_bytes(k, p, bits)
                <= SMEM_PER_BLOCK)


@pytest.mark.parametrize("k, p, bits", [
    (64, 46496, 8),       # one 16-byte unit past the widest 8-bit rows
    (64, 6848, 1),
    (1, 60000, 4),
])
def test_step_shapes_refused_name_the_limit(k, p, bits):
    with pytest.raises(ValueError) as err:
        check_step_shape(k, p, bits)
    msg = str(err.value)
    need = step_smem_bytes(k, p, bits)
    assert need > SMEM_PER_BLOCK
    assert f"K={k} and rows of {p} B at {bits} bits" in msg
    assert f"need {need} bytes" in msg
    assert f"the limit is {SMEM_PER_BLOCK}" in msg
