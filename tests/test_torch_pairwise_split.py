"""The arithmetic of the exact all-pairs scan kernel, on the CPU.

`pairwise_l2` (#7, csrc/pairwise_l2.cu) takes its products on the tensor
cores: both float32 operands split exactly into three bf16 parts
(`bf16_parts`), a block of PAIRWISE_TILE queries x PAIRWISE_TILE rows votes
a k-chunk of PAIRWISE_CHUNK dims at a time on whether either tile holds a
value that is not a bf16 value (`chunk_votes`), and takes h0.h0 alone, or
the products of parts with i + j <= 2 that the votes allow, finest first,
16 dims (one mma k-step) at a time into a float32 accumulator; the norms
come from the float32 values. Here, written in torch:

  (a) the split: h0 + h1 + h2 == v exactly, for both operands;
  (b) the kernel's sums emulated: bit-equal to `pairwise_l2_plain` and to
      JAX's `pairwise_l2_ref` on integer operands (float32 and bf16
      inputs), ragged Q, C and D; within chip_smoke.py's `within` (rtol
      1e-4 plus 1e-6 of |q|^2 + |x|^2) on noisy queries against integer
      rows and on real x real;
  (c) leaving out the products of parts that a chunk's vote skips changes
      no bit: the emulation that takes all six products everywhere gives
      the same output;
  (d) the products counted for the bound (`pairwise_tensor_flops`), and
      the row limit refused with a named error.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.distance.ref import pairwise_l2_ref
from repro_torch.kernels.distance.ops import (
    PAIRWISE_CHUNK, PAIRWISE_MAX_ROWS, PAIRWISE_TILE, bf16_parts,
    check_pairwise_rows, chunk_votes, pairwise_l2_plain,
    pairwise_tensor_flops)

# the kernel's order of the products of parts (i of q, j of x) in a chunk,
# finest first: i + j = 2, 1, 0
ORDER = [(2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0)]


def emulated_pairwise_l2(q, x, *, vote=True):
    """#7's arithmetic: the votes of each (tile, chunk), the products of
    parts they allow (all six with i + j <= 2 when vote=False), each over
    the chunk's k-steps in turn: float32 products, float32 sums of 16 a
    k-step into one accumulator; the norms from the float32 values; the
    epilogue in the plain version's order."""
    q = q.to(torch.float32)
    x = x.to(torch.float32)
    nq, d = q.shape
    chunks = max(1, -(-d // PAIRWISE_CHUNK))
    pad = chunks * PAIRWISE_CHUNK - d
    qh = [torch.nn.functional.pad(h, (0, pad)) for h in bf16_parts(q)]
    xh = [torch.nn.functional.pad(h, (0, pad)) for h in bf16_parts(x)]
    # rows of each tile whose chunk kc votes for its parts h1, h2
    vq = chunk_votes(q).repeat_interleave(PAIRWISE_TILE, 0)[:nq]
    vx = chunk_votes(x).repeat_interleave(PAIRWISE_TILE, 0)[:x.shape[0]]
    acc = torch.zeros((nq, x.shape[0]), dtype=torch.float32)
    for kc in range(chunks):
        aq = vq[:, kc][:, None] | (not vote)
        ax = vx[:, kc][None, :] | (not vote)
        for i, j in ORDER:
            for k0 in range(kc * PAIRWISE_CHUNK, (kc + 1) * PAIRWISE_CHUNK,
                            16):
                take = ((aq if i else torch.ones_like(aq))
                        & (ax if j else torch.ones_like(ax)))
                prod = (qh[i][:, None, k0:k0 + 16]
                        * xh[j][None, :, k0:k0 + 16]).sum(-1)
                acc = torch.where(take, acc + prod, acc)
    qsq = (q * q).sum(-1)
    xsq = (x * x).sum(-1)
    return torch.clamp((qsq[:, None] - 2.0 * acc) + xsq[None, :], min=0.0)


def within(got, want, q, x, rtol=1e-4, ulps=1e-6):
    """chip_smoke.py's bound: rtol of the distance plus ulps of the terms
    |q|^2 + |x|^2 that the distance cancels."""
    terms = (q * q).sum(-1)[:, None] + (x * x).sum(-1)[None, :]
    return bool(((got - want).abs() <= rtol * want.abs() + ulps * terms)
                .all())


# (Q, C, D): ragged against the tile of 128, the chunk of 32 and the k-step
# of 16, several tiles on both sides
SHAPES = [(1, 1, 1), (5, 7, 33), (3, 17, 100), (130, 211, 100),
          (129, 257, 31), (40, 300, 128), (7, 129, 160)]
IDS = ["x".join(map(str, s)) for s in SHAPES]


def _operands(shape, kind, seed):
    """numpy-seeded (q, x) of `kind`: "integer" (bigann-like 0..255 rows,
    -255..255 queries), "noisy" (real queries, integer rows), "real"
    (real x real) or "mixed" (integer queries in the first tile, real
    ones after; integer rows in the first tile, real after)."""
    nq, c, d = shape
    rng = np.random.default_rng(seed)
    q = rng.integers(-255, 256, (nq, d)).astype(np.float32)
    x = rng.integers(0, 256, (c, d)).astype(np.float32)
    if kind in ("noisy", "real"):
        q = q + rng.normal(scale=0.37, size=q.shape).astype(np.float32)
    if kind == "real":
        x = x * np.float32(0.01) + rng.normal(size=x.shape).astype(np.float32)
    if kind == "mixed":
        q[PAIRWISE_TILE:] += rng.normal(size=q[PAIRWISE_TILE:].shape
                                        ).astype(np.float32)
        x[PAIRWISE_TILE:] *= np.float32(1.001)
    return torch.as_tensor(q), torch.as_tensor(x)


@pytest.mark.parametrize("kind", ["integer", "real"])
def test_both_operands_split_into_three_exact_parts(kind):
    for v in _operands((64, 96, 100), kind, 1):
        h0, h1, h2 = bf16_parts(v)
        for h in (h0, h1, h2):
            assert torch.equal(h.to(torch.bfloat16).float(), h)
        assert torch.equal((h0 + h1) + h2, v)
        assert torch.equal(h0.double() + h1.double() + h2.double(),
                           v.double())
        if kind == "integer":
            assert not h1.any() and not h2.any()


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_emulated_kernel_is_bit_equal_on_integer_operands(shape):
    q, x = _operands(shape, "integer", sum(shape))
    got = emulated_pairwise_l2(q, x)
    assert torch.equal(got, pairwise_l2_plain(q, x))
    want = pairwise_l2_ref(jnp.asarray(q.numpy()), jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_emulated_kernel_is_bit_equal_on_bf16_inputs(shape):
    # integer values held as bf16 (the wrapper widens them to float32):
    # every chunk takes h0.h0 alone
    q, x = (t.clamp(-256, 256).to(torch.bfloat16)
            for t in _operands(shape, "integer", sum(shape) + 1))
    assert not chunk_votes(q.float()).any()
    assert not chunk_votes(x.float()).any()
    got = emulated_pairwise_l2(q, x)
    assert torch.equal(got, pairwise_l2_plain(q, x))
    want = pairwise_l2_ref(jnp.asarray(q.float().numpy()).astype(jnp.bfloat16),
                           jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["noisy", "real", "mixed"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_emulated_kernel_within_the_bound_on_real_operands(shape, kind):
    q, x = _operands(shape, kind, sum(shape) + 2)
    got = emulated_pairwise_l2(q, x)
    assert within(got, pairwise_l2_plain(q, x), q, x)
    want = torch.as_tensor(np.asarray(pairwise_l2_ref(
        jnp.asarray(q.numpy()), jnp.asarray(x.numpy()))))
    assert within(got, want, q, x)


@pytest.mark.parametrize("kind", ["integer", "noisy", "real", "mixed"])
def test_skipping_the_parts_a_vote_leaves_out_changes_no_bit(kind):
    q, x = _operands((200, 300, 100), kind, 3)
    assert torch.equal(emulated_pairwise_l2(q, x),
                       emulated_pairwise_l2(q, x, vote=False))


def test_the_votes_follow_the_tiles_and_chunks():
    q, x = _operands((200, 300, 100), "mixed", 4)
    # integer queries in the first tile, real ones in the second; rows
    # scaled by 1.001 leave bf16 in the second and third tiles
    assert chunk_votes(q).tolist() == [[False] * 4, [True] * 4]
    assert chunk_votes(x)[0].tolist() == [False] * 4
    assert bool(chunk_votes(x)[1:].all())
    # a real value in one dim of one row votes for its tile's chunk alone
    z = torch.zeros((300, 70))
    z[200, 40] = 0.1
    votes = chunk_votes(z)
    assert votes.shape == (3, 3)
    assert votes.nonzero().tolist() == [[1, 1]]


@pytest.mark.parametrize("kind, products", [("integer", 1), ("noisy", 3),
                                            ("real", 6)])
def test_products_counted_for_the_bound(kind, products):
    q, x = _operands((300, 257, 100), kind, 5)
    assert pairwise_tensor_flops(q, x) == 2.0 * 300 * 257 * 100 * products


def test_products_counted_tile_by_tile():
    # 128 of 200 queries integer, all 300 rows integer: the 72 real queries
    # take three products, the rest one
    q, x = _operands((200, 300, 64), "mixed", 6)
    x = x.round()
    assert pairwise_tensor_flops(q, x) == 2.0 * 300 * 64 * (128 + 3 * 72)


def test_rows_accepted_up_to_the_grid():
    assert PAIRWISE_MAX_ROWS == 65535 * PAIRWISE_TILE
    check_pairwise_rows(PAIRWISE_MAX_ROWS)
    check_pairwise_rows(131_072)


@pytest.mark.parametrize("rows", [PAIRWISE_MAX_ROWS + 1, 2 ** 31 - 1])
def test_rows_past_the_grid_refused_name_the_limit(rows):
    with pytest.raises(ValueError) as err:
        check_pairwise_rows(rows)
    assert f"at most {PAIRWISE_MAX_ROWS} rows per call, got {rows}" in str(
        err.value)
