"""The gathered-rows RaBitQ estimator, #5 `rabitq_gather_distance`, on the
CPU.

The kernel (csrc/rabitq_distance.cu) scores its rows with the scorer of
csrc/rabitq_rows.cuh, which #3 `rabitq_search_step` shares: a group of G
lanes a row (G the least power of two >= the row's units, at most 32),
lanes g, g + 32, ... of a row, eight rows' FMA chains a lane, xor shuffles
G/2 .. 1, and codes made floats exactly by a byte permute under 2^23's
exponent. Here, in numpy float32:

  (a) that scorer emulated bit for bit equals a whole warp's order (lane
      l takes units l, l + 32, ..., then xor shuffles 16 .. 1: the order
      #5 had before, and the one #3 was held to), on real operands, for rows of 1, 3, 5, 16,
      17, 32, 33, 64 and 576 units at bits 1, 2, 4 and 8, with rows whose
      codes are all zero and queries of negative values; with the
      epilogue, bit-equal to `rabitq_gather_distance_plain` on integer
      operands;
  (b) the shapes the kernel takes: a warp's shared slot
      (`gather_smem_bytes`, two buffers) within SMEM_PER_BLOCK, held at its
      edge by `check_gather_shape`;
  (c) the wrapper on CPU tensors (its plain version) against JAX's
      `rabitq_gather_distance` (Pallas in interpret mode) at K 1, 64 and
      300 and rows of 33, 64 and 2,304 bytes, rtol 1e-3 / atol 1e-2 as
      tests/test_torch_distance.py holds it.
"""

import numpy as np
import pytest
import torch

from repro.kernels.rabitq_dot import ops as jrops
from repro_torch.kernels.rabitq_dot.ops import (
    GATHER_MAX_ROWS, GATHER_WARPS_PER_BLOCK, SMEM_PER_BLOCK,
    check_gather_shape, gather_smem_bytes, gather_warps_per_block,
    rabitq_gather_distance, rabitq_gather_distance_plain)

F32 = np.float32
TWO23 = F32(8388608.0)


# ---- (a) the scorer's arithmetic
def fma32(a, b, c):
    """float32 a * b + c with one rounding, as the card's FFMA: the product
    of a code (<= 8 bits) and a float32 is exact in float64, the float64
    sum's error comes from TwoSum, and a sum that lands exactly between two
    float32 values is rounded the way its error points."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.astype(F32)
    r64 = r.astype(np.float64)
    other = np.nextafter(r, np.where(s > r64, F32(np.inf), F32(-np.inf)))
    tie = (r64 != s) & ((r64 + other.astype(np.float64)) / 2 == s)
    toward = np.where(err > 0, np.maximum(r, other), np.minimum(r, other))
    return np.where(tie & (err != 0), toward, r).astype(F32)


def units_of(rows: np.ndarray, words: bool) -> np.ndarray:
    """(M, P) uint8 rows -> (M, units) uint32 units: little-endian words,
    or bytes."""
    if words:
        return rows.view("<u4").astype(np.uint32)
    return rows.astype(np.uint32)


def code_of(x: np.ndarray, j: int, bits: int) -> np.ndarray:
    """rabitq_rows.cuh `code_of`: code j of each unit as a float32, its
    bits under 2^23's exponent less 2^23 (at 4 bits through the split
    nibbles and a byte permute)."""
    if bits == 4:
        half = (x >> 4) & 0x0F0F0F0F if j & 1 else x & 0x0F0F0F0F
        under = ((half >> (8 * (j >> 1))) & 0xFF) | 0x4B000000
    else:
        under = ((x >> (j * bits)) & ((1 << bits) - 1)) | 0x4B000000
    return under.astype(np.uint32).view(F32) - TWO23


def lane_partials(x, q, lanes, bits, words):
    """Partial dots of each row over the units lane, lane + 32, ...: code
    j of unit u times q[u * CPU + j], one FMA after another. x: (M, units)
    units, q: (units * CPU,) float32; returns (M, lanes)."""
    cpu = (32 if words else 8) // bits
    m, units = x.shape
    acc = np.zeros((m, lanes), F32)
    for base in range(0, units, 32):
        u = base + np.arange(lanes)
        live = u < units
        uc = np.where(live, u, 0)
        for j in range(cpu):
            prod = fma32(code_of(x[:, uc], j, bits),
                         np.broadcast_to(q[uc * cpu + j], (m, lanes)), acc)
            acc = np.where(live, prod, acc)
    return acc


def warp_order(rows, q, bits):
    """A whole warp a row: lane l takes units l, l + 32, ..., then xor
    shuffles 16 .. 1; lane 0's sum of each row."""
    words = rows.shape[1] % 4 == 0
    v = lane_partials(units_of(rows, words), q, 32, bits, words)
    for off in (16, 8, 4, 2, 1):
        v = v + v[:, np.arange(32) ^ off]
    return v[:, 0]


def pow2_at_least(n: int) -> int:
    g = 1
    while g < n:
        g <<= 1
    return g


def group_scorer(rows, q, bits):
    """rabitq_rows.cuh `score_rows`: a group of G lanes a row, kChains rows
    a lane a pass, the group reduced by xor shuffles G/2 .. 1; lane g == 0
    of each group writes its row's dot. Returns the (M,) dots."""
    words = rows.shape[1] % 4 == 0
    x = units_of(rows, words)
    m, units = x.shape
    g_size = pow2_at_least(units) if units < 32 else 32
    per = 32 // g_size
    chains = 8 if bits >= 4 else 2 * bits
    v = lane_partials(x, q, g_size, bits, words)
    for off in [g_size >> s for s in range(1, g_size.bit_length())]:
        v = v + v[:, np.arange(g_size) ^ off]
    dots = np.full(m, np.nan, F32)
    for r0 in range(0, m, chains * per):     # the passes of the warp
        for lane in range(0, 32, g_size):    # each group's lane g == 0
            for c in range(chains):
                r = r0 + lane // g_size + c * per
                if r < m:
                    assert np.isnan(dots[r])  # each row scored once
                    dots[r] = v[r, 0]
    assert not np.isnan(dots).any()
    return dots


def _rows_and_query(units, bits, words, seed, m=19):
    """m rows of `units` units (words or bytes) with two rows of all-zero
    codes, and a real query with negative values (one all negative)."""
    rng = np.random.default_rng(seed)
    p = 4 * units if words else units
    rows = rng.integers(0, 256, (m, p)).astype(np.uint8)
    rows[[3, 11]] = 0
    dq = units * (32 if words else 8) // bits
    q = (rng.normal(size=dq) * 7).astype(F32)
    if seed % 2:
        q = -np.abs(q)
    return rows, q


# (units, row of words): 32-bit words where P is a multiple of 4, bytes
# otherwise (1, 3, 5, 17 and 33 bytes)
SCORER_ROWS = [(u, True) for u in (1, 3, 5, 16, 17, 32, 33, 64, 576)] + [
    (u, False) for u in (1, 3, 5, 17, 33)]


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("units, words", SCORER_ROWS,
                         ids=[f"{u}{'w' if w else 'b'}"
                              for u, w in SCORER_ROWS])
def test_group_scorer_equals_warp_order(bits, units, words):
    for seed in (units, units + 1):
        rows, q = _rows_and_query(units, bits, words, seed)
        got = group_scorer(rows, q, bits)
        want = warp_order(rows, q, bits)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        assert not (got.view(np.uint32) == 0x80000000).any()  # no -0
        assert (got[[3, 11]] == 0).all()


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_whole_passes_score_rows_alike(bits):
    """The kernel hands score_rows an item's rows in whole passes of the
    warp (kScoreChains rows a lane, 32 / G groups) when a row is 4, 8, 16 or
    32 words, then the rest: each row's dot equals the one it gets in a
    single call over the whole item (D = 128: 4 * bits words a row)."""
    units = 4 * bits
    rows, q = _rows_and_query(units, bits, True, bits, m=64 + 5)
    per_pass = (8 if bits >= 4 else 2 * bits) * 32 // units
    whole = group_scorer(rows, q, bits)
    parts = np.concatenate([group_scorer(rows[r0:r0 + per_pass], q, bits)
                            for r0 in range(0, len(rows), per_pass)])
    np.testing.assert_array_equal(parts.view(np.uint32),
                                  whole.view(np.uint32))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_code_of_is_exact(bits):
    x = np.random.default_rng(bits).integers(0, 2 ** 32, 4096,
                                             dtype=np.uint64).astype(np.uint32)
    for j in range(32 // bits):
        want = ((x >> (j * bits)) & ((1 << bits) - 1)).astype(F32)
        np.testing.assert_array_equal(code_of(x, j, bits), want)


def test_fma32_rounds_once():
    # 205 * 5237765 = 2^30 + 1: added to 2^54 the float64 sum drops the 1
    # and lands on the tie between two float32 values; one rounding of the
    # exact sum goes up, a second one of the float64 sum to even goes down
    a, b, c = (np.array([v], F32) for v in (205.0, 5237765.0, 2.0 ** 54))
    assert np.float32(a.astype(np.float64) * b + c) == F32(2.0 ** 54)
    assert fma32(a, b, c)[0] == F32(2.0 ** 54 + 2.0 ** 31)
    # an exact tie rounds to even
    one = np.array([1.0], F32)
    assert fma32(one, np.array([2.0 ** -24], F32), one)[0] == F32(1.0)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("k, p", [(1, 16), (40, 33), (64, 64), (9, 2304)])
def test_emulated_kernel_is_bit_equal_on_integer_operands(bits, k, p):
    """The scorer and the estimator epilogue (add + qa) + rescale * (dot -
    qsum), clamped at 0, against the plain version: integer operands make
    every sum exact, so the orders agree bit for bit."""
    rng = np.random.default_rng(bits * 100 + k)
    nq = 3
    d = p * (8 // bits) - 3
    cand = rng.integers(0, 256, (nq, k, p)).astype(np.uint8)
    add = rng.integers(0, 4000, (nq, k)).astype(F32)
    rescale = rng.choice([-2., -1., 1., 2.], (nq, k)).astype(F32)
    q = rng.integers(-3, 4, (nq, d)).astype(F32)
    qa = rng.integers(0, 500, nq).astype(F32)
    qs = rng.integers(-50, 50, nq).astype(F32)
    got = np.empty((nq, k), F32)
    for i in range(nq):
        q_pad = np.zeros(p * (8 // bits), F32)
        q_pad[:d] = q[i]
        dot = group_scorer(cand[i], q_pad, bits)
        est = (add[i] + qa[i]) + rescale[i] * (dot - qs[i])
        got[i] = np.maximum(est, F32(0))
    want = rabitq_gather_distance_plain(
        *(torch.as_tensor(a) for a in (cand, add, rescale, q, qa, qs)),
        bits=bits)
    np.testing.assert_array_equal(got, want.numpy())


# ---- (b) the shapes the kernel takes
def test_gather_slot_at_the_main_shape():
    # two buffers of the query (128 floats) and 64 rows of 64 B, then the
    # 64 dots; four warps a block
    assert gather_smem_bytes(64, 64, 4) == 2 * (512 + 64 * 64) + 64 * 4
    assert gather_warps_per_block(64, 64, 4) == GATHER_WARPS_PER_BLOCK
    assert GATHER_WARPS_PER_BLOCK * gather_smem_bytes(64, 64, 4) == 37_888


def test_gather_slot_takes_the_rag_rows_in_items():
    # 2,304 B rows (D = 4,608): the query (18,432 B) and 7 rows an item,
    # twice; three warps a block
    assert gather_smem_bytes(300, 2304, 4) == 2 * (4608 * 4 + 7 * 2304) + 32
    assert gather_warps_per_block(300, 2304, 4) == 3


def test_gather_slot_stops_at_its_rows():
    assert gather_smem_bytes(1000, 16, 4) == 2 * (128 + GATHER_MAX_ROWS
                                                  * 16) + GATHER_MAX_ROWS * 4
    assert gather_smem_bytes(1, 17, 4) == 2 * (144 + 32) + 16
    assert gather_smem_bytes(40, 33, 4) == 2 * (272 + 1328) + 160


@pytest.mark.parametrize("k, p, bits", [
    (64, 64, 4), (300, 2304, 4), (40, 33, 4), (1, 16, 1), (300, 2304, 1),
    (13, 17, 2), (128, 64, 8), (1, 12_900, 4)])
def test_gather_shapes_accepted(k, p, bits):
    assert gather_smem_bytes(k, p, bits) <= SMEM_PER_BLOCK
    assert gather_warps_per_block(k, p, bits) >= 1
    check_gather_shape(k, p, bits)


@pytest.mark.parametrize("k, p, bits", [(1, 8192, 1), (1, 13_000, 4)])
def test_gather_shapes_refused_name_the_limit(k, p, bits):
    assert gather_smem_bytes(k, p, bits) > SMEM_PER_BLOCK
    assert gather_warps_per_block(k, p, bits) == 0
    with pytest.raises(ValueError, match=str(SMEM_PER_BLOCK)):
        check_gather_shape(k, p, bits)


# ---- (c) the wrapper's plain version against JAX's kernel
@pytest.mark.parametrize("k", [1, 64, 300])
@pytest.mark.parametrize("p", [33, 64, 2304])
def test_gather_distance_matches_jax(k, p):
    bits, nq = 4, 5
    rng = np.random.default_rng(k * 10_000 + p)
    d = 2 * p - (1 if p == 33 else 0)
    cand = rng.integers(0, 256, (nq, k, p)).astype(np.uint8)
    args = (cand, (rng.normal(size=(nq, k)) * 100).astype(F32),
            rng.normal(size=(nq, k)).astype(F32),
            rng.normal(size=(nq, d)).astype(F32),
            (rng.normal(size=nq) * 100).astype(F32),
            (rng.normal(size=nq) * 10).astype(F32))
    want = jrops.rabitq_gather_distance(*args, bits=bits)
    got = rabitq_gather_distance(*(torch.as_tensor(a) for a in args),
                                 bits=bits)
    assert tuple(got.shape) == (nq, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-2)


@pytest.mark.parametrize("bits", [1, 2, 8])
def test_gather_distance_matches_jax_at_each_width(bits):
    nq, k, p = 5, 64, 64
    rng = np.random.default_rng(bits)
    d = p * (8 // bits)
    args = (rng.integers(0, 256, (nq, k, p)).astype(np.uint8),
            (rng.normal(size=(nq, k)) * 100).astype(F32),
            rng.normal(size=(nq, k)).astype(F32),
            rng.normal(size=(nq, d)).astype(F32),
            (rng.normal(size=nq) * 100).astype(F32),
            (rng.normal(size=nq) * 10).astype(F32))
    want = jrops.rabitq_gather_distance(*args, bits=bits)
    got = rabitq_gather_distance(*(torch.as_tensor(a) for a in args),
                                 bits=bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-2)
