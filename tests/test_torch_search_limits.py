"""The shapes the fused search kernels take (`check_fused_shape`), on the
CPU: a pure function of (L, R, the row's bytes, codes per 16-byte unit),
held at its edges.

A block holds QUERIES_PER_BLOCK query slots of `query_smem_bytes` each
and has at most SMEM_PER_BLOCK bytes of shared memory. 4-bit rows of
whole 64-byte groups go to the tensor cores, which keep the query as three
bf16 parts (6 B a code) and stage rows unpadded; other rows keep an f32
query (4 B a code) and stage rows at an odd count of 16-byte units. With
64-byte rows and R = 64 a slot is 6,432 + 24 L bytes (L a multiple of
4): L = 2,152 fits and L = 2,153 does not. At L = R = 64 the widest
tensor-core rows are 4,224 bytes (264 units); SIMT rows of 6,160 bytes
(385 units, one row a stage) fit, and one byte more does not.
"""

import pytest

from repro_torch.kernels.search_step.ops import (
    QUERIES_PER_BLOCK, SMEM_PER_BLOCK, check_fused_shape, query_smem_bytes)

ROW4 = (64, 32)     # D = 128 at 4 bits: 64 bytes, 32 codes a unit


def test_query_slot_at_the_main_shape():
    # q as three bf16 parts 3 x 128 x 2 + frontier 2 x 3 x 256 + ids and
    # positions 2 x 256 + keys 64 x 8 + 64 rows of 64 B + their two
    # metadata floats 2 x 256 + counters 32
    assert query_smem_bytes(64, 64, *ROW4) == (
        768 + 1536 + 512 + 512 + 64 * 64 + 512 + 32)


def test_query_slot_on_the_simt_path():
    # D = 128 at 8 bits: q f32 512 + the same frontier, ids, keys + 35
    # rows a stage (5,120 // 144) at a stride of 9 units + metadata
    assert query_smem_bytes(64, 64, 128, 16) == (
        512 + 1536 + 512 + 512 + 35 * 144 + 2 * 144 + 32)


@pytest.mark.parametrize("l_width, r, row_bytes, codes_per_unit", [
    (64, 64, *ROW4),       # the main path: bigann-1M, beam 64, 4 bits
    (128, 64, *ROW4),      # L > R + 1, the exact-arithmetic cases
    (64, 64, 16, 128),     # 1 bit at D = 128
    (64, 64, 128, 16),     # 8 bits at D = 128
    (64, 64, 512, 4),      # exact rows at D = 128: 9 rows a stage
    (64, 64, 20, 32),      # D = 40 at 4 bits: 20-byte rows
    (64, 64, 18, 32),      # D = 36 at 4 bits: 18-byte rows
    (32, 64, 2304, 32),    # the RAG index's megakernel lane, D = 4,608
    (16, 16, 16, 32),      # the card tests' small shape
    (1, 1, 1, 128),
    (2152, 64, *ROW4),     # the largest L at R = 64, D = 128, 4 bits
    (64, 64, 4224, 32),    # the widest tensor-core rows at L = R = 64
    (64, 64, 6160, 32),    # the widest SIMT rows (385 units) at L = R = 64
])
def test_shapes_accepted(l_width, r, row_bytes, codes_per_unit):
    check_fused_shape(l_width, r, row_bytes, codes_per_unit)
    assert QUERIES_PER_BLOCK * query_smem_bytes(
        l_width, r, row_bytes, codes_per_unit) <= SMEM_PER_BLOCK


def test_a_frontier_slot_costs_24_bytes():
    # ids, dists and visited bits in two buffers, 16 bytes at a time
    assert (query_smem_bytes(68, 64, *ROW4) - query_smem_bytes(64, 64, *ROW4)
            == 6 * 16)


def test_the_stage_stops_at_its_bytes():
    # 64-byte rows: the stage grows a row (and its metadata) with R up to
    # 80 rows, 5,120 B; past that only the two R-int arrays grow (a 81st
    # candidate takes a second stage)
    assert (query_smem_bytes(64, 80, *ROW4) - query_smem_bytes(64, 79, *ROW4)
            == 64)
    assert (query_smem_bytes(64, 81, *ROW4) - query_smem_bytes(64, 80, *ROW4)
            == 2 * 16)


@pytest.mark.parametrize("l_width, r, row_bytes, codes_per_unit", [
    (2153, 64, *ROW4),
    (64, 64, 4288, 32),
    (64, 64, 6161, 32),
    (4096, 64, *ROW4),
    (64, 8192, *ROW4),
])
def test_shapes_refused_name_the_limit(l_width, r, row_bytes,
                                       codes_per_unit):
    with pytest.raises(ValueError) as err:
        check_fused_shape(l_width, r, row_bytes, codes_per_unit)
    msg = str(err.value)
    assert f"L={l_width}, R={r} and rows of {row_bytes} B" in msg
    assert f"the limit is {SMEM_PER_BLOCK}" in msg
    need = QUERIES_PER_BLOCK * query_smem_bytes(l_width, r, row_bytes,
                                                codes_per_unit)
    assert need > SMEM_PER_BLOCK
    assert f"need {need} bytes" in msg


@pytest.mark.parametrize("l_width, r", [(0, 64), (64, 0), (-1, 16)])
def test_empty_frontier_or_row_refused(l_width, r):
    with pytest.raises(ValueError, match="L and R must be >= 1"):
        check_fused_shape(l_width, r, *ROW4)
