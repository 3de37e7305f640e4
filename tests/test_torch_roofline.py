"""The port's roofline (`repro_torch.roofline`) against the JAX package's.

* `roofline_terms` and `model_flops`: equal to JAX's for the same inputs,
  exactly, on a `HwSpec` holding `TPU_V5E`'s numbers.
* `op_analyzer.OpAnalyzer` counts eager loops as they run: its FLOPs for a
  Python loop of 5 `tanh(x @ w)` and for 3 x 4 nested loops equal
  `analyze_hlo`'s on JAX's scanned programs (`tests/test_roofline.py`)
  exactly. A reduced stablelm-1.6b forward and train step
  (`use_flash_kernel=False` in both packages, the default) are within rel
  0.01 (forward) and 0.02 (train step) of `analyze_hlo` on the JAX
  functions compiled on the CPU.
* Collectives under a fake 4-rank group: counted by kind at their result
  bytes, exactly.
* Every kernel function reports its `kernel_costs` formula once, exactly,
  with no op inside it counted; on fake operands it returns its outputs'
  shapes without running and counts the most the data could need.
* The bounds `chip_smoke.py` prints come from `kernel_costs`: each formula
  equals the inline formula the script computed before, and gives the
  bound `PERF.md`'s kernel table holds at its shapes (to its 4 digits).
  The flash formulas read K/V only at the keys some query attends
  (`visible_keys`, held against the plain versions' mask).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.roofline import analysis as janalysis
from repro.roofline.hlo_analyzer import analyze_hlo
from repro_torch.roofline import kernel_costs as kc
from repro_torch.roofline import op_analyzer as oa
from repro_torch.roofline.analysis import (
    H100,
    HwSpec,
    model_flops,
    roofline_terms,
)
from repro_torch.roofline.op_analyzer import OpAnalyzer

TPU = janalysis.TPU_V5E
PORT_TPU = HwSpec(name=TPU.name, peak_flops=TPU.peak_flops,
                  hbm_bw=TPU.hbm_bw, ici_bw=TPU.ici_bw)


def _flops(fn, *args) -> float:
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())["flops"]


# ------------------------------------------------------------ analysis
@pytest.mark.parametrize("counts", [
    (1e15, 1e9, 1e6, 1), (1e12, 1e13, 1e6, 1), (1e12, 1e9, 1e12, 1),
    (3.3e14, 7.7e11, 2.5e10, 4), (0.0, 0.0, 0.0, 1)])
def test_roofline_terms_equal_jax(counts):
    """Exactly JAX's terms, dominant term and fraction, on the TPU's
    numbers; the H100's rates take the same formula."""
    assert roofline_terms(*counts, hw=PORT_TPU) == janalysis.roofline_terms(
        *counts, hw=TPU)
    flops, byts, coll, chips = counts
    got = roofline_terms(flops, byts, coll, chips, H100)
    assert got["compute_s"] == flops / (chips * 989e12)
    assert got["memory_s"] == byts / (chips * 3.35e12)
    assert got["collective_s"] == coll / (chips * 450e9)


def test_roofline_terms_split_the_float32_flops():
    """`f32_flops` runs at the float32 rate, the rest at the bf16 one."""
    got = roofline_terms(1e12, 0.0, 0.0, 1, H100, f32_flops=4e11)
    assert got["compute_s"] == 6e11 / 989e12 + 4e11 / 67e12


@pytest.mark.parametrize("n,t,training", [(1000, 10, True),
                                          (1000, 10, False),
                                          (2_730_000_000, 16_384, True)])
def test_model_flops_equal_jax(n, t, training):
    assert model_flops(n, t, training) == janalysis.model_flops(n, t,
                                                                training)


# ------------------------------------------------------------ loops
def test_loop_flops_equal_analyze_hlo_on_the_scan():
    """5 eager iterations count what the scanned program's while body,
    weighted by its trip count, counts."""
    def body(x, w):
        return jnp.tanh(x @ w), None

    xs = jax.ShapeDtypeStruct((64, 96), jnp.float32)
    ws = jax.ShapeDtypeStruct((5, 96, 96), jnp.float32)
    want = _flops(lambda x, ws: jax.lax.scan(body, x, ws)[0], xs, ws)
    x, w = torch.randn(64, 96), torch.randn(5, 96, 96)
    with OpAnalyzer() as ana:
        for i in range(5):
            x = torch.tanh(x @ w[i])
    assert ana.analyze()["flops"] == want == 5 * 2 * 64 * 96 * 96


def test_nested_loop_flops_equal_analyze_hlo():
    def inner(x, w):
        return jnp.tanh(x @ w), None

    def outer(x, ws):
        x, _ = jax.lax.scan(inner, x, ws)
        return x, None

    xs = jax.ShapeDtypeStruct((96, 96), jnp.float32)
    wss = jax.ShapeDtypeStruct((3, 4, 96, 96), jnp.float32)
    want = _flops(lambda x, wss: jax.lax.scan(outer, x, wss)[0], xs, wss)
    x, w = torch.randn(96, 96), torch.randn(3, 4, 96, 96)
    with OpAnalyzer() as ana:
        for i in range(3):
            for j in range(4):
                x = torch.tanh(x @ w[i, j])
    assert ana.analyze()["flops"] == want == 3 * 4 * 2 * 96 ** 3


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference"])
def test_composite_products_are_counted_in_every_grad_mode(mode):
    """linear, einsum and matmul reach the mode undecomposed under
    inference_mode: their products are counted all the same."""
    import contextlib
    ctx = {"grad": contextlib.nullcontext, "no_grad": torch.no_grad,
           "inference": torch.inference_mode}[mode]
    x, w = torch.randn(4, 8, 16), torch.randn(32, 16)
    with ctx(), OpAnalyzer() as ana:
        y = torch.nn.functional.linear(x, w)
        z = torch.einsum("bsd,bsd->bs", y, y)
        _ = torch.matmul(x, w.T), z
    assert ana.analyze()["flops"] == (2 * 4 * 8 * 16 * 32 + 2 * 4 * 8 * 32
                                      + 2 * 4 * 8 * 16 * 32)
    assert oa.ACTIVE is None


def test_an_op_with_its_own_kernel_is_counted_whole():
    """silu's backward has CPU and CUDA kernels: it is one op of its
    operand and result bytes, not its decomposition's passes."""
    x = torch.randn(64, 32, requires_grad=True)
    y = torch.nn.functional.silu(x)
    g = torch.ones_like(y)
    with OpAnalyzer() as ana:
        y.backward(g)
    ops = ana.by_op
    assert ops["aten.silu_backward"] == {"count": 1, "bytes": 3 * 64 * 32 * 4,
                                         "flops": 0.0}


# ------------------------------------------------------------ models
B, S = 2, 128


@pytest.fixture(scope="module")
def stablelm():
    from repro.configs import get_config as jget
    from repro.models import model as jm
    from repro_torch.configs import get_config
    jcfg, cfg = (jget("stablelm-1.6b").reduced(),
                 get_config("stablelm-1.6b").reduced())
    assert not cfg.use_flash_kernel and not jcfg.use_flash_kernel
    return jcfg, cfg, jm.init_params(jcfg, jax.random.PRNGKey(0))


def _port_model(cfg):
    from repro_torch.models import model as tm
    return tm.init_params(cfg, 0, device="cpu", param_dtype=torch.float32)


def _batch():
    z = torch.zeros((B, S), dtype=torch.int32)
    return {"tokens": z, "labels": z.clone()}


def test_forward_flops_within_1pct_of_analyze_hlo(stablelm):
    from repro.models import model as jm
    from repro_torch.models import model as tm
    jcfg, cfg, p = stablelm
    want = _flops(lambda p, t: jm.forward(p, jcfg, {"tokens": t}), p,
                  jnp.zeros((B, S), jnp.int32))
    params = _port_model(cfg)
    with torch.no_grad(), OpAnalyzer() as ana:
        tm.forward(params, cfg, {"tokens": _batch()["tokens"]})
    got = ana.analyze()["flops"]
    assert got == pytest.approx(want, rel=0.01)


def test_train_step_flops_within_2pct_of_analyze_hlo(stablelm):
    from repro.training import train_loop as jtl
    from repro.training.optimizer import OptimizerConfig as JOpt
    from repro_torch.training import (
        OptimizerConfig, init_train_state, make_train_step)
    jcfg, cfg, p = stablelm
    jb = {"tokens": jnp.zeros((B, S), jnp.int32),
          "labels": jnp.zeros((B, S), jnp.int32)}
    want = _flops(jtl.make_train_step(jcfg, JOpt(total_steps=10)),
                  jtl.init_train_state(jcfg, p), jb)
    state = init_train_state(cfg, _port_model(cfg))
    step = make_train_step(cfg, OptimizerConfig(total_steps=10))
    with OpAnalyzer() as ana:
        step(state, _batch())
    got = ana.analyze()["flops"]
    assert got == pytest.approx(want, rel=0.02)


# ------------------------------------------------------------ collectives
@pytest.fixture
def fake_world_of_4():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_collectives_by_kind_at_result_bytes(fake_world_of_4):
    import torch.distributed._functional_collectives as funcol
    t = torch.ones(6, 5)                                  # 120 B
    bufs = (torch.empty(24, 5), torch.empty(6, 5), torch.ones(24, 5),
            torch.empty(8, 5), torch.ones(8, 5))
    with OpAnalyzer() as ana:
        dist.all_reduce(t)
        dist.all_gather_into_tensor(bufs[0], t)              # 480 B
        dist.reduce_scatter_tensor(bufs[1], bufs[2])         # 120 B
        dist.all_to_all_single(bufs[3], bufs[4])             # 160 B
    # the payload is the collective term's, not the memory term's
    assert ana.analyze()["bytes_accessed"] == 0
    with ana:
        g = funcol.all_gather_tensor(t, 0, dist.group.WORLD)
        r = funcol.all_reduce(t, "sum", dist.group.WORLD)
        _ = g + 0, r + 0
    c = ana.analyze()["collectives"]
    assert c["all-reduce"] == {"bytes": 240.0, "count": 2.0}
    assert c["all-gather"] == {"bytes": 960.0, "count": 2.0}
    assert c["reduce-scatter"] == {"bytes": 120.0, "count": 1.0}
    assert c["all-to-all"] == {"bytes": 160.0, "count": 1.0}
    assert c["collective-permute"] == {"bytes": 0.0, "count": 0.0}
    assert c["total"] == {"bytes": 1480.0, "count": 6.0}


# ------------------------------------------------------------ kernels
def _ids(rng, q, k, n):
    return torch.as_tensor(rng.integers(-1, n, (q, k)).astype(np.int32))


def _search_operands(rng, quantized):
    from repro_torch.core.rabitq import (
        RaBitQCodes, RaBitQQuery, pack_codes)
    from repro_torch.core.vamana import VamanaGraph
    from repro_torch.kernels.search_step.ops import fused_operands
    n, d, r, q = 256, 16, 8, 12
    adj = torch.as_tensor(rng.integers(-1, n, (n, r)).astype(np.int32))
    graph = VamanaGraph(adjacency=adj, n_valid=n, medoid=0)
    vec = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32))
    qs = torch.as_tensor(rng.normal(size=(q, d)).astype(np.float32))
    if not quantized:
        return fused_operands(graph, beam_width=16, max_iters=10, queries=qs,
                              vectors=vec, vec_sqnorm=(vec * vec).sum(1))
    codes = RaBitQCodes(
        packed=pack_codes(torch.as_tensor(
            rng.integers(0, 16, (n, d)).astype(np.uint8)), 4),
        data_add=torch.rand(n), data_rescale=torch.rand(n), bits=4, dims=d)
    rq = RaBitQQuery(qs, torch.rand(q), torch.rand(q))
    return fused_operands(graph, beam_width=16, max_iters=10, codes=codes,
                          rq_query=rq)


def _kernel_calls(rng):
    """(name, call, the formula's Cost for the call's output) of every
    kernel function at small shapes on CPU tensors."""
    from repro_torch.kernels.distance import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rabitq_dot import ops as rops
    from repro_torch.kernels.search_step import ops as sops
    from repro_torch.kernels.topk.ops import topk
    q, k, n, d, p = 6, 5, 40, 16, 8
    qs = torch.randn(q, d)
    table = torch.randn(n, d)
    ids = _ids(rng, q, k, n)
    packed = torch.as_tensor(rng.integers(0, 256, (n, p)).astype(np.uint8))
    add, res = torch.rand(n), torch.rand(n)
    qa, qb = torch.rand(q), torch.rand(q)
    qkv = [torch.randn(2, 64, h, 32) for h in (4, 2, 2)]
    o, lse = fops.flash_attention_fwd_plain(*qkv)
    do = torch.randn_like(o)
    valid = float((ids >= 0).sum())
    sq = (table ** 2).sum(1)
    dists, pos = torch.randn(q, 20), _ids(rng, q, 20, n)
    safe = ids.clamp(min=0).long()
    gathered = (packed[safe], add[safe], res[safe])
    cases = [
        ("gather_l2", lambda: dops.gather_l2(qs, table, sq, ids),
         lambda out: kc.gather_l2(q, k, d, n_valid=valid)),
        ("gather_l2_tiled", lambda: dops.gather_l2_tiled(qs, table, sq, ids),
         lambda out: kc.gather_l2(q, k, d, n_valid=valid)),
        ("pairwise_l2", lambda: dops.pairwise_l2(qs, table),
         lambda out: kc.pairwise_l2(q, n, d, tensor_flops=(
             dops.pairwise_tensor_flops(qs, table)))),
        ("topk", lambda: topk(dists, pos, k),
         lambda out: kc.topk(q, 20, k)),
        ("rabitq_distance", lambda: rops.rabitq_distance(
            packed, add, res, qs, qa, qb, bits=4),
         lambda out: kc.rabitq_distance(q, n, p, d)),
        ("rabitq_gather_distance", lambda: rops.rabitq_gather_distance(
            *gathered, qs, qa, qb, bits=4),
         lambda out: kc.rabitq_gather_distance(q, k, p, d)),
        ("rabitq_search_step", lambda: rops.rabitq_search_step(
            ids, packed, add, res, n - 3, qs, qa, qb, bits=4),
         lambda out: kc.rabitq_search_step(
             q, k, p, p * 2, d, n_valid=float(torch.isfinite(out).sum()))),
        ("flash_attention", lambda: fops.flash_attention(*qkv),
         lambda out: kc.flash_attention(2, 64, 64, 4, 2, 32, causal=True,
                                        itemsize=4)),
        ("flash_attention_fwd", lambda: fops.flash_attention_fwd(*qkv),
         lambda out: kc.flash_attention_fwd(2, 64, 64, 4, 2, 32,
                                            causal=True, itemsize=4)),
        ("flash_attention_bwd", lambda: fops.flash_attention_bwd(
            *qkv, o, lse, do, window=16),
         lambda out: kc.flash_attention_bwd(2, 64, 64, 4, 2, 32,
                                            causal=True, window=16,
                                            itemsize=4)),
    ]
    for quant in (True, False):
        ops = _search_operands(rng, quant)
        (f_ids, f_dists, f_vis), hop_ops = sops.hop_operands(ops)
        row, meta = ((ops["data"].shape[1], 8) if quant
                     else (4 * ops["data"].shape[1], 4))
        dq, r = ops["q"].shape[1], ops["adjacency"].shape[1]
        cases += [
            ("fused_search", lambda ops=ops: sops.fused_search(
                **ops, telemetry=True),
             lambda out, row=row, meta=meta, dq=dq, r=r: kc.fused_search(
                 12, 16, r, row, meta, dq, hops=float(out[2].sum()),
                 scored=float(out[3][:, 0].sum()))),
            ("fused_hop", lambda f=(f_ids, f_dists, f_vis), h=hop_ops:
             sops.fused_hop(*f, 16, **h),
             lambda out, row=row, meta=meta, dq=dq, r=r: kc.fused_hop(
                 12, 16, r, row, meta, dq, active=float(out[3].sum()),
                 scored=float(out[3].sum()) * r)),
        ]
    return cases


@pytest.mark.parametrize("case", range(14))
def test_kernel_function_counts_its_formula_once(case):
    """Under the analyzer a kernel function counts its formula once — all
    the flops and bytes counted — whether or not the plain version
    dispatched ops inside it, and returns what it returns without it."""
    rng = np.random.default_rng(case)
    name, call, formula = _kernel_calls(rng)[case]
    torch.manual_seed(case)
    want = call()
    torch.manual_seed(case)
    with OpAnalyzer() as ana:
        got = call()
    assert oa.ACTIVE is None
    for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (got, want))):
        assert torch.equal(a, b)
    c = ana.analyze()
    cost = formula(got)
    assert c["kernels"] == {name: {"calls": 1, "bytes": cost.bytes,
                                   "flops": cost.flops, "rate": cost.rate}}
    assert c["bytes_accessed"] == cost.bytes and c["flops"] == cost.flops
    assert c["flops_f32"] == (cost.flops if cost.rate == "f32" else 0.0)


def test_kernel_functions_on_fake_operands_return_shapes_only():
    """On fake operands a kernel function runs nothing: its outputs have
    the real run's shapes and dtypes, and its formula counts the most the
    data could need (#1: max_iters hops a query, every neighbour
    scored)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.search_step import ops as sops
    ops = _search_operands(np.random.default_rng(3), True)
    real = sops.fused_search(**ops, telemetry=True)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake_ops = {k: mode.from_tensor(v) if isinstance(v, torch.Tensor)
                    else v for k, v in ops.items()}
        with OpAnalyzer() as ana:
            out = sops.fused_search(**fake_ops, telemetry=True)
            assert bool(out[0].sum() > 0) is True    # a host read: continue
    assert [(t.shape, t.dtype) for t in out] == [(t.shape, t.dtype)
                                                 for t in real]
    c = ana.analyze()
    hops = 12 * 10
    cost = kc.fused_search(12, 16, 8, ops["data"].shape[1], 8,
                           ops["q"].shape[1], hops=hops, scored=hops * 8)
    assert c["kernels"]["fused_search"]["bytes"] == cost.bytes
    assert ana.host_reads_answered == 1


# ------------------------------------------------------------ bounds
# the formulas chip_smoke.py computed inline before they moved here
def _old_fused_search(n_q, beam, r, p, bits, d, hops, scored):
    return ((hops * r * 4 + scored * (p + 8)
             + n_q * (beam * 12 + beam * 8 + 4 + p * 8 // bits * 4 + 8)),
            scored * 2 * d)


def _old_fused_hop(n_q, beam, r, p, dq, d, active, scored):
    return ((n_q * beam * 24 + active * r * 4 + scored * (p + 8)
             + n_q * (dq * 4 + 8) + n_q * 4), scored * 2 * d)


def _old_step(n_q, r, p, bits, d, n_valid):
    return (n_q * r * 8 + n_valid * (p + 8)
            + n_q * (p * 8 // bits * 4 + 8), n_valid * 2 * d)


MAIN = dict(n_q=10_000, beam=64, r=64, p=64, bits=4, d=128)


@pytest.mark.parametrize("hops,scored", [(1.0e6, 3.0e7), (3.9e5, 4.1e7),
                                         (1.4e6, 4.4e7)])
def test_data_dependent_bounds_equal_the_inline_formulas(hops, scored):
    """#1, #3 and #4 depend on the walk; at any counts their formulas are
    the ones chip_smoke.py computed inline."""
    m = MAIN
    c = kc.fused_search(m["n_q"], m["beam"], m["r"], m["p"], 8,
                        m["p"] * 8 // m["bits"], hops=hops, scored=scored,
                        d=m["d"])
    assert (c.bytes, c.flops) == _old_fused_search(
        m["n_q"], m["beam"], m["r"], m["p"], m["bits"], m["d"], hops, scored)
    c = kc.fused_hop(m["n_q"], m["beam"], m["r"], m["p"], 8, 128,
                     active=hops / 20, scored=scored / 20, d=m["d"])
    assert (c.bytes, c.flops) == _old_fused_hop(
        m["n_q"], m["beam"], m["r"], m["p"], 128, m["d"], hops / 20,
        scored / 20)
    c = kc.rabitq_search_step(m["n_q"], m["r"], m["p"], 128, m["d"],
                              n_valid=scored / 64)
    assert (c.bytes, c.flops) == _old_step(m["n_q"], m["r"], m["p"],
                                           m["bits"], m["d"], scored / 64)


# (name, cost, PERF.md's bound_ms, its "by") at the table's shapes
Q, L, D, P, C = 10_000, 64, 128, 64, 131_072
TABLE = [
    # #1 and #3 at the walk of chip_smoke.py's phase 5 on an NVIDIA H100
    # 80GB HBM3 (739,517 hops, 43,109,391 scored candidates, 577,632
    # in-range ids of #3's hop)
    ("#1 fused_search", kc.fused_search(Q, L, 64, P, 8, 128, hops=739_517,
                                        scored=43_109_391, d=D), 0.988,
     "bytes"),
    ("#3 rabitq_search_step", kc.rabitq_search_step(
        Q, 64, P, 128, D, n_valid=577_632), 0.0155, "bytes"),
    ("#2 gather_l2", kc.gather_l2(Q, L, D, n_valid=Q * L), 0.1016, "bytes"),
    ("#5 rabitq_gather_distance", kc.rabitq_gather_distance(Q, L, P, D),
     0.0161, "bytes"),
    ("#6 rabitq_distance", kc.rabitq_distance(Q, C, P, D), 1.569, "bytes"),
    ("#7 pairwise_l2", kc.pairwise_l2(Q, C, D, tensor_flops=2.0 * Q * C * D),
     1.587, "bytes"),
    ("#8 gather_l2_tiled", kc.gather_l2(Q, L, D, n_valid=Q * L), 0.1016,
     "bytes"),
    ("#9 topk", kc.topk(Q, L + 64, L), 0.0046, "bytes"),
    ("#10 flash_attention", kc.flash_attention(4, 4096, 4096, 36, 4, 128,
                                               causal=True), 0.6254,
     "operations"),
    ("#11 flash_attention_fwd", kc.flash_attention_fwd(
        2, 4096, 4096, 36, 36, 64, causal=True), 0.1563, "operations"),
    ("#12 flash_attention_bwd", kc.flash_attention_bwd(
        2, 4096, 4096, 36, 36, 64, causal=True), 0.3908, "operations"),
    ("#10 at hubert's", kc.flash_attention(4, 1024, 1024, 16, 16, 80,
                                           causal=False), 0.0217,
     "operations"),
    ("#10 at zamba2's", kc.flash_attention(4, 4096, 4096, 32, 32, 80,
                                           causal=True, window=4096),
     0.3474, "operations"),
    ("#10 at olmoe's", kc.flash_attention(4, 1024, 1024, 16, 16, 128,
                                          causal=True), 0.0200, "bytes"),
    ("#11 at granite-moe's", kc.flash_attention_fwd(
        2, 2048, 2048, 16, 8, 64, causal=True), 0.0174, "operations"),
    ("#11 at zamba2's", kc.flash_attention_fwd(
        1, 4096, 4096, 32, 32, 80, causal=True, window=4096), 0.0869,
     "operations"),
    ("#11 at hubert's", kc.flash_attention_fwd(
        4, 1024, 1024, 16, 16, 80, causal=False), 0.0217, "operations"),
    ("#12 at granite-moe's", kc.flash_attention_bwd(
        2, 2048, 2048, 16, 8, 64, causal=True), 0.0434, "operations"),
    ("#12 at zamba2's", kc.flash_attention_bwd(
        1, 4096, 4096, 32, 32, 80, causal=True, window=4096), 0.2171,
     "operations"),
    ("#12 at hubert's", kc.flash_attention_bwd(
        4, 1024, 1024, 16, 16, 80, causal=False), 0.0543, "operations"),
    # the tensor-parallel split's local shapes (chip_smoke.py's TP_FLASH)
    ("#11 at stablelm's heads", kc.flash_attention_fwd(
        16, 4096, 4096, 2, 2, 64, causal=True), 0.0695, "operations"),
    ("#12 at stablelm's heads", kc.flash_attention_bwd(
        16, 4096, 4096, 2, 2, 64, causal=True), 0.1737, "operations"),
    ("#11 at hubert's heads", kc.flash_attention_fwd(
        16, 4096, 4096, 1, 1, 80, causal=False), 0.0869, "operations"),
    ("#12 at hubert's heads", kc.flash_attention_bwd(
        16, 4096, 4096, 1, 1, 80, causal=False), 0.2171, "operations"),
    ("#11 at chameleon's last rank", kc.flash_attention_fwd(
        16, 256, 4096, 64, 8, 128, causal=True, q_offset=3840), 0.5385,
     "operations"),
    ("#12 at chameleon's last rank", kc.flash_attention_bwd(
        16, 256, 4096, 64, 8, 128, causal=True, q_offset=3840), 1.3462,
     "operations"),
    ("#11 at chameleon's first rank", kc.flash_attention_fwd(
        16, 256, 4096, 64, 8, 128, causal=True, q_offset=0), 0.0454,
     "bytes"),
    ("#12 at chameleon's first rank", kc.flash_attention_bwd(
        16, 256, 4096, 64, 8, 128, causal=True, q_offset=0), 0.1656,
     "bytes"),
    # zamba2's shared block on a rank's 2 of 32 heads (TP_PREFILL_FLASH,
    # TP_FLASH): prefill_32k within its 4,096-token window, train_4k
    ("#10 at zamba2's heads", kc.flash_attention(
        2, 32768, 32768, 2, 2, 80, causal=True, window=4096), 0.1629,
     "operations"),
    ("#11 at zamba2's heads", kc.flash_attention_fwd(
        16, 4096, 4096, 2, 2, 80, causal=True, window=4096), 0.0869,
     "operations"),
    ("#12 at zamba2's heads", kc.flash_attention_bwd(
        16, 4096, 4096, 2, 2, 80, causal=True, window=4096), 0.2171,
     "operations"),
]


@pytest.mark.parametrize("name,cost,ms,by", TABLE, ids=[t[0] for t in TABLE])
def test_bounds_equal_perf_md(name, cost, ms, by):
    """Each formula gives `PERF.md`'s bound at its shapes, to the digits
    the table prints (#7's integer operands take h0·h0 alone: 2·Q·C·D
    tensor flops)."""
    got, got_by = cost.bound()
    digits = len(str(ms).split(".")[1])
    assert round(got, digits) == ms and got_by == by


def test_six_and_seven_float32_bounds_equal_perf_md():
    """#6's and #7's float32 bounds beside the bf16 ones: 5.008 ms, by
    operations."""
    c6 = kc.rabitq_distance(Q, C, P, D)
    assert round(kc.bound(c6.bytes, c6.flops)[0], 3) == 5.008
    c7 = kc.pairwise_l2(Q, C, D, tensor_flops=0)
    assert kc.bound(c7.bytes, 2.0 * Q * C * D) == (
        pytest.approx(5.008, abs=5e-4), "operations")


@pytest.mark.parametrize("sq,skv,causal,window,q_offset", [
    (64, 64, True, 0, 0), (64, 64, False, 0, 0), (16, 64, True, 0, 0),
    (16, 64, True, 0, 48), (16, 64, True, 0, 20), (16, 64, True, 24, 40),
    (64, 64, True, 16, 0), (16, 64, False, 8, 30), (16, 64, True, 4, 100)])
def test_flash_bytes_read_only_the_visible_keys(sq, skv, causal, window,
                                                q_offset):
    """The flash formulas read a K/V row only where some query attends
    it: `visible_keys` equals the keys the plain versions' mask
    (`_visible`) keeps for at least one query; #10/#11 read them once,
    #12 reads them once and writes dk and dv whole."""
    from repro_torch.kernels.flash_attention.ops import _visible
    mask = _visible(torch.arange(sq) + q_offset, torch.arange(skv), causal,
                    window)
    keys = int(mask.any(0).sum())
    assert kc.visible_keys(sq, skv, causal, window, q_offset) == keys
    b, h, hk, dh, item = 2, 4, 2, 32, 2
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    assert kc.flash_attention(b, sq, skv, h, hk, dh, **kw).bytes == (
        (2 * b * sq * h + 2 * b * keys * hk) * dh * item)
    assert kc.flash_attention_fwd(b, sq, skv, h, hk, dh, **kw).bytes == (
        (2 * b * sq * h + 2 * b * keys * hk) * dh * item + b * h * sq * 4)
    assert kc.flash_attention_bwd(b, sq, skv, h, hk, dh, **kw).bytes == (
        (4 * b * sq * h + 2 * b * (keys + skv) * hk) * dh * item
        + b * h * sq * 4)
