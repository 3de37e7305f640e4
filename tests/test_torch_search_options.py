"""The search options the crossed lane test (tests/test_torch_search.py)
does not hold, through both packages on one index.

A JAX-built index (N 2,048, D 32, R 16, 4-bit RaBitQ, 150 tombstones, a
label plane) crosses into the port by `core_to_arrays` /
`core_from_arrays`. Both packages then search it on the megakernel, hop
and unfused lanes, with kernels and plain, under each option: telemetry
on, both filter modes, a beam schedule (48, 32, 16), `rerank=False` and
`rerank_tile=16`, at beam 48. Held to the conformance bars
(tests/test_conformance.py): id agreement >= 0.95, dists rtol 1e-3 / atol
1e-2, hops equal, no tombstoned or out-of-filter id.

Telemetry: `scored`, `masked` and `duplicates` equal the JAX package's on
the same lane. `occupancy` is held against the JAX package's unfused
path on every lane: at L = 48 > R + 1 the JAX fused kernels' frontier
merge (`_merge_topl`) refills the +inf tail with taken entries, a
recorded fault of the JAX kernels, so their occupancy is not the
reference there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import search_spec as jss
from repro.core.construction import ConstructionParams as JParams
from repro.core.index import JasperIndex as JIndex
from repro.core.index_core import core_search as j_core_search
from repro.core.index_core import core_to_arrays as j_to_arrays
from repro_torch.core import search_spec as tss
from repro_torch.core.index_core import core_from_arrays, core_search

SEED = 654
N, D, Q, K, BEAM = 2048, 32, 48, 10, 48
N_DELETE = 150
ID_AGREEMENT = 0.95
DIST_RTOL, DIST_ATOL = 1e-3, 1e-2
PARAMS = dict(degree_bound=16, alpha=1.2, beam_width=16, max_iters=24,
              rev_cap=16, prune_chunk=256)

LANES = {"megakernel": dict(fusion="megakernel"), "hop": dict(fusion="hop"),
         "none": dict(fusion="none")}
OPTIONS = {
    "telemetry": dict(telemetry="on"),
    "filter-exclude": dict(filter=(1, 3), filter_mode="exclude"),
    "filter-traverse": dict(filter=(0, 2), filter_mode="traverse"),
    "schedule": dict(beam_schedule=(48, 32, 16)),
    "no-rerank": dict(rerank=False),
    "rerank-tile16": dict(rerank_tile=16),
}
CELLS = [(lane, kernels, opt) for lane in LANES for kernels in (True, False)
         for opt in OPTIONS]
CELL_IDS = [f"{lane}-{'kernel' if k else 'plain'}-{opt}"
            for lane, k, opt in CELLS]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors gain nothing from intra-op threads; one thread keeps
    this file from competing with the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _spec_kw(lane, kernels, opt):
    return dict(k=K, beam_width=BEAM, quantized=True, use_kernels=kernels,
                traverse_deleted=True, **LANES[lane], **OPTIONS[opt])


@pytest.fixture(scope="module")
def crossed():
    rng = np.random.default_rng(SEED)
    data = rng.normal(size=(N, D)).astype(np.float32)
    queries = rng.normal(size=(Q, D)).astype(np.float32)
    labels = rng.integers(0, 4, N)
    jidx = JIndex(D, N, construction=JParams(**PARAMS),
                  quantization="rabitq", bits=4, seed=SEED)
    jidx.build(data, labels=labels)
    dead = np.sort(rng.choice(N, N_DELETE, replace=False))
    jidx.delete(dead)
    core = core_from_arrays(j_to_arrays(jidx.core), bits=4, store_dims=D,
                            quantized=True, device="cpu")
    return dict(jidx=jidx, core=core, queries=queries, labels=labels,
                dead=dead, jax={}, port={})


def _run(crossed, pkg, lane, kernels, opt):
    """One package's search of a cell (memoised per module)."""
    key = (lane, kernels, opt)
    memo = crossed[pkg]
    if key not in memo:
        q = crossed["queries"]
        if pkg == "jax":
            spec = jss.SearchSpec(**_spec_kw(lane, kernels, opt))
            out = j_core_search(crossed["jidx"].core, jnp.asarray(q),
                                spec=spec.resolve(), filter_tombstones=True,
                                filter_bytes=(jnp.asarray(spec.filter_bytes())
                                              if spec.filter is not None
                                              else None))
            memo[key] = [np.asarray(x) for x in out[:3]] + (
                [[np.asarray(t) for t in out[3]]] if len(out) > 3 else [])
        else:
            spec = tss.SearchSpec(**_spec_kw(lane, kernels, opt))
            out = core_search(crossed["core"], torch.as_tensor(q),
                              spec=spec.resolve(), filter_tombstones=True,
                              filter_bytes=spec.filter_bytes())
            memo[key] = [_np(x) for x in out[:3]] + (
                [[_np(t) for t in out[3]]] if len(out) > 3 else [])
    return memo[key]


@pytest.mark.parametrize("lane,kernels,opt", CELLS, ids=CELL_IDS)
def test_option_matches_jax(crossed, lane, kernels, opt):
    j = _run(crossed, "jax", lane, kernels, opt)
    t = _run(crossed, "port", lane, kernels, opt)
    (j_ids, j_d, j_hops), (t_ids, t_d, t_hops) = j[:3], t[:3]
    assert t_ids.shape == j_ids.shape == (Q, K)
    assert float(np.mean(t_ids == j_ids)) >= ID_AGREEMENT
    np.testing.assert_allclose(t_d, j_d, rtol=DIST_RTOL, atol=DIST_ATOL)
    assert np.array_equal(t_hops, j_hops)
    kept = t_ids[t_ids >= 0]
    assert not np.isin(kept, crossed["dead"]).any()
    filt = OPTIONS[opt].get("filter")
    if filt is not None:
        assert np.isin(crossed["labels"][kept], filt).all()
    if opt == "telemetry":
        # scored, masked, duplicates: the JAX package's same lane
        for a, b in zip(t[3][:3], j[3][:3]):
            assert np.array_equal(a, b)
        # occupancy: the JAX package's unfused path (see the docstring)
        ref = _run(crossed, "jax", "none", kernels, opt)
        assert np.array_equal(t[3][3], ref[3][3])
        assert t[3][3].shape == (Q, ref[3][3].shape[1])
