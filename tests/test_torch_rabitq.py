"""Port parity: RaBitQ, bitmaps / label planes, distances, synthetic data.

Inputs are made from a seed with numpy and fed to both packages; the JAX
package is the reference. Tolerances (stated once, here):

  * pack/unpack, bitmaps, label planes, synthetic data: bit-exact;
  * `_preprocess_query`, `rabitq_estimate`, distance helpers:
    rtol 1e-5, atol 1e-4 (float32 sums in another order);
  * `_encode`: it rounds after a matmul, so a coordinate within an ulp of a
    rounding boundary may flip — held by >= 0.999 code agreement plus the
    estimator tolerance on the metadata.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as jd
from repro.core import mutations as jm
from repro.core import rabitq as jr
from repro_torch.core import distances as td
from repro_torch.core import mutations as tm
from repro_torch.core import rabitq as tr

RTOL, ATOL = 1e-5, 1e-4
CODE_AGREEMENT = 0.999
RNG_SEED = 11


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


def _data(n=400, d=32, seed=RNG_SEED):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32), rng


@pytest.mark.parametrize("bits", tr.SUPPORTED_BITS)
@pytest.mark.parametrize("dims", [32, 33, 7])
def test_pack_unpack_bit_exact(bits, dims):
    rng = np.random.default_rng(bits * 100 + dims)
    codes = rng.integers(0, 2**bits, (5, 3, dims)).astype(np.uint8)
    want = np.asarray(jr.pack_codes(jnp.asarray(codes), bits))
    got = _np(tr.pack_codes(torch.as_tensor(codes), bits))
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert tr.packed_dim(dims, bits) == jr.packed_dim(dims, bits)
    back = _np(tr.unpack_codes(torch.as_tensor(want), bits, dims))
    assert np.array_equal(back, codes)
    assert np.array_equal(
        back, np.asarray(jr.unpack_codes(jnp.asarray(want), bits, dims)))


def test_random_rotation_orthonormal_and_seeded():
    r1 = tr.random_rotation(torch.Generator().manual_seed(3), 24)
    r2 = tr.random_rotation(torch.Generator().manual_seed(3), 24)
    assert torch.equal(r1, r2)
    eye = r1 @ r1.T
    assert torch.allclose(eye, torch.eye(24), atol=1e-5)


@pytest.mark.parametrize("bits", tr.SUPPORTED_BITS)
def test_encode_matches_reference(bits):
    x, _ = _data()
    params = jr.rabitq_train(__import__("jax").random.PRNGKey(0),
                             jnp.asarray(x), bits=bits)
    want = jr.rabitq_encode(params, jnp.asarray(x))
    tparams = tr.RaBitQParams(
        rotation=torch.as_tensor(np.asarray(params.rotation)),
        centroid=torch.as_tensor(np.asarray(params.centroid)), bits=bits)
    got = tr.rabitq_encode(tparams, torch.as_tensor(x))
    agree = np.mean(_np(got.unpacked()) == np.asarray(want.unpacked()))
    assert agree >= CODE_AGREEMENT
    np.testing.assert_allclose(_np(got.data_add), np.asarray(want.data_add),
                               rtol=RTOL, atol=ATOL)
    # rescale depends on the codes: compare rows whose codes all agree
    same = np.all(_np(got.unpacked()) == np.asarray(want.unpacked()), axis=1)
    np.testing.assert_allclose(_np(got.data_rescale)[same],
                               np.asarray(want.data_rescale)[same],
                               rtol=RTOL, atol=ATOL)


def test_train_centroid_matches():
    x, rng = _data()
    mask = rng.random(x.shape[0]) < 0.7
    p = tr.rabitq_train(torch.Generator().manual_seed(0), torch.as_tensor(x),
                        bits=4, valid_mask=torch.as_tensor(mask))
    want = jr.rabitq_train(__import__("jax").random.PRNGKey(0),
                           jnp.asarray(x), bits=4,
                           valid_mask=jnp.asarray(mask))
    np.testing.assert_allclose(_np(p.centroid), np.asarray(want.centroid),
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError):
        tr.rabitq_train(torch.Generator(), torch.as_tensor(x), bits=3)


@pytest.fixture(scope="module")
def shared_quantizer():
    """One quantizer + codes from the reference, carried into the port."""
    x, rng = _data(n=300, d=32)
    q = rng.normal(size=(9, 32)).astype(np.float32)
    params = jr.rabitq_train(__import__("jax").random.PRNGKey(1),
                             jnp.asarray(x), bits=4)
    codes = jr.rabitq_encode(params, jnp.asarray(x))
    tparams = tr.RaBitQParams(
        rotation=torch.as_tensor(np.asarray(params.rotation)),
        centroid=torch.as_tensor(np.asarray(params.centroid)), bits=4)
    tcodes = tr.RaBitQCodes(
        packed=torch.as_tensor(np.asarray(codes.packed)),
        data_add=torch.as_tensor(np.asarray(codes.data_add)),
        data_rescale=torch.as_tensor(np.asarray(codes.data_rescale)),
        bits=4, dims=32)
    return params, codes, tparams, tcodes, q, rng


def test_preprocess_query_matches(shared_quantizer):
    params, _, tparams, _, q, _ = shared_quantizer
    want = jr.rabitq_preprocess_query(params, jnp.asarray(q))
    got = tr.rabitq_preprocess_query(tparams, torch.as_tensor(q))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("form", ["candidates", "all_pairs"])
def test_estimate_matches(shared_quantizer, form):
    params, codes, tparams, tcodes, q, rng = shared_quantizer
    jq = jr.rabitq_preprocess_query(params, jnp.asarray(q))
    tq = tr.rabitq_preprocess_query(tparams, torch.as_tensor(q))
    if form == "candidates":
        ids = rng.integers(-1, 300, (9, 13)).astype(np.int32)
        want = jr.rabitq_estimate(codes, jq, jnp.asarray(ids))
        got = tr.rabitq_estimate(tcodes, tq, torch.as_tensor(ids))
    else:
        want = jr.rabitq_estimate(codes, jq)
        got = tr.rabitq_estimate(tcodes, tq)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL * 10)


# --------------------------------------------------- bitmaps / label planes
@pytest.mark.parametrize("n", [1, 8, 37, 256])
def test_bitmap_bit_exact(n):
    rng = np.random.default_rng(n)
    dense = rng.random(n) < 0.4
    want = np.asarray(jm.pack_bitmap(jnp.asarray(dense)))
    got = _np(tm.pack_bitmap(torch.as_tensor(dense)))
    assert np.array_equal(got, want)
    assert tm.bitmap_bytes(n) == jm.bitmap_bytes(n)
    assert np.array_equal(_np(tm.unpack_bitmap(torch.as_tensor(want), n)),
                          dense)
    ids = rng.integers(-1, n, (4, 6)).astype(np.int32)
    assert np.array_equal(
        _np(tm.bitmap_gather(torch.as_tensor(want), torch.as_tensor(ids))),
        np.asarray(jm.bitmap_gather(jnp.asarray(want), jnp.asarray(ids))))


def test_label_planes_bit_exact():
    rng = np.random.default_rng(5)
    rows = [rng.choice(32, size=rng.integers(0, 4), replace=False).tolist()
            for _ in range(50)]
    for labels in (None, 7, [i % 32 for i in range(50)], rows):
        assert np.array_equal(tm.pack_label_rows(labels, 50),
                              jm.pack_label_rows(labels, 50))
    for fset in ([0], [3, 17], [31, 8, 9]):
        assert np.array_equal(tm.filter_to_bytes(fset),
                              jm.filter_to_bytes(fset))
    plane = tm.pack_label_rows(rows, 50)
    fb = tm.filter_to_bytes([3, 17, 30])
    ids = rng.integers(-1, 50, (7, 9)).astype(np.int32)
    want = jm.label_match_gather(jnp.asarray(plane), jnp.asarray(fb),
                                 jnp.asarray(ids))
    got = tm.label_match_gather(torch.as_tensor(plane), torch.as_tensor(fb),
                                torch.as_tensor(ids))
    assert np.array_equal(_np(got), np.asarray(want))
    with pytest.raises(ValueError):
        tm.filter_to_bytes([32])
    assert tm.N_LABEL_BYTES == jm.N_LABEL_BYTES


def test_mutation_state_init():
    st = tm.init_mutation_state(20, "cpu")
    ref = jm.init_mutation_state(20)
    assert np.array_equal(_np(st.tombstone_bits),
                          np.asarray(ref.tombstone_bits))
    assert np.array_equal(_np(st.labels), np.asarray(ref.labels))
    assert np.array_equal(_np(st.free_ids), np.asarray(ref.free_ids))
    assert (st.n_free, st.n_deleted, st.generation) == (0, 0, 0)


# ---------------------------------------------------------------- distances
def test_distance_helpers_match():
    x, rng = _data(n=50, d=12)
    q = rng.normal(size=(6, 12)).astype(np.float32)
    tx, tq = torch.as_tensor(x), torch.as_tensor(q)
    pairs = [
        (td.l2_squared(tx[:6], tq), jd.l2_squared(x[:6], q)),
        (td.inner_product(tx[:6], tq), jd.inner_product(x[:6], q)),
        (td.pairwise_l2_squared(tq, tx), jd.pairwise_l2_squared(q, x)),
        (td.pairwise_distance(tq, tx, "mips"),
         jd.pairwise_distance(q, x, "mips")),
        (td.mips_augment_data(tx), jd.mips_augment_data(x)),
        (td.mips_augment_query(tq), jd.mips_augment_query(q)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    with pytest.raises(ValueError):
        td.pairwise_distance(tq, tx, "cosine")


@pytest.mark.parametrize("name", ["bigann", "deep", "text2image"])
def test_synthetic_data_bit_identical(name):
    from repro.configs.base import ANNS_DATASETS as J_DS
    from repro.data.synthetic import make_anns_dataset as j_data
    from repro.data.synthetic import make_queries as j_queries
    from repro_torch.data.synthetic import ANNS_DATASETS as T_DS
    from repro_torch.data.synthetic import make_anns_dataset, make_queries
    assert T_DS[name].__dict__ == J_DS[name].__dict__
    assert np.array_equal(make_anns_dataset(T_DS[name], n=300, seed=2),
                          j_data(J_DS[name], n=300, seed=2))
    assert np.array_equal(make_queries(T_DS[name], 20, seed=5),
                          j_queries(J_DS[name], 20, seed=5))
