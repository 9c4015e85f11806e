"""The port's device retrieval (``plip_tpu_torch.ops.retrieval``, and
``PLIP.retrieval(backend="device"|"auto")`` with the int8 index) against
``plip_tpu.ops.retrieval`` (CPU).

The corpora and edges are those of ``tests/test_retrieval_topk.py`` and
``tests/test_retrieval_adversarial.py``, single-device cases: equal indices
(exact ties earliest index first in both), scores allclose 1e-6, the same
integers from ``quantize_rows``, and the margin crusher tripping the
candidate-boundary probe in both packages."""

import numpy as np
import pytest
import torch

from plip_tpu.api import PLIP as JPLIP
from plip_tpu.ops import retrieval as JR
from plip_tpu_torch import api
from plip_tpu_torch.api import PLIP
from plip_tpu_torch.ops import retrieval as R
from tests.test_retrieval_adversarial import (_clustered, _duplicate_heavy, _host_exact,
                                              _low_rank, _margin_crusher)
from tests.test_retrieval_topk import _host_topk


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CORPORA = {"clustered": _clustered, "low_rank": _low_rank, "duplicate_heavy": _duplicate_heavy}


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("normalize", [True, "queries", False])
@pytest.mark.parametrize("n,chunk", [(1000, 128), (64, 64), (37, 512)])
@pytest.mark.parametrize("merge", ["exact", "approx"])
def test_cosine_topk_matches_jax(normalize, n, chunk, merge):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((5, 32)).astype(np.float32)
    x = rng.standard_normal((n, 32)).astype(np.float32)
    k = 7 if n >= 7 else n
    got = R.cosine_topk(q, x, k=k, normalize=normalize, chunk=chunk, merge=merge)
    _same(got, JR.cosine_topk(q, x, k=k, normalize=normalize, chunk=chunk, merge=merge))
    ref_idx, _ = _host_topk(q, x, k, normalize)
    np.testing.assert_array_equal(got[0], ref_idx)


def test_cosine_topk_edges():
    """Empty corpus -> [Q, 0]; k past n clamps; a pre-padded index with
    ``n_valid`` ranks only its real rows, also where every real score is
    negative (a zero pad row would score 0); an unknown merge raises."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    idx, vals = R.cosine_topk(q, np.zeros((0, 8), np.float32), k=5)
    assert idx.shape == (3, 0) and vals.shape == (3, 0)
    x = rng.standard_normal((5, 8)).astype(np.float32)
    _same(R.cosine_topk(q, x, k=9), JR.cosine_topk(q, x, k=9))
    x = -np.abs(rng.standard_normal((50, 8))).astype(np.float32)
    q = np.abs(q)
    padded = np.concatenate([x, np.zeros((14, 8), np.float32)])
    for chunk in (16, 64, 8192):
        got = R.cosine_topk(q, padded, k=6, normalize="queries", chunk=chunk, n_valid=50)
        _same(got, JR.cosine_topk(q, padded, k=6, normalize="queries", chunk=chunk,
                                  n_valid=50))
        assert (got[0] < 50).all() and (got[1] < 0).all()
        _same(got, R.cosine_topk(q, x, k=6, normalize="queries", chunk=chunk))
    with pytest.raises(ValueError, match="unknown merge"):
        R.cosine_topk(q, x, k=3, merge="fast")


def test_ties_rank_earliest_index_first():
    """Exact duplicates: the stable order of ``lax.top_k``, so the JAX
    package's indices and the stable host argsort's, across chunk borders
    and the carry."""
    rng = np.random.default_rng(8)
    u = rng.standard_normal((6, 16)).astype(np.float32)
    x = u[rng.integers(0, 6, 500)]
    x[::7] = 0.0  # ties at score 0 too
    q = rng.standard_normal((4, 16)).astype(np.float32)
    for chunk, k in ((64, 40), (100, 90), (500, 25)):
        got = R.cosine_topk(q, x, k=k, normalize=False, chunk=chunk)
        _same(got, JR.cosine_topk(q, x, k=k, normalize=False, chunk=chunk))
        s = q @ x.T
        np.testing.assert_array_equal(got[0], np.argsort(-s, axis=1, kind="stable")[:, :k])


@pytest.mark.parametrize("normalize", [False, True])
def test_quantize_rows_gives_the_same_integers(normalize):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((64, 48)) * rng.gamma(2.0, 2.0, (64, 1))).astype(np.float32)
    got, want = R.quantize_rows(x, normalize), JR.quantize_rows(x, normalize)
    assert got[0].dtype == np.int8 and got[1].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("M,N,D", [(6, 128, 64), (1, 37, 13), (17, 8, 8)])
def test_int8_dot_is_exact(M, N, D):
    g = torch.Generator().manual_seed(M)
    a = torch.randint(-127, 128, (M, D), dtype=torch.int8, generator=g)
    b = torch.randint(-127, 128, (N, D), dtype=torch.int8, generator=g)
    got = R.int8_dot(a, b)
    assert got.dtype == torch.int32
    assert torch.equal(got, a.int() @ b.int().T)


@pytest.mark.parametrize("rescore", [True, False])
@pytest.mark.parametrize("merge", ["auto", "exact", "approx"])
def test_int8_topk_matches_jax(rescore, merge):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((6, 64)).astype(np.float32)
    x = (rng.standard_normal((700, 64)) * rng.gamma(2.0, 1.0, (700, 1))).astype(np.float32)
    q8, inv = R.quantize_rows(x, normalize=False)
    kw = dict(k=10, chunk=128, merge=merge, rescore_vectors=x if rescore else None)
    got = R.cosine_topk_int8(q, q8, inv, **kw)
    _same(got, JR.cosine_topk_int8(q, q8, inv, **kw))
    if rescore:
        ref_idx, ref_vals = _host_topk(q, x, 10, normalize="queries")
        np.testing.assert_array_equal(got[0], ref_idx)
        np.testing.assert_allclose(got[1], ref_vals, rtol=1e-5, atol=1e-5)


def test_int8_topk_edges():
    """k > n clamps; n smaller than the chunk; ``n_valid`` on a pre-padded
    index; an empty corpus -> [Q, 0]; an unknown merge raises."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 16)).astype(np.float32)
    x = rng.standard_normal((5, 16)).astype(np.float32)
    q8, inv = R.quantize_rows(x, normalize=False)
    got = R.cosine_topk_int8(q, q8, inv, k=9, chunk=64, rescore_vectors=x)
    assert got[0].shape == (2, 5)
    _same(got, JR.cosine_topk_int8(q, q8, inv, k=9, chunk=64, rescore_vectors=x))
    x = rng.standard_normal((203, 16)).astype(np.float32)
    q8, inv = R.quantize_rows(x, normalize=False)
    q8p, invp = np.pad(q8, ((0, 53), (0, 0))), np.pad(inv, (0, 53))
    got = R.cosine_topk_int8(q, q8p, invp, k=7, chunk=32, rescore_vectors=x, n_valid=203)
    _same(got, JR.cosine_topk_int8(q, q8p, invp, k=7, chunk=32, rescore_vectors=x,
                                   n_valid=203))
    np.testing.assert_array_equal(got[0], _host_topk(q, x, 7, normalize="queries")[0])
    e_idx, e_vals = R.cosine_topk_int8(q, np.zeros((0, 16), np.int8),
                                       np.zeros((0,), np.float32), k=3)
    assert e_idx.shape == (2, 0) and e_vals.shape == (2, 0)
    with pytest.raises(ValueError, match="unknown merge"):
        R.cosine_topk_int8(q, q8, inv, k=3, merge="fast")


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_adversarial_corpora_match_jax(name):
    """Clusters, a low-rank subspace, duplicates: fp32 and int8 with rescore
    give the JAX package's indices and the exact host ranking's scores."""
    rng = np.random.default_rng(1)
    x = CORPORA[name](rng)
    q = rng.standard_normal((8, x.shape[1])).astype(np.float32)
    _, tv = _host_exact(q, x, 10)
    got = R.cosine_topk(q, x, k=10, normalize="queries", chunk=1024)
    _same(got, JR.cosine_topk(q, x, k=10, normalize="queries", chunk=1024))
    np.testing.assert_allclose(got[1], tv, rtol=0, atol=1e-5)
    x8, inv = R.quantize_rows(x, normalize=False)
    got = R.cosine_topk_int8(q, x8, inv, k=10, rescore_vectors=x, chunk=1024)
    _same(got, JR.cosine_topk_int8(q, x8, inv, k=10, rescore_vectors=x, chunk=1024))
    np.testing.assert_allclose(got[1], tv, rtol=0, atol=1e-5)


def _count_streams(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(module, name, counting)
    return calls


def test_margin_crusher_trips_the_probe_in_both(monkeypatch):
    """Score gaps far below int8 noise: without the probe both packages lose
    the same true rows; with it both re-stream and end on the exact ranking."""
    rng = np.random.default_rng(2)
    x, q = _margin_crusher(rng)
    x8, inv = R.quantize_rows(x, normalize=False)
    ti, tv = _host_exact(q, x, 10)
    raw = R.cosine_topk_int8(q, x8, inv, k=10, rescore_vectors=x, chunk=1024,
                             auto_oversample=False)
    _same(raw, JR.cosine_topk_int8(q, x8, inv, k=10, rescore_vectors=x, chunk=1024,
                                   auto_oversample=False))
    assert len(set(raw[0][0]) & set(ti[0])) / 10.0 < 0.9

    port_streams = _count_streams(monkeypatch, R, "_scan_int8")
    port_fallback = _count_streams(monkeypatch, R, "_scan_f32")
    jax_streams = _count_streams(monkeypatch, JR, "_topk_int8_jit")
    got = R.cosine_topk_int8(q, x8, inv, k=10, rescore_vectors=x, chunk=1024)
    want = JR.cosine_topk_int8(q, x8, inv, k=10, rescore_vectors=x, chunk=1024)
    assert len(port_streams) == len(jax_streams) == 2 and len(port_fallback) == 1
    _same(got, want)
    np.testing.assert_array_equal(got[0], ti)
    np.testing.assert_allclose(got[1], tv, rtol=0, atol=1e-6)


def test_probe_passes_in_one_stream_on_benign(monkeypatch):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4096, 64)).astype(np.float32)
    q = rng.standard_normal((4, 64)).astype(np.float32)
    x8, inv = R.quantize_rows(x, normalize=False)
    streams = _count_streams(monkeypatch, R, "_scan_int8")
    got = R.cosine_topk_int8(q, x8, inv, k=10, rescore_vectors=x, chunk=1024)
    assert len(streams) == 1
    np.testing.assert_array_equal(got[0], _host_exact(q, x, 10)[0])


# ---- PLIP ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def plips(tmp_path_factory):
    import jax

    from plip_tpu.models import clip as jclip
    from plip_tpu.models.config import CLIPConfig, TextConfig, VisionConfig
    from plip_tpu.utils.checkpoint import save_checkpoint

    cfg = CLIPConfig(
        vision=VisionConfig(width=64, layers=1, heads=4, image_size=224, patch_size=32),
        text=TextConfig(width=32, layers=1, heads=4, vocab_size=49408, context_length=77),
        embed_dim=24)
    path = str(tmp_path_factory.mktemp("ret") / "tiny.npz")
    save_checkpoint(path, jclip.init_params(jax.random.PRNGKey(4), cfg), cfg)
    return JPLIP(path), PLIP(path, device="cpu")


QUERIES = ["tumor tissue", "benign gland", "an H&E image of stroma"]


@pytest.mark.parametrize("quantize", [False, "int8"])
def test_api_device_retrieval_matches_jax(plips, quantize):
    """A 20,000-row index (three chunks of the stream, the last one short):
    the device backend gives the JAX package's device indices and the host
    backend's ranking."""
    jm, tm = plips
    emb = np.random.default_rng(6).standard_normal((20000, 24)).astype(np.float32)
    jm.set_image_index(emb, quantize=quantize)
    tm.set_image_index(emb, quantize=quantize)
    got = tm.retrieval(QUERIES, top_k=5, backend="device")
    np.testing.assert_array_equal(got, jm.retrieval(QUERIES, top_k=5, backend="device"))
    np.testing.assert_array_equal(got, tm.retrieval(QUERIES, top_k=5, backend="host"))
    # "auto" on the CPU: the host in both packages
    np.testing.assert_array_equal(tm.retrieval(QUERIES, top_k=5, backend="auto"),
                                  jm.retrieval(QUERIES, top_k=5, backend="auto"))
    rows = -(-20000 // api.RETRIEVAL_CHUNK) * api.RETRIEVAL_CHUNK
    index = tm._device_index_cache
    assert (index[0] if quantize else index).shape[0] == rows  # padded once
    tm.retrieval(QUERIES, top_k=5, backend="device")
    assert tm._device_index_cache is index  # uploaded once per index


def test_api_index_modes(plips):
    jm, tm = plips
    emb = np.random.default_rng(7).standard_normal((40, 24)).astype(np.float32)
    tm.set_image_index(emb, quantize=True)
    assert tm._index_quantize == "int8"
    np.testing.assert_array_equal(tm.retrieval(QUERIES, top_k=5, backend="device"),
                                  tm.retrieval(QUERIES, top_k=5, backend="host"))
    tm.image_vectors = emb  # plain assignment resets the int8 mode
    assert tm._index_quantize is False
    tm.retrieval(QUERIES, top_k=5, backend="device")
    assert tm._device_index_key[2] is False and tm._device_index_cache.dtype == torch.float32
    with pytest.raises(ValueError, match="unknown quantize"):
        tm.set_image_index(emb, quantize="fp8")
    assert tm.retrieval(QUERIES, top_k=5, backend="auto").shape == (3, 5)  # host on the CPU


def test_api_build_image_index_int8(plips):
    jm, tm = plips
    rng = np.random.default_rng(4)
    images = [rng.integers(0, 256, (224, 224, 3), dtype=np.uint8) for _ in range(8)]
    jm.build_image_index(images, batch_size=8, quantize="int8")
    tm.build_image_index(images, batch_size=8, quantize="int8")
    np.testing.assert_array_equal(tm.retrieval(QUERIES, top_k=4, backend="device"),
                                  jm.retrieval(QUERIES, top_k=4, backend="device"))


@pytest.mark.parametrize("device,n,q,want", [
    ("cpu", 10**7, 64, "host"), ("cuda", 262144, 1, "device"), ("cuda", 262143, 1, "host"),
    ("cuda", 16384, 64, "device"), ("cuda", 16383, 64, "host")])
def test_auto_gate(plips, monkeypatch, device, n, q, want):
    """``backend="auto"`` takes the device on a CUDA device from 262,144 rows
    or 2^20 scores (the JAX package's gate)."""
    _, tm = plips
    taken = []
    monkeypatch.setattr(tm, "device", torch.device(device))
    monkeypatch.setattr(tm, "encode_text", lambda texts, batch_size: np.ones((q, 24),
                                                                            np.float32))
    monkeypatch.setattr(tm, "_nearest_neighbours", lambda **kw: taken.append("host"))
    monkeypatch.setattr(tm, "_device_index", lambda n, quant: None)
    monkeypatch.setattr(api, "cosine_topk", lambda *a, **kw: (taken.append("device"), None))
    monkeypatch.setattr(tm, "_image_vectors", np.zeros((n, 1), np.float32), raising=False)
    monkeypatch.setattr(tm, "_index_quantize", False, raising=False)
    tm.retrieval(["x"] * q, top_k=1, backend="auto")
    assert taken == [want]
