"""The two scoring formulations (forward membership vs CSR gather/scatter)
must rank identically — each is an independent oracle for the other."""

import jax.numpy as jnp
import numpy as np
import pytest

from corpus import build_corpus_db
from spaghettisearch_tpu.ops.scoring import (
    exact_top_k,
    score_queries,
    score_queries_forward,
)
from spaghettisearch_tpu.retrieval.device_index import DeviceIndex
from spaghettisearch_tpu.retrieval.engine import QueryEngine, parse_query


@pytest.fixture(scope="module")
def engine():
    return QueryEngine(build_corpus_db(n_pages=25, seed=9))


@pytest.mark.parametrize(
    "query",
    ["algorithm", "quantum physics database", "matrix matrix", "galaxy poetry theater music novel"],
)
def test_forward_matches_csr(engine, query):
    idx = engine.index
    snap = engine.snapshot
    parsed = parse_query(query)
    q = max(len(parsed.keyword_hashes), 1)
    term_ids = np.full((1, q), snap.n_words, np.int32)
    term_ids[0] = snap.term_ids(parsed.keyword_hashes)
    qlen = np.array([float(parsed.query_len)], np.float32)
    tp = np.zeros((1, idx.n_categories), np.float32)
    e = 8
    phd = np.full((1, e), idx.n_docs, np.int32)
    phz = np.zeros((1, e), np.float32)

    fs, fi = score_queries_forward(
        idx.title.fwd, idx.body.fwd,
        idx.mag_title, idx.mag_body, idx.pagerank,
        jnp.asarray(term_ids), jnp.asarray(qlen), jnp.asarray(tp),
        topk=min(50, idx.n_docs),
    )
    cs, ci = score_queries(
        idx.title.offsets, idx.title.doc_ids, idx.title.weights,
        idx.body.offsets, idx.body.doc_ids, idx.body.weights,
        idx.mag_title, idx.mag_body, idx.pagerank,
        jnp.asarray(term_ids), jnp.asarray(qlen), jnp.asarray(tp),
        jnp.asarray(phd), jnp.asarray(phz), jnp.asarray(phz), jnp.asarray(phz),
        posting_cap=idx.posting_cap, topk=min(50, idx.n_docs), n_docs=idx.n_docs,
    )
    fs, fi, cs, ci = map(np.asarray, (fs, fi, cs, ci))
    f = {int(i): float(s) for s, i in zip(fs[0], fi[0]) if np.isfinite(s)}
    c = {int(i): float(s) for s, i in zip(cs[0], ci[0]) if np.isfinite(s)}
    assert f.keys() == c.keys()
    for d in f:
        assert f[d] == pytest.approx(c[d], rel=1e-5, abs=1e-7)


def test_exact_top_k_matches_lax():
    import jax

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(7, 5000)).astype(np.float32))
    want_s, _ = jax.lax.top_k(x, 20)
    got_s, got_i = exact_top_k(x, 20)
    np.testing.assert_allclose(np.asarray(got_s), np.asarray(want_s))
    # returned ids must address the right values
    np.testing.assert_allclose(
        np.take_along_axis(np.asarray(x), np.asarray(got_i), 1), np.asarray(got_s)
    )


def test_exact_top_k_chunk_max_path():
    """The large-D chunk-max route (per-128-chunk max -> top-k chunks ->
    gather -> exact top-k) must match lax.top_k on tie-free data, including
    -inf non-candidate tails and a non-chunk-multiple doc count."""
    import jax

    rng = np.random.default_rng(3)
    for d, k in ((400_000, 50), (262_144 + 37, 10)):
        x_np = rng.normal(size=(3, d)).astype(np.float32)
        x_np[rng.random((3, d)) < 0.6] = -np.inf  # non-candidates
        x = jnp.asarray(x_np)
        want_s, want_i = jax.lax.top_k(x, k)
        got_s, got_i = exact_top_k(x, k)
        np.testing.assert_array_equal(np.asarray(got_s), np.asarray(want_s))
        finite = np.isfinite(np.asarray(want_s))
        np.testing.assert_array_equal(
            np.asarray(got_i)[finite], np.asarray(want_i)[finite]
        )
        assert got_i.dtype == jnp.int32
    # ties: values exact, order normalized to (score desc, id asc)
    x_np = np.zeros((1, 300_000), np.float32)
    x_np[0, [7, 250_000]] = 5.0
    got_s, got_i = exact_top_k(jnp.asarray(x_np), 3)
    assert np.asarray(got_s).tolist() == [[5.0, 5.0, 0.0]]
    assert np.asarray(got_i)[0, :2].tolist() == [7, 250_000]


def test_forward_doc_term_cap_bounds_memory():
    """A pathological doc with a huge vocabulary must not inflate T_pad for
    the whole corpus; its dense row keeps the top-weight terms, and docs
    under the cap stay exact."""
    from spaghettisearch_tpu.index.snapshot import SectionCSR

    n_docs, n_words = 8, 600
    rows = {}
    # normal docs: 5 distinct words each; doc 0: 500 distinct words
    for w in range(500):
        rows[f"w{w:04d}"] = {"d0": [float(500 - w), -100.0]}
    for d in range(1, n_docs):
        for w in range(5):
            rows.setdefault(f"x{d}_{w}", {})[f"d{d}"] = [1.0, float(w)]
    word_id = {h: i for i, h in enumerate(sorted(rows))}
    doc_id = {f"d{d}": d for d in range(n_docs)}
    csr = SectionCSR.build(rows, word_id, doc_id, len(word_id), n_docs)

    ft, fw, fj = csr.forward_with_postings(n_docs, doc_term_cap=64)
    assert ft.shape[1] == 64  # bounded, not 500-padded
    # doc 0 keeps exactly its 64 highest-weight terms
    kept = fw[0][ft[0] >= 0]
    assert len(kept) == 64 and kept.min() == 500 - 64 + 1
    # normal docs keep everything
    for d in range(1, n_docs):
        assert (ft[d] >= 0).sum() == 5

    exact_ft, exact_fw, _ = csr.forward_with_postings(n_docs, doc_term_cap=None)
    assert exact_ft.shape[1] >= 500
    for d in range(1, n_docs):
        assert set(exact_ft[d][exact_ft[d] >= 0]) == set(ft[d][ft[d] >= 0])


def test_engine_rank_order_independent_of_term_count_sort(engine):
    """rank() sorts the batch by term count for the kernel and must
    inverse-permute results back to request order."""
    queries = [
        "galaxy poetry theater music",  # 4 terms
        "algorithm",  # 1 term
        "quantum physics",  # 2 terms
        "matrix",  # 1 term
    ]
    batch = engine.query_batch(queries)
    singles = [engine.query(t) for t in queries]
    assert any(singles)  # the corpus must actually match something
    for got, want in zip(batch, singles):
        assert [r["Url"] for r in got] == [r["Url"] for r in want]
        for g, w in zip(got, want):
            assert g["FinalRank"] == pytest.approx(w["FinalRank"])


def test_lazy_fwd_host_resident_matches_eager():
    """Over the device's fwd budget the doc-major ft/fw/fj stay host-side
    (the keyword kernel and the mixed lane never read them) and the sparse
    phrase matcher upgrades them lazily via fwd_device() — results must be
    identical either way, on both the mixed lane and the sparse lane."""
    from spaghettisearch_tpu.models.bm25 import BM25Ranker
    from spaghettisearch_tpu.retrieval.device_index import MemoryBudget

    db = build_corpus_db(n_pages=25, seed=9)
    eager = QueryEngine(db)
    snap = eager.snapshot
    tight = MemoryBudget(fwd_dev_bytes=0)

    def lazy_index():
        return DeviceIndex.from_snapshot(snap, budget=tight)

    lazy = QueryEngine(db, snapshot=snap, index=lazy_index())
    assert isinstance(lazy.index.body.fwd.ft, np.ndarray), "fwd not host-side"
    queries = ["algorithm database", '"quantum physics"',
               'ranking "matrix tensor" cluster', "poetry"]
    for q, w, g in zip(queries, eager.query_batch(queries),
                       lazy.query_batch(queries)):
        assert [r["Url"] for r in g] == [r["Url"] for r in w], q

    # sparse lane (BM25 has no mixed lane): the phrase matcher must
    # trigger the lazy upgrade and match the eager engine result-for-result
    eb = QueryEngine(db, snapshot=snap, model=BM25Ranker())
    lb = QueryEngine(db, snapshot=snap, index=lazy_index(), model=BM25Ranker())
    assert isinstance(lb.index.body.fwd.ft, np.ndarray)
    for q in queries:
        w, g = eb.query(q), lb.query(q)
        assert [r["Url"] for r in g] == [r["Url"] for r in w], q
    assert not isinstance(lb.index.body.fwd.ft, np.ndarray), (
        "sparse matcher did not upgrade fwd to device"
    )
