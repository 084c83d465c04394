"""Doc-sorted device layout (DeviceIndex doc_sort): docs sorted by distinct
body-term count so the keyword kernel's body sweep can stop at each doc
block's real T bound (tests/test_gpu_route.py checks the bound against the
static sweep). Everything downstream must be invisible to callers: scorers gather
top-k ids back through doc_perm, so engine results match the natural layout
exactly (modulo f32 tie groups, which these fixtures avoid)."""

import jax.numpy as jnp
import numpy as np
import pytest

from corpus import build_corpus_db
from spaghettisearch_tpu.ops.scoring import exact_top_k
from spaghettisearch_tpu.retrieval.device_index import DeviceIndex
from spaghettisearch_tpu.retrieval.engine import QueryEngine


def test_exact_top_k_doc_map_both_routes():
    """doc_map must remap selected ids to natural space and renormalize the
    order to (score desc, natural id asc), on the small-D lax.top_k route
    and the large-D chunk-max route."""
    rng = np.random.default_rng(7)
    for d in (5000, 300_000):
        perm = rng.permutation(d).astype(np.int32)
        nat = rng.normal(size=(3, d)).astype(np.float32)
        permuted = nat[:, perm]  # permuted[i] = nat[perm[i]]
        want_s, want_i = exact_top_k(jnp.asarray(nat), 20)
        got_s, got_i = exact_top_k(
            jnp.asarray(permuted), 20, doc_map=jnp.asarray(perm)
        )
        np.testing.assert_array_equal(np.asarray(got_s), np.asarray(want_s))
        np.testing.assert_array_equal(np.asarray(got_i), np.asarray(want_i))


@pytest.fixture(scope="module")
def natural_engine():
    return QueryEngine(build_corpus_db(n_pages=40, seed=17), doc_sort=False)


@pytest.fixture(scope="module")
def sorted_engine(natural_engine):
    # same store, forced doc-sorted layout
    return QueryEngine(natural_engine.db, doc_sort=True)


def test_doc_sort_layout_is_active(sorted_engine, natural_engine):
    idx = sorted_engine.index
    assert idx.doc_perm is not None
    assert idx.body.tmax_blocks is not None
    assert natural_engine.index.doc_perm is None
    # the permutation really moved docs and covers every slot exactly once
    perm = np.asarray(idx.doc_perm_np)
    assert sorted(perm.tolist()) == list(range(idx.n_docs_padded))
    assert not np.array_equal(perm, np.arange(idx.n_docs_padded))
    # body T padded to the chunk multiple
    from spaghettisearch_tpu.retrieval.device_index import DOC_SORT_TC

    assert idx.body.fwd.ft.shape[1] % DOC_SORT_TC == 0


@pytest.mark.parametrize(
    "query",
    [
        "algorithm",
        "quantum physics database",
        '"quantum physics"',
        'galaxy "music theater" poetry',
        "matrix matrix",
        "zzzznomatch",
    ],
)
def test_doc_sort_engine_matches_natural(sorted_engine, natural_engine, query):
    """Keyword, phrase, and mixed queries must return identical results
    (urls AND scores) under both layouts — the permutation is an internal
    kernel concern."""
    want = natural_engine.query(query)
    got = sorted_engine.query(query)
    assert [r["Url"] for r in got] == [r["Url"] for r in want]
    for g, w in zip(got, want):
        assert g["FinalRank"] == pytest.approx(w["FinalRank"], rel=1e-5)


def test_doc_sort_batch_matches_natural(sorted_engine, natural_engine):
    queries = [
        "galaxy poetry theater music",
        "algorithm",
        '"quantum physics" theory',
        "matrix",
    ]
    want = natural_engine.query_batch(queries)
    got = sorted_engine.query_batch(queries)
    for g_rows, w_rows in zip(got, want):
        assert [r["Url"] for r in g_rows] == [r["Url"] for r in w_rows]
        for g, w in zip(g_rows, w_rows):
            assert g["FinalRank"] == pytest.approx(w["FinalRank"], rel=1e-5)


def test_doc_sort_survives_refresh(sorted_engine, natural_engine):
    """refresh() must rebuild the permuted index (doc_sort persists) and
    still match the natural engine."""
    sorted_engine.refresh()
    assert sorted_engine.index.doc_perm is not None
    want = natural_engine.query("quantum physics")
    got = sorted_engine.query("quantum physics")
    assert [r["Url"] for r in got] == [r["Url"] for r in want]


def test_doc_sort_bm25_matches_natural(natural_engine):
    """The BM25 model builds its own forward arrays — they must follow the
    index permutation."""
    from spaghettisearch_tpu.models.bm25 import BM25Ranker

    nat = QueryEngine(
        natural_engine.db, model=BM25Ranker(), doc_sort=False
    )
    srt = QueryEngine(natural_engine.db, model=BM25Ranker(), doc_sort=True)
    for query in ("algorithm", '"quantum physics"', "galaxy music"):
        want = nat.query(query)
        got = srt.query(query)
        assert [r["Url"] for r in got] == [r["Url"] for r in want]
        for g, w in zip(got, want):
            assert g["FinalRank"] == pytest.approx(w["FinalRank"], rel=1e-5)


def test_doc_sort_auto_threshold():
    """Auto policy: off below DOC_SORT_MIN_DOCS, forced-on works on tiny
    corpora (tests), and truncated indexes never permute."""
    db = build_corpus_db(n_pages=10, seed=3)
    eng = QueryEngine(db)  # auto -> off at 10 docs
    assert eng.index.doc_perm is None
    forced = DeviceIndex.from_snapshot(eng.snapshot, doc_sort=True)
    assert forced.doc_perm is not None
    assert forced.match_pad == forced.n_docs_padded


