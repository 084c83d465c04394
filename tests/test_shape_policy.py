"""Compile-shape policy and exactness routing.

Two serving invariants:
1. After warmup(), NO live query may trigger a fresh XLA compile (a compile
   takes seconds while the micro-batcher holds the rank lock). Verified by counting jit cache entries across every device
   program the engine can reach, then firing adversarial query shapes.
2. When the dense forward view is truncated (doc_term_cap), keyword scoring
   must stay EXACT by routing through the complete CSR (reference semantics:
   every posting contributes, retrieval/main_retrieve.go:204-247).
"""

import random
from datetime import datetime, timezone

import numpy as np
import pytest

import oracle
from corpus import build_corpus_db, make_page
from spaghettisearch_tpu.index.indexer import index_page
from spaghettisearch_tpu.ops.pagerank import update_pagerank
from spaghettisearch_tpu.ops.weighting import update_term_weights
from spaghettisearch_tpu.retrieval.engine import QueryEngine, parse_query
from spaghettisearch_tpu.store.tables import Database


def _finish(db):
    update_pagerank(db)
    update_term_weights(db, "title")
    update_term_weights(db, "body")


def _jit_cache_sizes():
    """Total jit cache entries across every device program the single-chip
    engine can dispatch."""
    import spaghettisearch_tpu.models.blended as blended
    import spaghettisearch_tpu.models.bm25 as bm25
    import spaghettisearch_tpu.ops.phrase as phrase
    import spaghettisearch_tpu.ops.scoring as scoring

    fns = (
        scoring.score_queries_forward,
        scoring.score_queries_forward_phrase,
        scoring.score_queries,
        scoring.score_queries_mixed,  # the mixed lane's program
        blended._custom_score,
        bm25._bm25_score_csr,
        phrase.match_phrase_fwd_batch,
        phrase.match_phrase_batch,
        phrase.match_phrase_fwd,
        phrase.match_phrase,
    )
    return sum(f._cache_size() for f in fns)


def _adversarial_queries(wide_phrase: str):
    long_kw = " ".join(f"zzterm{i}" for i in range(7))
    very_long_kw = " ".join(f"zzterm{i}" for i in range(40))
    ph9 = '"' + " ".join(f"zztok{i}" for i in range(9)) + '"'
    ph17 = '"' + " ".join(f"zztok{i}" for i in range(17)) + '"'
    return [
        ["algorithm"] * 3,                      # odd batch -> pow2 bucket
        ["algorithm"] * 23,
        [long_kw],                              # q catch-all
        [very_long_kw, "algorithm"],            # q truncation
        [ph9],                                  # long-phrase bucket p=16
        [ph17],                                 # phrase truncation
        [wide_phrase],                          # wide fold -> e catch-all
        [wide_phrase, long_kw, "algorithm"],    # everything at once
        ['"algorithm ranking"', "galaxy"] * 5,  # mixed odd batch, bp=2
    ]


@pytest.fixture(scope="module")
def wide_db():
    """Corpus where one bigram appears in >E_BASE docs (wide phrase fold)."""
    rng = random.Random(7)
    db = Database(None)
    db.topic_meta.set("G", {"numPages": 10.0, "wordCount": 1.0})
    ts = datetime(2026, 1, 1, tzinfo=timezone.utc)
    for i in range(80):
        url, html = make_page(rng, i, 80, "http://wide.local")
        html = html.replace(b"<p>", b"<p>glorp blip ", 1)
        index_page(db, html, url, last_modified=ts)
    _finish(db)
    return db


def test_no_fresh_compiles_after_warmup(wide_db):
    eng = QueryEngine(wide_db)
    eng.warmup()
    # the wide phrase must really exceed the base fold width
    matches = eng._match_phrases_batch([parse_query('"glorp blip"').phrase_hashes])
    assert int((matches[0][0] < eng.index.n_docs).sum()) > 64

    before = _jit_cache_sizes()
    for batch in _adversarial_queries('"glorp blip"'):
        res = eng.query_batch(batch)
        assert len(res) == len(batch)
    after = _jit_cache_sizes()
    assert after == before, f"{after - before} fresh compiles after warmup"


def test_no_fresh_compiles_after_warmup_big_batch(wide_db):
    """big_batch engines add the B_BIG=256 bucket; warmup must cover it so
    batcher slices past 128 rows (and the relocated (B_BIG, Q_CATCHALL)
    catch-all) never compile live."""
    from spaghettisearch_tpu.retrieval.engine import B_BIG

    eng = QueryEngine(wide_db, big_batch=True)
    eng.warmup()

    long_kw = " ".join(f"zzterm{i}" for i in range(7))
    big_batches = [
        ["algorithm"] * (B_BIG - 37),                      # keyword B_BIG
        (['"algorithm ranking"', "galaxy"] * 80)[:170],    # mixed B_BIG
        [long_kw] + ["algorithm"] * 140,                   # B_BIG catch-all
    ]
    before = _jit_cache_sizes()
    for batch in _adversarial_queries('"glorp blip"') + big_batches:
        res = eng.query_batch(batch)
        assert len(res) == len(batch)
    after = _jit_cache_sizes()
    assert after == before, f"{after - before} fresh compiles after warmup"


def test_no_fresh_compiles_after_warmup_sharded(wide_db):
    import jax

    from spaghettisearch_tpu.retrieval.sharded_engine import ShardedQueryEngine

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    eng = ShardedQueryEngine(wide_db, n_shards=2)
    eng.warmup()

    def cache_sizes():
        return sum(s._jit._cache_size() for s in eng._scorer_cache.values())

    before = cache_sizes()
    assert before > 0
    for batch in _adversarial_queries('"glorp blip"'):
        res = eng.query_batch(batch)
        assert len(res) == len(batch)
    after = cache_sizes()
    assert after == before, f"{after - before} fresh sharded compiles after warmup"


def test_wide_phrase_results_match_oracle(wide_db):
    """The catch-all wide-fold program must stay exact, not just compiled."""
    eng = QueryEngine(wide_db)
    want = oracle.retrieve(wide_db, '"glorp blip"', 200)
    s, i = eng.rank([parse_query('"glorp blip"')], topk=200)
    got = {
        eng.snapshot.doc_hashes[j]: float(v)
        for v, j in zip(s[0], i[0])
        if np.isfinite(v)
    }
    assert got.keys() == dict(want).keys()
    for d, v in want:
        assert got[d] == pytest.approx(v, rel=2e-4, abs=1e-5)


def test_oversized_batches_chunk_to_warmed_widths(wide_db):
    """Batches wider than any warmed program (arbitrary /query_batch
    payloads — the micro-batcher never emits them) split into warmed-width
    chunks instead of compiling a live batch shape, and past B_BIG=256 the
    old fill loop overflowed outright (IndexError). Results must match the
    per-query answers row for row."""
    eng = QueryEngine(wide_db)
    eng.warmup()
    parsed = [
        parse_query(q)
        for q in (["algorithm", '"glorp blip"', "galaxy ranking"] * 100)[:300]
    ]
    before = _jit_cache_sizes()
    s_all, i_all = eng.rank(parsed)
    assert _jit_cache_sizes() == before, "oversized batch compiled live"
    assert s_all.shape[0] == len(parsed) == i_all.shape[0]
    # chunking preserves per-row scoring (row 0 via the 16-wide bucket)
    s_one, i_one = eng.rank(parsed[:1])
    np.testing.assert_allclose(s_all[0], s_one[0], rtol=1e-6)


@pytest.fixture(scope="module")
def truncated_db():
    """One pathological doc whose distinct-term count exceeds the (patched)
    dense cap; 'zzrare' lives ONLY in that doc's truncated tail."""
    rng = random.Random(3)
    db = Database(None)
    db.topic_meta.set("G", {"numPages": 10.0, "wordCount": 1.0})
    ts = datetime(2026, 1, 1, tzinfo=timezone.utc)
    for i in range(10):
        url, html = make_page(rng, i, 10, "http://tr.local")
        index_page(db, html, url, last_modified=ts)
    # many high-frequency filler terms (each 3x -> high weight) push the
    # single-occurrence rare terms past the cap in the top-by-weight order
    filler = " ".join(f"uw{j} uw{j} uw{j}" for j in range(40))
    body = filler + " zzrare zzalso"
    index_page(
        db,
        f"<html><head><title>big page</title></head><body><p>{body}</p>"
        f"</body></html>".encode(),
        "http://tr.local/big",
        last_modified=ts,
    )
    _finish(db)
    return db


def test_truncated_dense_routes_keyword_scoring_through_csr(truncated_db, monkeypatch):
    import spaghettisearch_tpu.retrieval.device_index as di

    monkeypatch.setattr(di, "DOC_TERM_CAP", 16)
    eng = QueryEngine(truncated_db)
    assert eng.index.dense_truncated
    # the truncated doc must still be an exact-scored candidate for a term
    # that only exists in its dropped dense tail
    for q in ("zzrare", "zzrare algorithm", "uw3 zzalso", "algorithm database"):
        want = oracle.retrieve(truncated_db, q, 50)
        s, i = eng.rank([parse_query(q)], topk=50)
        got = {
            eng.snapshot.doc_hashes[j]: float(v)
            for v, j in zip(s[0], i[0])
            if np.isfinite(v)
        }
        assert got.keys() == dict(want).keys(), q
        for d, v in want:
            assert got[d] == pytest.approx(v, rel=2e-4, abs=1e-5), (q, d)
    big = truncated_db  # the big doc must be a candidate for zzrare
    s, i = eng.rank([parse_query("zzrare")], topk=50)
    urls = [
        big.doc_info.get(eng.snapshot.doc_hashes[j]).url
        for v, j in zip(s[0], i[0])
        if np.isfinite(v)
    ]
    assert "http://tr.local/big" in urls


def test_truncated_dense_bm25_routes_through_csr(truncated_db, monkeypatch):
    import spaghettisearch_tpu.retrieval.device_index as di
    from spaghettisearch_tpu.models.bm25 import BM25Ranker

    monkeypatch.setattr(di, "DOC_TERM_CAP", 16)
    eng = QueryEngine(truncated_db, model=BM25Ranker())
    assert eng.index.dense_truncated
    s, i = eng.rank([parse_query("zzrare")], topk=50)
    urls = [
        truncated_db.doc_info.get(eng.snapshot.doc_hashes[j]).url
        for v, j in zip(s[0], i[0])
        if np.isfinite(v)
    ]
    assert "http://tr.local/big" in urls


def test_sharded_live_pins_refresh(monkeypatch):
    """A (snapshot, index) pair captured before /refresh must keep scoring
    against ITS OWN sharded index — mixing the new index with the old
    snapshot's doc-id space returns wrong documents."""
    import jax

    from spaghettisearch_tpu.retrieval.sharded_engine import ShardedQueryEngine

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    db = build_corpus_db(n_pages=12, seed=4)
    eng = ShardedQueryEngine(db, n_shards=2)
    parsed = parse_query("algorithm database")
    old_live = eng._live
    want_s, want_i = eng.rank([parsed], topk=20, live=old_live)

    # grow the corpus so doc ids shift, then refresh
    rng = random.Random(99)
    ts = datetime(2026, 2, 2, tzinfo=timezone.utc)
    for i in range(12, 30):
        url, html = make_page(rng, i, 30, "http://test.local")
        index_page(db, html, url, last_modified=ts)
    _finish(db)
    eng.refresh()
    assert eng._live is not old_live

    got_s, got_i = eng.rank([parsed], topk=20, live=old_live)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6)
    # and the swapped-in live scores against the NEW corpus
    new_s, _ = eng.rank([parsed], topk=20)
    assert np.isfinite(np.asarray(new_s)).sum() >= np.isfinite(want_s).sum()


def test_sharded_scorer_reused_across_same_geometry_refresh():
    import jax

    from spaghettisearch_tpu.retrieval.sharded_engine import ShardedQueryEngine

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    db = build_corpus_db(n_pages=12, seed=4)
    eng = ShardedQueryEngine(db, n_shards=2)
    eng.rank([parse_query("algorithm")], topk=20)
    scorer = eng._live[1].scorers[20]
    eng.refresh()  # same store -> same padded geometry
    eng.rank([parse_query("algorithm")], topk=20)
    assert eng._live[1].scorers[20] is scorer


def test_refresh_across_padding_boundary_warms_off_lock(tmp_path):
    """A crawl that grows the corpus past D_pad (512-doc steps) changes
    every jit shape. prepare_refresh(warm=True) — the server's /refresh
    path — must pre-compile the new geometry off-lock so the first live
    query after the swap hits zero fresh compiles."""
    import random

    rng = random.Random(11)
    db = Database(str(tmp_path / "db"))
    db.topic_meta.set("G", {"numPages": 10.0, "wordCount": 1.0})
    ts = datetime(2026, 1, 1, tzinfo=timezone.utc)
    for i in range(30):
        url, html = make_page(rng, i, 600, "http://grow.local")
        index_page(db, html, url, last_modified=ts)
    _finish(db)

    eng = QueryEngine(db)
    assert eng.index.n_docs_padded == 512
    eng.warmup()

    # grow past the 512-doc padding boundary, as a crawl would
    for i in range(30, 600):
        url, html = make_page(rng, i, 600, "http://grow.local")
        index_page(db, html, url, last_modified=ts)
    _finish(db)

    state = eng.prepare_refresh()  # warm=True: compiles happen HERE
    eng.commit_refresh(state)
    assert eng.index.n_docs_padded == 1024  # geometry really changed

    before = _jit_cache_sizes()
    for batch in _adversarial_queries('"the quick"'):
        res = eng.query_batch(batch)
        assert len(res) == len(batch)
    after = _jit_cache_sizes()
    assert after == before, f"{after - before} fresh compiles after refresh"
