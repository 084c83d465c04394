"""Multi-chip sharding on the virtual 8-device CPU mesh: sharded query
scoring and PageRank must match their single-chip counterparts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from corpus import build_corpus_db
from spaghettisearch_tpu.ops.pagerank import _load_graph, pagerank_power
from spaghettisearch_tpu.parallel.mesh import make_mesh
from spaghettisearch_tpu.parallel.sharded import (
    ShardedIndex,
    make_sharded_scorer,
    sharded_pagerank,
)
from spaghettisearch_tpu.retrieval.engine import QueryEngine, parse_query


@pytest.fixture(scope="module")
def db():
    return build_corpus_db(n_pages=30, seed=5)


@pytest.fixture(scope="module")
def engine(db):
    return QueryEngine(db)


@pytest.fixture(scope="module", params=[2, 8])
def mesh(request):
    if len(jax.devices()) < request.param:
        pytest.skip("not enough virtual devices")
    return make_mesh(request.param)


@pytest.fixture(scope="module")
def sharded(engine, mesh):
    sidx = ShardedIndex.from_snapshot(engine.snapshot, mesh)
    return sidx, make_sharded_scorer(sidx, topk=50)


def _run_sharded(engine, scorer, sidx, query, topk=50):
    parsed = parse_query(query)
    q = max(len(parsed.keyword_hashes), 1)
    term_ids = np.full((1, q), engine.snapshot.n_words, np.int32)
    ids = engine.snapshot.term_ids(parsed.keyword_hashes)
    term_ids[0, : len(ids)] = ids
    qlen = np.array([float(parsed.query_len)], np.float32)
    tp = np.zeros((1, sidx.pagerank.shape[-1]), np.float32)

    pmax = max(len(parsed.phrase_hashes), 4)
    ph_ids = np.full(pmax, engine.snapshot.n_words, np.int32)
    ph_valid = np.zeros(pmax, bool)
    gen = 0
    if parsed.phrase_hashes:
        pids = engine.snapshot.term_ids(parsed.phrase_hashes)
        ph_ids[: len(pids)] = pids
        ph_valid[: len(pids)] = True
        dfs = engine.snapshot.title.df(pids) + engine.snapshot.body.df(pids)
        gen = int(np.argmin(dfs))
    s, i = scorer(
        sidx,
        jnp.asarray(term_ids), jnp.asarray(qlen), jnp.asarray(tp),
        jnp.asarray(ph_ids), jnp.asarray(ph_valid), jnp.asarray(gen, jnp.int32),
    )
    return np.asarray(s)[0], np.asarray(i)[0]


QUERIES = (
    "algorithm",
    "quantum physics database",
    "galaxy poetry theater ranking",
    '"algorithm"',
    "nonexistentword",
)


def test_sharded_matches_single_chip(engine, sharded):
    sidx, scorer = sharded
    for query in QUERIES:
        parsed = parse_query(query)
        want_s, want_i = engine.rank([parsed], topk=50)
        got_s, got_i = _run_sharded(engine, scorer, sidx, query)

        want = [(int(i), float(s)) for s, i in zip(want_s[0], want_i[0]) if np.isfinite(s)]
        got = [(int(i), float(s)) for s, i in zip(got_s, got_i) if np.isfinite(s)]
        assert len(got) == len(want), query
        # same doc set; same scores; same order up to ties
        assert dict(got).keys() == dict(want).keys(), query
        for (gi, gs), (wi, ws) in zip(
            sorted(got, key=lambda t: (-t[1], t[0])),
            sorted(want, key=lambda t: (-t[1], t[0])),
        ):
            assert gi == wi
            assert gs == pytest.approx(ws, rel=1e-5, abs=1e-6)


def test_sharded_phrase(engine, sharded, db):
    sidx, scorer = sharded
    from spaghettisearch_tpu.text.laundry import laundry

    for doc_hash in engine.snapshot.doc_hashes:
        raw = db.cached_doc(doc_hash)
        if not raw:
            continue
        toks = laundry(" ".join(raw.decode().split("<p>")[1].split("</p>")[0].split()))
        if len(toks) >= 3:
            query = f'"{toks[0]} {toks[1]} {toks[2]}"'
            break
    parsed = parse_query(query)
    want_s, want_i = engine.rank([parsed], topk=50)
    got_s, got_i = _run_sharded(engine, scorer, sidx, query)
    want = {int(i): float(s) for s, i in zip(want_s[0], want_i[0]) if np.isfinite(s)}
    got = {int(i): float(s) for s, i in zip(got_s, got_i) if np.isfinite(s)}
    assert want and got.keys() == want.keys()
    for k, v in got.items():
        assert v == pytest.approx(want[k], rel=1e-5)


def test_sharded_pagerank_matches(db, mesh):
    node_list, es, ed, od = _load_graph(db)
    n = len(node_list)
    n_pages = np.array([float(n)], np.float32)
    want = np.asarray(
        pagerank_power(
            jnp.asarray(es), jnp.asarray(ed), jnp.asarray(od, jnp.float32),
            jnp.asarray(n_pages), n, eps=1e-10,
        )
    )
    got = np.asarray(
        sharded_pagerank(mesh, es, ed, od.astype(np.float32), n_pages, n, eps=1e-10)
    )
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_2d_mesh_batch_dp_matches_1d(engine):
    """(q=2, d=4) mesh: query batch split data-parallel over q, docs over d;
    results must equal the 1-D doc-sharded mesh row for row."""
    from spaghettisearch_tpu.parallel.mesh import make_mesh2d

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh1 = make_mesh(4)
    mesh2 = make_mesh2d(2, 4)

    sidx1 = ShardedIndex.from_snapshot(engine.snapshot, mesh1)
    sidx2 = ShardedIndex.from_snapshot(engine.snapshot, mesh2)
    scorer1 = make_sharded_scorer(sidx1, topk=20)
    scorer2 = make_sharded_scorer(sidx2, topk=20)

    rng = np.random.default_rng(0)
    b, q = 4, 3
    term_ids = rng.integers(0, engine.snapshot.n_words, (b, q)).astype(np.int32)
    qlen = np.full((b,), float(q), np.float32)
    tp = np.zeros((b, sidx1.pagerank.shape[-1]), np.float32)
    ph_ids = np.full(4, engine.snapshot.n_words, np.int32)
    ph_valid = np.zeros(4, bool)

    args = (
        jnp.asarray(term_ids), jnp.asarray(qlen), jnp.asarray(tp),
        jnp.asarray(ph_ids), jnp.asarray(ph_valid), jnp.asarray(0, jnp.int32),
    )
    s1, i1 = map(np.asarray, scorer1(sidx1, *args))
    s2, i2 = map(np.asarray, scorer2(sidx2, *args))
    np.testing.assert_allclose(s2, s1, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(i2, i1)


def test_sharded_bm25_matches_single_chip(engine):
    """BM25 over the doc-sharded mesh equals the single-chip BM25Ranker."""
    from spaghettisearch_tpu.models.bm25 import BM25Ranker
    from spaghettisearch_tpu.retrieval.engine import QueryEngine

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    eng25 = QueryEngine(engine.db, model=BM25Ranker())
    mesh = make_mesh(4)
    sidx = ShardedIndex.from_snapshot(eng25.snapshot, mesh, weights="bm25")
    scorer = make_sharded_scorer(sidx, topk=50, scoring="bm25")

    for query in ("algorithm database", "quantum", '"algorithm"'):
        parsed = parse_query(query)
        want_s, want_i = eng25.rank([parsed], topk=50)
        got_s, got_i = _run_sharded(eng25, scorer, sidx, query)
        want = {int(i): float(s) for s, i in zip(want_s[0], want_i[0]) if np.isfinite(s)}
        got = {int(i): float(s) for s, i in zip(got_s, got_i) if np.isfinite(s)}
        assert got.keys() == want.keys(), query
        for k, v in got.items():
            assert v == pytest.approx(want[k], rel=1e-5), (query, k)


def test_sharded_phrase_with_truncated_dense_rows():
    """A pathological doc (capped dense row) must still phrase-match on the
    sharded path via the exact CSR fallback."""
    import random
    from datetime import datetime, timezone

    import spaghettisearch_tpu.parallel.sharded as sh
    from corpus import make_page
    from spaghettisearch_tpu.index.indexer import index_page
    from spaghettisearch_tpu.ops.pagerank import update_pagerank
    from spaghettisearch_tpu.ops.weighting import update_term_weights
    from spaghettisearch_tpu.store.tables import Database

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    old_cap = sh.DOC_TERM_CAP
    sh.DOC_TERM_CAP = 16  # force truncation without a giant fixture
    try:
        rng = random.Random(0)
        db = Database(None)
        db.topic_meta.set("G", {"numPages": 10.0, "wordCount": 1.0})
        ts = datetime(2026, 1, 1, tzinfo=timezone.utc)
        for i in range(8):
            url, html = make_page(rng, i, 8, "http://tr.local")
            index_page(db, html, url, last_modified=ts)
        body = " ".join(f"uw{j}" for j in range(40)) + " zzmk quantum"
        index_page(db, f"<html><head><title>big</title></head><body><p>{body}</p></body></html>".encode(),
                   "http://tr.local/big", last_modified=ts)
        update_pagerank(db); update_term_weights(db, "title"); update_term_weights(db, "body")
        eng = QueryEngine(db)
        mesh = make_mesh(2)
        sidx = ShardedIndex.from_snapshot(eng.snapshot, mesh)
        assert sidx.dense_truncated
        scorer = make_sharded_scorer(sidx, topk=20)
        got_s, got_i = _run_sharded(eng, scorer, sidx, '"zzmk quantum"')
        hits = [eng.snapshot.doc_hashes[int(i)] for s, i in zip(got_s, got_i) if np.isfinite(s)]
        urls = [db.doc_info.get(h).url for h in hits]
        assert urls == ["http://tr.local/big"]
    finally:
        sh.DOC_TERM_CAP = old_cap


def test_sharded_engine_matches_single_chip(db):
    """ShardedQueryEngine end to end (mixed keyword/phrase batch) equals the
    single-chip engine result-for-result."""
    from spaghettisearch_tpu.retrieval.sharded_engine import ShardedQueryEngine

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    single = QueryEngine(db)
    sharded_eng = ShardedQueryEngine(db, n_shards=4, n_query_rows=2)
    from spaghettisearch_tpu.text.laundry import laundry

    phrase = None
    for h in single.snapshot.doc_hashes:
        raw = db.cached_doc(h)
        if raw:
            toks = laundry(" ".join(raw.decode().split("<p>")[1].split("</p>")[0].split()))
            if len(toks) >= 2:
                phrase = f'"{toks[0]} {toks[1]}"'
                break
    queries = ["algorithm database", phrase, "quantum physics galaxy",
               f"{phrase} ranking", "nonexistentzz", ""]
    want = single.query_batch(queries)
    got = sharded_eng.query_batch(queries)
    for q, w, g in zip(queries, want, got):
        assert [r["Url"] for r in g] == [r["Url"] for r in w], q
        for rw, rg in zip(w, g):
            assert rg["FinalRank"] == pytest.approx(rw["FinalRank"], rel=1e-5), q


def test_sharded_engine_bm25_matches_single_chip(db):
    from spaghettisearch_tpu.models.bm25 import BM25Ranker
    from spaghettisearch_tpu.retrieval.sharded_engine import ShardedQueryEngine

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    single = QueryEngine(db, model=BM25Ranker())
    sharded_eng = ShardedQueryEngine(db, model=BM25Ranker(), n_shards=4)
    queries = ["algorithm database", "quantum physics galaxy", '"algorithm"', ""]
    want = single.query_batch(queries)
    got = sharded_eng.query_batch(queries)
    for q, w, g in zip(queries, want, got):
        assert [r["Url"] for r in g] == [r["Url"] for r in w], q
        for rw, rg in zip(w, g):
            assert rg["FinalRank"] == pytest.approx(rw["FinalRank"], rel=1e-5), q


def test_sharded_engine_phrase_rows_cross_query_axis(db):
    """Regression: with a 2-D mesh, phrase-row indices are GLOBAL batch
    positions and must be localized per query-axis slice — pre-fix, a
    phrase query on one q-row folded its matches into another q-row's
    batch slot."""
    from spaghettisearch_tpu.retrieval.sharded_engine import ShardedQueryEngine
    from spaghettisearch_tpu.text.laundry import laundry

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    single = QueryEngine(db)
    phrase = None
    for h in single.snapshot.doc_hashes:
        raw = db.cached_doc(h)
        if raw:
            toks = laundry(" ".join(raw.decode().split("<p>")[1].split("</p>")[0].split()))
            if len(toks) >= 2:
                phrase = f'"{toks[0]} {toks[1]}"'
                break
    # 4 live queries, phrases at rows 0 and 2: with n_query_rows=2 the local
    # slice is 2 rows, so row 2's phrase must land on q-row 1 slot 0
    queries = [f"{phrase} algorithm", "galaxy", phrase, "database ranking"]
    for shards, rows in [(4, 2), (2, 4)]:
        mesh_eng = ShardedQueryEngine(db, n_shards=shards, n_query_rows=rows)
        want = single.query_batch(queries)
        got = mesh_eng.query_batch(queries)
        for q, a, b_ in zip(queries, want, got):
            assert [r["Url"] for r in b_] == [r["Url"] for r in a], (shards, rows, q)
            for x, y in zip(a, b_):
                assert y["FinalRank"] == pytest.approx(x["FinalRank"], rel=1e-5)


def test_sharded_mixed_lane_routed_and_matches(db):
    """The fused mixed lane (parallel/sharded.py make_sharded_mixed_scorer)
    must actually serve phrase batches on pos-dense sharded indexes — and
    match the single-chip engine score-for-score across the phrase grammar
    edge cases (1-term phrase, phrase-only, all-phrase batch, phrase with
    zero matches)."""
    from spaghettisearch_tpu.retrieval.sharded_engine import ShardedQueryEngine
    from spaghettisearch_tpu.text.laundry import laundry

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    single = QueryEngine(db)
    sharded_eng = ShardedQueryEngine(db, n_shards=4)
    sidx = sharded_eng.index.sidx
    assert sidx.pos_dense and not sidx.dense_truncated
    phrase = None
    for h in single.snapshot.doc_hashes:
        raw = db.cached_doc(h)
        if raw:
            toks = laundry(" ".join(raw.decode().split("<p>")[1].split("</p>")[0].split()))
            if len(toks) >= 3:
                phrase = f'"{toks[0]} {toks[1]} {toks[2]}"'
                one = f'"{toks[1]}"'
                break
    batches = [
        [phrase, one, '"quantum galaxy algorithm"', f"{phrase} database"],
        [phrase] * 3,  # all-phrase batch
        [f"ranking {one}"],
    ]
    for queries in batches:
        parsed = [parse_query(q) for q in queries]
        assert sharded_eng._use_mixed(sidx, parsed)  # the lane is LIVE
        s_sh, i_sh = sharded_eng.rank(parsed)
        s_1, i_1 = single.rank(parsed)
        for r in range(len(queries)):
            k = int((s_1[r] > -np.inf).sum())
            assert np.array_equal(i_sh[r][:k], i_1[r][:k]), queries[r]
            assert np.allclose(s_sh[r][:k], s_1[r][:k], rtol=1e-5), queries[r]
            assert not np.isfinite(s_sh[r][k:]).any()
    # the mixed scorer object itself must be what served those batches
    assert any(isinstance(k, tuple) and k and k[0] == "mixed"
               for k in sharded_eng.index.scorers)


def test_sharded_no_posT_falls_back_to_sparse_lane(db):
    """An index without the dense position layout (budget/C-width refusal)
    must keep serving phrases through the sparse matcher lane, with
    identical results."""
    from spaghettisearch_tpu.retrieval.sharded_engine import ShardedQueryEngine

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    single = QueryEngine(db)
    sharded_eng = ShardedQueryEngine(db, n_shards=4)
    sidx = sharded_eng.index.sidx
    sidx.title_posT = None  # simulate a refused posT build
    sharded_eng.index.scorers.clear()
    sharded_eng._scorer_cache.clear()
    queries = ['"algorithm database"', "galaxy ranking"]
    parsed = [parse_query(q) for q in queries]
    assert not sharded_eng._use_mixed(sidx, parsed)
    s_sh, i_sh = sharded_eng.rank(parsed)
    s_1, i_1 = single.rank(parsed)
    for r in range(len(queries)):
        k = int((s_1[r] > -np.inf).sum())
        assert np.array_equal(i_sh[r][:k], i_1[r][:k]), queries[r]
        assert np.allclose(s_sh[r][:k], s_1[r][:k], rtol=1e-5), queries[r]


def test_sharded_class_batching_advice(db, monkeypatch):
    """ShardedQueryEngine overrides class_batching_pays (the inherited
    single-chip one walks DeviceIndex attrs _ShardedLive lacks): off for
    small corpora, on past the doc threshold with the fused lane live."""
    from spaghettisearch_tpu.retrieval import sharded_engine as se

    eng = se.ShardedQueryEngine(db, n_shards=2)
    assert eng.class_batching_pays() is False  # 30 docs < threshold
    monkeypatch.setattr(se, "SEGREGATE_MIN_DOCS", 1)
    assert eng.class_batching_pays() is True  # fused lane + "large" corpus


# ------------ single-device kernel-level parity on the mesh -------------- #


def _hot_synth_snap():
    """Synthetic snapshot with max_df << n_docs: no df==N zero-weight terms,
    so the hot cache is active (cf. tests/test_hot_terms.py — the crawl
    fixtures all carry an every-page word whose idf is 0)."""
    import sys

    sys.path.insert(0, ".")
    from bench import synth_snapshot

    s = synth_snapshot(
        n_docs=3_000, n_words=2_000, body_terms_per_doc=24,
        title_terms_per_doc=4, max_df=512, seed=5,
    )
    s.word_id.update({h: i for i, h in enumerate(s.word_hashes)})
    return s


def _hot_cold_queries(snap, rng, n, phrase_every=0):
    from spaghettisearch_tpu.retrieval.engine import ParsedQuery

    df = np.diff(snap.body.post_offsets[: snap.n_words + 1])
    hot_pool = np.argsort(-df)[:64]
    cold_pool = np.argsort(-df)[1_000:1_500]
    out = []
    for i in range(n):
        k = int(rng.integers(1, 5))
        wids = [
            int(rng.choice(hot_pool if rng.random() < 0.5 else cold_pool))
            for _ in range(k)
        ]
        phs = []
        if phrase_every and i % phrase_every == 0:
            phs = [snap.word_hashes[int(rng.choice(hot_pool))]]
        out.append(ParsedQuery(
            raw="", stripped="", phrases=["p"] if phs else [],
            keyword_hashes=[snap.word_hashes[w] for w in wids],
            phrase_hashes=phs,
        ))
    return out


def test_sharded_hot_cache_built_and_global(monkeypatch):
    """The sharded index carries per-shard slices of the GLOBAL hot-term
    set: the map must match the single-chip DeviceIndex's for the same
    snapshot, and the dense rows must reassemble to the same weights."""
    from spaghettisearch_tpu.retrieval import device_index as di

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    monkeypatch.setattr(di, "HOT_H_MAX", 64)
    snap = _hot_synth_snap()
    sidx = ShardedIndex.from_snapshot(snap, make_mesh(4))
    single = di.DeviceIndex.from_snapshot(snap)
    assert sidx.hot_body_w is not None and single.hot_body_w is not None
    assert sidx.hot_body_map == single.hot_body_map
    got = np.asarray(sidx.hot_body_w)  # [S, H, Dl]
    want = np.asarray(single.hot_body_w)  # [H, D_pad]
    s, h, dl = got.shape
    flat = np.moveaxis(got, 0, 1).reshape(h, s * dl)
    n = snap.n_docs
    np.testing.assert_array_equal(flat[: want.shape[0], :n], want[:, :n])


@pytest.mark.parametrize("phrase_every", [0, 4])
def test_sharded_hot_cold_mix_matches_single_chip(monkeypatch, phrase_every):
    """Queries mixing hot and cold terms exercise the qnb cold-split +
    hot-matmul fold on the mesh (keyword scorer and, with phrases, the
    fused mixed scorer); ranks must equal the single-chip hot engine."""
    from spaghettisearch_tpu.retrieval import device_index as di
    from spaghettisearch_tpu.retrieval.sharded_engine import ShardedQueryEngine

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    monkeypatch.setattr(di, "HOT_H_MAX", 64)
    snap = _hot_synth_snap()
    single = QueryEngine(None, snapshot=snap)
    sharded_eng = ShardedQueryEngine(None, snapshot=snap, n_shards=4)
    sidx = sharded_eng.index.sidx
    assert sidx.hot_body_map is not None and len(sidx.hot_body_map) == 64
    assert sidx.hot_body_map == single.index.hot_body_map
    rng = np.random.default_rng(17)
    batch = _hot_cold_queries(snap, rng, 16, phrase_every)
    ss, si = sharded_eng.rank(batch, topk=30)
    ws, wi = single.rank(batch, topk=30)
    for row in range(len(batch)):
        got = {int(i): float(s) for s, i in zip(ss[row], si[row]) if np.isfinite(s)}
        want = {int(i): float(s) for s, i in zip(ws[row], wi[row]) if np.isfinite(s)}
        assert got.keys() == want.keys(), row
        for d in got:
            assert got[d] == pytest.approx(want[d], rel=1e-5, abs=1e-7), (row, d)


def test_sharded_doc_sorted_matches_natural(engine, mesh):
    """The per-shard doc-sorted layout (dynamic-T sweep + doc_perm gather)
    must return the same natural ids and scores as the natural layout."""
    sidx_n = ShardedIndex.from_snapshot(engine.snapshot, mesh, doc_sort=False)
    sidx_s = ShardedIndex.from_snapshot(engine.snapshot, mesh, doc_sort=True)
    assert sidx_n.doc_perm is None
    assert sidx_s.doc_perm is not None and sidx_s.body_tmax is not None
    sc_n = make_sharded_scorer(sidx_n, topk=50)
    sc_s = make_sharded_scorer(sidx_s, topk=50)
    for query in QUERIES + ('"algorithm database"',):
        s_n, i_n = _run_sharded(engine, sc_n, sidx_n, query)
        s_s, i_s = _run_sharded(engine, sc_s, sidx_s, query)
        fin = np.isfinite(s_n)
        assert np.isfinite(s_s).sum() == fin.sum(), query
        np.testing.assert_array_equal(i_s[fin], i_n[fin], err_msg=query)
        np.testing.assert_allclose(
            s_s[fin], s_n[fin], rtol=1e-5, atol=1e-7, err_msg=query
        )


def test_sharded_engine_doc_sorted_end_to_end(db, monkeypatch):
    """ShardedQueryEngine on a force-gated doc-sorted index (keyword, hot
    mix, and fused-mixed phrase batches) equals the single-chip NATURAL
    layout engine — the strongest cross-layout oracle."""
    from spaghettisearch_tpu.retrieval import device_index as di
    from spaghettisearch_tpu.retrieval.sharded_engine import ShardedQueryEngine
    from spaghettisearch_tpu.text.laundry import laundry

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    single = QueryEngine(db, doc_sort=False)
    monkeypatch.setattr(di, "DOC_SORT_MIN_DOCS", 1)
    monkeypatch.setattr(di, "_doc_sort_pays", lambda nt: True)
    sharded_eng = ShardedQueryEngine(db, n_shards=4)
    sidx = sharded_eng.index.sidx
    assert sidx.doc_perm is not None  # the gate actually fired
    phrase = None
    for h in single.snapshot.doc_hashes:
        raw = db.cached_doc(h)
        if raw:
            toks = laundry(" ".join(raw.decode().split("<p>")[1].split("</p>")[0].split()))
            if len(toks) >= 2:
                phrase = f'"{toks[0]} {toks[1]}"'
                break
    queries = ["algorithm database", phrase, "quantum physics galaxy",
               f"{phrase} ranking", "nonexistentzz", ""]
    want = single.query_batch(queries)
    got = sharded_eng.query_batch(queries)
    for q, w, g in zip(queries, want, got):
        assert [r["Url"] for r in g] == [r["Url"] for r in w], q
        for rw, rg in zip(w, g):
            assert rg["FinalRank"] == pytest.approx(rw["FinalRank"], rel=1e-5), q


def test_sharded_refresh_warm_covers_all_live_shapes(db):
    """After a geometry-changing refresh, the FIRST query of
    every program family the batcher can dispatch must hit a warmed program.
    A lazy shard_map compile under live mesh load starves in-flight
    collectives past XLA's ~40 s rendezvous watchdog and fatally aborts the
    server (round-4 1M soak, commit d8ac86c) — so prepare_refresh(warm=True)
    must walk the full shape set even on the CPU mesh when geometry changed."""
    import logging
    from datetime import datetime, timezone

    from corpus import VOCAB
    from spaghettisearch_tpu.index.indexer import index_page
    from spaghettisearch_tpu.ops.pagerank import update_pagerank
    from spaghettisearch_tpu.ops.weighting import update_term_weights
    from spaghettisearch_tpu.retrieval.sharded_engine import ShardedQueryEngine

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    fresh_db = build_corpus_db(n_pages=24, seed=11)
    eng = ShardedQueryEngine(fresh_db, n_shards=2)
    eng.warmup()

    # grow the vocab + per-doc distinct-term count past the padded geometry
    body = " ".join(f"zfreshterm{i}" for i in range(64))
    html = (
        "<html><head><title>fresh geometry page</title></head>"
        f"<body><p>{body}</p></body></html>"
    ).encode()
    index_page(fresh_db, html, "http://test.local/fresh",
               last_modified=datetime(2026, 2, 1, tzinfo=timezone.utc))
    update_pagerank(fresh_db)
    update_term_weights(fresh_db, "title")
    update_term_weights(fresh_db, "body")

    jax.config.update("jax_log_compiles", True)
    records: list[logging.LogRecord] = []

    class _Cap(logging.Handler):
        def emit(self, r):  # noqa: D102
            records.append(r)

    cap = _Cap(level=logging.WARNING)
    logging.getLogger("jax").addHandler(cap)
    try:
        state = eng.prepare_refresh(warm=True)
        warmed = [r for r in records if "Compiling " in r.getMessage()]
        # sensitivity: the changed geometry must force fresh compiles during
        # the off-lock warm (this also proves the capture hook works)
        assert warmed, "geometry change did not recompile — test is blind"
        old = eng.commit_refresh(state)
        if old is not None:
            old.close()
        records.clear()

        # the batcher's reachable dispatch surface: trickle + both batch
        # buckets, mixed composition, pure-phrase, rare-grammar catch-alls
        kw = "algorithm database"
        ph = '"algorithm database"'
        rare_kw = " ".join(VOCAB[:12])
        rare_ph = '"' + " ".join(VOCAB[:12]) + '" ' + rare_kw
        eng.query_batch([kw])
        eng.query_batch([ph, kw, kw])
        eng.query_batch([kw] * 16)
        eng.query_batch([ph] * 16)
        eng.query_batch([ph, kw] * 30)
        eng.query_batch([kw] * 128)
        eng.query_batch(([ph] * 3 + [kw] * 5) * 16)
        eng.query_batch([rare_kw, rare_ph, kw, ph])
        lazy = [r.getMessage() for r in records if "Compiling " in r.getMessage()]
        assert not lazy, f"post-refresh lazy compiles: {lazy[:4]}"
    finally:
        logging.getLogger("jax").removeHandler(cap)
        jax.config.update("jax_log_compiles", False)
