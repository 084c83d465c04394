"""Serving fast path: the pre-serialized JSON hydration must be parse-equal
to the dict path, and the HTTP wire must carry the full Rank_combined
contract (reference: cmd/server/server.go:32-52 + retrieval/get_metadata.go)."""

import json
import urllib.request

import pytest

from corpus import build_corpus_db
from spaghettisearch_tpu.retrieval.engine import QueryEngine, parse_query
from spaghettisearch_tpu.serve.server import SearchServer


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    return build_corpus_db(
        n_pages=40, seed=3, root=str(tmp_path_factory.mktemp("serve_db"))
    )


@pytest.fixture(scope="module")
def engine(db):
    return QueryEngine(db)


QUERIES = (
    "algorithm",
    "quantum physics database",
    '"document gradient"',
    'galaxy "quantum poetry" ranking',
    "nonexistentzz",
    "",
)


def test_json_fast_path_parse_equal_to_dict_path(engine):
    for q in QUERIES:
        parsed = parse_query(q)
        live = engine._live
        if parsed.is_empty:
            continue
        scores, ids = engine.rank([parsed], live=live)
        want = engine.hydrate_row(scores[0], ids[0], parsed, live)
        got = json.loads(engine.hydrate_row_json(scores[0], ids[0], parsed, live))
        assert got == want, q
        # key order inside each result matches the reference contract
        for r in got:
            assert list(r.keys()) == [
                "Url", "Page_title", "Mod_date", "Page_size", "Children",
                "Parents", "Words_mapping", "Summary", "PageRank", "FinalRank",
            ]


def test_record_cache_survives_repeat_queries(engine):
    a = engine.query("algorithm")
    cache = getattr(engine.snapshot, "_hyd_records", None)
    assert cache  # populated by hydration
    b = engine.query("algorithm")
    assert a == b


def test_http_wire_equals_engine(engine):
    server = SearchServer(engine, batching=True)
    host, port = server.start_background(port=0)
    try:
        base = f"http://127.0.0.1:{port}"
        for q in QUERIES:
            req = urllib.request.Request(
                base + "/query",
                data=json.dumps({"query": q}).encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=30) as resp:
                got = json.loads(resp.read())
            want = engine.query(q)
            assert got == want, q
    finally:
        server.shutdown()


def test_refresh_reports_lock_hold_and_picks_up_new_docs(db, engine):
    import random
    from datetime import datetime, timezone

    from corpus import make_page
    from spaghettisearch_tpu.index.indexer import index_page
    from spaghettisearch_tpu.ops.pagerank import update_pagerank
    from spaghettisearch_tpu.ops.weighting import update_term_weights

    server = SearchServer(engine, batching=False)
    host, port = server.start_background(port=0)
    try:
        base = f"http://127.0.0.1:{port}"
        n0 = engine.index.n_docs
        rng = random.Random(123)
        ts = datetime(2026, 3, 3, tzinfo=timezone.utc)
        for i in range(40, 50):
            url, html = make_page(rng, i, 50, "http://test.local")
            index_page(db, html, url, last_modified=ts)
        update_pagerank(db)
        update_term_weights(db, "title")
        update_term_weights(db, "body")
        req = urllib.request.Request(base + "/refresh", data=b"{}")
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.loads(resp.read())
        assert out["ok"] and out["docs"] > n0
        # the serving lock is held only for the swap, not the rebuild
        assert out["lock_seconds"] < out["seconds"] or out["seconds"] < 0.05
        # queries against the refreshed index still work end to end
        with urllib.request.urlopen(base + "/query/algorithm", timeout=30) as resp:
            assert json.loads(resp.read())
    finally:
        server.shutdown()


def test_prewarm_hydration_matches_lazy_records():
    """Bulk-built hydration records must equal the lazy per-doc path."""
    import copy

    from corpus import build_corpus_db
    from spaghettisearch_tpu.retrieval.engine import QueryEngine

    eng = QueryEngine(build_corpus_db(n_pages=20, seed=4))
    snap = eng.snapshot
    # lazy-build a few records first, then prewarm the rest
    lazy = {d: eng._doc_record(d, snap) for d in (0, 3, 7)}
    n = eng.prewarm_hydration()
    assert n == snap.n_docs
    fresh_snap = copy.copy(snap)
    fresh_snap._hyd_records = {}
    for d in range(snap.n_docs):
        want = eng._doc_record(d, fresh_snap)  # lazy rebuild
        got = snap._hyd_records[d]
        assert got == want, d
    for d, rec in lazy.items():
        assert snap._hyd_records[d] == rec


# -------------- native response assembler (native/fastserve.cpp) --------- #


@pytest.fixture(scope="module")
def prewarmed(tmp_path_factory):
    # own corpus: the module `db` can be superseded (and closed) by the
    # refresh test's commit_refresh swap
    eng = QueryEngine(build_corpus_db(
        n_pages=30, seed=7, root=str(tmp_path_factory.mktemp("native_hyd"))
    ))
    n = eng.prewarm_hydration()
    assert n == eng.snapshot.n_docs
    gen = getattr(eng.snapshot, "_native_hyd", None)
    assert gen is not None and gen.count() == eng.snapshot.n_docs
    return eng


def _python_assembly(eng, scores_row, ids_row, parsed, live):
    """Force the legacy Python wire path for comparison."""
    gen = live[0].__dict__.pop("_native_hyd", None)
    try:
        return eng.hydrate_row_json(scores_row, ids_row, parsed, live)
    finally:
        if gen is not None:
            live[0]._native_hyd = gen


def test_native_assembler_parse_equal(prewarmed):
    eng = prewarmed
    live = eng._live
    for q in QUERIES:
        parsed = parse_query(q)
        if parsed.is_empty:
            continue
        scores, ids = eng.rank([parsed], live=live)
        native = eng.hydrate_row_json(scores[0], ids[0], parsed, live)
        legacy = _python_assembly(eng, scores[0], ids[0], parsed, live)
        assert json.loads(native) == json.loads(legacy), q


def test_native_assembler_score_edge_cases(prewarmed):
    import numpy as np

    eng = prewarmed
    live = eng._live
    parsed = parse_query("algorithm")
    n = live[0].n_docs
    ids = np.arange(6, dtype=np.int32) % n
    scores = np.array(
        [np.inf, 1.5, -np.inf, np.nan, 3.0, 42.0], dtype=np.float32
    )
    native = json.loads(eng.hydrate_row_json(scores, ids, parsed, live))
    legacy = json.loads(_python_assembly(eng, scores, ids, parsed, live))
    assert native == legacy
    # -inf and nan rows dropped; inf survives as a float
    assert len(native) == 4
    assert native[0]["FinalRank"] == float("inf")
    assert isinstance(native[-1]["FinalRank"], float)


def test_native_assembler_escaping():
    """Quotes, backslashes, control bytes and UTF-8 in summary text must
    survive the native JSON escape parse-equal to json.dumps."""
    import json as _json

    from spaghettisearch_tpu.retrieval.native_hydrate import (
        HydrationGen, native_available,
    )
    from spaghettisearch_tpu.retrieval.native_summary import pack_query
    from spaghettisearch_tpu.retrieval.summary import prepare_summary_query

    if not native_available():
        pytest.skip("native assembler unavailable")
    nasty = 'späm "quoted" back\\slash\ttab ctrl\x01 héllo match end'
    frag = _json.dumps({"Url": "http://x", "Page_title": 'a"b\\c'},
                       separators=(",", ":"))[:-1]
    gen = HydrationGen(1)
    gen.set_doc(0, frag.encode(), nasty.encode())
    import numpy as np

    packed = pack_query(prepare_summary_query("match", []))
    body = gen.assemble(np.array([0], np.int32),
                        np.array([2.5], np.float32), packed)
    got = _json.loads(body)
    assert got[0]["Url"] == "http://x"
    assert got[0]["Page_title"] == 'a"b\\c'
    assert "match" in got[0]["Summary"]
    # the escaped summary round-trips the nasty bytes it windows over
    assert "\\" not in got[0]["Summary"] or "back\\slash" in got[0]["Summary"]
    assert got[0]["FinalRank"] == 2.5


def test_native_batch_assembly_matches_per_row(prewarmed):
    """fv_assemble_batch (one call per ranked batch, run by the
    micro-batcher worker) must produce byte-identical bodies to the
    per-row fv_assemble path for a mixed keyword/phrase batch."""
    import numpy as np

    from spaghettisearch_tpu.retrieval.native_summary import pack_query
    from spaghettisearch_tpu.retrieval.summary import prepare_summary_query

    eng = prewarmed
    live = eng._live
    gen = live[0]._native_hyd
    queries = [q for q in QUERIES if not parse_query(q).is_empty]
    parsed = [parse_query(q) for q in queries]
    scores, ids = eng.rank(parsed, live=live)
    scores = np.asarray(scores)
    ids = np.asarray(ids)
    packed = [
        pack_query(prepare_summary_query(p.stripped, p.phrases))
        for p in parsed
    ]
    bodies = gen.assemble_batch(ids, scores, packed)
    assert bodies is not None and len(bodies) == len(queries)
    for r, q in enumerate(queries):
        want = gen.assemble(ids[r], scores[r], packed[r])
        assert bodies[r] == want, q
        assert json.loads(bodies[r]) == json.loads(
            eng.hydrate_row_json(scores[r], ids[r], parsed[r], live)
        ), q


def test_batcher_returns_native_bodies(prewarmed):
    """The micro-batcher's query_raw must hand back finished native bodies
    parse-equal to the per-request hydration path."""
    from spaghettisearch_tpu.serve.batcher import MicroBatcher
    from spaghettisearch_tpu.utils.rwlock import RWLock

    eng = prewarmed
    b = MicroBatcher(eng, max_batch=8, max_wait_ms=5, lock=RWLock())
    try:
        for q in QUERIES:
            body, scores_row, ids_row, parsed, live = b.query_raw(q)
            if parse_query(q).is_empty:
                assert body == b"[]"
                continue
            assert body is not None, q
            assert json.loads(body) == json.loads(
                eng.hydrate_row_json(scores_row, ids_row, parsed, live)
            ), q
    finally:
        b.shutdown()


# ---------------------- fastloop abuse guards ---------------------------- #


def _guarded_server(engine, **opts):
    defaults = dict(read_timeout=0.6, max_header=2048, max_body=4096,
                    max_connections=4)
    defaults.update(opts)
    server = SearchServer(engine, batching=False, http_opts=defaults)
    host, port = server.start_background(port=0)
    return server, port


def test_fastloop_slow_header_client_dropped(engine):
    import socket
    import time

    server, port = _guarded_server(engine)
    try:
        c = socket.create_connection(("127.0.0.1", port), timeout=5)
        c.sendall(b"GET /healthz HTT")  # never completes the request
        t0 = time.monotonic()
        got = c.recv(4096)  # server must CLOSE (empty), not hang forever
        assert got == b""
        assert time.monotonic() - t0 < 5
    finally:
        server.shutdown()


def test_fastloop_non_object_payload_400(engine):
    """A bare JSON list/scalar body is a client error (400), not a 500:
    payload.get on a list raised AttributeError before the guard."""
    import socket

    server, port = _guarded_server(engine)
    try:
        for body in (b'["algorithm"]', b'"algorithm"', b"3"):
            c = socket.create_connection(("127.0.0.1", port), timeout=5)
            req = (b"POST /query_batch HTTP/1.1\r\nHost: t\r\n"
                   b"Content-Type: application/json\r\nContent-Length: "
                   + str(len(body)).encode() + b"\r\n\r\n" + body)
            c.sendall(req)
            got = c.recv(4096)
            assert b"400" in got.split(b"\r\n", 1)[0], body
            c.close()
    finally:
        server.shutdown()


def test_fastloop_oversized_header_rejected(engine):
    import socket

    server, port = _guarded_server(engine)
    try:
        c = socket.create_connection(("127.0.0.1", port), timeout=5)
        c.sendall(b"GET /healthz HTTP/1.1\r\nX-Junk: " + b"a" * 4096)
        got = c.recv(4096)
        assert b"400" in got.split(b"\r\n", 1)[0]
    finally:
        server.shutdown()


def test_fastloop_oversized_body_rejected(engine):
    import socket

    server, port = _guarded_server(engine)
    try:
        c = socket.create_connection(("127.0.0.1", port), timeout=5)
        c.sendall(
            b"POST /query HTTP/1.1\r\nContent-Length: 999999\r\n\r\n"
        )
        got = c.recv(4096)
        assert b"413" in got.split(b"\r\n", 1)[0]
    finally:
        server.shutdown()


def test_fastloop_connection_cap(engine):
    import socket

    server, port = _guarded_server(engine, max_connections=2)
    try:
        keep = [socket.create_connection(("127.0.0.1", port), timeout=5)
                for _ in range(2)]
        for c in keep:  # make them real half-open requests
            c.sendall(b"GET /healthz HT")
        extra = socket.create_connection(("127.0.0.1", port), timeout=5)
        extra.sendall(b"GET /healthz HTTP/1.1\r\n\r\n")
        got = extra.recv(4096)
        assert got == b"" or b"503" in got.split(b"\r\n", 1)[0]
        for c in keep:
            c.close()
    finally:
        server.shutdown()


def test_fastloop_abrupt_close_and_recovery(engine):
    import socket

    server, port = _guarded_server(engine)
    try:
        c = socket.create_connection(("127.0.0.1", port), timeout=5)
        c.sendall(b"POST /query HTTP/1.1\r\nContent-Length: 100\r\n\r\n{")
        c.close()  # mid-body abort
        # the server must keep serving
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=10
        ) as resp:
            assert json.loads(resp.read())["ok"] is True
    finally:
        server.shutdown()


def test_result_cache_hits_and_refresh_invalidation(db, tmp_path):
    """Opt-in response cache: identical bytes on a hit, LRU-bounded, and a
    /refresh bumps the generation so stale responses can never serve."""
    import shutil

    root = str(tmp_path / "rc_db")
    shutil.copytree(db.root, root)
    from spaghettisearch_tpu.store.tables import Database

    db2 = Database(root)
    eng = QueryEngine(db2)
    server = SearchServer(eng, batching=True, result_cache=4)
    try:
        a1 = server.handle_query_json("algorithm database")
        a2 = server.handle_query_json("algorithm database")
        assert a1 == a2 and server._rcache_hits == 1
        # LRU bound: capacity 4, 5 distinct queries evict the oldest
        for q in ("q1", "q2", "q3", "q4"):
            server.handle_query_json(q)
        assert len(server._rcache) == 4
        gen0 = server._rcache_gen
        # refresh bumps the generation: same query re-executes
        import spaghettisearch_tpu.index.indexer as ix
        from datetime import datetime, timezone

        ix.index_page(
            db2,
            b"<html><title>fresh algorithm</title><p>algorithm database "
            b"entirely fresh page</p></html>",
            "http://test.local/fresh-rc",
            last_modified=datetime(2030, 1, 1, tzinfo=timezone.utc),
        )
        server.handle_refresh()
        assert server._rcache_gen == gen0 + 1
        misses0 = server._rcache_misses
        a3 = server.handle_query_json("algorithm database")
        assert server._rcache_misses == misses0 + 1
        # the fresh doc is only visible post-refresh — proving the cached
        # pre-refresh bytes were not served
        assert b"fresh-rc" in a3 and b"fresh-rc" not in a1
    finally:
        server.shutdown()
        db2.close()


def test_big_batch_server_coalesces_past_128(engine):
    """--bigBatch wiring: a 256-row micro-batch through SearchServer must
    resolve every request with the same results the default server gives
    (exercises the B_BIG bucket end-to-end: batcher slice > 128, engine
    padding, inverse permutation, native assembly). Uses the live engine's
    state, not the raw db fixture — the refresh test closes that handle."""
    import threading

    eng = QueryEngine(engine.db, snapshot=engine.snapshot,
                      index=engine.index, big_batch=True)
    server = SearchServer(eng, batching=True, max_batch=256)
    ref = SearchServer(
        QueryEngine(engine.db, snapshot=engine.snapshot, index=engine.index),
        batching=True,
    )
    texts = [QUERIES[i % 4] for i in range(160)]
    results = [None] * len(texts)

    # stall the batcher's first slice so all 160 requests coalesce
    barrier = threading.Barrier(len(texts) + 1)

    def worker(i):
        barrier.wait()
        results[i] = server.handle_query_json(texts[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(texts))]
    for t in threads:
        t.start()
    barrier.wait()
    for t in threads:
        t.join(timeout=120)
    assert all(r is not None for r in results)
    batches = server.batcher.stats.batches
    assert server.batcher.stats.queries == len(texts)
    want = {t: ref.handle_query_json(t) for t in set(texts)}
    for t, r in zip(texts, results):
        assert json.loads(r) == json.loads(want[t])
    server.batcher.shutdown()
    ref.batcher.shutdown()
    assert batches >= 1


def test_fastloop_relative_static_dir_serves(engine, tmp_path, monkeypatch):
    """A relative static_dir must serve assets, not 403 them (the traversal
    guard compares against the absolute root)."""
    import socket

    (tmp_path / "static").mkdir()
    (tmp_path / "static" / "index.html").write_text("<html>rel-ok</html>")
    monkeypatch.chdir(tmp_path)
    server = SearchServer(engine, batching=False, static_dir="static")
    host, port = server.start_background(port=0)
    try:
        c = socket.create_connection(("127.0.0.1", port), timeout=5)
        c.sendall(b"GET / HTTP/1.1\r\nHost: t\r\n\r\n")
        got = c.recv(4096)
        assert b"200" in got.split(b"\r\n", 1)[0]
        assert b"rel-ok" in got
        # traversal still forbidden
        c2 = socket.create_connection(("127.0.0.1", port), timeout=5)
        c2.sendall(b"GET /../../etc/passwd HTTP/1.1\r\nHost: t\r\n\r\n")
        got2 = c2.recv(4096)
        assert b"root:" not in got2
    finally:
        server.shutdown()
