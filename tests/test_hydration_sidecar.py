"""Persisted hydration sidecar: a server restarting on an unchanged
(snapshot, store) pair must come up WITHOUT re-walking the store, produce
byte-for-byte identical responses, and detect any store change via the
content fingerprint (spaghettisearch_tpu/retrieval/hydration_sidecar.py).

The Go reference hydrates per query straight from BadgerDB
(retrieval/get_metadata.go); the sidecar is serving infrastructure for the
1M-doc tier, where the prewarm walk takes minutes."""

import datetime
import json
import os

import pytest

from corpus import build_corpus_db, make_page
from spaghettisearch_tpu.index.indexer import index_page
from spaghettisearch_tpu.index.persist import load_snapshot, save_snapshot
from spaghettisearch_tpu.index.snapshot import build_snapshot
from spaghettisearch_tpu.retrieval.engine import QueryEngine, parse_query
from spaghettisearch_tpu.retrieval.hydration_sidecar import SIDECAR_NAME

QUERIES = (
    "algorithm",
    "quantum physics database",
    'galaxy "quantum poetry" ranking',
)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("sidecar")
    db = build_corpus_db(n_pages=30, seed=5, root=str(root / "store"))
    snap = build_snapshot(db)
    save_snapshot(snap, str(root / "snapshot"))
    return db, str(root / "snapshot")


def _responses(engine):
    out = {}
    for q in QUERIES:
        parsed = parse_query(q)
        scores, ids = engine.rank([parsed])
        out[q] = json.loads(
            engine.hydrate_row_json(scores[0], ids[0], parsed, engine._live)
        )
        assert out[q]  # queries chosen to hit the fixture vocabulary
    return out


def test_sidecar_roundtrip_and_no_store_walk(setup, monkeypatch):
    db, snap_dir = setup
    e1 = QueryEngine(db, snapshot=load_snapshot(snap_dir))
    n1 = e1.prewarm_hydration()
    assert n1 == e1.snapshot.n_docs
    want = _responses(e1)
    path = os.path.join(snap_dir, SIDECAR_NAME)
    assert os.path.exists(path), "fresh prewarm must persist the sidecar"

    # restart: fresh snapshot object, same store — prewarm must take the
    # sidecar path; any doc_info/word/doc_summary table walk is a failure
    e2 = QueryEngine(db, snapshot=load_snapshot(snap_dir))
    for table in (db.doc_info, db.word, db.doc_summary):
        monkeypatch.setattr(
            table, "items",
            lambda *_a, **_k: pytest.fail("store walked despite sidecar"),
        )
    n2 = e2.prewarm_hydration()
    assert n2 == n1
    assert getattr(e2.snapshot, "_hyd_blob", None) is not None
    monkeypatch.undo()
    assert _responses(e2) == want

    # repeated prewarm on the same snapshot stays a no-op
    assert e2.prewarm_hydration() == n1


def test_sidecar_python_fallback_records_match(setup):
    """The lazy blob decode (_doc_record) must equal a store-built record —
    exercised by disabling the native assembler on the sidecar engine."""
    db, snap_dir = setup
    e1 = QueryEngine(db, snapshot=load_snapshot(snap_dir))
    e1.prewarm_hydration()
    e2 = QueryEngine(db, snapshot=load_snapshot(snap_dir))
    assert e2.prewarm_hydration() == e1.snapshot.n_docs
    e2.snapshot._native_hyd = None  # force the Python assembler
    for q in QUERIES:
        parsed = parse_query(q)
        scores, ids = e2.rank([parsed])
        live = e2._live
        py = json.loads(e2.hydrate_row_json(scores[0], ids[0], parsed, live))
        assert py == e2.hydrate_row(scores[0], ids[0], parsed, live)


def test_sidecar_invalidated_by_store_change(setup):
    db, snap_dir = setup
    e1 = QueryEngine(db, snapshot=load_snapshot(snap_dir))
    e1.prewarm_hydration()

    # append to a fingerprinted table: any store change must invalidate
    import random

    url, html = make_page(random.Random(123), 990, 991, "http://test.local")
    index_page(
        db, html, url,
        last_modified=datetime.datetime(2026, 2, 1, tzinfo=datetime.timezone.utc),
    )
    snap2 = build_snapshot(db)
    save_snapshot(snap2, snap_dir)  # doc set changed -> new snapshot too
    e2 = QueryEngine(db, snapshot=load_snapshot(snap_dir))
    assert e2._load_hyd_sidecar(e2.snapshot) is None  # stale -> rebuild
    n = e2.prewarm_hydration()
    assert n == e2.snapshot.n_docs
    # ... and the rebuild re-saved a now-valid sidecar
    e3 = QueryEngine(db, snapshot=load_snapshot(snap_dir))
    assert e3._load_hyd_sidecar(e3.snapshot) == n


def test_in_memory_snapshot_skips_sidecar(setup):
    """Snapshots built straight from the store (refresh path) have no
    source_dir: nothing is persisted, nothing is loaded."""
    db, snap_dir = setup
    e = QueryEngine(db)  # build_snapshot in __post_init__: source_dir None
    assert e._hyd_sidecar_key(e.snapshot) is None
    assert e.prewarm_hydration() == e.snapshot.n_docs
    assert not os.path.exists(os.path.join(os.getcwd(), SIDECAR_NAME))


def test_streamed_builder_equals_dict_builder(tmp_path):
    """The streaming prewarm (bounded-RAM sidecar build)
    must produce per-doc fragments and texts byte-identical to the
    in-memory dict builder it replaced on the disk-backed path."""
    import numpy as np

    db = build_corpus_db(n_pages=25, seed=9, root=str(tmp_path / "store"))
    snap = build_snapshot(db)
    save_snapshot(snap, str(tmp_path / "snapshot"))

    e1 = QueryEngine(db, snapshot=load_snapshot(str(tmp_path / "snapshot")))
    built = e1.prewarm_hydration()  # streaming builder (sidecar saveable)
    assert built == e1.snapshot.n_docs
    assert getattr(e1.snapshot, "_hyd_blob", None) is not None
    assert not getattr(e1.snapshot, "_hyd_records", None)  # no dict cache
    path = os.path.join(str(tmp_path / "snapshot"), SIDECAR_NAME)
    with np.load(path) as z:
        flags = z["flags"]
        off = z["frag_off"]
        blob = z["frag_blob"].tobytes()
        texts_included = bool(z["texts_included"])
        t_off = z["text_off"]
        t_blob = z["text_blob"].tobytes()

    # dict builder on the same pair: disable the sidecar key so the legacy
    # in-memory path runs (it would otherwise just load the file above)
    e2 = QueryEngine(db, snapshot=load_snapshot(str(tmp_path / "snapshot")))
    e2._hyd_sidecar_key = lambda s: None
    e2.prewarm_hydration()
    cache = e2.snapshot._hyd_records
    assert len(cache) == e2.snapshot.n_docs
    for did in range(e2.snapshot.n_docs):
        assert bool(flags[did] & 1), did
        frag_streamed = blob[off[did]: off[did + 1]].decode()
        assert cache[did][1] == frag_streamed, did
    if texts_included:
        for did, dh in enumerate(e2.snapshot.doc_hashes):
            text = db.doc_summary.get(dh)
            streamed = t_blob[t_off[did]: t_off[did + 1]].decode()
            if flags[did] & 2:
                assert streamed == text, did
            else:
                assert text is None and streamed == "", did

    # and the streamed blob serves responses identical to the dict path
    for q in QUERIES:
        parsed = parse_query(q)
        s1, i1 = e1.rank([parsed])
        a = json.loads(e1.hydrate_row_json(s1[0], i1[0], parsed, e1._live))
        s2, i2 = e2.rank([parsed])
        b = json.loads(e2.hydrate_row_json(s2[0], i2[0], parsed, e2._live))
        assert a == b, q
