"""The fused mixed lane (ops/kernels/mixed.py) must agree score-for-score
with the legacy two-phase lane (sparse matcher + host fold), which is
itself oracle-tested against the reference semantics
(reference: retrieval/phrase.go:53-109, main_retrieve.go:45-103).
"""

from __future__ import annotations

import random
import sys
from datetime import datetime, timezone

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, ".")

from spaghettisearch_tpu.index.indexer import index_page
from spaghettisearch_tpu.index.snapshot import build_snapshot
from spaghettisearch_tpu.ops.weighting import update_term_weights
from spaghettisearch_tpu.retrieval.device_index import DeviceIndex, _build_posT
from spaghettisearch_tpu.retrieval.engine import QueryEngine, parse_query
from spaghettisearch_tpu.store.tables import Database

WORDS = [
    "alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
    "hotel", "india", "juliet", "kilo", "lima",
]


def _build_corpus(seed: int, n_pages: int = 40) -> Database:
    """Small crawled corpus with repeated bigrams (multi-position lists),
    anchors (-100 titles), and meta terms."""
    rng = random.Random(seed)
    db = Database(None)
    ts = datetime(2026, 1, 1, tzinfo=timezone.utc)
    for i in range(n_pages):
        body = []
        for _ in range(rng.randint(5, 25)):
            body.append(rng.choice(WORDS))
            if rng.random() < 0.4:  # plant adjacent bigrams
                body.append(rng.choice(WORDS[:4]))
        anchors = "".join(
            f'<a href="/p{rng.randrange(n_pages)}">{rng.choice(WORDS)}</a>'
            for _ in range(rng.randint(0, 3))
        )
        html = (
            f"<html><head><title>{rng.choice(WORDS)} {rng.choice(WORDS)}</title>"
            f'<meta name="description" content="{rng.choice(WORDS)} page">'
            f"</head><body><p>{' '.join(body)}</p>{anchors}</body></html>"
        )
        index_page(db, html.encode(), f"http://mixed.local/p{i}", last_modified=ts)
    update_term_weights(db, "title")
    update_term_weights(db, "body")
    return db


def _queries(rng: random.Random, n: int) -> list[str]:
    out = []
    for i in range(n):
        kws = " ".join(rng.choice(WORDS) for _ in range(rng.randint(0, 3)))
        q = kws
        if i % 3 != 2:
            plen = rng.randint(1, 5)
            ph = " ".join(rng.choice(WORDS[:6]) for _ in range(plen))
            q = f'"{ph}" {kws}'
        out.append(q or "alpha")
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_lane_matches_legacy_engine(seed):
    db = _build_corpus(seed)
    eng_fused = QueryEngine(db)
    assert eng_fused.index.pos_dense, "posT should build for a small corpus"
    assert eng_fused.model.supports_mixed(eng_fused.index)

    eng_legacy = QueryEngine(db)
    eng_legacy.index.title.posT = None  # forces the two-phase lane
    assert not eng_legacy.model.supports_mixed(eng_legacy.index)

    rng = random.Random(seed + 77)
    queries = _queries(rng, 24)
    parsed = [parse_query(q) for q in queries]
    parsed = [p for p in parsed if not p.is_empty]

    sf, if_ = eng_fused.rank(parsed)
    sl, il = eng_legacy.rank(parsed)

    for row in range(len(parsed)):
        got = {
            int(d): float(s)
            for s, d in zip(sf[row], if_[row])
            if s != -np.inf and not np.isnan(s)
        }
        want = {
            int(d): float(s)
            for s, d in zip(sl[row], il[row])
            if s != -np.inf and not np.isnan(s)
        }
        assert set(got) == set(want), (row, queries[row])
        for doc in want:
            np.testing.assert_allclose(got[doc], want[doc], rtol=1e-5)


def test_fused_lane_single_batch_mixed_rows():
    """One batch mixing keyword-only rows, 1-term phrases, and long
    phrases exercises the row sort + pn dispatch."""
    db = _build_corpus(3)
    eng = QueryEngine(db)
    eng2 = QueryEngine(db)
    eng2.index.body.posT = None
    qs = [
        "alpha bravo", '"alpha"', '"alpha bravo" charlie',
        '"charlie delta alpha bravo echo" golf', "echo",
        '"bravo alpha"', "nonexistentword", '"alpha alpha"',
    ]
    parsed = [parse_query(q) for q in qs]
    sf, if_ = eng.rank(parsed)
    sl, il = eng2.rank(parsed)
    for row in range(len(parsed)):
        got = {int(d): float(s) for s, d in zip(sf[row], if_[row]) if np.isfinite(s)}
        want = {int(d): float(s) for s, d in zip(sl[row], il[row]) if np.isfinite(s)}
        assert set(got) == set(want), (row, qs[row])
        for doc in want:
            np.testing.assert_allclose(got[doc], want[doc], rtol=1e-5)


def test_build_posT_dedupes_and_windows():
    """posT keeps every UNIQUE position even when raw lists exceed the
    unique count (duplicate -100 anchors must not evict later positions)."""
    from spaghettisearch_tpu.index.snapshot import SectionCSR
    from spaghettisearch_tpu.ops.kernels.mixed import POS_BIG

    # one word, one doc, positions [-100,-100,-100, 4, 9] -> unique 3
    post_offsets = np.array([0, 1], np.int32)
    doc_ids = np.array([0] + [1] * 127, np.int32)
    weights = np.zeros(128, np.float32)
    weights[0] = 1.0
    pos_offsets = np.zeros(129, np.int32)
    pos_offsets[1:] = 5
    positions = np.full(128, np.inf, np.float32)
    positions[:5] = [-100, -100, -100, 4, 9]
    csr = SectionCSR(
        post_offsets=post_offsets, doc_ids=doc_ids, weights=weights,
        pos_offsets=pos_offsets, positions=positions,
        n_postings=1, max_df=1, max_positions=5,
    )
    ft, fw, fj = csr.forward_with_postings(1)
    built = _build_posT(csr, np.concatenate([fj, np.full((511, fj.shape[1]), 127, np.int32)]), 512, POS_BIG)
    assert built is not None
    posT, c = built
    assert c == 3
    t = fj.shape[1]
    got = sorted(posT[0 * t, 0:1].tolist() + posT[1 * t, 0:1].tolist() + posT[2 * t, 0:1].tolist())
    assert got == [-100.0, 4.0, 9.0]


def test_posT_int16_roundtrip_and_engine_equality():
    """int16 posT planes (device_index.POS_T_INT16, mixed.quantize_posT)
    must dequantize to the exact f32 planes — engine results identical
    bit-for-bit, and out-of-range corpora must refuse quantization."""
    from spaghettisearch_tpu.ops.kernels.mixed import (
        POS16_PAD, POS_BIG, _deq_posT, quantize_posT,
    )
    from spaghettisearch_tpu.retrieval import device_index as di

    # unit: roundtrip every value class through encode -> kernel dequant
    plane = np.array(
        [[-100.0, 0.0, 7.0, 31999.0, POS_BIG], [POS_BIG] * 5], np.float32
    )
    q16 = quantize_posT(plane)
    assert q16 is not None and q16.dtype == np.int16
    assert q16[0, 4] == POS16_PAD
    back = np.asarray(_deq_posT(jnp.asarray(q16)))
    np.testing.assert_array_equal(back, plane)
    # refusal: a real position beyond POS16_MAX keeps the f32 plane
    assert quantize_posT(np.array([[40000.0]], np.float32)) is None

    # engine-level: identical results with quantization on vs off
    db = _build_corpus(5)
    assert di.POS_T_INT16, "int16 planes should be the default"
    eng16 = QueryEngine(db)
    assert eng16.index.body.posT.dtype == jnp.int16
    old = di.POS_T_INT16
    di.POS_T_INT16 = False
    try:
        eng32 = QueryEngine(db)
    finally:
        di.POS_T_INT16 = old
    assert eng32.index.body.posT.dtype == jnp.float32
    rng = random.Random(123)
    parsed = [p for p in (parse_query(q) for q in _queries(rng, 24)) if not p.is_empty]
    s16, i16 = eng16.rank(parsed)
    s32, i32 = eng32.rank(parsed)
    np.testing.assert_array_equal(np.asarray(s16), np.asarray(s32))
    np.testing.assert_array_equal(np.asarray(i16), np.asarray(i32))
