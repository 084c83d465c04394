"""Hot-term dense body-weight cache (retrieval/device_index.py
_build_hot_cache + ops/scoring.py hot_body_scores): a query's hot terms are
removed from the body compare sweep (cold-first slot layout, qnb bound) and
contributed instead by a one-hot f32 matmul over the dense [H, D] rows. The
split must be score-equivalent to the full sweep on every path: engine
routing and the XLA formulations (tests/test_gpu_route.py covers the
keyword kernel's qnb split in interpret mode)."""

from __future__ import annotations

import sys

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, ".")

from spaghettisearch_tpu.models.blended import BlendedRanker
from spaghettisearch_tpu.retrieval.device_index import DeviceIndex
from spaghettisearch_tpu.retrieval.engine import ParsedQuery, QueryEngine


def _synth_snapshot(**kw):
    sys.path.insert(0, ".")
    from bench import synth_snapshot

    return synth_snapshot(**kw)


class _NoHot(BlendedRanker):
    def supports_hot(self, index) -> bool:
        return False


@pytest.fixture(scope="module")
def snap():
    # max_df << n_docs -> no df==N zero-weight terms -> hot cache active
    s = _synth_snapshot(
        n_docs=3_000, n_words=2_000, body_terms_per_doc=24,
        title_terms_per_doc=4, max_df=512, seed=5,
    )
    # synth snapshots ship an empty hash->id map (the benches feed term ids
    # directly); the engine path needs it
    s.word_id.update({h: i for i, h in enumerate(s.word_hashes)})
    return s


@pytest.fixture(scope="module")
def engines(snap):
    # cap H below the vocabulary so the hot/cold split is genuinely mixed
    from spaghettisearch_tpu.retrieval import device_index as di

    saved = di.HOT_H_MAX
    di.HOT_H_MAX = 64
    try:
        hot = QueryEngine(None, snapshot=snap)
        cold = QueryEngine(None, snapshot=snap, model=_NoHot())
    finally:
        di.HOT_H_MAX = saved
    assert hot.index.hot_body_map, "hot cache must be active on this corpus"
    assert len(hot.index.hot_body_map) == 64
    assert hot.index.hot_body_w is not None
    assert not hot.index.has_zero_weight
    return hot, cold


def _queries(snap, rng, n, phrase_every=0):
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
        out.append(
            ParsedQuery(
                raw="", stripped="", phrases=["p"] if phs else [],
                keyword_hashes=[snap.word_hashes[w] for w in wids],
                phrase_hashes=phs,
            )
        )
    return out


def _as_maps(scores, ids):
    scores, ids = np.asarray(scores), np.asarray(ids)
    return [
        {int(i): float(s) for s, i in zip(srow, irow) if np.isfinite(s)}
        for srow, irow in zip(scores, ids)
    ]


@pytest.mark.parametrize("phrase_every", [0, 4])
def test_engine_hot_split_matches_full_sweep(snap, engines, phrase_every):
    """The hot-routing engine must rank exactly like the full-sweep engine
    (same candidates, same scores to fp tolerance) for keyword-only and
    mixed batches."""
    hot, cold = engines
    rng = np.random.default_rng(17)
    batch = _queries(snap, rng, 24, phrase_every)
    hs, hi = hot.rank(batch, topk=30)
    cs, ci = cold.rank(batch, topk=30)
    for row, (hm, cm) in enumerate(zip(_as_maps(hs, hi), _as_maps(cs, ci))):
        assert hm.keys() == cm.keys(), row
        for d in hm:
            assert hm[d] == pytest.approx(cm[d], rel=1e-5, abs=1e-7), (row, d)


def test_engine_hot_rows_are_cold_first(snap, engines):
    hot, _ = engines
    hm = hot.index.hot_body_map
    df = np.diff(snap.body.post_offsets[: snap.n_words + 1])
    hot_wid = int(np.argsort(-df)[0])
    cold_wid = int(np.argsort(-df)[1_200])
    assert hot_wid in hm and cold_wid not in hm, "H cap must leave cold terms"
    p = ParsedQuery(
        raw="", stripped="", phrases=[],
        keyword_hashes=[snap.word_hashes[hot_wid], snap.word_hashes[cold_wid]],
        phrase_hashes=[],
    )
    tids, qlen, qn, qnb, sids = hot._fill_keyword_rows([p], 1, 4, snap, hm)
    assert qn[0] == 2 and qnb[0] == 1
    assert tids[0, 0] == cold_wid and tids[0, 1] == hot_wid
    assert sids[0, 0] == hm[hot_wid] and sids[0, 1] == -1


def test_hot_cache_disabled_on_zero_weight_index():
    from corpus import build_corpus_db

    eng = QueryEngine(build_corpus_db(n_pages=25, seed=9))
    if eng.index.has_zero_weight:
        assert eng.index.hot_body_w is None
        assert eng.index.hot_body_map is None
