"""The GPU route: the Triton keyword kernel (interpret mode here) against
the XLA formulation, the kernel's lowering for CUDA, the index-select phrase
stage, full-precision scoring products, route choice by backend, device
memory budgets, and the compile cache location."""

from __future__ import annotations

import functools
import os
import random
import re
import subprocess
import sys
import threading
from datetime import datetime, timezone

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spaghettisearch_tpu.ops import scoring
from spaghettisearch_tpu.ops.kernels import membership
from spaghettisearch_tpu.ops.kernels.membership import keyword_scores_2sec
from spaghettisearch_tpu.ops.scoring import forward_section_scores, mask_cold
from spaghettisearch_tpu.retrieval import device_index as di

N_VOCAB = 300
SENTINEL = N_VOCAB  # never stored in a forward row


def _section(rng, d, t, nt=None):
    """Transposed forward section [T, D]: each doc holds nt[d] distinct
    terms (one slot per term), -1 / 0.0 pads."""
    if nt is None:
        nt = rng.integers(0, t + 1, d)
    ftT = np.full((t, d), -1, np.int32)
    fwT = np.zeros((t, d), np.float32)
    for doc in range(d):
        k = int(nt[doc])
        ftT[:k, doc] = rng.choice(N_VOCAB, k, replace=False)
        fwT[:k, doc] = rng.random(k).astype(np.float32) + 0.01
    return ftT, fwT


def _queries(rng, ftT, qn):
    """Term tiles whose active slots draw from terms the index holds."""
    present = np.unique(ftT[ftT >= 0])
    tids = np.full((len(qn), 4), SENTINEL, np.int32)
    for i, n in enumerate(qn):
        tids[i, :n] = rng.choice(present, int(n))
    return tids


def _xla(title, body, tids, qnb=None):
    ts, tc = forward_section_scores(title[0].T, title[1].T, jnp.asarray(tids))
    body_t = mask_cold(jnp.asarray(tids), None if qnb is None else jnp.asarray(qnb))
    bs, bc = forward_section_scores(body[0].T, body[1].T, body_t)
    return [np.asarray(x) for x in (ts, tc, bs, bc)]


def _kernel(title, body, tids, qn=None, **kw):
    out = keyword_scores_2sec(
        *map(jnp.asarray, (*title, *body)), jnp.asarray(tids),
        None if qn is None else jnp.asarray(qn), interpret=True, **kw,
    )
    return [None if x is None else np.asarray(x) for x in out]


QN_PATTERNS = {
    "sorted": [4, 4, 3, 3, 3, 2, 2, 2, 2, 1, 1, 1, 1, 1, 0, 0] * 2,
    "full": [4] * 32,
    "unbounded": None,  # qn omitted: every slot swept
}


@pytest.mark.parametrize("emit_counts", [True, False])
@pytest.mark.parametrize("pattern", sorted(QN_PATTERNS))
def test_keyword_kernel_matches_xla(pattern, emit_counts):
    """Row-block qn bounds and count elision against the XLA sweep."""
    rng = np.random.default_rng(3)
    title = _section(rng, 512, 8)
    body = _section(rng, 512, 24)
    qn = QN_PATTERNS[pattern]
    n = np.array(qn if qn is not None else [4] * 32)
    tids = _queries(rng, body[0], n)
    want = _xla(title, body, tids)
    got = _kernel(title, body, tids, qn, emit_counts=emit_counts)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    if emit_counts:
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[3], want[3])
    else:
        assert got[1] is None and got[3] is None
        # all weights > 0: candidacy by score equals candidacy by count
        np.testing.assert_array_equal(
            got[0] + got[2] > 0, want[1] + want[3] > 0
        )


def test_keyword_kernel_qnb_split():
    """Hot split: the title sweeps every active slot, the body only the
    cold slots [0, qnb)."""
    rng = np.random.default_rng(5)
    title = _section(rng, 512, 8)
    body = _section(rng, 512, 24)
    qn = np.array([4, 4, 3, 3, 2, 2, 1, 1] * 2)
    qnb = np.array([3, 1, 3, 0, 2, 1, 1, 0] * 2)
    order = np.lexsort((-qn, -qnb))
    qn, qnb = qn[order], qnb[order]
    tids = _queries(rng, body[0], qn)
    want = _xla(title, body, tids, qnb)
    got = _kernel(title, body, tids, qn, qnb=jnp.asarray(qnb))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6)


@pytest.mark.parametrize("emit_counts", [True, False])
def test_keyword_kernel_tmax_bound_matches_static(emit_counts):
    """Doc-sorted layout: the per-block body T bound gives the same sums as
    the full static sweep, and it really bounds the loop."""
    rng = np.random.default_rng(11)
    d, tb, blk = 1024, 32, 256
    nt = np.sort(rng.integers(0, tb + 1, d))[::-1]
    title = _section(rng, d, 8)
    body = _section(rng, d, tb, nt)
    tmax = nt.reshape(-1, blk).max(axis=1).astype(np.int32)
    qn = np.array([4, 3, 2, 2, 1, 1, 1, 0] * 2)
    tids = _queries(rng, body[0], qn)
    kw = dict(emit_counts=emit_counts, tmax_block=blk)
    static = _kernel(title, body, tids, qn, **kw)
    bounded = _kernel(title, body, tids, qn, body_tmax=jnp.asarray(tmax), **kw)
    for s, b in zip(static, bounded):
        if s is not None:
            np.testing.assert_array_equal(b, s)
    zero = _kernel(title, body, tids, qn,
                   body_tmax=jnp.zeros_like(jnp.asarray(tmax)), **kw)
    assert not zero[2].any() and static[2].any()


def test_keyword_kernel_pads_ragged_batch_and_docs():
    """A batch, a slot count and a doc count that are not tile multiples."""
    rng = np.random.default_rng(7)
    title = _section(rng, 1000, 5)
    body = _section(rng, 1000, 19)
    qn = np.array([3, 3, 2, 2, 2, 1, 1, 1, 1, 1, 0, 0, 0])
    tids = _queries(rng, body[0], qn)[:, :3]
    want = _xla(title, body, tids)
    got = _kernel(title, body, tids, qn)
    assert got[0].shape == (13, 1000)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6)


def test_keyword_kernel_lowers_for_cuda():
    """The kernel lowers to a Triton call for CUDA (no GPU needed to lower;
    compiling it is chip_smoke.py's job)."""
    ft = jnp.asarray(np.full((8, 256), -1, np.int32))
    fw = jnp.zeros((8, 256), jnp.float32)
    tids = jnp.zeros((16, 4), jnp.int32)
    fn = jax.jit(functools.partial(keyword_scores_2sec, emit_counts=False))
    text = fn.trace(ft, fw, ft, fw, tids).lower(lowering_platforms=("cuda",)).as_text()
    assert "xla.gpu.triton" in text and "keyword_sweep" in text


# ---------------------------------------------------------------------- #
# the phrase stage
# ---------------------------------------------------------------------- #

FILLER = [f"zq{a}{b}" for a in "bcdfghjklm" for b in "bcdfghjklmnpqrtvwxz"]


@pytest.fixture(scope="module")
def long_doc_engine():
    """A corpus with one page of ~2,500 body tokens whose "alpha bravo"
    sits past token 2048, plus short pages holding alpha and bravo apart."""
    from spaghettisearch_tpu.index.indexer import index_page
    from spaghettisearch_tpu.ops.weighting import update_term_weights
    from spaghettisearch_tpu.retrieval.engine import QueryEngine
    from spaghettisearch_tpu.store.tables import Database

    rng = random.Random(4)
    db = Database(None)
    ts = datetime(2026, 1, 1, tzinfo=timezone.utc)
    long_body = [rng.choice(FILLER) for _ in range(2400)]
    long_body += ["alpha", "bravo", "charlie"] + [rng.choice(FILLER) for _ in range(100)]
    pages = [" ".join(long_body)]
    for i in range(11):  # alpha and bravo apart, on some pages only
        words = [rng.choice(FILLER) for _ in range(30)]
        if i % 2:
            words.insert(rng.randrange(30), "alpha")
            words.insert(rng.randrange(30), "bravo")
        pages.append(" ".join(words))
    for i, body in enumerate(pages):
        html = (f"<html><head><title>page {FILLER[i]}</title></head>"
                f"<body><p>{body}</p></body></html>")
        index_page(db, html.encode(), f"http://long.local/p{i}", last_modified=ts)
    update_term_weights(db, "title", total_docs=len(pages))
    update_term_weights(db, "body", total_docs=len(pages))
    eng = QueryEngine(db)
    assert eng.index.pos_dense
    return eng


def _one_hot_phrase(tftT, tfwT, bftT, bfwT, tposT, bposT, ph_ids, ph_valid):
    """The select-by-one-hot-contraction formulation, in float64 numpy."""
    from spaghettisearch_tpu.ops.kernels.mixed import POS_REAL_MAX, _deq_posT

    def term(ftT, fwT, posT, pid):
        t = ftT.shape[0]
        eq = (ftT[None] == pid[:, None, None]).astype(np.float64)  # [B, T, D]
        pos = np.asarray(_deq_posT(jnp.asarray(posT)), np.float64)
        pos = pos.reshape(-1, t, ftT.shape[1])  # [C, T, D]
        return (eq.sum(1) > 0, np.einsum("btd,td->bd", eq, fwT),
                np.einsum("btd,ctd->cbd", eq, pos))

    valid = ph_valid > 0
    b, d = ph_ids.shape[0], tftT.shape[1]
    present = np.ones((b, d), bool)
    t_all, b_all = present.copy(), present.copy()
    sum_tw, sum_bw = np.zeros((b, d)), np.zeros((b, d))
    for p in range(ph_ids.shape[1]):
        v = valid[:, p][:, None]
        tf, tw, tsel = term(tftT, tfwT, tposT, ph_ids[:, p])
        bf, bw, bsel = term(bftT, bfwT, bposT, ph_ids[:, p])
        tf, bf = tf | ~v, bf | ~v
        present &= tf | bf
        t_all &= tf
        b_all &= bf
        sum_tw += np.where(v, tw, 0.0)
        sum_bw += np.where(v, bw, 0.0)
        if p == 0:
            anchor_t, anchor_b = tsel, bsel
            hit_t, hit_b = anchor_t < POS_REAL_MAX, anchor_b < POS_REAL_MAX
        else:
            hit_t &= (tsel[None] == anchor_t[:, None] + p).any(1) | ~v[None]
            hit_b &= (bsel[None] == anchor_b[:, None] + p).any(1) | ~v[None]
    hp = valid[:, :1]
    t_ok = present & t_all & hit_t.any(0) & hp
    b_ok = present & b_all & hit_b.any(0) & hp
    return (np.where(t_ok, sum_tw, 0.0), np.where(b_ok, sum_bw, 0.0),
            (t_ok | b_ok).astype(np.float64))


def test_forward_rows_hold_each_term_once(long_doc_engine):
    """The invariant the phrase stage's index select rests on: a term
    occupies at most one slot of a doc's forward row (one posting per
    (term, doc)), in both sections and both layouts."""
    for sec in (long_doc_engine.index.title, long_doc_engine.index.body):
        for ft in (np.asarray(sec.fwd.ft), np.asarray(sec.fwd.ftT).T):
            for row in ft:
                real = row[row >= 0]
                assert len(np.unique(real)) == len(real)


def test_phrase_stage_index_select_matches_one_hot(long_doc_engine):
    """The index-select phrase stage against the one-hot contraction it
    replaced, on phrases whose positions lie above 2048."""
    from spaghettisearch_tpu.ops.kernels.mixed import phrase_scores
    from spaghettisearch_tpu.retrieval.engine import parse_query

    eng = long_doc_engine
    idx, snap = eng.index, eng.snapshot
    tid = {h: i for i, h in enumerate(snap.word_hashes)}
    rows = [parse_query(q).phrase_hashes for q in (
        '"alpha bravo"', '"bravo charlie"', '"alpha bravo charlie"',
        '"bravo alpha"', '"alpha"', '"charlie alpha"')]
    rows += [[]]  # a keyword-only row
    p = 4
    ph_ids = np.full((len(rows), p), snap.n_words, np.int32)
    ph_valid = np.zeros((len(rows), p), np.float32)
    for i, hs in enumerate(rows):
        ph_ids[i, : len(hs)] = [tid[h] for h in hs]
        ph_valid[i, : len(hs)] = 1.0
    t, b = idx.title.fwd, idx.body.fwd
    got = phrase_scores(t.ftT, t.fwT, b.ftT, b.fwT, idx.title.posT,
                        idx.body.posT, jnp.asarray(ph_ids), jnp.asarray(ph_valid))
    want = _one_hot_phrase(*(np.asarray(x) for x in (
        t.ftT, t.fwT, b.ftT, b.fwT, idx.title.posT, idx.body.posT)),
        ph_ids, ph_valid)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), w, rtol=1e-6, atol=1e-7)
    flag = np.asarray(got[2])
    assert flag[0].sum() == 1 and flag[2].sum() == 1  # only the long page
    assert flag[3].sum() == 0  # never adjacent in that order
    assert flag[6].sum() == 0


def test_phrase_stage_matches_sparse_matcher_past_2048(long_doc_engine):
    """The mixed lane (dense phrase stage) against the two-phase lane
    (sparse match_phrase_fwd) and the reference oracle, for phrases that
    only match past token 2048."""
    from oracle import retrieve

    from spaghettisearch_tpu.retrieval.engine import QueryEngine, parse_query

    eng = long_doc_engine
    legacy = QueryEngine(eng.db, snapshot=eng.snapshot)
    legacy.index.title.posT = None  # forces the sparse two-phase lane
    assert eng.model.supports_mixed(eng.index)
    assert not legacy.model.supports_mixed(legacy.index)
    qs = ['"alpha bravo"', '"bravo charlie" alpha', '"alpha bravo charlie"',
          '"bravo alpha"']
    parsed = [parse_query(q) for q in qs]
    sf, i_f = eng.rank(parsed)
    sl, i_l = legacy.rank(parsed)
    for row, q in enumerate(qs):
        got = [(eng.snapshot.doc_hashes[int(d)], float(s))
               for s, d in zip(sf[row], i_f[row]) if np.isfinite(s)]
        two = [(eng.snapshot.doc_hashes[int(d)], float(s))
               for s, d in zip(sl[row], i_l[row]) if np.isfinite(s)]
        want = retrieve(eng.db, q)
        assert [d for d, _ in got] == [d for d, _ in two] == [d for d, _ in want], q
        for (_, a), (_, b), (_, c) in zip(got, two, want):
            assert a == pytest.approx(c, rel=1e-5) and b == pytest.approx(c, rel=1e-5)
    assert len([s for s in sf[0] if np.isfinite(s)]) == 1


# ---------------------------------------------------------------------- #
# precision, routing, memory budgets, compile cache
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def hot_index():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from bench import synth_snapshot

    snap = synth_snapshot(n_docs=2_000, n_words=1_000, body_terms_per_doc=16,
                          title_terms_per_doc=4, max_df=256, seed=2)
    idx = di.DeviceIndex.from_snapshot(snap)
    assert idx.hot_body_w is not None and idx.pos_dense
    return snap, idx


def _program_args(snap, idx, name):
    b, q, p = 16, 4, 4
    rng = np.random.default_rng(0)
    tids = jnp.asarray(rng.integers(0, snap.n_words, (b, q)), jnp.int32)
    qlen = jnp.ones((b,), jnp.float32)
    tp = jnp.ones((b, idx.n_categories), jnp.float32) / 2
    qn = jnp.full((b,), q, jnp.int32)
    hot = dict(qnb=qn, hot_sids=jnp.zeros((b, q), jnp.int32), hot_w=idx.hot_body_w)
    t, bd = idx.title.fwd, idx.body.fwd
    fold = (jnp.full((b, 8), idx.n_docs, jnp.int32),) + (jnp.zeros((b, 8)),) * 3
    if name == "forward":
        return scoring.score_queries_forward, (
            t, bd, idx.mag_title, idx.mag_body, idx.pagerank, tids, qlen, tp, qn,
        ), dict(topk=10, **hot)
    if name == "forward_phrase":
        return scoring.score_queries_forward_phrase, (
            t, bd, idx.mag_title, idx.mag_body, idx.pagerank, tids, qlen, tp,
            *fold, qn,
        ), dict(topk=10, **hot)
    if name == "mixed":
        ph = jnp.asarray(rng.integers(0, snap.n_words, (b, p)), jnp.int32)
        return scoring.score_queries_mixed, (
            t, bd, idx.title.posT, idx.body.posT, idx.mag_title, idx.mag_body,
            idx.pagerank, tids, qlen, tp, ph, jnp.ones((b, p)), qn,
        ), dict(topk=10, **hot)
    if name == "csr":
        return scoring.score_queries, (
            idx.title.offsets, idx.title.doc_ids, idx.title.weights,
            idx.body.offsets, idx.body.doc_ids, idx.body.weights,
            idx.mag_title, idx.mag_body, idx.pagerank, tids, qlen, tp, *fold,
        ), dict(posting_cap=idx.posting_cap, topk=10, n_docs=idx.n_docs)
    from spaghettisearch_tpu.models.blended import _custom_score

    return _custom_score, (
        t.ft, t.fw, bd.ft, bd.fw, idx.mag_title, idx.mag_body, idx.pagerank,
        jnp.ones((4,), jnp.float32), tids, qlen, tp, *fold,
    ), dict(topk=10)


@pytest.mark.parametrize("name", ["forward", "forward_phrase", "mixed", "csr", "custom"])
def test_scoring_dots_lower_at_highest_precision(hot_index, name):
    """Every dot_general on the scoring path asks for full f32 precision:
    a GPU's default f32 product may run in TF32."""
    fn, args, kw = _program_args(*hot_index, name)
    text = fn.lower(*args, **kw).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert dots, "expected at least the topic product"
    for ln in dots:
        assert re.search(r"precision = \[HIGHEST, HIGHEST\]", ln), ln


@pytest.mark.parametrize("backend,want", [("gpu", True), ("cpu", False), ("rocm", None)])
def test_route_choice_by_backend(monkeypatch, backend, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if want is None:
        with pytest.raises(RuntimeError, match="expected gpu or cpu"):
            scoring.use_gpu_kernel()
    else:
        assert scoring.use_gpu_kernel() is want


def test_gpu_route_reaches_the_kernel(monkeypatch, hot_index):
    """On a gpu backend the engine's keyword program runs the kernel (here
    in interpret mode) and ranks exactly like the cpu route."""
    from spaghettisearch_tpu.retrieval.engine import ParsedQuery, QueryEngine

    snap, idx = hot_index
    snap.word_id.update({h: i for i, h in enumerate(snap.word_hashes)})
    eng = QueryEngine(None, snapshot=snap, index=idx)
    rng = np.random.default_rng(9)
    batch = [ParsedQuery(raw="", stripped="", phrases=[], phrase_hashes=[],
                         keyword_hashes=[snap.word_hashes[int(w)] for w in
                                         rng.integers(0, snap.n_words, 1 + i % 4)])
             for i in range(20)]
    want_s, want_i = eng.rank(batch)
    calls = []
    real = membership.keyword_scores_2sec

    def spy(*args, **kw):
        calls.append(kw.get("body_tmax") is not None)
        return real(*args, interpret=True, **kw)

    monkeypatch.setattr(membership, "keyword_scores_2sec", spy)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    got_s, got_i = eng.rank(batch)
    assert calls, "the gpu route did not reach the kernel"
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6)
    np.testing.assert_array_equal(got_i[np.isfinite(want_s)], want_i[np.isfinite(want_s)])


def test_xla_blocks_bound_the_temporaries():
    for b, d, w in ((128, 1_000_448, 48), (16, 100_352, 120), (4, 100, 8)):
        n = scoring.xla_n_blocks(b, d, w)
        db = -(-d // n)
        assert n * db >= d
        assert db == 1 or db * b * w * 4 <= scoring.XLA_BLOCK_BYTES
    rng = np.random.default_rng(1)
    ft = jnp.asarray(rng.integers(-1, 40, (333, 12)), jnp.int32)
    fw = jnp.asarray(rng.random((333, 12)), jnp.float32)
    tids = jnp.asarray(rng.integers(0, 40, (5, 4)), jnp.int32)
    auto = forward_section_scores(ft, fw, tids)
    for n in (1, 7):
        for a, e in zip(auto, forward_section_scores(ft, fw, tids, n_blocks=n)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(e), rtol=1e-6)


def test_memory_budget_follows_the_device(hot_index):
    """No limit reported (the CPU backend): no gates. A reported limit: the
    stated shares. Explicit budgets gate the resident structures."""
    assert di.MemoryBudget.for_device(jax.devices()[0]) == di.MemoryBudget()

    class Card:
        def memory_stats(self):
            return {"bytes_limit": 64 << 30}

    got = di.MemoryBudget.for_device(Card())
    assert got.pos_t_bytes == (64 << 30) // di.POS_T_SHARE
    assert got.hot_w_bytes == (64 << 30) // di.HOT_W_SHARE
    assert got.fwd_dev_bytes == (64 << 30) // di.FWD_DEV_SHARE

    snap, _ = hot_index
    tight = di.DeviceIndex.from_snapshot(
        snap, budget=di.MemoryBudget(pos_t_bytes=0, hot_w_bytes=0, fwd_dev_bytes=0))
    assert tight.title.posT is None and tight.hot_body_w is None
    # without posT the sparse lane serves, so the forward arrays upload
    assert not isinstance(tight.body.fwd.ft, np.ndarray)


def test_fwd_device_uploads_once(monkeypatch, hot_index):
    snap, _ = hot_index
    idx = di.DeviceIndex.from_snapshot(snap, budget=di.MemoryBudget(fwd_dev_bytes=0))
    sec = idx.body
    assert isinstance(sec.fwd.ft, np.ndarray)
    puts = []
    real_put = jax.device_put
    gate = threading.Barrier(8)

    def counting_put(x, *a, **kw):
        puts.append(x.shape)
        return real_put(x, *a, **kw)

    monkeypatch.setattr(jax, "device_put", counting_put)
    outs = []

    def worker():
        gate.wait()
        outs.append(sec.fwd_device())

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(puts) == 3  # ft, fw, fj once
    assert all(o is outs[0] for o in outs)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from spaghettisearch_tpu.utils import jaxcache

    updates = []
    monkeypatch.setattr(jax.config, "update", lambda *a: updates.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxcache.enable_persistent_cache() == str(tmp_path)
    assert updates == []


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    from spaghettisearch_tpu.utils import jaxcache

    updates = []
    monkeypatch.setattr(jax.config, "update", lambda *a: updates.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = jaxcache.enable_persistent_cache()
    assert path == os.path.join(repo, ".jax_cache") and os.path.isdir(path)
    assert ("jax_compilation_cache_dir", path) in updates


def test_server_and_indexer_import_without_lxml_or_aiohttp():
    code = (
        "import sys, spaghettisearch_tpu.cli.server, "
        "spaghettisearch_tpu.index.indexer\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('lxml', 'aiohttp'))\n"
        "assert not bad, bad\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", code], cwd=repo, env=env, check=True)
