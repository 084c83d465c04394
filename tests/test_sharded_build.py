"""_shard_csr cross-implementation property test.

The production builder (parallel/sharded.py) splits per shard with
vectorized-numpy passes. This file keeps a structurally INDEPENDENT
implementation — one global stable argsort to (shard, word)-major order —
as an equality oracle over randomized CSRs.

On the host, at 1M docs / 48M postings, the global-argsort variant was
about 5x slower than the per-shard linear scans, so the per-shard builder
stays the production path and this variant lives here as the oracle.
"""

import numpy as np
import pytest

from spaghettisearch_tpu.index.snapshot import SectionCSR, _pad_to
from spaghettisearch_tpu.parallel.sharded import (
    DOC_TERM_CAP,
    _repeat_blocks,
    _shard_csr,
)

# patched by the truncation test
_CAP = None


def _cap():
    return DOC_TERM_CAP if _CAP is None else _CAP


def _shard_csr_vectorized(csr, n_shards, docs_per_shard, t_pad):
    """Alternative implementation: one stable argsort re-orders the postings
    from word-major to (shard, word)-major (postings inside a word's window
    are doc-ascending, so within (shard, word) they stay doc-ascending), and
    all per-shard offsets/slots fall out of bincounts over the combined key."""
    n_words = csr.post_offsets.shape[0] - 1
    n_post = csr.n_postings
    word_of_post = np.repeat(
        np.arange(n_words, dtype=np.int64), np.diff(csr.post_offsets)
    )
    doc = csr.doc_ids[:n_post].astype(np.int64)
    shard_of_post = doc // docs_per_shard

    key = shard_of_post * n_words + word_of_post
    order_sw = np.argsort(key, kind="stable")

    counts = np.bincount(key, minlength=n_shards * n_words).reshape(
        n_shards, n_words
    )
    offsets_sw = np.zeros((n_shards, n_words + 1), np.int64)
    np.cumsum(counts, axis=1, out=offsets_sw[:, 1:])
    per_shard = offsets_sw[:, -1]
    max_local = int(per_shard.max(initial=0))
    post_width = -(-(max_local + 1) // 128) * 128

    sorted_shard = shard_of_post[order_sw]
    local_slot = np.arange(n_post, dtype=np.int64) - np.repeat(
        np.concatenate([[0], np.cumsum(per_shard)])[:-1], per_shard
    )
    doc_ids = np.full((n_shards, post_width), docs_per_shard, np.int32)
    weights = np.zeros((n_shards, post_width), np.float32)
    doc_ids[sorted_shard, local_slot] = (
        doc[order_sw] - sorted_shard * docs_per_shard
    ).astype(np.int32)
    weights[sorted_shard, local_slot] = csr.weights[order_sw]

    starts = csr.pos_offsets[order_sw]
    lens = (csr.pos_offsets[order_sw + 1] - starts).astype(np.int64)
    pos_lens = np.zeros((n_shards, post_width), np.int64)
    pos_lens[sorted_shard, local_slot] = lens
    pos_offsets = np.zeros((n_shards, post_width + 1), np.int64)
    np.cumsum(pos_lens, axis=1, out=pos_offsets[:, 1:])
    max_pos = int(pos_offsets[:, -1].max(initial=0))
    pos_width = -(-(max_pos + 1) // 128) * 128
    positions = np.full((n_shards, pos_width), np.inf, np.float32)
    flat_dst = _repeat_blocks(
        sorted_shard * pos_width + pos_offsets[sorted_shard, local_slot], lens
    )
    positions.reshape(-1)[flat_dst] = csr.positions[_repeat_blocks(starts, lens)]

    off_width = -(-(n_words + 2) // 128) * 128
    offsets = np.zeros((n_shards, off_width), np.int32)
    offsets[:, : n_words + 1] = offsets_sw
    offsets[:, n_words + 1 :] = offsets_sw[:, -1:]

    cap = _cap()
    truncated = t_pad > cap
    t_keep = min(t_pad, cap)  # truncation bound (pre-rounding)
    # production rounds the array WIDTH up to the sweep-chunk multiple
    # (8 natural / DOC_SORT_TC doc-sorted) with sentinel-filled extra slots
    t_pad = -(-t_keep // 8) * 8
    ft = np.full((n_shards, docs_per_shard, t_pad), -1, np.int32)
    fw = np.zeros((n_shards, docs_per_shard, t_pad), np.float32)
    fj = np.full((n_shards, docs_per_shard, t_pad), post_width - 1, np.int32)
    if n_post:
        w_sorted = csr.weights[order_sw]
        keep = np.arange(n_post, dtype=np.int64)
        if truncated:
            rank_order = np.lexsort((-w_sorted, doc[order_sw]))
            docs_r = doc[order_sw][rank_order]
            off = np.concatenate(
                [[0],
                 np.cumsum(np.bincount(docs_r, minlength=n_shards * docs_per_shard))]
            )
            rank_in_doc = np.arange(n_post, dtype=np.int64) - off[docs_r]
            keep = rank_order[rank_in_doc < t_keep]
        dorder = keep[np.argsort(doc[order_sw][keep], kind="stable")]
        docs_g = doc[order_sw][dorder]
        row_off = np.zeros(n_shards * docs_per_shard + 1, np.int64)
        np.add.at(row_off, docs_g + 1, 1)
        row_off = np.cumsum(row_off)
        slot = np.arange(len(dorder), dtype=np.int64) - row_off[docs_g]
        s_idx = docs_g // docs_per_shard
        d_loc = docs_g - s_idx * docs_per_shard
        ft[s_idx, d_loc, slot] = word_of_post[order_sw][dorder].astype(np.int32)
        fw[s_idx, d_loc, slot] = w_sorted[dorder]
        fj[s_idx, d_loc, slot] = local_slot[dorder].astype(np.int32)

    return dict(
        offsets=offsets,
        doc_ids=doc_ids,
        weights=weights,
        pos_offsets=pos_offsets.astype(np.int32),
        positions=positions,
        ft=ft, fw=fw, fj=fj, truncated=truncated,
    )


def _random_csr(rng, n_docs, n_words, density, max_pos=4):
    pairs = set()
    n = int(n_docs * n_words * density)
    for _ in range(n):
        pairs.add((int(rng.integers(n_words)), int(rng.integers(n_docs))))
    pairs = sorted(pairs)
    words = np.array([w for w, _ in pairs], np.int64)
    docs = np.array([d for _, d in pairs], np.int32)
    n_post = len(pairs)
    counts = np.bincount(words, minlength=n_words)
    post_offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    plens = rng.integers(1, max_pos + 1, n_post)
    pos_offsets = np.zeros(_pad_to(n_post) + 1, np.int32)
    pos_offsets[1 : n_post + 1] = np.cumsum(plens)
    pos_offsets[n_post + 1 :] = pos_offsets[n_post]
    n_pos = int(pos_offsets[n_post])
    positions = np.full(_pad_to(n_pos), np.inf, np.float32)
    positions[:n_pos] = rng.integers(0, 100, n_pos).astype(np.float32)
    doc_ids = np.full(_pad_to(n_post), n_docs, np.int32)
    doc_ids[:n_post] = docs
    weights = np.zeros(_pad_to(n_post), np.float32)
    weights[:n_post] = rng.uniform(0.01, 2.0, n_post).astype(np.float32)
    return SectionCSR(
        post_offsets=post_offsets,
        doc_ids=doc_ids,
        weights=weights,
        pos_offsets=pos_offsets,
        positions=positions,
        n_postings=n_post,
        max_df=int(counts.max(initial=0)),
        max_positions=int(plens.max(initial=1)) if n_post else 1,
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_shard_build_matches_independent_impl(seed, n_shards):
    rng = np.random.default_rng(seed)
    n_docs, n_words = 173, 61
    csr = _random_csr(rng, n_docs, n_words, density=0.04)
    dl = -(-n_docs // n_shards)
    per_doc = np.bincount(csr.doc_ids[: csr.n_postings], minlength=n_docs)
    t_pad = max(int(per_doc.max(initial=0)), 1)
    got = _shard_csr(csr, n_shards, dl, t_pad)
    want = _shard_csr_vectorized(csr, n_shards, dl, t_pad)
    # the oracle covers the CSR + forward views; posT/pos_c (the mixed
    # kernel's position planes) are equivalence-tested against the
    # single-chip engine in test_sharded.py
    assert want.keys() <= got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_shard_build_truncated_matches_independent_impl(monkeypatch):
    """doc_term_cap truncation keeps per-doc top-weight terms identically."""
    import spaghettisearch_tpu.parallel.sharded as sh

    import test_sharded_build as me

    rng = np.random.default_rng(7)
    n_docs, n_words, n_shards = 31, 300, 2
    csr = _random_csr(rng, n_docs, n_words, density=0.5)
    per_doc = np.bincount(csr.doc_ids[: csr.n_postings], minlength=n_docs)
    t_pad = max(int(per_doc.max(initial=0)), 1)
    dl = -(-n_docs // n_shards)
    cap = 16
    assert t_pad > cap, "fixture must actually exceed the cap"
    monkeypatch.setattr(sh, "DOC_TERM_CAP", cap)
    monkeypatch.setattr(me, "_CAP", cap)
    got = _shard_csr(csr, n_shards, dl, t_pad)
    want = _shard_csr_vectorized(csr, n_shards, dl, t_pad)
    assert got["truncated"] and want["truncated"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_empty_csr_shards():
    csr = _random_csr(np.random.default_rng(0), 10, 5, density=0.0)
    out = _shard_csr(csr, 2, 5, 1)
    ref = _shard_csr_vectorized(csr, 2, 5, 1)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
