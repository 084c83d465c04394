"""The flagship ranking model: PageRank-blended vector-space cosine.

The reference hard-codes the model as scattered constants (blend weights at
get_metadata.go:69, damping at start_crawl.go:175, top-50 at
main_retrieve.go:99); here it is a first-class configurable model object
whose defaults reproduce the reference exactly. The engine delegates device
scoring to the model, so alternative model families (different blends,
personalization vectors, per-section weighting) are drop-in.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..config import (
    MAX_RESULTS,
    PAGERANK_CONVERGENCE,
    PAGERANK_DAMPING,
    SCORE_SCALE,
    W_BODY,
    W_PAGERANK,
    W_TITLE,
)
from ..ops import scoring as _scoring


@dataclass(frozen=True)
class BlendedRanker:
    """FinalRank = (w_pagerank*sqd + w_title*title + w_body*body) * scale,
    cosine-normalized per section, candidates only."""

    w_pagerank: float = W_PAGERANK
    w_title: float = W_TITLE
    w_body: float = W_BODY
    scale: float = SCORE_SCALE
    topk: int = MAX_RESULTS
    damping: float = PAGERANK_DAMPING
    convergence: float = PAGERANK_CONVERGENCE

    def finalize(self, ts, tc, bs, bc, mag_t, mag_b, pagerank, qlen, topic_probs):
        qmag = jnp.sqrt(qlen)[:, None]
        tn = ts / (mag_t[None, :] * qmag)
        bn = bs / (mag_b[None, :] * qmag)
        tn = jnp.where(jnp.isnan(tn), 0.0, tn)
        bn = jnp.where(jnp.isnan(bn), 0.0, bn)
        sqd = _scoring.topic_dot(topic_probs, pagerank)
        final = (self.w_pagerank * sqd + self.w_title * tn + self.w_body * bn) * self.scale
        return jnp.where(tc + bc > 0, final, -jnp.inf)

    def is_reference_blend(self) -> bool:
        return (
            self.w_pagerank == W_PAGERANK
            and self.w_title == W_TITLE
            and self.w_body == W_BODY
            and self.scale == SCORE_SCALE
        )

    def supports_hot(self, index) -> bool:
        """True when the hot-term dense body-weight cache can serve this
        (index, model): the cache exists (DeviceIndex gates it on zero
        weights / truncation) and the blend is the reference formula."""
        return index.hot_body_w is not None and self.is_reference_blend()

    def _hot_args(self, index, term_ids, qn, qnb, hot_sids):
        """Normalize the hot-split arguments so every caller (live rank,
        warmup, settle) compiles the SAME program signature: when the index
        carries the hot cache, missing qnb/hot_sids default to the no-split
        values (qnb=qn or full width, hot_sids all -1)."""
        if not self.supports_hot(index):
            return None, None, None
        b, q = term_ids.shape
        if qnb is None:
            qnb = qn if qn is not None else jnp.full((b,), q, jnp.int32)
        if hot_sids is None:
            hot_sids = jnp.full((b, q), -1, jnp.int32)
        return qnb, hot_sids, index.hot_body_w

    def score_keywords(
        self, index, term_ids, qlen, topic_probs, topk=None, qn=None,
        qnb=None, hot_sids=None,
    ):
        """Keyword batch -> (scores [B,K], doc ids [B,K]) on device. qn is
        the per-row active term count (batch sorted descending by it): the
        kernel skips compare sweeps past each row block's max."""
        k = min(topk or self.topk, index.n_docs) or 1
        if self.is_reference_blend():
            qnb, hot_sids, hot_w = self._hot_args(index, term_ids, qn, qnb, hot_sids)
            return _scoring.score_queries_forward(
                index.title.fwd, index.body.fwd,
                index.mag_title, index.mag_body, index.pagerank,
                term_ids, qlen, topic_probs, qn, qnb, hot_sids, hot_w,
                index.body.tmax_blocks, index.doc_perm, topk=k,
                use_kernel=_scoring.use_gpu_kernel(),
                emit_counts=index.has_zero_weight,
            )
        return self._custom_forward(index, term_ids, qlen, topic_probs, k)

    def score_with_phrase(
        self, index, term_ids, qlen, topic_probs,
        ph_docs, ph_tw, ph_bw, ph_fl, topk=None, qn=None,
        qnb=None, hot_sids=None,
    ):
        k = min(topk or self.topk, index.n_docs) or 1
        if self.is_reference_blend():
            qnb, hot_sids, hot_w = self._hot_args(index, term_ids, qn, qnb, hot_sids)
            return _scoring.score_queries_forward_phrase(
                index.title.fwd, index.body.fwd,
                index.mag_title, index.mag_body, index.pagerank,
                term_ids, qlen, topic_probs,
                ph_docs, ph_tw, ph_bw, ph_fl, qn, qnb, hot_sids, hot_w,
                index.body.tmax_blocks, index.doc_perm, topk=k,
                use_kernel=_scoring.use_gpu_kernel(),
                emit_counts=index.has_zero_weight,
            )
        return self._custom_forward(
            index, term_ids, qlen, topic_probs, k, (ph_docs, ph_tw, ph_bw, ph_fl)
        )

    def supports_mixed(self, index) -> bool:
        """True when the fused mixed lane can serve this (index, model):
        the index carries the doc-major position layout and the blend is
        the reference formula (custom blends keep the two-phase lane)."""
        return index.pos_dense and not index.dense_truncated and self.is_reference_blend()

    def score_mixed(
        self, index, term_ids, qlen, topic_probs,
        ph_ids, ph_valid, topk=None, qn=None, pn=None,
        qnb=None, hot_sids=None,
    ):
        """Mixed keyword+phrase lane: ONE device program per mixed batch
        (dense phrase matching, ops/kernels/mixed.py)."""
        k = min(topk or self.topk, index.n_docs) or 1
        qnb, hot_sids, hot_w = self._hot_args(index, term_ids, qn, qnb, hot_sids)
        return _scoring.score_queries_mixed(
            index.title.fwd, index.body.fwd,
            index.title.posT, index.body.posT,
            index.mag_title, index.mag_body, index.pagerank,
            term_ids, qlen, topic_probs, ph_ids, ph_valid, qn, pn,
            qnb, hot_sids, hot_w, index.doc_perm, index.body.tmax_blocks,
            topk=k,
            use_kernel=_scoring.use_gpu_kernel(),
            emit_counts=index.has_zero_weight,
        )

    def score_csr(
        self, index, term_ids, qlen, topic_probs,
        ph_docs=None, ph_tw=None, ph_bw=None, ph_fl=None, topk=None,
    ):
        """Exact CSR gather/scatter scoring (with optional phrase fold).

        Production route whenever the dense forward view was truncated
        (index.dense_truncated): the CSR holds every posting, so scores and
        candidacy for pathological >doc_term_cap documents stay exact."""
        k = min(topk or self.topk, index.n_docs) or 1
        b = term_ids.shape[0]
        if ph_docs is None:
            e = 8
            ph_docs = jnp.full((b, e), index.match_pad, jnp.int32)
            ph_tw = jnp.zeros((b, e), jnp.float32)
            ph_bw = jnp.zeros((b, e), jnp.float32)
            ph_fl = jnp.zeros((b, e), jnp.float32)
        blend = None
        if not self.is_reference_blend():
            blend = jnp.array(
                [self.w_pagerank, self.w_title, self.w_body, self.scale], jnp.float32
            )
        # doc-sorted layout: the device doc_ids live in permuted space over
        # [0, d_pad), so the scatter bound is match_pad and ids map back
        return _scoring.score_queries(
            index.title.offsets, index.title.doc_ids, index.title.weights,
            index.body.offsets, index.body.doc_ids, index.body.weights,
            index.mag_title, index.mag_body, index.pagerank,
            term_ids, qlen, topic_probs,
            ph_docs, ph_tw, ph_bw, ph_fl, blend, index.doc_perm,
            posting_cap=index.posting_cap, topk=k, n_docs=index.match_pad,
        )

    def _custom_forward(self, index, term_ids, qlen, topic_probs, k, phrase=None):
        weights = jnp.array(
            [self.w_pagerank, self.w_title, self.w_body, self.scale], jnp.float32
        )
        if phrase is None:
            b = term_ids.shape[0]
            e = 8
            phrase = (
                jnp.full((b, e), index.n_docs_padded, jnp.int32),
                jnp.zeros((b, e), jnp.float32),
                jnp.zeros((b, e), jnp.float32),
                jnp.zeros((b, e), jnp.float32),
            )
        return _custom_score(
            index.title.ft, index.title.fw, index.body.ft, index.body.fw,
            index.mag_title, index.mag_body, index.pagerank,
            weights, term_ids, qlen, topic_probs, *phrase, index.doc_perm,
            topk=k,
        )


from functools import partial  # noqa: E402


@partial(jax.jit, static_argnames=("topk",))
def _custom_score(
    title_ft, title_fw, body_ft, body_fw,
    mag_t, mag_b, pagerank,
    weights,  # f32 [4]: w_pagerank, w_title, w_body, scale
    term_ids, qlen, topic_probs,
    ph_docs, ph_tw, ph_bw, ph_fl,
    doc_map=None,
    *,
    topk: int,
):
    n_docs = title_ft.shape[0]
    b = term_ids.shape[0]
    ts, tc = _scoring.forward_section_scores(title_ft, title_fw, term_ids)
    bs, bc = _scoring.forward_section_scores(body_ft, body_fw, term_ids)
    brow = jnp.arange(b)[:, None]
    pacc = jnp.zeros((b, n_docs + 1, 3), ts.dtype)
    pacc = pacc.at[brow, ph_docs].add(
        jnp.stack([ph_tw, ph_bw, ph_fl], axis=-1), mode="drop"
    )
    ts = ts + pacc[:, :n_docs, 0]
    bs = bs + pacc[:, :n_docs, 1]
    tc = tc + pacc[:, :n_docs, 2]

    qmag = jnp.sqrt(qlen)[:, None]
    tn = ts / (mag_t[None, :] * qmag)
    bn = bs / (mag_b[None, :] * qmag)
    tn = jnp.where(jnp.isnan(tn), 0.0, tn)
    bn = jnp.where(jnp.isnan(bn), 0.0, bn)
    sqd = _scoring.topic_dot(topic_probs, pagerank)
    final = (weights[0] * sqd + weights[1] * tn + weights[2] * bn) * weights[3]
    final = jnp.where(tc + bc > 0, final, -jnp.inf)
    return _scoring.exact_top_k(final, topk, doc_map=doc_map)
