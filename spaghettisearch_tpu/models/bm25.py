"""BM25 ranking model — the second model family beyond the reference's
TF-IDF/PageRank blend (reference has only the blend, get_metadata.go:69).

Okapi BM25 maps perfectly onto the existing columnar index: the per-posting
term frequency is the position-list length already stored in the CSR
(indexer writes one position per occurrence, indexer.py `[normTF, pos...]`),
doc length is the per-doc tf sum, so the full BM25 weight

    idf = ln((N - df + 0.5) / (df + 0.5) + 1)
    w   = idf * tf*(k1+1) / (tf + k1*(1 - b + b*dl/avgdl))

is PRECOMPUTED per posting at prepare time. Scoring then reuses the exact
same forward-membership machinery as the blended model (dense compare +
weighted reduce; the Triton kernel on the GPU), and phrase matching reuses
match_phrase_fwd with the BM25 weight arrays swapped in — the matcher just
sums the weights of matched postings.

Sections combine as weighted field scores (BM25F-lite):
    final = title_boost * S_title + body_boost * S_body
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import jax
import jax.numpy as jnp
import numpy as np

from ..index.snapshot import IndexSnapshot, SectionCSR
from ..ops import scoring as _scoring


def bm25_posting_weights(
    csr: SectionCSR, n_docs: int, k1: float = 1.2, b: float = 0.75
) -> np.ndarray:
    """Per-posting BM25 weight array (padded slots stay 0)."""
    n_post = csr.n_postings
    p_pad = csr.doc_ids.shape[0]
    out = np.zeros(p_pad, np.float32)
    if n_post == 0 or n_docs == 0:
        return out
    tf = np.diff(csr.pos_offsets[: n_post + 1]).astype(np.float64)
    df = np.diff(csr.post_offsets).astype(np.float64)
    word_of_post = np.repeat(
        np.arange(df.shape[0], dtype=np.int64), np.diff(csr.post_offsets)
    )
    doc_len = np.zeros(n_docs + 1, np.float64)
    np.add.at(doc_len, csr.doc_ids[:n_post], tf)
    avgdl = max(doc_len[:n_docs].sum() / n_docs, 1e-9)
    idf = np.log((n_docs - df + 0.5) / (df + 0.5) + 1.0)
    dl = doc_len[csr.doc_ids[:n_post]]
    out[:n_post] = (
        idf[word_of_post] * tf * (k1 + 1.0) / (tf + k1 * (1.0 - b + b * dl / avgdl))
    ).astype(np.float32)
    return out


@jax.jit
def _bm25_finalize(ts, tc, bs, bc, title_boost, body_boost):
    final = title_boost * ts + body_boost * bs
    return jnp.where(tc + bc > 0, final, -jnp.inf)


@dataclass
class BM25Ranker:
    """Drop-in ranking model for QueryEngine(model=BM25Ranker()).

    PageRank/topic blending is intentionally absent: BM25 is the pure
    lexical alternative; use BlendedRanker for the reference formula."""

    k1: float = 1.2
    b: float = 0.75
    title_boost: float = 2.0
    body_boost: float = 1.0
    topk: int = 50
    _fwd: dict = field(default_factory=dict, repr=False)

    # -- engine hooks -------------------------------------------------- #
    def prepare(self, snapshot: IndexSnapshot, index, device=None) -> None:
        """Build BM25 forward weight arrays aligned with the DeviceIndex's
        ft layout (same snapshot => same doc/term slots; under the
        doc-sorted layout the index's doc permutation is applied so doc
        axes line up — BM25 keeps the static-T sweep)."""
        from ..retrieval.device_index import ForwardArrays

        put = lambda x: jax.device_put(x, device)  # noqa: E731
        self._fwd = {}
        for name in ("title", "body"):
            csr: SectionCSR = getattr(snapshot, name)
            w = bm25_posting_weights(csr, snapshot.n_docs, self.k1, self.b)
            bm_csr = replace(csr, weights=w)
            ft, fw, fj = bm_csr.forward_with_postings(snapshot.n_docs)
            sec = getattr(index, name)
            d_pad = sec.fwd.ft.shape[0]
            pad_rows = d_pad - snapshot.n_docs
            ft = np.concatenate([ft, np.full((pad_rows, ft.shape[1]), -1, np.int32)])
            fw = np.concatenate([fw, np.zeros((pad_rows, fw.shape[1]), np.float32)])
            fj = np.concatenate(
                [fj, np.full((pad_rows, fj.shape[1]), csr.doc_ids.shape[0] - 1, np.int32)]
            )
            if index.doc_perm_np is not None:
                ft, fw, fj = (
                    ft[index.doc_perm_np], fw[index.doc_perm_np],
                    fj[index.doc_perm_np],
                )
            self._fwd[name] = ForwardArrays(
                ft=put(ft), fw=put(fw), fj=put(fj),
                ftT=put(np.ascontiguousarray(ft.T)),
                fwT=put(np.ascontiguousarray(fw.T)),
            )
            # padded posting-weight vector for the phrase matcher
            self._fwd[name + "_w"] = put(w)

    def phrase_weights(self, index):
        """Posting-weight arrays the phrase matcher should sum (ft/fj are
        weight-independent, so the engine keeps using the index's)."""
        return self._fwd["title_w"], self._fwd["body_w"]

    # -- scoring ------------------------------------------------------- #
    def _sections(self, term_ids, qn=None):
        # BM25 weights are strictly positive (idf = ln(x+1) > 0, tf term
        # > 0), so count accumulation is always elidable
        return _scoring._both_section_scores(
            self._fwd["title"], self._fwd["body"], term_ids,
            _scoring.use_gpu_kernel(), qn, emit_counts=False,
        )

    def score_keywords(self, index, term_ids, qlen, topic_probs, topk=None, qn=None):
        k = min(topk or self.topk, index.n_docs) or 1
        ts, tc, bs, bc = self._sections(term_ids, qn)
        if tc is None:
            tc = (ts + bs > 0).astype(ts.dtype)
            bc = jnp.zeros_like(tc)
        final = _bm25_finalize(ts, tc, bs, bc, self.title_boost, self.body_boost)
        return _scoring.exact_top_k(final, k, doc_map=index.doc_perm)

    def score_csr(
        self, index, term_ids, qlen, topic_probs,
        ph_docs=None, ph_tw=None, ph_bw=None, ph_fl=None, topk=None,
    ):
        """Exact CSR scoring with BM25 posting weights (production route when
        the dense forward view was truncated by doc_term_cap)."""
        k = min(topk or self.topk, index.n_docs) or 1
        b = term_ids.shape[0]
        if ph_docs is None:
            e = 8
            ph_docs = jnp.full((b, e), index.match_pad, jnp.int32)
            ph_tw = jnp.zeros((b, e), jnp.float32)
            ph_bw = jnp.zeros((b, e), jnp.float32)
            ph_fl = jnp.zeros((b, e), jnp.float32)
        return _bm25_score_csr(
            index.title.offsets, index.title.doc_ids, self._fwd["title_w"],
            index.body.offsets, index.body.doc_ids, self._fwd["body_w"],
            term_ids, ph_docs, ph_tw, ph_bw, ph_fl,
            jnp.float32(self.title_boost), jnp.float32(self.body_boost),
            index.doc_perm,
            posting_cap=index.posting_cap, topk=k, n_docs=index.match_pad,
        )

    def score_with_phrase(
        self, index, term_ids, qlen, topic_probs,
        ph_docs, ph_tw, ph_bw, ph_fl, topk=None, qn=None,
    ):
        k = min(topk or self.topk, index.n_docs) or 1
        ts, tc, bs, bc = self._sections(term_ids, qn)
        b = term_ids.shape[0]
        dl = ts.shape[1]
        brow = jnp.arange(b)[:, None]
        pacc = jnp.zeros((b, index.n_docs_padded + 1, 3), dtype=ts.dtype)
        pacc = pacc.at[brow, ph_docs].add(
            jnp.stack([ph_tw, ph_bw, ph_fl], axis=-1), mode="drop"
        )
        if tc is None:
            tc = ((ts + bs + pacc[:, :dl, 0] + pacc[:, :dl, 1] > 0)
                  | (pacc[:, :dl, 2] > 0)).astype(ts.dtype)
            bc = jnp.zeros_like(tc)
        else:
            tc = tc + pacc[:, :dl, 2]
        ts = ts + pacc[:, :dl, 0]
        bs = bs + pacc[:, :dl, 1]
        final = _bm25_finalize(ts, tc, bs, bc, self.title_boost, self.body_boost)
        return _scoring.exact_top_k(final, k, doc_map=index.doc_perm)


from functools import partial  # noqa: E402


@partial(jax.jit, static_argnames=("posting_cap", "topk", "n_docs"))
def _bm25_score_csr(
    title_offsets, title_doc_ids, title_w,
    body_offsets, body_doc_ids, body_w,
    term_ids, ph_docs, ph_tw, ph_bw, ph_fl,
    title_boost, body_boost,
    doc_map=None,
    *,
    posting_cap: int,
    topk: int,
    n_docs: int,
):
    """CSR gather/scatter BM25 scoring (exact; phrase contributions folded)."""
    b = term_ids.shape[0]
    brow = jnp.arange(b)[:, None]
    td, tw, tv = _scoring._gather_section(
        title_offsets, title_doc_ids, title_w, term_ids, posting_cap
    )
    ts, tc = _scoring._scatter_scores(td, tw, tv, n_docs)
    bd, bw_, bv = _scoring._gather_section(
        body_offsets, body_doc_ids, body_w, term_ids, posting_cap
    )
    bs, bc = _scoring._scatter_scores(bd, bw_, bv, n_docs)
    pacc = jnp.zeros((b, n_docs + 1, 3), dtype=ts.dtype)
    pacc = pacc.at[brow, ph_docs].add(
        jnp.stack([ph_tw, ph_bw, ph_fl], axis=-1), mode="drop"
    )
    ts = ts + pacc[:, :n_docs, 0]
    bs = bs + pacc[:, :n_docs, 1]
    tc = tc + pacc[:, :n_docs, 2]
    final = _bm25_finalize(ts, tc, bs, bc, title_boost, body_boost)
    return _scoring.exact_top_k(final, topk, doc_map=doc_map)
