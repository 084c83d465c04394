"""Batched query scoring: the flagship jit'd device programs.

One XLA program replaces the reference's entire per-query goroutine pipeline
(reference: retrieval/main_retrieve.go:50-103 + get_metadata.go:16-77).

Two formulations share one finalization (cosine normalize -> PageRank blend
-> candidate mask -> exact top-k):

1. **Forward membership** (production keyword path): the index is doc-major
   `ft[d, j]` term ids / `fw[d, j]` weights; per query term the score is a
   dense compare + weighted reduce over [B, D, T] — no scatter, no gather.
   On the GPU the sweep is a Triton kernel (ops/kernels/membership.py); on
   the CPU it is the XLA formulation below.

2. **CSR gather/scatter** (phrase + parity path): gather each term's postings
   window and scatter-add per-doc weights. Kept because phrase matching needs
   the positional CSR anyway and as an independent oracle for the forward
   path.

Scoring semantics match the reference exactly:
- per-doc title/body score = sum of the [0] entries (normTF*idf) of the doc's
  postings across query terms, counting duplicate query terms once per
  occurrence (main_retrieve.go:62-78);
- cosine: score /= magnitude * sqrt(query_len); NaN (0/0) -> 0 but +inf kept
  (get_metadata.go:53-66 only guards IsNaN);
- final = (0.33*sqd + 0.38*title + 0.29*body) * 100 (get_metadata.go:69);
  sqd = topic_probs . pagerank[d] — zero when the topic model is off, the
  reference's shipped behavior (main_retrieve.go:87-88);
- only candidate docs (>=1 postings row hit or a phrase match) are ranked;
  non-candidates come back as -inf.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import SCORE_SCALE, W_BODY, W_PAGERANK, W_TITLE


def use_gpu_kernel() -> bool:
    """The keyword sweep's route, chosen by backend: the Triton kernel on
    `gpu`, the XLA formulation on `cpu`. No other backend is supported."""
    backend = jax.default_backend()
    if backend == "gpu":
        return True
    if backend == "cpu":
        return False
    raise RuntimeError(
        f"no scoring route for JAX backend {backend!r}; expected gpu or cpu"
    )


#: bound on one doc block's materialized [B, Db, width] f32 plane in the XLA
#: formulations (ops/scoring.py forward_section_scores, the phrase stage in
#: ops/kernels/mixed.py); the block count follows from it and the shapes
XLA_BLOCK_BYTES = 256 << 20


def xla_n_blocks(b: int, d: int, width: int) -> int:
    """Doc blocks needed so one block's [b, Db, width] f32 plane stays
    within XLA_BLOCK_BYTES."""
    per_doc = max(b * width * 4, 1)
    db = max(XLA_BLOCK_BYTES // per_doc, 1)
    return max(-(-d // db), 1)


# ---------------------------------------------------------------------- #
# exact top-k
# ---------------------------------------------------------------------- #


def exact_top_k(
    scores: jax.Array, k: int, chunk: int = 128, chunk_min_docs: int = 1 << 18,
    doc_map: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Exact top-k over the doc axis.

    Plain lax.top_k at small D. Large D takes the chunk-max route, which
    reads the scores once and sorts only k candidate chunks:

      1. per-128-doc-chunk max             (bandwidth-bound reduce)
      2. lax.top_k over the [B, D/128] chunk maxima
      3. gather the k winning chunks       ([B, k*128] candidates)
      4. exact lax.top_k over the candidates

    Value-exact: every element > v_k (the k-th value) lives in a chunk
    whose max > v_k, and at most k chunks can have max > v_k, so step 2
    keeps all of them. Tie semantics at exactly v_k can pick different
    (equal-scoring) doc ids than plain lax.top_k when v_k ties span
    chunks; the selected order is normalized to (score desc, id asc) —
    lax.top_k's rule — so divergence is confined to which tied-at-v_k id
    fills the tail (the reference's tie order is map-iteration
    nondeterministic anyway, retrieval/util.go:48-54; bench --mode parity
    classifies these as tie-explained)).

    With doc_map (doc-sorted layout, DeviceIndex.doc_perm) the score axis
    is in permuted doc space: selected ids are gathered through doc_map
    back to natural ids BEFORE the tie normalization, so callers see
    natural ids in the canonical (score desc, natural id asc) order."""
    b, d = scores.shape
    k = min(k, d)
    if d < chunk_min_docs or d < 2 * chunk * k:
        tv, tid = jax.lax.top_k(scores, k)
        if doc_map is None:
            return tv, tid
        tid = doc_map[tid]
        neg_s, tid = jax.lax.sort((-tv, tid), num_keys=2, dimension=1)
        return -neg_s, tid
    pad = (-d) % chunk
    xp = (
        jnp.pad(scores, ((0, 0), (0, pad)), constant_values=-jnp.inf)
        if pad
        else scores
    )
    m = xp.shape[1] // chunk
    ch = xp.reshape(b, m, chunk)
    cmax = ch.max(axis=2)  # [B, M]
    _, ci = jax.lax.top_k(cmax, k)  # [B, k] winning chunk ids
    cand = jnp.take_along_axis(ch, ci[:, :, None], axis=1).reshape(b, k * chunk)
    tv, tp = jax.lax.top_k(cand, k)  # [B, k] positions into cand
    tid = (
        jnp.take_along_axis(ci, tp // chunk, axis=1) * chunk + tp % chunk
    ).astype(jnp.int32)
    if doc_map is not None:
        tid = doc_map[tid]
    # normalize tie order to lax.top_k's (score desc, then lowest id)
    neg_s, tid = jax.lax.sort((-tv, tid), num_keys=2, dimension=1)
    return -neg_s, tid


# ---------------------------------------------------------------------- #
# shared finalization
# ---------------------------------------------------------------------- #


def finalize_scores(
    title_score: jax.Array,  # [B, D]
    title_count: jax.Array,
    body_score: jax.Array,
    body_count: jax.Array,
    mag_title: jax.Array,  # [D]
    mag_body: jax.Array,
    pagerank: jax.Array,  # [D, C]
    query_len: jax.Array,  # [B]
    topic_probs: jax.Array,  # [B, C]
) -> jax.Array:
    qmag = jnp.sqrt(query_len)[:, None]
    title_n = title_score / (mag_title[None, :] * qmag)
    body_n = body_score / (mag_body[None, :] * qmag)
    title_n = jnp.where(jnp.isnan(title_n), 0.0, title_n)
    body_n = jnp.where(jnp.isnan(body_n), 0.0, body_n)
    # topic-sensitive importance: sqd[b,d] = topic_probs[b] . pagerank[d]
    sqd = topic_dot(topic_probs, pagerank)
    final = (W_PAGERANK * sqd + W_TITLE * title_n + W_BODY * body_n) * SCORE_SCALE
    count = title_count + body_count
    return jnp.where(count > 0, final, -jnp.inf)


# ---------------------------------------------------------------------- #
# forward-membership formulation
# ---------------------------------------------------------------------- #


def topic_dot(topic_probs: jax.Array, pagerank: jax.Array) -> jax.Array:
    """[B, C] . [D, C]^T -> [B, D] in full f32: a GPU's default f32 product
    may run in TF32 (~10 mantissa bits), which moves final scores by ~1e-3."""
    return jnp.dot(
        topic_probs, pagerank.T,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


def forward_section_scores(
    ft: jax.Array,  # int32 [D, T], -1 padding
    fw: jax.Array,  # f32 [D, T]
    term_ids: jax.Array,  # int32 [B, Q], pad >= n_words (never matches -1)
    n_blocks: int | None = None,  # None: sized by XLA_BLOCK_BYTES
) -> tuple[jax.Array, jax.Array]:
    """-> (score [B, D], count [B, D]).

    mult[b,d,j] = #occurrences of ft[d,j] among the query's terms (duplicate
    query terms count per occurrence, matching the reference's per-term
    fan-out); score = sum_j fw*mult, count = sum_j mult. The weighted sum is
    an elementwise multiply and reduce, not a dot: it fuses with the
    compares and cannot be lowered to a reduced-precision product."""
    d, t = ft.shape
    b, q = term_ids.shape
    if n_blocks is None:
        n_blocks = xla_n_blocks(b, d, t)
    db = -(-d // n_blocks)
    pad = n_blocks * db - d
    ftb = jnp.pad(ft, ((0, pad), (0, 0)), constant_values=-1).reshape(n_blocks, db, t)
    fwb = jnp.pad(fw, ((0, pad), (0, 0))).reshape(n_blocks, db, t)

    def block_scores(args):
        ft_blk, fw_blk = args  # [Db, T]
        mult = sum(
            (ft_blk[None] == term_ids[:, qi, None, None]).astype(jnp.float32)
            for qi in range(q)
        )  # [B, Db, T]
        return (mult * fw_blk[None]).sum(-1), mult.sum(-1)

    score, count = jax.lax.map(block_scores, (ftb, fwb))  # [M, B, Db]
    score = jnp.moveaxis(score, 0, 1).reshape(b, -1)[:, :d]
    count = jnp.moveaxis(count, 0, 1).reshape(b, -1)[:, :d]
    return score, count


def mask_cold(term_ids: jax.Array, qnb: jax.Array | None) -> jax.Array:
    """Replace slots past each row's cold-term count with the sentinel.

    The hot-split layout puts a query's COLD terms in slots [0, qnb) and
    its hot terms after (the title sweep reads all of them); the body sweep
    must see only the cold slots — masking per ROW matters because the
    kernel bounds its compare loop per ROW-BLOCK max, so a row's hot slots
    below the block max would otherwise be swept AND added by the dense
    hot product (double count)."""
    if qnb is None:
        return term_ids
    q = term_ids.shape[1]
    return jnp.where(
        jnp.arange(q, dtype=jnp.int32)[None, :] < qnb[:, None],
        term_ids,
        jnp.iinfo(jnp.int32).max,
    )


def hot_body_scores(hot_w: jax.Array, hot_sids: jax.Array) -> jax.Array:
    """Sum of a query's hot-term dense body-weight rows, as a one-hot f32
    product: [B, H] @ [H, D] -> [B, D]. hot_sids pads with -1
    (never matches the iota). Exact per element (adding true zeros never
    changes an f32 sum; duplicate query terms raise the one-hot entry to
    their multiplicity, matching the sweep's per-occurrence counting);
    summation GROUPING differs from the sweep only at ulp level, inside
    the parity tolerance."""
    h = hot_w.shape[0]
    onehot = (
        (hot_sids[:, :, None] == jnp.arange(h, dtype=jnp.int32)[None, None, :])
        .astype(jnp.float32)
        .sum(axis=1)
    )  # [B, H]
    # HIGHEST: true-f32 accumulation; a reduced-precision f32 product
    # (TF32 on a GPU) keeps ~10 mantissa bits, enough to reorder top-50 ids
    return jnp.dot(
        onehot, hot_w,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


def _both_section_scores(
    title_fwd, body_fwd, term_ids, use_kernel: bool,
    qn=None, emit_counts=True, qnb=None, body_tmax=None,
):
    """Title and body keyword sweeps: one Triton kernel pass on the GPU,
    the per-section XLA formulation on the CPU. With qnb (the hot-split
    cold term count, cold slots first) the BODY sweep covers only the cold
    slots — the hot terms' body contribution comes from the caller's
    hot_body_scores product; the title sweep always covers every slot.
    body_tmax (doc-sorted layout) bounds the kernel's body sweep per doc
    block; the XLA formulation ignores it (full sweep, same result). With
    emit_counts=False the kernel drops the counts (returned as None);
    the XLA formulation always returns them."""
    if not use_kernel:
        ts, tc = forward_section_scores(title_fwd.ft, title_fwd.fw, term_ids)
        bs, bc = forward_section_scores(
            body_fwd.ft, body_fwd.fw, mask_cold(term_ids, qnb)
        )
        return ts, tc, bs, bc
    from .kernels.membership import keyword_scores_2sec

    return keyword_scores_2sec(
        title_fwd.ftT, title_fwd.fwT, body_fwd.ftT, body_fwd.fwT, term_ids, qn,
        emit_counts=emit_counts, qnb=qnb, body_tmax=body_tmax,
    )


@partial(jax.jit, static_argnames=("topk", "use_kernel", "emit_counts"))
def score_queries_forward(
    title_fwd,  # ForwardArrays
    body_fwd,  # ForwardArrays
    mag_title: jax.Array,
    mag_body: jax.Array,
    pagerank: jax.Array,
    term_ids: jax.Array,  # int32 [B, Q]
    query_len: jax.Array,  # f32 [B]
    topic_probs: jax.Array,  # f32 [B, C]
    qn: jax.Array | None = None,  # i32 [B] active term counts (sorted desc)
    qnb: jax.Array | None = None,  # i32 [B] cold-term count (hot split)
    hot_sids: jax.Array | None = None,  # i32 [B, QH] hot slots, -1 pad
    hot_w: jax.Array | None = None,  # f32 [H, D] dense hot body weights
    body_tmax: jax.Array | None = None,  # i32 [D//512] (doc-sorted layout)
    doc_map: jax.Array | None = None,  # i32 [D] permuted -> natural ids
    *,
    topk: int,
    use_kernel: bool = False,
    emit_counts: bool = True,
) -> tuple[jax.Array, jax.Array]:
    """Keyword-only fast path. -> (top scores [B,K], doc ids [B,K])."""
    ts, tc, bs, bc = _both_section_scores(
        title_fwd, body_fwd, term_ids, use_kernel, qn, emit_counts,
        qnb=qnb, body_tmax=body_tmax,
    )
    if hot_w is not None and hot_sids is not None:
        hot = hot_body_scores(hot_w, hot_sids)[:, : bs.shape[1]]
        bs = bs + hot
        if bc is not None:  # true-count path: hot candidacy must count too
            bc = bc + (hot > 0).astype(bs.dtype)
    if tc is None:  # counts elided: all weights > 0, candidacy <=> score > 0
        tc = (ts + bs > 0).astype(ts.dtype)
        bc = jnp.zeros_like(tc)
    final = finalize_scores(
        ts, tc, bs, bc, mag_title, mag_body, pagerank, query_len, topic_probs
    )
    return exact_top_k(final, topk, doc_map=doc_map)


@partial(jax.jit, static_argnames=("topk", "use_kernel", "emit_counts"))
def score_queries_forward_phrase(
    title_fwd,  # ForwardArrays
    body_fwd,  # ForwardArrays
    mag_title: jax.Array,
    mag_body: jax.Array,
    pagerank: jax.Array,
    term_ids: jax.Array,  # int32 [B, Q]
    query_len: jax.Array,  # f32 [B]
    topic_probs: jax.Array,  # f32 [B, C]
    phrase_doc_ids: jax.Array,  # int32 [B, E] host-compressed, pad >= n_docs
    phrase_title_w: jax.Array,  # f32 [B, E]
    phrase_body_w: jax.Array,  # f32 [B, E]
    phrase_flag: jax.Array,  # f32 [B, E]
    qn: jax.Array | None = None,
    qnb: jax.Array | None = None,
    hot_sids: jax.Array | None = None,
    hot_w: jax.Array | None = None,
    body_tmax: jax.Array | None = None,
    doc_map: jax.Array | None = None,
    *,
    topk: int,
    use_kernel: bool = False,
    emit_counts: bool = True,
) -> tuple[jax.Array, jax.Array]:
    """Forward keyword scoring + sparse phrase fold.

    The phrase op's output is compressed on host to its (few) real matches
    before this call, so the scatter is tiny — E is typically <= 1024 vs the
    2*posting_cap device-side sparse width. Under the doc-sorted layout
    (doc_map set) phrase_doc_ids are already permuted-space ids — the
    matcher reads the index's remapped device doc_ids."""
    n_docs = title_fwd.ft.shape[0]
    b = term_ids.shape[0]
    brow = jnp.arange(b)[:, None]

    ts, tc, bs, bc = _both_section_scores(
        title_fwd, body_fwd, term_ids, use_kernel, qn, emit_counts,
        qnb=qnb, body_tmax=body_tmax,
    )
    if hot_w is not None and hot_sids is not None:
        hot = hot_body_scores(hot_w, hot_sids)[:, : bs.shape[1]]
        bs = bs + hot
        if bc is not None:
            bc = bc + (hot > 0).astype(bs.dtype)

    pacc = jnp.zeros((b, n_docs + 1, 3), dtype=ts.dtype)
    pacc = pacc.at[brow, phrase_doc_ids].add(
        jnp.stack([phrase_title_w, phrase_body_w, phrase_flag], axis=-1), mode="drop"
    )
    if tc is None:  # counts elided: candidacy from scores + phrase flags
        tc = ((ts + bs > 0) | (pacc[:, :n_docs, 2] > 0)).astype(ts.dtype)
        bc = jnp.zeros_like(tc)
    else:
        tc = tc + pacc[:, :n_docs, 2]
    ts = ts + pacc[:, :n_docs, 0]
    bs = bs + pacc[:, :n_docs, 1]

    final = finalize_scores(
        ts, tc, bs, bc, mag_title, mag_body, pagerank, query_len, topic_probs
    )
    return exact_top_k(final, topk, doc_map=doc_map)


def mixed_section_scores(
    title_fwd, body_fwd, title_posT, body_posT, term_ids, ph_ids, ph_valid,
    use_kernel: bool, qn=None, pn=None, emit_counts=True, qnb=None,
    body_tmax=None,
):
    """Keyword sweeps (kernel or XLA, as _both_section_scores) with the
    dense phrase stage (XLA, ops/kernels/mixed.py phrase_scores) folded in:
    -> (ts, tc, bs, bc), each [B, D]. Phrase weights add to the scores; the
    phrase candidacy flag adds to the title count when counts are kept
    (with counts elided, a phrase match has positive weight, so candidacy
    by score covers it)."""
    from .kernels.mixed import phrase_scores

    ts, tc, bs, bc = _both_section_scores(
        title_fwd, body_fwd, term_ids, use_kernel, qn, emit_counts,
        qnb=qnb, body_tmax=body_tmax,
    )
    add_t, add_b, flag = phrase_scores(
        title_fwd.ftT, title_fwd.fwT, body_fwd.ftT, body_fwd.fwT,
        title_posT, body_posT, ph_ids, ph_valid, pn,
    )
    return ts + add_t, None if tc is None else tc + flag, bs + add_b, bc


@partial(jax.jit, static_argnames=("topk", "use_kernel", "emit_counts"))
def score_queries_mixed(
    title_fwd,  # ForwardArrays
    body_fwd,  # ForwardArrays
    title_posT: jax.Array,  # f32|int16 [Ct*Tt, D] doc-major positions
    body_posT: jax.Array,  # f32|int16 [Cb*Tb, D]
    mag_title: jax.Array,
    mag_body: jax.Array,
    pagerank: jax.Array,
    term_ids: jax.Array,  # int32 [B, Q]
    query_len: jax.Array,  # f32 [B]
    topic_probs: jax.Array,  # f32 [B, C]
    ph_ids: jax.Array,  # int32 [B, P] phrase terms (sentinel pad)
    ph_valid: jax.Array,  # f32 [B, P]
    qn: jax.Array | None = None,
    pn: jax.Array | None = None,  # i32 [B] active phrase slots
    qnb: jax.Array | None = None,
    hot_sids: jax.Array | None = None,
    hot_w: jax.Array | None = None,
    doc_map: jax.Array | None = None,  # i32 [D] permuted -> natural ids
    body_tmax: jax.Array | None = None,  # i32 [D//512] (doc-sorted layout)
    *,
    topk: int,
    use_kernel: bool = False,
    emit_counts: bool = True,
) -> tuple[jax.Array, jax.Array]:
    """The mixed lane: keyword membership scoring + dense phrase matching +
    fold + finalize + top-k in ONE device program — no sparse matcher
    dispatches, no host repack, one packed result fetch. body_tmax
    (doc-sorted layout) bounds the keyword kernel's body sweep per doc
    block; the XLA formulation ignores it (full sweep, same result)."""
    from .kernels.mixed import derive_mixed_counts

    ts, tc, bs, bc = mixed_section_scores(
        title_fwd, body_fwd, title_posT, body_posT, term_ids, ph_ids,
        ph_valid, use_kernel, qn, pn, emit_counts, qnb, body_tmax,
    )
    # derive candidacy AFTER the hot fold: a doc matched only by a hot body
    # term must still become a candidate
    if hot_w is not None and hot_sids is not None:
        hot = hot_body_scores(hot_w, hot_sids)[:, : bs.shape[1]]
        bs = bs + hot
        if bc is not None:
            bc = bc + (hot > 0).astype(bs.dtype)
    ts, tc, bs, bc = derive_mixed_counts(ts, tc, bs, bc)
    final = finalize_scores(
        ts, tc, bs, bc, mag_title, mag_body, pagerank, query_len, topic_probs
    )
    return exact_top_k(final, topk, doc_map=doc_map)


# ---------------------------------------------------------------------- #
# CSR gather/scatter formulation (phrase + parity oracle)
# ---------------------------------------------------------------------- #


def _gather_section(
    post_offsets: jax.Array,  # int32 [V+2] (sentinel empty row at V)
    doc_ids: jax.Array,  # int32 [P_pad], pad = n_docs
    weights: jax.Array,  # f32 [P_pad]
    term_ids: jax.Array,  # int32 [B, Q], pad = V (sentinel)
    posting_cap: int,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """-> (docs [B,Q,L], w [B,Q,L], valid [B,Q,L])"""
    start = post_offsets[term_ids]  # [B, Q]
    end = post_offsets[term_ids + 1]
    idx = start[..., None] + jnp.arange(posting_cap, dtype=jnp.int32)  # [B,Q,L]
    valid = idx < end[..., None]
    idx = jnp.where(valid, idx, doc_ids.shape[0] - 1)
    docs = doc_ids[idx]
    w = jnp.where(valid, weights[idx], 0.0)
    return docs, w, valid


def _scatter_scores(
    docs: jax.Array, w: jax.Array, valid: jax.Array, n_docs: int
) -> tuple[jax.Array, jax.Array]:
    """Scatter (weight, candidate-count) per doc. -> (scores [B,D], count [B,D])"""
    b = docs.shape[0]
    flat_docs = docs.reshape(b, -1)
    payload = jnp.stack(
        [w.reshape(b, -1), valid.reshape(b, -1).astype(w.dtype)], axis=-1
    )  # [B, QL, 2]
    acc = jnp.zeros((b, n_docs + 1, 2), dtype=w.dtype)
    acc = acc.at[jnp.arange(b)[:, None], flat_docs].add(
        payload, mode="drop", unique_indices=False
    )
    return acc[:, :n_docs, 0], acc[:, :n_docs, 1]


def score_dense(
    title_offsets: jax.Array,
    title_doc_ids: jax.Array,
    title_weights: jax.Array,
    body_offsets: jax.Array,
    body_doc_ids: jax.Array,
    body_weights: jax.Array,
    mag_title: jax.Array,
    mag_body: jax.Array,
    pagerank: jax.Array,
    term_ids: jax.Array,
    query_len: jax.Array,
    topic_probs: jax.Array,
    phrase_doc_ids: jax.Array,  # int32 [B, E], pad = n_docs
    phrase_title_w: jax.Array,
    phrase_body_w: jax.Array,
    phrase_flag: jax.Array,
    *,
    posting_cap: int,
    n_docs: int,
    blend: jax.Array | None = None,  # f32 [4] custom (w_pr, w_title, w_body, scale)
) -> jax.Array:
    """Dense final scores [B, D] via the CSR formulation; folds sparse phrase
    contributions (weights + candidacy) before normalization."""
    b = term_ids.shape[0]
    brow = jnp.arange(b)[:, None]

    t_docs, t_w, t_valid = _gather_section(
        title_offsets, title_doc_ids, title_weights, term_ids, posting_cap
    )
    title_score, title_count = _scatter_scores(t_docs, t_w, t_valid, n_docs)

    b_docs, b_w, b_valid = _gather_section(
        body_offsets, body_doc_ids, body_weights, term_ids, posting_cap
    )
    body_score, body_count = _scatter_scores(b_docs, b_w, b_valid, n_docs)

    pacc = jnp.zeros((b, n_docs + 1, 3), dtype=title_score.dtype)
    pacc = pacc.at[brow, phrase_doc_ids].add(
        jnp.stack([phrase_title_w, phrase_body_w, phrase_flag], axis=-1), mode="drop"
    )
    title_score = title_score + pacc[:, :n_docs, 0]
    body_score = body_score + pacc[:, :n_docs, 1]
    title_count = title_count + pacc[:, :n_docs, 2]

    # doc-level arrays may be padded beyond n_docs (DOC_BLOCK layout); slice
    if blend is None:
        return finalize_scores(
            title_score, title_count, body_score, body_count,
            mag_title[:n_docs], mag_body[:n_docs], pagerank[:n_docs],
            query_len, topic_probs,
        )
    qmag = jnp.sqrt(query_len)[:, None]
    tn = title_score / (mag_title[None, :n_docs] * qmag)
    bn = body_score / (mag_body[None, :n_docs] * qmag)
    tn = jnp.where(jnp.isnan(tn), 0.0, tn)
    bn = jnp.where(jnp.isnan(bn), 0.0, bn)
    sqd = topic_dot(topic_probs, pagerank[:n_docs])
    final = (blend[0] * sqd + blend[1] * tn + blend[2] * bn) * blend[3]
    return jnp.where(title_count + body_count > 0, final, -jnp.inf)


@partial(jax.jit, static_argnames=("posting_cap", "topk", "n_docs"))
def score_queries(
    title_offsets: jax.Array,
    title_doc_ids: jax.Array,
    title_weights: jax.Array,
    body_offsets: jax.Array,
    body_doc_ids: jax.Array,
    body_weights: jax.Array,
    mag_title: jax.Array,
    mag_body: jax.Array,
    pagerank: jax.Array,
    term_ids: jax.Array,
    query_len: jax.Array,
    topic_probs: jax.Array,
    phrase_doc_ids: jax.Array,
    phrase_title_w: jax.Array,
    phrase_body_w: jax.Array,
    phrase_flag: jax.Array,
    blend: jax.Array | None = None,
    doc_map: jax.Array | None = None,
    *,
    posting_cap: int,
    topk: int,
    n_docs: int,
) -> tuple[jax.Array, jax.Array]:
    """CSR path with phrase folding. -> (top scores [B,K], doc ids [B,K]).

    The production keyword scorer routes here when the dense forward view
    was truncated (doc_term_cap) — the CSR stays complete, so scores and
    candidacy remain exact for pathological documents. Under the
    doc-sorted layout pass n_docs = the PADDED doc count (device doc_ids
    are remapped over [0, d_pad)) plus doc_map for natural output ids."""
    final = score_dense(
        title_offsets, title_doc_ids, title_weights,
        body_offsets, body_doc_ids, body_weights,
        mag_title, mag_body, pagerank,
        term_ids, query_len, topic_probs,
        phrase_doc_ids, phrase_title_w, phrase_body_w, phrase_flag,
        posting_cap=posting_cap,
        n_docs=n_docs,
        blend=blend,
    )
    return exact_top_k(final, topk, doc_map=doc_map)
