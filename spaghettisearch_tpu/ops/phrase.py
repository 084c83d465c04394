"""Phrase retrieval: vectorized positional intersection on device.

The reference intersects per-term position lists with per-doc sort-merge
loops across goroutines (reference: retrieval/phrase.go:11-170,
retrieval/util.go:162-203). Here one jit'd program evaluates a whole phrase
against all candidate documents at once:

1. candidates = the doc lists (title+body) of a generator term — the engine
   picks the rarest term, so every true match is covered;
2. per term & section, membership of each candidate is a vectorized
   searchsorted into the term's sorted posting row;
3. per term, the candidate's position list is gathered and shifted by the
   term's phrase offset (positions[i] -= i, reference: phrase.go:144-157);
4. the phrase matches where shifted positions intersect across all terms
   (any position of term 0 present in every other term's list).

Semantics preserved from evalPhraseOccurrence (phrase.go:53-109):
- a candidate counts only if *every* phrase term occurs in title OR body;
- the body contributes sum(term body weights) only when every term has a
  body entry and the body position intersection is non-empty; title likewise;
- a single-term phrase matches wherever the term occurs (any position,
  sentinel -100 included).

Position lists are capped at `pos_cap` per posting and postings at
`posting_cap` per term; the engine sizes both from snapshot maxima so
nothing is truncated.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("posting_cap", "pos_cap", "n_docs"))
def match_phrase_fwd(
    # forward views ([D_pad, T]) + positional CSR per section
    title_ft: jax.Array,
    title_fj: jax.Array,
    title_weights: jax.Array,
    title_pos_offsets: jax.Array,
    title_positions: jax.Array,
    body_ft: jax.Array,
    body_fj: jax.Array,
    body_weights: jax.Array,
    body_pos_offsets: jax.Array,
    body_positions: jax.Array,
    # CSR row windows of the generator term (candidate source)
    title_offsets: jax.Array,
    title_doc_ids: jax.Array,
    body_offsets: jax.Array,
    body_doc_ids: jax.Array,
    term_ids: jax.Array,  # int32 [P]
    term_valid: jax.Array,  # bool [P]
    gen_idx: jax.Array,  # int32 scalar
    # fixed-width per-posting position rows [P_pad, pos_cap] (inf pad rows),
    # built by DeviceSection within a memory budget: replaces the [P, E, C]
    # per-ELEMENT position gather with [P, E] ROW gathers
    title_pos_mat: jax.Array | None = None,
    body_pos_mat: jax.Array | None = None,
    *,
    posting_cap: int,  # covers the GENERATOR term's df only
    pos_cap: int,
    n_docs: int,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Forward-index phrase matcher: membership and posting lookup are dense
    compares against each candidate's term list (no binary searches), using
    fj to jump to position lists. ~100x less gather traffic than the
    searchsorted formulation for selective phrases, since posting_cap only
    needs to cover the rarest term. Semantics identical to match_phrase."""
    p = term_ids.shape[0]
    shift = jnp.arange(p, dtype=jnp.float32)

    # --- candidates from the generator term's CSR windows (title+body) ---
    t_docs, _, _ = _gather_term_windows(
        title_offsets, title_doc_ids, term_ids[gen_idx][None], posting_cap
    )
    b_docs, _, _ = _gather_term_windows(
        body_offsets, body_doc_ids, term_ids[gen_idx][None], posting_cap
    )
    cand = jnp.sort(jnp.concatenate([t_docs[0], b_docs[0]]))  # [E]
    first = jnp.concatenate([jnp.array([True]), cand[1:] != cand[:-1]])
    is_real = cand < n_docs
    keep_slot = first & is_real
    d_pad = title_ft.shape[0]
    cand_row = jnp.where(keep_slot, cand, d_pad - 1)  # pad doc row: all -1

    def section(ft, fj, weights, pos_offsets, positions, pos_mat):
        ftc = ft[cand_row]  # [E, T] row gather
        fjc = fj[cand_row]
        eq = ftc[None, :, :] == term_ids[:, None, None]  # [P, E, T]
        found = jnp.any(eq, axis=-1)  # [P, E]
        j = jnp.max(jnp.where(eq, fjc[None], 0), axis=-1)  # unique per row
        w0 = weights[jnp.minimum(j, weights.shape[0] - 1)]
        w = jnp.where(found, w0, 0.0)
        if pos_mat is not None:
            jm = jnp.where(found, j, pos_mat.shape[0] - 1)  # pad row: all inf
            pos = pos_mat[jm] - shift[:, None, None]  # [P, E, C] row gather
            return found, w, pos
        j = jnp.where(found, j, pos_offsets.shape[0] - 2)  # -> empty range
        p_start = pos_offsets[j]
        p_end = jnp.where(found, pos_offsets[j + 1], p_start)
        pidx = p_start[..., None] + jnp.arange(pos_cap, dtype=jnp.int32)
        pvalid = pidx < p_end[..., None]
        pidx = jnp.where(pvalid, pidx, positions.shape[0] - 1)
        pos = jnp.where(pvalid, positions[pidx], jnp.inf) - shift[:, None, None]
        return found, w, pos

    t_found, t_w, t_pos = section(
        title_ft, title_fj, title_weights, title_pos_offsets, title_positions,
        title_pos_mat,
    )
    b_found, b_w, b_pos = section(
        body_ft, body_fj, body_weights, body_pos_offsets, body_positions,
        body_pos_mat,
    )

    tv = term_valid
    present_all = jnp.all(jnp.where(tv[:, None], t_found | b_found, True), axis=0)
    title_all = jnp.all(jnp.where(tv[:, None], t_found, True), axis=0)
    body_all = jnp.all(jnp.where(tv[:, None], b_found, True), axis=0)

    def intersect(pos_pec):
        """True where some shifted position of term 0 appears in every valid
        term's list. Pairwise compares for short position lists; the
        [P,E,C,C'] intermediate grows quadratically in pos_cap, so long
        lists (repetitive documents) use sorted-membership searches
        instead — positions are stored sorted, and the shift preserves
        order."""
        p0 = pos_pec[0]  # [E, C]
        if pos_cap <= 16:
            member = p0[None, :, :, None] == pos_pec[:, :, None, :]  # [P,E,C,C']
            hit = jnp.any(member, axis=-1)  # [P, E, C]
            hit = jnp.where(tv[:, None, None], hit, True)
            all_terms = jnp.all(hit, axis=0)  # [E, C]
            return jnp.any(all_terms & jnp.isfinite(p0), axis=-1)
        return _intersect_all(pos_pec, tv)

    t_match = intersect(t_pos)
    b_match = intersect(b_pos)

    title_ok = present_all & title_all & t_match & keep_slot
    body_ok = present_all & body_all & b_match & keep_slot
    keep = title_ok | body_ok

    sum_t = jnp.sum(jnp.where(tv[:, None], t_w, 0.0), axis=0)
    sum_b = jnp.sum(jnp.where(tv[:, None], b_w, 0.0), axis=0)

    out_docs = jnp.where(keep, cand, n_docs).astype(jnp.int32)
    out_tw = jnp.where(title_ok, sum_t, 0.0)
    out_bw = jnp.where(body_ok, sum_b, 0.0)
    return out_docs, out_tw, out_bw, keep.astype(jnp.float32)


@partial(jax.jit, static_argnames=("posting_cap", "pos_cap", "n_docs"))
def match_phrase_fwd_batch(
    title_ft, title_fj, title_weights, title_pos_offsets, title_positions,
    body_ft, body_fj, body_weights, body_pos_offsets, body_positions,
    title_offsets, title_doc_ids, body_offsets, body_doc_ids,
    term_ids,  # int32 [B, P]
    term_valid,  # bool [B, P]
    gen_idx,  # int32 [B]
    title_pos_mat=None,
    body_pos_mat=None,
    *,
    posting_cap: int,  # max over the batch's generator dfs
    pos_cap: int,
    n_docs: int,
):
    """Batched match_phrase_fwd: one device program for a whole batch of
    phrase queries (the index arrays broadcast, the query axis vmaps)."""
    fn = partial(
        match_phrase_fwd,
        posting_cap=posting_cap, pos_cap=pos_cap, n_docs=n_docs,
    )
    return jax.vmap(
        lambda t, v, g: fn(
            title_ft, title_fj, title_weights, title_pos_offsets, title_positions,
            body_ft, body_fj, body_weights, body_pos_offsets, body_positions,
            title_offsets, title_doc_ids, body_offsets, body_doc_ids,
            t, v, g, title_pos_mat, body_pos_mat,
        )
    )(term_ids, term_valid, gen_idx)


@partial(jax.jit, static_argnames=("posting_cap", "pos_cap", "n_docs"))
def match_phrase_batch(
    title_offsets, title_doc_ids, title_weights, title_pos_offsets, title_positions,
    body_offsets, body_doc_ids, body_weights, body_pos_offsets, body_positions,
    term_ids,  # int32 [B, P]
    term_valid,  # bool [B, P]
    gen_idx,  # int32 [B]
    *,
    posting_cap: int,
    pos_cap: int,
    n_docs: int,
):
    """Batched exact CSR matcher (vmap over queries): the fallback when a
    dense forward row was truncated (doc_term_cap) and the forward matcher
    could under-match."""
    fn = partial(
        match_phrase, posting_cap=posting_cap, pos_cap=pos_cap, n_docs=n_docs
    )
    return jax.vmap(
        lambda t, v, g: fn(
            title_offsets, title_doc_ids, title_weights,
            title_pos_offsets, title_positions,
            body_offsets, body_doc_ids, body_weights,
            body_pos_offsets, body_positions,
            t, v, g,
        )
    )(term_ids, term_valid, gen_idx)


def _gather_term_windows(offsets, doc_ids, term_ids, posting_cap):
    """[P] term ids -> (docs [P,L] sorted w/ sentinel pad, start [P], valid [P,L])."""
    start = offsets[term_ids]
    end = offsets[term_ids + 1]
    idx = start[:, None] + jnp.arange(posting_cap, dtype=jnp.int32)
    valid = idx < end[:, None]
    idx = jnp.where(valid, idx, doc_ids.shape[0] - 1)
    docs = jnp.where(valid, doc_ids[idx], jnp.iinfo(jnp.int32).max)
    return docs, start, valid


def _membership(docs_pl, cand_e):
    """docs [P,L] sorted rows, cand [E] -> (found [P,E], row_idx [P,E])."""
    idx = jax.vmap(lambda row: jnp.searchsorted(row, cand_e))(docs_pl)
    idx_c = jnp.minimum(idx, docs_pl.shape[1] - 1)
    found = jnp.take_along_axis(docs_pl, idx_c, axis=1) == cand_e[None, :]
    return found, idx_c.astype(jnp.int32)


def _gather_positions(pos_offsets, positions, post_idx, found, shift, pos_cap):
    """post_idx [P,E] global posting indices -> shifted positions [P,E,C]
    (inf where absent)."""
    j = jnp.where(found, post_idx, pos_offsets.shape[0] - 2)
    p_start = pos_offsets[j]
    p_end = jnp.where(found, pos_offsets[j + 1], p_start)
    pidx = p_start[..., None] + jnp.arange(pos_cap, dtype=jnp.int32)
    pvalid = pidx < p_end[..., None]
    pidx = jnp.where(pvalid, pidx, positions.shape[0] - 1)
    pos = jnp.where(pvalid, positions[pidx], jnp.inf)
    return pos - shift[:, None, None]


def _intersect_all(pos_pec, term_valid):
    """pos [P,E,C] shifted sorted positions (inf pad). True where some
    position of term 0 appears in every valid term's list."""
    p0 = pos_pec[0]  # [E, C]
    # membership of each p0 value in each term's sorted list
    ss = jax.vmap(  # over P
        jax.vmap(jnp.searchsorted)  # over E
    )(pos_pec, jnp.broadcast_to(p0, pos_pec.shape))
    ss = jnp.minimum(ss, pos_pec.shape[-1] - 1)
    eq = jnp.take_along_axis(pos_pec, ss, axis=-1) == p0[None]
    # invalid (padding) terms always "match"; term 0 trivially matches itself
    eq = jnp.where(term_valid[:, None, None], eq, True)
    all_terms = jnp.all(eq, axis=0)  # [E, C]
    return jnp.any(jnp.logical_and(all_terms, jnp.isfinite(p0)), axis=-1)  # [E]


@partial(jax.jit, static_argnames=("posting_cap", "pos_cap", "n_docs"))
def match_phrase(
    title_offsets: jax.Array,
    title_doc_ids: jax.Array,
    title_weights: jax.Array,
    title_pos_offsets: jax.Array,
    title_positions: jax.Array,
    body_offsets: jax.Array,
    body_doc_ids: jax.Array,
    body_weights: jax.Array,
    body_pos_offsets: jax.Array,
    body_positions: jax.Array,
    term_ids: jax.Array,  # int32 [P] (pad = sentinel empty row)
    term_valid: jax.Array,  # bool [P]
    gen_idx: jax.Array,  # int32 scalar: index of the candidate-generator term
    *,
    posting_cap: int,
    pos_cap: int,
    n_docs: int,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """-> (doc_ids [E], title_w [E], body_w [E], flag [E]) with pad doc n_docs.
    E = 2*posting_cap."""
    p = term_ids.shape[0]
    shift = jnp.arange(p, dtype=jnp.float32)

    t_docs, t_start, _ = _gather_term_windows(
        title_offsets, title_doc_ids, term_ids, posting_cap
    )
    b_docs, b_start, _ = _gather_term_windows(
        body_offsets, body_doc_ids, term_ids, posting_cap
    )

    # --- candidates: generator term's title+body docs, deduped ---
    cand = jnp.sort(
        jnp.concatenate([t_docs[gen_idx], b_docs[gen_idx]])
    )  # [E] ascending, sentinel-padded
    first = jnp.concatenate([jnp.array([True]), cand[1:] != cand[:-1]])
    is_real = cand < n_docs
    cand = jnp.where(first & is_real, cand, jnp.iinfo(jnp.int32).max)

    # --- per-term membership and weights ---
    t_found, t_idx = _membership(t_docs, cand)
    b_found, b_idx = _membership(b_docs, cand)
    t_post = t_start[:, None] + t_idx
    b_post = b_start[:, None] + b_idx
    t_w = jnp.where(t_found, title_weights[jnp.minimum(t_post, title_weights.shape[0] - 1)], 0.0)
    b_w = jnp.where(b_found, body_weights[jnp.minimum(b_post, body_weights.shape[0] - 1)], 0.0)

    tv = term_valid
    present_all = jnp.all(jnp.where(tv[:, None], t_found | b_found, True), axis=0)
    title_all = jnp.all(jnp.where(tv[:, None], t_found, True), axis=0)
    body_all = jnp.all(jnp.where(tv[:, None], b_found, True), axis=0)

    # --- positional intersection ---
    t_pos = _gather_positions(
        title_pos_offsets, title_positions, t_post, t_found, shift, pos_cap
    )
    b_pos = _gather_positions(
        body_pos_offsets, body_positions, b_post, b_found, shift, pos_cap
    )
    t_match = _intersect_all(t_pos, tv)
    b_match = _intersect_all(b_pos, tv)

    title_ok = present_all & title_all & t_match
    body_ok = present_all & body_all & b_match
    keep = title_ok | body_ok

    sum_t = jnp.sum(jnp.where(tv[:, None], t_w, 0.0), axis=0)
    sum_b = jnp.sum(jnp.where(tv[:, None], b_w, 0.0), axis=0)

    out_docs = jnp.where(keep, cand, n_docs).astype(jnp.int32)
    out_tw = jnp.where(title_ok, sum_t, 0.0)
    out_bw = jnp.where(body_ok, sum_b, 0.0)
    flag = keep.astype(jnp.float32)
    return out_docs, out_tw, out_bw, flag
