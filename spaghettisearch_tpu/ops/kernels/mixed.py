"""Dense phrase matching for the mixed lane (keyword + "quoted phrase"
queries in one device program), in plain XLA.

Phrase matching runs as a dense pass over a doc-major position layout kept
beside the forward index —

    posT[c*T + t, d] = (c-th UNIQUE position of doc d's term-slot t), BIG pad

so the positional-chain check per (query, doc) is a handful of compares and
the whole mixed batch is ONE device program with ONE packed result fetch.
Per phrase term and doc, the term's forward slot is found by compare
(a term occupies at most one slot of a doc's forward row — one posting per
(term, doc)), and its weight and positions are read by index at that slot.

Reference semantics (retrieval/phrase.go:53-109 + main_retrieve.go:62-78),
identical to ops/phrase.py match_phrase_fwd (equivalence-tested):
  - a doc matches only if EVERY phrase term occurs in title OR body;
  - the title contributes sum(term title weights) only when every term has
    a title entry and the title positional chain intersects; body likewise;
  - chain: some position of term 0 such that term i occurs at pos0 + i
    (positions pre-shifted by the term's phrase offset, phrase.go:144-157);
  - a single-term phrase matches wherever the term occurs (sentinel -100
    anchor/meta positions included);
  - phrase-matched docs are candidates even with zero keyword overlap.

Value-domain invariants: real positions are -100 or in [0, POS_REAL_MAX);
the pad is POS_BIG, which never equals a shifted real position. An absent
(doc, term) reads some slot's positions, but those are only ever compared
where the all-terms-found masks hold.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

#: pad value for absent position slots; exactly representable in f32, far
#: above any real document position
POS_BIG = float(1 << 24)
#: everything below this is a real position (real docs are << 1e6 tokens)
POS_REAL_MAX = float(1 << 23)

#: int16 posT planes (bandwidth and memory compression): POS16_PAD encodes
#: POS_BIG and every real value (-100 sentinel included) round-trips
#: exactly, so scores and match sets are bitwise-identical to the f32
#: planes. quantize_posT returns None when any real position exceeds
#: POS16_MAX (pathological giant documents keep the f32 planes; the margin
#: below int16 max keeps PAD16 unambiguous).
POS16_PAD = 32767
POS16_MAX = 32000.0


def quantize_posT(posT_np):
    """Host-side int16 encoding of a doc-major position plane ([C*T, D]
    f32, values in {-100} ∪ [0, POS16_MAX] ∪ {POS_BIG}); None when some
    real position is too large to encode. Chunked to bound transients."""
    import numpy as np

    if posT_np.size == 0:
        return posT_np.astype(np.int16)
    mx = float(
        posT_np.max(initial=-100.0, where=posT_np < POS_REAL_MAX)
    )
    if mx > POS16_MAX:
        return None
    out = np.empty(posT_np.shape, np.int16)
    rows = posT_np.shape[0]
    step = max(1, (64 << 20) // max(posT_np.shape[1] * 4, 1))
    for r0 in range(0, rows, step):
        blk = posT_np[r0 : r0 + step]
        np.copyto(
            out[r0 : r0 + step],
            np.where(blk >= POS_REAL_MAX, np.float32(POS16_PAD), blk).astype(
                np.int16
            ),
        )
    return out


def _deq_posT(x):
    """Dequantize an int16 posT block back to the exact f32 plane (identity
    on f32 inputs): upcast + one select mapping PAD16 -> POS_BIG."""
    if x.dtype != jnp.int16:
        return x
    xf = x.astype(jnp.float32)
    return jnp.where(xf >= float(POS16_PAD), POS_BIG, xf)


def derive_mixed_counts(ts, tc, bs, bc):
    """Fill in the candidacy counts the count-elided keyword sweep drops:
    valid iff every index weight is positive (DeviceIndex.has_zero_weight
    guards the df==N idf-zero corner) — then candidacy ⟺ score > 0, and the
    title count carries the whole flag (finalize sums tc+bc)."""
    if tc is None:
        tc = (ts + bs > 0).astype(ts.dtype)
        bc = jnp.zeros_like(tc)
    return ts, tc, bs, bc


def phrase_scores(
    title_ftT, title_fwT, body_ftT, body_fwT,  # [T, D] transposed forward
    title_posT, body_posT,  # f32|int16 [C*T, D] (c-major slot rows)
    ph_ids,  # int32 [B, P] phrase terms, valid slots first (sentinel pad)
    ph_valid,  # f32 [B, P] 1/0
    pn=None,  # i32 [B] active phrase slots (derived from ph_valid if None)
):
    """-> (add_t, add_b, flag), each f32 [B, D]: the phrase title/body
    weights of matched docs and the phrase candidacy flag.

    Doc-blocked (lax.map) so one block's [B, Db, max(T, C)] planes stay
    within the XLA block budget; the phrase-term loop is dynamic, bounded
    by the batch's longest phrase, and a batch with no phrase skips the
    stage entirely."""
    from ..scoring import xla_n_blocks

    tt, d = title_ftT.shape
    tb = body_ftT.shape[0]
    ct = title_posT.shape[0] // tt
    cb = body_posT.shape[0] // tb
    b, p = ph_ids.shape
    if pn is None:
        pn = ph_valid.sum(axis=1).astype(jnp.int32)
    p_hi = jnp.clip(pn.max(), 0, p)
    valid = ph_valid > 0.0  # [B, P]
    hp = valid[:, 0][:, None]  # row has a phrase at all

    n_blocks = xla_n_blocks(b, d, max(tt, tb, ct, cb))
    db = -(-d // n_blocks)
    pad = n_blocks * db - d

    def blocks(x, fill):  # [R, D] -> [n_blocks, R, Db]
        if pad:
            x = jnp.pad(x, ((0, 0), (0, pad)), constant_values=fill)
        return jnp.moveaxis(x.reshape(x.shape[0], n_blocks, db), 1, 0)

    def pos_fill(x):
        return POS16_PAD if x.dtype == jnp.int16 else POS_BIG

    cols = jnp.arange(db)[None, :]

    def term(ft, fw, pos, pid):
        """One phrase term in one section block: (found [B, Db], weight
        [B, Db], positions [C, B, Db]) read at the term's forward slot."""
        eq = ft[None] == pid[:, None, None]  # [B, T, Db]
        found = eq.any(axis=1)
        slot = jnp.argmax(eq, axis=1)  # the term's only slot (0 if absent)
        w = jnp.where(found, fw[slot, cols], 0.0)
        return found, w, pos[:, slot, cols]

    def block(args):
        tft, tfw, tpos, bft, bfw, bpos = args
        tpos = _deq_posT(tpos).reshape(ct, tt, db)
        bpos = _deq_posT(bpos).reshape(cb, tb, db)

        def stage(pi):
            pid = jax.lax.dynamic_index_in_dim(ph_ids, pi, 1, keepdims=False)
            v = jax.lax.dynamic_index_in_dim(valid, pi, 1, keepdims=False)
            v = v[:, None]
            tf, tw, tsel = term(tft, tfw, tpos, pid)
            bf, bw, bsel = term(bft, bfw, bpos, pid)
            return v, tf | ~v, bf | ~v, jnp.where(v, tw, 0.0), \
                jnp.where(v, bw, 0.0), tsel, bsel

        # phrase term 0 anchors the chain
        _, tf0, bf0, tw0, bw0, anchor_t, anchor_b = stage(0)
        init = (tf0 | bf0, tf0, bf0, tw0, bw0,
                anchor_t < POS_REAL_MAX, anchor_b < POS_REAL_MAX)

        def chain(pi, carry):
            present, t_all, b_all, sum_tw, sum_bw, hit_t, hit_b = carry
            v, tf, bf, tw, bw, tsel, bsel = stage(pi)
            fp = pi.astype(jnp.float32)
            # hit[c0] survives iff some position c of term pi sits at
            # anchor[c0] + pi; invalid slots leave every flag unchanged
            m_t = jnp.any(tsel[None] == anchor_t[:, None] + fp, axis=1)
            m_b = jnp.any(bsel[None] == anchor_b[:, None] + fp, axis=1)
            return (
                present & (tf | bf), t_all & tf, b_all & bf,
                sum_tw + tw, sum_bw + bw,
                hit_t & (m_t | ~v[None]), hit_b & (m_b | ~v[None]),
            )

        # a 1-term phrase runs zero chain steps: it matches wherever the
        # term occurs, any position (-100 included)
        present, t_all, b_all, sum_tw, sum_bw, hit_t, hit_b = (
            jax.lax.fori_loop(1, p_hi, chain, init)
        )
        t_ok = present & t_all & hit_t.any(axis=0) & hp
        b_ok = present & b_all & hit_b.any(axis=0) & hp
        return (
            jnp.where(t_ok, sum_tw, 0.0),
            jnp.where(b_ok, sum_bw, 0.0),
            (t_ok | b_ok).astype(jnp.float32),
        )

    def run(_):
        out = jax.lax.map(block, (
            blocks(title_ftT, -1), blocks(title_fwT, 0.0),
            blocks(title_posT, pos_fill(title_posT)),
            blocks(body_ftT, -1), blocks(body_fwT, 0.0),
            blocks(body_posT, pos_fill(body_posT)),
        ))  # 3 x [M, B, Db]
        return tuple(jnp.moveaxis(o, 0, 1).reshape(b, -1)[:, :d] for o in out)

    def skip(_):
        z = jnp.zeros((b, d), jnp.float32)
        return z, z, z

    return jax.lax.cond(p_hi > 0, run, skip, None)
