"""Device-resident index: the snapshot's arrays placed in device memory
with the padding/sentinel layout the scoring programs expect."""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import NamedTuple

import jax
import numpy as np

from ..index.snapshot import IndexSnapshot, SectionCSR

#: doc-axis padding granularity; also the body_tmax bound's doc block
DOC_BLOCK = 512

#: bound on per-doc dense forward terms (memory guard; docs beyond it are
#: scored through the exact CSR path — engine.rank routes on dense_truncated)
DOC_TERM_CAP = 4096

#: doc-sorted layout (see _doc_sort_perm) switches on automatically at and
#: above this padded doc count. Below it small corpora (tests, fixtures)
#: keep the natural layout: the dynamic-T sweep needs real T-skew to pay,
#: and natural order keeps small-corpus tie behavior byte-stable. Tie
#: semantics above the gate stay canonical — exact_top_k re-normalizes to
#: (score desc, natural id asc) after the doc_map gather on both top-k
#: routes.
DOC_SORT_MIN_DOCS = 1 << 16

#: body T is padded to a multiple of this under the doc-sorted layout; the
#: layout gate (_doc_sort_pays) projects each block's sweep at this grain
DOC_SORT_TC = 32


def _doc_sort_pays(nt: np.ndarray) -> bool:
    """Project whether the bounded sweep actually wins on THIS corpus: the
    doc-sorted layout pads body T to a multiple of DOC_SORT_TC (32) and
    sweeps ~ceil(block_tmax/32)*32 rows per block, vs the natural layout's
    static T_pad (multiple of 8). On a uniform-T corpus (the synthetic
    scale shapes: 48 terms/doc) that padding can make the bounded layout
    cost more than it saves; crawled corpora skew. Gate on the projected
    per-block sweep from the sorted nt distribution."""
    t_nat = -(-max(int(nt.max(initial=1)), 1) // 8) * 8
    srt = np.sort(nt)[::-1]
    tmax = srt[:: DOC_BLOCK].astype(np.int64)  # per-block max = block head
    swept = np.maximum(-(-tmax // DOC_SORT_TC) * DOC_SORT_TC, DOC_SORT_TC)
    return float(swept.mean()) <= 0.9 * t_nat


def _doc_sort_perm(
    nt: np.ndarray, d_pad: int
) -> tuple[np.ndarray, np.ndarray]:
    """Doc permutation for the dynamic-T membership sweep: sort docs by
    descending distinct-term count so DOC_BLOCK blocks are T-homogeneous,
    then interleave whole blocks (snake assignment) so heavy and light
    blocks mix along the doc axis. Returns (perm [d_pad] new-pos ->
    old-doc, tmax [nb] per new block max nt). Scores are bitwise-exact:
    only pad slots are skipped."""
    order = np.argsort(-nt, kind="stable")
    tmax0 = nt[order].reshape(-1, DOC_BLOCK).max(axis=1)
    blk_order = np.argsort(-tmax0, kind="stable")
    half_a, half_b = [], []
    for i, blk in enumerate(blk_order):
        (half_a if i % 4 in (0, 3) else half_b).append(blk)
    blocks = np.array(half_a + half_b, dtype=np.int64)
    perm = order.reshape(-1, DOC_BLOCK)[blocks].reshape(-1)
    return perm, tmax0[blocks].astype(np.int32)


def _round_up(n: int, m: int = 128) -> int:
    return max(((n + m - 1) // m) * m, m)


class ForwardArrays(NamedTuple):
    """Doc-major forward index in both layouts: [D, T] for the XLA
    formulation, transposed [T, D] (doc axis contiguous) for the keyword
    kernel and the phrase stage; fj maps each doc-term to its CSR posting
    (sparse phrase matcher)."""

    ft: jax.Array  # int32 [D_pad, T]
    fw: jax.Array  # f32 [D_pad, T]
    fj: jax.Array  # int32 [D_pad, T] posting index (pad -> empty posting)
    ftT: jax.Array  # int32 [T, D_pad]
    fwT: jax.Array  # f32 [T, D_pad]


#: pos_mat is only materialized while P_pad * pos_cap * 4 bytes stays under
#: this budget (it is pure acceleration; the scalar-gather path is exact)
POS_MAT_BUDGET_BYTES = 512 << 20

#: doc-major positions (posT, the mixed lane's phrase layout) are built
#: while the resident plane (C*T_pad*D_pad bytes at 2 B/el under
#: POS_T_INT16, else 4) per section fits MemoryBudget.pos_t_bytes AND the
#: per-posting unique-position count stays <= POS_T_C_MAX; the engine
#: falls back to the sparse two-phase phrase lane when absent
POS_T_C_MAX = 32

#: store posT planes as int16 when every real position fits (mixed.py
#: quantize_posT): halves the plane's host and device footprint and the
#: bytes the phrase stage reads, dequantized per block to the exact f32
#: values (scores bitwise-identical). Falls back to f32 per section when a
#: pathological document has positions beyond POS16_MAX.
POS_T_INT16 = True

#: hot-term dense weight cache (body section): the H highest-df terms get
#: their exact [D_pad] tf-idf rows stored dense on device, so a query's hot
#: terms cost ONE f32 product (one-hot [B,H] @ W [H,D]) instead of a full
#: [T, D] compare sweep EACH — the sweep cost is per-term and
#: df-independent, while df-weighted query mixes concentrate on exactly
#: these terms. Cold terms keep the sweep. H = min(HOT_H_MAX, budget /
#: (D_pad*4)). The product reads the WHOLE [H, D] matrix per batch, so H is
#: capped by that read, not just by memory.
HOT_H_MAX = 512

#: shares of the index device's memory limit (memory_stats()["bytes_limit"])
#: granted to each optional resident structure; see MemoryBudget
POS_T_SHARE = 8  # posT plane, per section: 1/8 of the limit
HOT_W_SHARE = 16  # dense hot-term matrix: 1/16
FWD_DEV_SHARE = 8  # doc-major ft/fw/fj copies, per section: 1/8


@dataclass(frozen=True)
class MemoryBudget:
    """Byte budgets for the optional device-resident structures; None means
    no gate. for_device() derives them from the device's own memory limit;
    a device that reports none (the CPU backend) gets no gates, and callers
    that need one (tests) pass explicit budgets."""

    pos_t_bytes: int | None = None  # posT plane, per section
    hot_w_bytes: int | None = None  # dense hot-term matrix
    fwd_dev_bytes: int | None = None  # doc-major ft/fw/fj, per section

    @classmethod
    def for_device(cls, device=None) -> "MemoryBudget":
        if device is None:
            device = jax.local_devices()[0]
        stats = device.memory_stats() if hasattr(device, "memory_stats") else None
        limit = int((stats or {}).get("bytes_limit") or 0)
        if not limit:
            return cls()
        return cls(
            pos_t_bytes=limit // POS_T_SHARE,
            hot_w_bytes=limit // HOT_W_SHARE,
            fwd_dev_bytes=limit // FWD_DEV_SHARE,
        )


def _fits(nbytes: int, budget: int | None) -> bool:
    return budget is None or nbytes <= budget


def _build_hot_cache(
    csr: SectionCSR, d_pad: int, inv_perm: np.ndarray | None = None,
    budget: int | None = None,
) -> tuple[np.ndarray, dict[int, int]] | None:
    """Dense [H_pad, D_pad] f32 weight rows for the top-H df terms plus the
    term-id -> hot-slot map. None when the section is empty or the budget
    leaves no useful H. Only valid for candidacy-by-score engines (all
    weights > 0): callers gate on has_zero_weight. With inv_perm (doc-sorted
    layout) columns live in permuted doc space, matching the forward
    arrays."""
    n_post = csr.n_postings
    if n_post == 0:
        return None
    n_words = csr.post_offsets.shape[0] - 1
    df = np.diff(csr.post_offsets[: n_words + 1])
    h = min(HOT_H_MAX, n_words)
    if budget is not None:
        h = min(h, int(budget // max(d_pad * 4, 1)))
    if h >= 128:
        # keep the PADDED array inside the budget: h_pad rounds up to a
        # 128-row multiple
        h = (h // 128) * 128
    if h < 8:
        return None
    top = np.argsort(-df, kind="stable")[:h]
    top = top[df[top] > 0]
    if top.size == 0:
        return None
    h_pad = _round_up(int(top.size), 128)  # 128-row multiple; pad rows 0
    w = np.zeros((h_pad, d_pad), np.float32)
    for slot, wid in enumerate(top.tolist()):
        s, e = int(csr.post_offsets[wid]), int(csr.post_offsets[wid + 1])
        cols = csr.doc_ids[s:e]
        if inv_perm is not None:
            cols = inv_perm[cols]
        w[slot, cols] = csr.weights[s:e]
    return w, {int(wid): slot for slot, wid in enumerate(top.tolist())}


def _build_posT(
    csr: SectionCSR, fj: np.ndarray, d_pad: int, pos_big: float,
    bytes_per_el: int = 4, budget: int | None = None,
) -> tuple[np.ndarray, int] | None:
    """Doc-major positions for the mixed lane's phrase stage (see
    build_posT_raw; this wrapper unpacks a SectionCSR)."""
    return build_posT_raw(
        csr.pos_offsets, csr.positions, csr.n_postings, csr.doc_ids.shape[0],
        fj, d_pad, pos_big, bytes_per_el=bytes_per_el, budget=budget,
    )


def build_posT_raw(
    pos_offsets: np.ndarray,  # int32 [>= n_post+1] (padded tail repeats ok)
    positions: np.ndarray,
    n_post: int,
    p_pad: int,  # padded posting-slot count fj indexes into
    fj: np.ndarray,  # int32 [D, T] posting index per doc-term slot
    d_pad: int,
    pos_big: float,
    bytes_per_el: int = 4,  # 2 when the caller will quantize to int16:
    # the budget gates the RESIDENT plane, and int16 planes (POS_T_INT16)
    # keep the mixed lane live at ~2x the doc count
    budget: int | None = None,  # bytes; None = no gate
) -> tuple[np.ndarray, int] | None:
    """Doc-major positions for the mixed lane's phrase stage:

        posT[c*T + t, d] = c-th UNIQUE position of doc d's term-slot t

    (c-major rows so the slot-c view posT[c*T:(c+1)*T] is a contiguous
    [T, D] plane). Pad = pos_big (finite and never equal to a shifted real
    position). Duplicate
    positions within a posting (e.g. repeated anchor -100s) carry no chain
    information and are blanked, which also caps C at the max UNIQUE
    position count. Returns None when C would exceed POS_T_C_MAX or the
    array would exceed the budget."""
    d, t = fj.shape
    pos_off = pos_offsets.astype(np.int64)
    if n_post == 0:
        return np.full((1 * t, d_pad), pos_big, np.float32), 1
    # dedupe positions WITHIN each posting first (they are sorted per
    # posting, so duplicates are adjacent; an element is kept iff it opens
    # its posting or differs from its predecessor)
    l_total = int(pos_off[n_post])
    plen = np.diff(pos_off[: n_post + 1])
    raw = positions[:l_total]
    seg_first = np.zeros(max(l_total, 1), bool)
    seg_first[pos_off[:n_post][plen > 0]] = True
    # an element is a true intra-posting duplicate iff it equals its
    # predecessor AND does not open its posting (boundary equality between
    # consecutive postings is not a duplicate)
    dup = np.empty(max(l_total, 1), bool)
    dup[0] = False
    if l_total:
        dup[1:] = (raw[1:] == raw[:-1]) & ~seg_first[1:]
    if l_total == 0 or not bool(dup.any()):
        # fast path — no posting has an intra-posting duplicate: body
        # positions are unique by construction and titles only duplicate
        # the -100 sentinel, so this skips the dedup gather pass
        # (measured the dominant cost of the 1M sharded index build)
        c = max(int(plen.max(initial=1)), 1)
        if c > POS_T_C_MAX or not _fits(c * t * d_pad * bytes_per_el, budget):
            return None
        pos_u = raw
        off_u = np.zeros(p_pad + 1, np.int64)
        off_u[: n_post + 1] = pos_off[: n_post + 1]
        off_u[n_post + 1 :] = off_u[n_post]
    else:
        keep = ~dup[:l_total]
        pos_u = raw[keep]
        # unique count per posting from the kept-prefix sums (no
        # repeat/bincount: both were multi-second at 52M postings)
        ksum = np.zeros(l_total + 1, np.int64)
        np.cumsum(keep, out=ksum[1:])
        uniq = ksum[pos_off[1 : n_post + 1]] - ksum[pos_off[:n_post]]
        c = max(int(uniq.max(initial=1)), 1)
        if c > POS_T_C_MAX or not _fits(c * t * d_pad * bytes_per_el, budget):
            return None
        # deduped offsets, extended over padded posting slots (empty ranges)
        off_u = np.zeros(p_pad + 1, np.int64)
        off_u[1 : n_post + 1] = np.cumsum(uniq)
        off_u[n_post + 1 :] = off_u[n_post]
    # np.empty, NOT np.full: the chunk loop assigns EVERY row of columns
    # [0, d), so only the pad-doc tail needs the pos_big fill (np.full on
    # the 1M body posT was 4.1 GB / ~19 s of pure pad writes)
    out = np.empty((c * t, d_pad), np.float32)
    if d_pad > d:
        out[:, d:] = pos_big
    l_guard = max(len(pos_u) - 1, 0)
    pos_u = (
        np.concatenate([pos_u, [pos_big]]).astype(np.float32)
        if len(pos_u) else np.array([pos_big], np.float32)
    )
    # int32 halves the index-math bandwidth (safe: position-list lengths
    # are far below 2^31; keep int64 for a pathological giant section)
    off_u32 = off_u.astype(np.int32) if off_u[-1] < 2**31 - c - 1 else off_u
    chunk = max(1, (64 << 20) // max(t * c * 4, 1))  # bound transient memory
    ar_c = np.arange(c, dtype=np.int32)[:, None, None]  # [C, 1, 1]
    for d0 in range(0, d, chunk):
        d1 = min(d0 + chunk, d)
        fj_blk = fj[d0:d1].T  # [T, db]
        start = off_u32[fj_blk]
        end = off_u32[fj_blk + 1]
        # compute straight in [C, T, db] order: the final reshape to
        # [C*T, db] is then a view, not the strided 64 MB copy per chunk
        # that transpose(2, 1, 0) forced (~10 s of the 1M build)
        idx = start[None] + ar_c  # [C, T, db] int32
        valid = idx < end[None]
        pos = np.where(valid, pos_u[np.minimum(idx, l_guard)], pos_big)
        out[:, d0:d1] = pos.reshape(c * t, d1 - d0)
    return out, c


@dataclass
class DeviceSection:
    offsets: jax.Array  # int32 [V+2]; row V is the sentinel empty row
    doc_ids: jax.Array  # int32 [P_pad]
    weights: jax.Array  # f32 [P_pad]
    pos_offsets: jax.Array  # int32 [P_pad+1]
    positions: jax.Array  # f32 [L_pad]
    fwd: ForwardArrays
    # fixed-width per-posting position rows [P_pad, pos_cap], inf-padded:
    # turns the phrase matcher's per-element position gather into row
    # gathers (ops/phrase.py match_phrase_fwd); None when over budget
    pos_mat: jax.Array | None = None
    # doc-major positions [C*T_pad, D_pad] for the mixed lane's phrase
    # stage (ops/kernels/mixed.py); None when over budget / C too wide —
    # the engine then falls back to the two-phase sparse phrase lane
    posT: jax.Array | None = None
    pos_c: int = 0
    # True when some doc's dense forward row was truncated (doc_term_cap):
    # the forward phrase matcher would then under-match, so the engine
    # routes phrase queries through the exact CSR matcher instead
    dense_truncated: bool = False
    # True when some real posting weight is <= 0 (a df==N term has idf 0,
    # reference weighting indexer.go normTF*log2(N/df)): candidacy then
    # needs true counts; otherwise the kernels may elide count accumulation
    # because candidacy <=> score > 0
    has_zero_weight: bool = False
    # per-DOC_BLOCK max distinct-term count (i32 [D_pad//DOC_BLOCK], the
    # keyword kernel's dynamic-T bound); only set for the body section
    # under the doc-sorted layout
    tmax_blocks: jax.Array | None = None
    # placement target for lazy uploads (fwd_device)
    device: object | None = None
    _fwd_lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def fwd_device(self) -> "ForwardArrays":
        """The forward arrays with ft/fw/fj ON DEVICE. Over the device's
        fwd budget those stay host-side at build (the keyword kernel and
        the mixed lane never read them) — the sparse phrase matcher
        upgrades them here, once, under a lock so concurrent callers
        upload one copy, and the result is memoized."""
        with self._fwd_lock:
            f = self.fwd
            if not isinstance(f.ft, np.ndarray):
                return f
            put = lambda x: jax.device_put(x, self.device)  # noqa: E731
            f = ForwardArrays(
                ft=put(f.ft), fw=put(f.fw), fj=put(f.fj), ftT=f.ftT, fwT=f.fwT
            )
            self.fwd = f
            return f

    @classmethod
    def from_csr(
        cls, csr: SectionCSR, n_docs: int, d_pad: int, device=None,
        doc_term_cap: int | None = None, pos_cap: int | None = None,
        perm: np.ndarray | None = None,  # [d_pad] new pos -> old doc
        inv_full: np.ndarray | None = None,  # [n_docs+1] old -> new, pad -> d_pad
        tmax_blocks: np.ndarray | None = None,  # body only (doc-sorted)
        t_multiple: int = 8,
        budget: MemoryBudget | None = None,  # None: MemoryBudget.for_device
    ) -> "DeviceSection":
        if doc_term_cap is None:
            doc_term_cap = DOC_TERM_CAP
        if budget is None:
            budget = MemoryBudget.for_device(device)
        put = lambda x: jax.device_put(x, device)  # noqa: E731
        pos_mat = None
        p_pad = csr.doc_ids.shape[0]
        if pos_cap and p_pad * pos_cap * 4 <= POS_MAT_BUDGET_BYTES:
            n_post = csr.n_postings
            pm = np.full((p_pad, pos_cap), np.inf, np.float32)
            if n_post:
                pidx = csr.pos_offsets[:n_post, None] + np.arange(
                    pos_cap, dtype=np.int64
                )
                pvalid = pidx < csr.pos_offsets[1 : n_post + 1, None]
                pm[:n_post] = np.where(
                    pvalid,
                    csr.positions[np.minimum(pidx, csr.positions.shape[0] - 1)],
                    np.inf,
                )
            pos_mat = put(pm)
        # append sentinel row (empty range) for unknown/padded term ids
        offsets = np.concatenate([csr.post_offsets, csr.post_offsets[-1:]])
        n_post = csr.n_postings
        max_terms = int(np.bincount(
            csr.doc_ids[:n_post], minlength=max(n_docs, 1)
        ).max(initial=0)) if n_post else 0
        truncated = doc_term_cap is not None and max_terms > doc_term_cap
        zero_w = bool(n_post) and bool((csr.weights[:n_post] <= 0).any())
        ft, fw, fj = csr.forward_with_postings(n_docs, doc_term_cap=doc_term_cap)
        pad_rows = d_pad - n_docs
        ft = np.concatenate([ft, np.full((pad_rows, ft.shape[1]), -1, np.int32)])
        fw = np.concatenate([fw, np.zeros((pad_rows, fw.shape[1]), np.float32)])
        fj = np.concatenate(
            [fj, np.full((pad_rows, fj.shape[1]), csr.doc_ids.shape[0] - 1, np.int32)]
        )
        if perm is not None:
            # doc-sorted layout: rows in permuted doc space; the CSR's
            # device doc_ids are remapped below so every formulation (dense
            # sweep, CSR scatter, phrase matchers) agrees on doc indices
            ft, fw, fj = ft[perm], fw[perm], fj[perm]
        t_col_pad = (-ft.shape[1]) % t_multiple
        if t_col_pad:
            # dynamic-T sweep reads tc-row chunks: pad T up (empty slots)
            ft = np.concatenate(
                [ft, np.full((d_pad, t_col_pad), -1, np.int32)], axis=1
            )
            fw = np.concatenate(
                [fw, np.zeros((d_pad, t_col_pad), np.float32)], axis=1
            )
            fj = np.concatenate(
                [fj, np.full((d_pad, t_col_pad), csr.doc_ids.shape[0] - 1, np.int32)],
                axis=1,
            )
        posT = None
        pos_c = 0
        if not truncated:  # truncated rows route to CSR anyway
            from ..ops.kernels.mixed import POS_BIG

            built = _build_posT(
                csr, fj, d_pad, POS_BIG,
                bytes_per_el=2 if POS_T_INT16 else 4,
                budget=budget.pos_t_bytes,
            )
            if built is not None:
                posT_np, pos_c = built
                if POS_T_INT16:
                    from ..ops.kernels.mixed import quantize_posT

                    q16 = quantize_posT(posT_np)
                    if q16 is not None:
                        posT_np = q16
                if (posT_np.dtype != np.int16
                        and not _fits(posT_np.nbytes, budget.pos_t_bytes)):
                    # quantization refused (pathological positions) and the
                    # f32 plane only fit under the 2-byte budget: drop it
                    posT_np, pos_c = None, 0
                posT = put(posT_np) if posT_np is not None else None
        # doc-major ft/fw/fj feed the sparse phrase matcher and the XLA
        # formulation; the keyword kernel and the mixed lane read ftT/fwT
        # (+posT). Over the fwd budget they stay HOST-side and upgrade
        # lazily via fwd_device() if a sparse-lane path ever runs. When
        # posT is absent the sparse lane IS the serving path: upload.
        fwd_eager = (
            _fits(ft.nbytes + fw.nbytes + fj.nbytes, budget.fwd_dev_bytes)
            or posT is None or truncated
        )
        fwd = ForwardArrays(
            ft=put(ft) if fwd_eager else ft,
            fw=put(fw) if fwd_eager else fw,
            fj=put(fj) if fwd_eager else fj,
            ftT=put(np.ascontiguousarray(ft.T)),
            fwT=put(np.ascontiguousarray(fw.T)),
        )
        doc_ids_np = csr.doc_ids if inv_full is None else inv_full[csr.doc_ids]
        return cls(
            offsets=put(offsets.astype(np.int32)),
            doc_ids=put(doc_ids_np),
            weights=put(csr.weights),
            pos_offsets=put(csr.pos_offsets),
            positions=put(csr.positions),
            fwd=fwd,
            pos_mat=pos_mat,
            posT=posT,
            pos_c=pos_c,
            dense_truncated=truncated,
            has_zero_weight=zero_w,
            tmax_blocks=(
                None if tmax_blocks is None else put(tmax_blocks.astype(np.int32))
            ),
            device=device,
        )

    # convenience aliases used by the XLA formulation and tests
    @property
    def ft(self) -> jax.Array:
        return self.fwd.ft

    @property
    def fw(self) -> jax.Array:
        return self.fwd.fw


@dataclass
class DeviceIndex:
    title: DeviceSection
    body: DeviceSection
    mag_title: jax.Array  # f32 [D_pad]
    mag_body: jax.Array  # f32 [D_pad]
    pagerank: jax.Array  # f32 [D_pad, C] (C >= 1; zeros when no topics)
    pagerankT: jax.Array  # f32 [C, D_pad] (doc axis contiguous)
    n_docs: int  # true doc count (hydration bound)
    n_docs_padded: int
    n_words: int
    posting_cap: int  # covers max df across both sections
    pos_cap: int  # covers max positions per posting
    # hot-term dense body-weight cache (see _build_hot_cache); None when
    # the index has zero weights (candidacy needs true counts), is
    # dense-truncated (scoring routes through CSR), or the budget bars it
    hot_body_w: jax.Array | None = None  # f32 [H_pad, D_pad]
    hot_body_map: dict[int, int] | None = None  # term id -> hot slot
    # doc-sorted layout (see _doc_sort_perm): every doc-axis array above
    # lives in permuted doc space; doc_perm maps permuted position ->
    # natural doc id (pads -> >= n_docs) and the scorers gather through it
    # after top-k so callers always see natural ids
    doc_perm: jax.Array | None = None  # int32 [D_pad]
    doc_perm_np: np.ndarray | None = None

    @classmethod
    def from_snapshot(
        cls, snap: IndexSnapshot, device=None, doc_sort: bool | None = None,
        budget: MemoryBudget | None = None,  # None: MemoryBudget.for_device
    ) -> "DeviceIndex":
        if budget is None:
            budget = MemoryBudget.for_device(device)
        put = lambda x: jax.device_put(x, device)  # noqa: E731
        d_pad = _round_up(max(snap.n_docs, 1), DOC_BLOCK)

        def section_nt(csr: SectionCSR) -> np.ndarray:
            n_post = csr.n_postings
            if not n_post:
                return np.zeros(d_pad, np.int32)
            return np.bincount(
                csr.doc_ids[:n_post], minlength=d_pad
            ).astype(np.int32)

        # doc-sorted layout: default-on at the large-corpus tier where the
        # static-T membership sweep dominates; off when any dense row would
        # truncate (scoring then routes through the CSR path, which wants
        # natural order and real-prefix slicing)
        title_nt = section_nt(snap.title)
        body_nt = section_nt(snap.body)
        truncatable = (
            int(title_nt.max(initial=0)) > DOC_TERM_CAP
            or int(body_nt.max(initial=0)) > DOC_TERM_CAP
        )
        if doc_sort is None:
            doc_sort = d_pad >= DOC_SORT_MIN_DOCS and _doc_sort_pays(body_nt)
        doc_sort = doc_sort and not truncatable and snap.n_docs > 0
        perm = inv_full = body_tmax = None
        t_multiple = 8
        if doc_sort:
            perm, body_tmax = _doc_sort_perm(body_nt, d_pad)
            inv = np.empty(d_pad, np.int32)
            inv[perm] = np.arange(d_pad, dtype=np.int32)
            inv_full = np.empty(snap.n_docs + 1, np.int32)
            inv_full[: snap.n_docs] = inv[: snap.n_docs]
            inv_full[snap.n_docs] = d_pad  # CSR pad doc id -> out-of-range
            t_multiple = DOC_SORT_TC

        def pad_docs(a: np.ndarray) -> np.ndarray:
            out = np.zeros((d_pad,) + a.shape[1:], dtype=a.dtype)
            out[: a.shape[0]] = a
            return out[perm] if perm is not None else out

        if snap.pagerank is not None and snap.pagerank.shape[1] > 0:
            pr = snap.pagerank
        else:
            pr = np.zeros((snap.n_docs, 1), dtype=np.float32)
        posting_cap = _round_up(max(snap.title.max_df, snap.body.max_df, 1))
        pos_cap = _round_up(max(snap.title.max_positions, snap.body.max_positions, 1), 8)
        title = DeviceSection.from_csr(
            snap.title, snap.n_docs, d_pad, device, pos_cap=pos_cap,
            perm=perm, inv_full=inv_full, t_multiple=t_multiple,
            budget=budget,
        )
        body = DeviceSection.from_csr(
            snap.body, snap.n_docs, d_pad, device, pos_cap=pos_cap,
            perm=perm, inv_full=inv_full, tmax_blocks=body_tmax,
            t_multiple=t_multiple, budget=budget,
        )
        hot_w = hot_map = None
        if not (
            title.has_zero_weight
            or body.has_zero_weight
            or title.dense_truncated
            or body.dense_truncated
        ):
            built = _build_hot_cache(
                snap.body, d_pad,
                inv_perm=None if inv_full is None else inv_full[: snap.n_docs],
                budget=budget.hot_w_bytes,
            )
            if built is not None:
                hot_np, hot_map = built
                hot_w = put(hot_np)
        return cls(
            title=title,
            body=body,
            mag_title=put(pad_docs(snap.mag_title)),
            mag_body=put(pad_docs(snap.mag_body)),
            pagerank=put(pad_docs(pr)),
            pagerankT=put(np.ascontiguousarray(pad_docs(pr).T)),
            n_docs=snap.n_docs,
            n_docs_padded=d_pad,
            n_words=snap.n_words,
            posting_cap=posting_cap,
            pos_cap=pos_cap,
            hot_body_w=hot_w,
            hot_body_map=hot_map,
            doc_perm=None if perm is None else put(perm.astype(np.int32)),
            doc_perm_np=None if perm is None else perm.astype(np.int32),
        )

    @property
    def n_categories(self) -> int:
        return int(self.pagerank.shape[1])

    @property
    def match_pad(self) -> int:
        """Doc-id pad/sentinel for matcher outputs and phrase fold arrays:
        real ids are < match_pad. Natural layout pads postings with n_docs;
        the doc-sorted layout scatters real docs across [0, d_pad) so its
        sentinel is d_pad (device doc_ids are remapped accordingly)."""
        return self.n_docs_padded if self.doc_perm is not None else self.n_docs

    @property
    def dense_truncated(self) -> bool:
        return self.title.dense_truncated or self.body.dense_truncated

    @property
    def pos_dense(self) -> bool:
        """True when both sections carry the doc-major position layout the
        mixed lane's phrase stage reads (ops/kernels/mixed.py)."""
        return self.title.posT is not None and self.body.posT is not None

    @property
    def has_zero_weight(self) -> bool:
        return self.title.has_zero_weight or self.body.has_zero_weight
