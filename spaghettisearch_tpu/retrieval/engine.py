"""The query engine: host query parsing + one jit'd device program per batch.

Online path equivalent of the reference's Retrieve (reference:
retrieval/main_retrieve.go:15-104), restructured for a batched device: the per-term /
per-doc goroutine fan-out becomes array vectorization inside
ops.scoring.score_queries, and candidates come back as a dense top-k.

Query grammar parity:
- "..." spans are phrases (regex `".*?"`, reference: util.go:151-160), removed
  from the keyword part;
- all phrase spans concatenate into ONE token sequence evaluated as a single
  positional chain (reference: main_retrieve.go:26,45 passes the joined list);
- query_len for cosine normalization = #keyword tokens + #phrase tokens
  (reference: main_retrieve.go:90).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MAX_KEYWORDS, MAX_LINKED_DOCS, MAX_RESULTS, EngineConfig
from ..index.snapshot import IndexSnapshot, build_snapshot
from ..models.blended import BlendedRanker
from ..ops.phrase import match_phrase_batch, match_phrase_fwd_batch
from ..store.docinfo import ZERO_TIME, DocInfo
from ..store.tables import Database
from ..utils.hashing import md5_hex
from ..utils.timing import TRACER
from .device_index import DeviceIndex
from .summary import get_summary
from .topics import compute_topic_probs

_PHRASE_RE = re.compile(r'".*?"')


@dataclass
class ParsedQuery:
    raw: str
    stripped: str  # query text with phrase spans removed
    phrases: list[str]  # phrase texts (no quotes)
    keyword_hashes: list[str]
    phrase_hashes: list[str]

    @property
    def query_len(self) -> int:
        return len(self.keyword_hashes) + len(self.phrase_hashes)

    @property
    def is_empty(self) -> bool:
        return self.query_len == 0


def parse_query(text: str) -> ParsedQuery:
    from ..text.laundry import laundry

    spans = _PHRASE_RE.findall(text)
    phrases = [s[1:-1] for s in spans]
    stripped = text
    for ph in phrases:
        stripped = stripped.replace('"' + ph + '"', "", 1)
    keywords = laundry(" ".join(stripped.split()))
    phrase_tokens = laundry(" ".join(phrases))
    return ParsedQuery(
        raw=text,
        stripped=stripped,
        phrases=phrases,
        keyword_hashes=[md5_hex(w) for w in keywords],
        phrase_hashes=[md5_hex(w) for w in phrase_tokens],
    )


def _bucket(n: int, step: int = 4) -> int:
    """Round up to a step multiple (pads dynamic sizes into a small set of
    static shapes so jit retraces stay bounded)."""
    return max(((n + step - 1) // step) * step, step)


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


# --------------------------------------------------------------------- #
# Compile-shape policy.
#
# Every jit axis a live query can reach must come from a FINITE set that
# warmup() pre-compiles — a fresh XLA compile takes seconds while the
# micro-batcher holds the rank lock, stalling all traffic. Common shapes get
# fine-grained buckets; rare shapes all collapse onto one padded catch-all
# program (padding costs little, a fresh compile costs seconds):
#
#   batch b : {B_SMALL, WARM_B_MAX} ONLY — the qn-sorted kernel skips
#             all-pad row blocks' compare loops, so padding a 17-query
#             batch to 128 costs little while every extra live program
#             costs a compile and a first-use settle (see _settle_live);
#             any rare axis below forces b to WARM_B_MAX so only ONE
#             catch-all program exists per family
#   keywords q : Q_BASE (covers almost all queries) or Q_CATCHALL; terms
#             beyond Q_CATCHALL are dropped (a >32-stemmed-keyword query is
#             degenerate; divergence from the reference documented here)
#   phrase terms p : 4 (batched) | 8 | 16 (matched one query at a time);
#             phrase tokens beyond 16 are dropped likewise
#   phrase fold width e : E_BASE, then per-index levels up to pow2(n_docs)
# --------------------------------------------------------------------- #
WARM_B_MAX = 128
B_SMALL = 16  # low-latency bucket for trickle traffic / CLI single queries
B_BIG = 256  # opt-in wide bucket (engine.big_batch / server --bigBatch):
# when the serving wall is a per-execution overhead rather than the kernel
# itself, amortizing it over 256 rows pays; costs 2 extra mixed-family
# programs' warmup, so it is OFF by default
B_PHRASE = 32  # opt-in mixed bucket for stale pure-phrase cohorts
# (engine.phrase_b32 / server --phraseStale pure): a patience-expired
# phrase cohort dispatches standalone at (32, Q_BASE) instead of merging
# into the next 128-row arrival-order batch. The mixed program's phrase
# stage runs over every doc whatever the row count, so this trades
# throughput for phrase latency; OFF by default
_MATCH_FETCH_K = 256  # matcher fetch compression width (top-K real matches)
MATCHER_BP = (1, 4, 16)  # phrase-matcher vmap widths (chunked above 16)
Q_BASE = 4
Q_CATCHALL = 32
P_BASE = 4
P_LEVELS = (P_BASE, 8, 16)
E_BASE = 64
E_MID = 4096
# phrase-class batch segregation advice threshold (class_batching_pays):
# below this doc count the mixed program costs little more than the keyword
# program, so class-pure batching buys nothing
SEGREGATE_MIN_DOCS = 1 << 19


def _p_level(n: int) -> int:
    for lvl in P_LEVELS:
        if n <= lvl:
            return lvl
    return P_LEVELS[-1]


def _b_bucket(n: int) -> int:
    """Batch bucket: {B_SMALL, WARM_B_MAX} (+B_BIG for batches the opt-in
    256-row batcher emits). Few programs per family, not eight: the
    kernel's qn bound makes pad rows nearly free, and the serving program
    set must stay small (every program is a compile and a warmup)."""
    if n <= B_SMALL:
        return B_SMALL
    if n <= WARM_B_MAX:
        return WARM_B_MAX
    return B_BIG


def _bp_bucket(n: int) -> int:
    for lvl in MATCHER_BP:
        if n <= lvl:
            return lvl
    return MATCHER_BP[-1]


def _e_levels(n_docs: int) -> tuple[int, ...]:
    # the phrase fold arrays upload as [B, e] from host per batch: at
    # e=pow2(100k) that is hundreds of MB of host memset + transfer per
    # batch, so mid levels matter even though each level is one more
    # program to settle
    full = _pow2(max(n_docs, E_BASE))
    return tuple(sorted({E_BASE, min(1024, full), min(8192, full), full}))


class _MultiRankHandle:
    """finish()-compatible concatenation of several chunk handles: batches
    wider than the warmed program set are SPLIT at dispatch instead of
    routing to a never-warmed batch width (a live compile stalls the batch
    for seconds) or overflowing the fill
    buffers (IndexError past B_BIG). All chunks are dispatched before any
    is fetched, so the device executions queue back-to-back."""

    __slots__ = ("_handles",)

    def __init__(self, handles) -> None:
        self._handles = handles

    def finish(self) -> tuple[np.ndarray, np.ndarray]:
        parts = [h.finish() for h in self._handles]
        return (
            np.concatenate([p[0] for p in parts], axis=0),
            np.concatenate([p[1] for p in parts], axis=0),
        )


class _RankHandle:
    """A dispatched-but-unfetched batch rank. The device executes (and the
    result transfers) asynchronously after dispatch; finish() blocks for the
    packed result. The micro-batcher uses the split to overlap batch N's
    device execution with batch N-1's host-side response assembly."""

    __slots__ = ("_packed", "_shape", "_inv", "_b_real")

    def __init__(self, scores, ids, inv, b_real) -> None:
        # pack on device: one d2h transfer, not two
        self._packed = jnp.concatenate(
            [scores.reshape(-1), ids.astype(jnp.float32).reshape(-1)]
        )
        # start the d2h transfer the moment the device program finishes:
        # queued here (non-blocking), it rides out batch N+1's compute, so
        # finish()'s np.asarray finds the bytes already host-side.
        try:
            self._packed.copy_to_host_async()
        except AttributeError:  # non-jax array (tests, fallbacks)
            pass
        self._shape = scores.shape
        self._inv = inv
        self._b_real = b_real

    def finish(self) -> tuple[np.ndarray, np.ndarray]:
        packed = np.asarray(self._packed)
        n = packed.shape[0] // 2
        s = packed[:n].reshape(self._shape)
        i = packed[n:].reshape(self._shape).astype(np.int32)
        return s[self._inv][: self._b_real], i[self._inv][: self._b_real]


def _cap_levels(posting_cap: int) -> tuple[int, ...]:
    """Phrase-matcher posting-window levels. The matcher's cost is linear in
    the static cap (it gathers 2*cap candidate rows per section); two
    levels {128, full} would make ANY phrase whose generator df exceeded 128
    pay the full-index worst case. Geometric levels bound each phrase's
    cost to ~its own generator df."""
    return tuple(sorted({min(128, posting_cap), min(2048, posting_cap),
                         posting_cap}))


@dataclass
class QueryEngine:
    db: Database
    snapshot: IndexSnapshot | None = None
    index: DeviceIndex | None = None
    config: EngineConfig = field(default_factory=EngineConfig)
    model: BlendedRanker = field(default_factory=BlendedRanker)
    use_topic_model: bool = False  # reference ships with the model disabled
    # reference quirk: its naive-Bayes product is seeded at 0 so enabled
    # still yields zero probabilities; fixed=True seeds at 1 (usable model)
    topic_model_fixed: bool = False
    device: object | None = None
    # opt-in B_BIG=256 batch bucket (see the compile-shape policy header).
    # Only meaningful with a fused-mixed-capable index: the legacy sparse
    # lane's program families were never warmed at 256 (rank_async ignores
    # the flag there). The catch-all (q > Q_BASE) program moves to
    # (B_BIG, Q_CATCHALL) so exactly one catch-all exists per family.
    big_batch: bool = False
    # opt-in B_PHRASE=32 mixed bucket for pure-phrase fused-lane batches
    # (the micro-batcher's ph_stale="pure" policy emits them at patience
    # expiry); adds exactly one mixed (32, Q_BASE) program to the warmed set
    phrase_b32: bool = False
    # doc-sorted device layout (DeviceIndex doc_sort / _doc_sort_perm);
    # None = auto (on at the >=256k-padded-doc tier)
    doc_sort: bool | None = None

    def __post_init__(self) -> None:
        if self.snapshot is None:
            self.snapshot = build_snapshot(self.db)
        if self.index is None:
            self.index = DeviceIndex.from_snapshot(
                self.snapshot, self.device, doc_sort=self.doc_sort
            )
        if hasattr(self.model, "prepare"):  # model-specific device arrays
            self.model.prepare(self.snapshot, self.index, self.device)
        # the (snapshot, index, model) triple readers must see together: a
        # single attribute store is atomic under the GIL, separates are not
        self._live = (self.snapshot, self.index, self.model)

    # ------------------------------------------------------------------ #
    # refresh: build OFF the serving lock, commit in O(pointer swap)
    # ------------------------------------------------------------------ #

    def prepare_refresh(self, warm: bool = True):
        """Build the NEXT live state — snapshot, device index, prepared
        model, and (for disk stores) a freshly-opened Database that sees
        every row other processes appended. Safe to run off the serving
        lock: nothing live is touched. The reference instead mutates rows
        in place under a global mutex (SURVEY §2.4); this design is
        immutable snapshots + atomic swap, and this is the build half.

        With warm=True (default) the NEW state's full compile-shape matrix
        is walked here, off-lock: a crawl that grows the corpus past a
        padding boundary (D_pad steps by 512 docs, T_pad by 8 terms, new
        e-levels) changes every jit shape, and without this the first live
        query after the swap would pay a fresh XLA compile while holding
        the serving read lock."""
        import copy

        new_db = None
        db = self.db
        if self.db.root is not None:
            # our own handles may hold buffered appends the fresh open
            # must see (swap-before-flush dropped rows)
            for t in self.db.tables.values():
                t.flush_bulk()
                if hasattr(t._kv, "flush"):
                    t._kv.flush()
            new_db = Database(self.db.root, backend=self.db.backend_kind)
            db = new_db
        snapshot = build_snapshot(db)
        index = DeviceIndex.from_snapshot(
            snapshot, self.device, doc_sort=self.doc_sort
        )
        model = self.model
        if hasattr(model, "prepare"):
            # prepare into a CLONE: the live model's device arrays stay
            # consistent for in-flight queries on the old live triple
            model = copy.copy(model)
            model.prepare(snapshot, index, self.device)
        if warm:
            ghost = copy.copy(self)
            ghost.db = db
            ghost.snapshot, ghost.index, ghost.model = snapshot, index, model
            ghost._live = (snapshot, index, model)
            ghost.warmup()
            ghost.prewarm_hydration()
            ghost.prewarm_wordlist()
        return (new_db, snapshot, index, model)

    def commit_refresh(self, state):
        """Swap in a prepared live state — O(pointer stores). Caller must
        exclude concurrent readers (the server holds its write lock).
        Returns the superseded Database (or None) for the CALLER to close
        AFTER releasing the lock: closing a crawl-scale store flushes and
        frees for seconds, which must not stall queries."""
        new_db, snapshot, index, model = state
        old_db = self.db if new_db is not None else None
        if new_db is not None:
            self.db = new_db
        self.model = model
        self._live = (snapshot, index, model)
        self.snapshot, self.index = snapshot, index
        return old_db

    def refresh(self) -> None:
        """Rebuild the snapshot + device index from the store and swap
        atomically. In-flight queries holding the old live triple keep the
        old arrays alive (but the server must serialize refresh vs store
        readers — see serve/server.py's reader-writer lock). Convenience
        form for batch jobs/tests: skips the off-lock warmup (the server's
        /refresh calls prepare_refresh() directly, which warms)."""
        old_db = self.commit_refresh(self.prepare_refresh(warm=False))
        if old_db is not None:
            old_db.close()

    # ------------------------------------------------------------------ #
    # device ranking
    # ------------------------------------------------------------------ #

    def class_batching_pays(self, live=None) -> bool:
        """Advise the micro-batcher whether phrase-class batch segregation
        pays on the current live index. One phrase-bearing query sends a
        whole batch down the mixed program, whose phrase stage runs over
        every doc; the cost gap vs the keyword program grows with doc
        count, so segregation is only worth the phrase-latency patience at
        the large tiers."""
        if live is None:
            live = self._live
        idx = live[1]
        model = live[2] if len(live) > 2 else self.model
        return (
            getattr(model, "supports_mixed", None) is not None
            and model.supports_mixed(idx)
            and idx.n_docs >= SEGREGATE_MIN_DOCS
        )

    def rank(
        self, parsed: list[ParsedQuery], topk: int = MAX_RESULTS, live=None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Device-rank a batch. Returns (scores [B,K], doc_ids [B,K]);
        non-candidate slots have score -inf."""
        return self.rank_async(parsed, topk, live).finish()

    def rank_async(
        self, parsed: list[ParsedQuery], topk: int = MAX_RESULTS, live=None
    ) -> _RankHandle:
        """Dispatch a batch rank and return immediately; the device (and the
        d2h transfer) proceed while the host does other work. Call
        .finish() on the returned handle for the (scores, ids) arrays."""
        if live is None:
            live = self._live
        snap, idx = live[0], live[1]
        model = live[2] if len(live) > 2 else self.model
        b_real = len(parsed)
        has_phrase = any(p.phrase_hashes for p in parsed)
        fused = has_phrase and getattr(model, "supports_mixed", None) is not None \
            and model.supports_mixed(idx)
        # with big_batch the warmed catch-all lives at (B_BIG, Q_CATCHALL)
        # for fused-lane and keyword-only batches; the legacy sparse phrase
        # lane keeps its (WARM_B_MAX, ...) families
        b_catch = (
            B_BIG if self.big_batch and (fused or not has_phrase)
            else WARM_B_MAX
        )
        if b_real > b_catch:
            # wider than any warmed program for this lane (the micro-batcher
            # never emits these, but /query_batch accepts arbitrary lists):
            # split rather than compile a live batch shape — or overflow
            # the (b, q) fill buffers outright past B_BIG
            return _MultiRankHandle([
                self.rank_async(parsed[i : i + b_catch], topk, live)
                for i in range(0, b_real, b_catch)
            ])
        # bucket the batch axis to a power of two: the micro-batcher emits
        # arbitrary coalesced sizes, and every distinct b would otherwise
        # compile its own XLA program
        b = _b_bucket(b_real)
        if (
            self.phrase_b32
            and fused
            and B_SMALL < b_real <= B_PHRASE
            and all(p.phrase_hashes for p in parsed)
        ):
            # opt-in stale-cohort shape: a pure-phrase batch of 17..32 rows
            # rides its own (B_PHRASE, Q_BASE) mixed program instead of a
            # 128-row pad (see B_PHRASE note; warmed in warmup())
            b = B_PHRASE
        q_real = max((len(p.keyword_hashes) for p in parsed), default=1)
        if q_real <= Q_BASE:
            q = Q_BASE
        else:
            # rare long-keyword shape -> the single warmed catch-all program
            q = Q_CATCHALL
            if b < b_catch:
                b = b_catch
            if q_real > Q_CATCHALL:
                import logging

                logging.getLogger("spaghettisearch.engine").warning(
                    "query has %d keyword terms; scoring the first %d",
                    q_real, Q_CATCHALL,
                )
        if fused:
            return self._rank_fused(parsed, topk, live, b, q, q_real, b_real)
        matches: list[tuple[np.ndarray, ...]] = []
        e = E_BASE
        if has_phrase:
            # phrase matches: batched device positional intersection, then
            # host-compress the sparse results so the fold-in scatter is tiny
            matches = [(np.zeros(0, np.int32),) * 4 for _ in parsed]
            ph_rows = [i for i, p in enumerate(parsed) if p.phrase_hashes]
            batch = self._match_phrases_batch(
                [parsed[i].phrase_hashes for i in ph_rows], live
            )
            for i, (d, tw, bw, fl) in zip(ph_rows, batch):
                real = d < idx.match_pad
                matches[i] = (d[real], tw[real], bw[real], fl[real])
            e_real = max((len(m[0]) for m in matches), default=1)
            levels = _e_levels(idx.n_docs)
            e = next(lvl for lvl in levels if e_real <= lvl)
            if e > E_BASE:
                # rare wide-fold shape -> catch-all program; q keeps its own
                # bucket (escalating q to Q_CATCHALL would make every wide
                # phrase pay an 8x keyword-compare scan); pad rows are
                # near-free since the kernel bounds qn=0 row blocks
                if q_real > Q_BASE:
                    q = Q_CATCHALL
                if b < WARM_B_MAX:
                    b = WARM_B_MAX

        hot_map = self._hot_map(model, idx)
        term_ids, qlen, qn, qnb, hot_sids = self._fill_keyword_rows(
            parsed, b, q, snap, hot_map
        )

        topic_probs = np.zeros((b, idx.n_categories), dtype=np.float32)
        if self.use_topic_model:
            for i, p in enumerate(parsed):
                probs = compute_topic_probs(
                    self.db, p.keyword_hashes, fixed=self.topic_model_fixed
                )
                for j, c in enumerate(snap.categories):
                    topic_probs[i, j] = probs.get(c, 0.0)

        # a truncated dense forward view would mis-score (and can even drop
        # candidacy for) docs with >doc_term_cap distinct terms; the CSR is
        # always complete, so production scoring routes through it then
        use_csr = idx.dense_truncated

        # sort the batch by descending term count: each kernel row block
        # then runs its compare loop only to the block max, so 1-2 term
        # queries stop paying for phantom Q_BASE pad slots (results are
        # inverse-permuted back to request order below). With the hot-term
        # split the BODY sweep (the dominant cost) is bounded by qnb, so
        # cold-term count is the primary key
        perm = np.lexsort((-qn, -qnb))
        inv = np.empty_like(perm)
        inv[perm] = np.arange(b)
        term_ids, qlen, qn, qnb = term_ids[perm], qlen[perm], qn[perm], qnb[perm]
        hot_sids = hot_sids[perm]
        topic_probs = topic_probs[perm]
        hot_kw = (
            {"qnb": jnp.asarray(qnb), "hot_sids": jnp.asarray(hot_sids)}
            if hot_map is not None
            else {}
        )

        if not has_phrase:
            # fast path: forward-membership scorer (no scatter/gather)
            with TRACER.span("rank.device"):
                if use_csr:
                    scores, ids = model.score_csr(
                        idx, jnp.asarray(term_ids), jnp.asarray(qlen),
                        jnp.asarray(topic_probs), topk=topk,
                    )
                else:
                    scores, ids = model.score_keywords(
                        idx,
                        jnp.asarray(term_ids), jnp.asarray(qlen),
                        jnp.asarray(topic_probs), topk=topk, qn=jnp.asarray(qn),
                        **hot_kw,
                    )
                return _RankHandle(scores, ids, inv, b_real)

        # pad slot lands past the real doc range in the fold-in accumulator
        # and is dropped/sliced away (the doc-sorted layout never routes
        # through use_csr — DeviceIndex gates doc_sort on truncation)
        pad_doc = idx.n_docs if use_csr else idx.n_docs_padded
        ph_docs = np.full((b, e), pad_doc, dtype=np.int32)
        ph_tw = np.zeros((b, e), dtype=np.float32)
        ph_bw = np.zeros((b, e), dtype=np.float32)
        ph_fl = np.zeros((b, e), dtype=np.float32)
        for i, (d, tw, bw, fl) in enumerate(matches):
            n = len(d)
            ph_docs[i, :n], ph_tw[i, :n] = d, tw
            ph_bw[i, :n], ph_fl[i, :n] = bw, fl
        # matches were filled in request order; apply the qn sort permutation
        ph_docs, ph_tw = ph_docs[perm], ph_tw[perm]
        ph_bw, ph_fl = ph_bw[perm], ph_fl[perm]

        with TRACER.span("rank.device"):
            if use_csr:
                scores, ids = model.score_csr(
                    idx,
                    jnp.asarray(term_ids), jnp.asarray(qlen), jnp.asarray(topic_probs),
                    jnp.asarray(ph_docs), jnp.asarray(ph_tw), jnp.asarray(ph_bw),
                    jnp.asarray(ph_fl), topk=topk,
                )
            else:
                scores, ids = model.score_with_phrase(
                    idx,
                    jnp.asarray(term_ids), jnp.asarray(qlen), jnp.asarray(topic_probs),
                    jnp.asarray(ph_docs), jnp.asarray(ph_tw), jnp.asarray(ph_bw),
                    jnp.asarray(ph_fl), topk=topk, qn=jnp.asarray(qn),
                    **hot_kw,
                )
            return _RankHandle(scores, ids, inv, b_real)

    def _rank_fused(
        self, parsed: list[ParsedQuery], topk: int, live, b: int, q: int,
        q_real: int, b_real: int,
    ) -> _RankHandle:
        """Mixed lane: keyword scoring + dense phrase matching + fold +
        finalize + top-k as ONE device program with ONE packed fetch
        (ops/kernels/mixed.py). Replaces the two-phase sparse lane (matcher
        dispatches -> compressed fetch -> host repack -> fold upload ->
        scorer) for reference-blend models on indexes carrying the
        doc-major position layout.

        Program-shape policy: (b in {B_SMALL, WARM_B_MAX}) x (q in {Q_BASE,
        Q_CATCHALL}, q > Q_BASE forces b=WARM_B_MAX) — 3 live mixed
        programs. The phrase width is ONE static P_LEVELS[-1]: the phrase
        stage's term loop is dynamic-trip (bounded by the batch's real max
        term count), so a wide pad column costs nothing."""
        snap, idx = live[0], live[1]
        model = live[2] if len(live) > 2 else self.model
        p_real = max((len(p.phrase_hashes) for p in parsed), default=0)
        p_lvl = P_LEVELS[-1]
        if p_real > p_lvl:
            import logging

            logging.getLogger("spaghettisearch.engine").warning(
                "phrase has %d terms; matching the first %d", p_real, p_lvl
            )

        hot_map = self._hot_map(model, idx)
        term_ids, qlen, qn, qnb, hot_sids = self._fill_keyword_rows(
            parsed, b, q, snap, hot_map
        )
        ph_ids = np.full((b, p_lvl), snap.n_words, dtype=np.int32)
        ph_valid = np.zeros((b, p_lvl), dtype=np.float32)
        pn = np.zeros(b, dtype=np.int32)
        for i, pq in enumerate(parsed):
            pids = snap.term_ids(pq.phrase_hashes)[:p_lvl]
            ph_ids[i, : len(pids)] = pids
            ph_valid[i, : len(pids)] = 1.0
            pn[i] = len(pids)

        topic_probs = np.zeros((b, idx.n_categories), dtype=np.float32)
        if self.use_topic_model:
            for i, pq in enumerate(parsed):
                probs = compute_topic_probs(
                    self.db, pq.keyword_hashes, fixed=self.topic_model_fixed
                )
                for j, c in enumerate(snap.categories):
                    topic_probs[i, j] = probs.get(c, 0.0)

        # sort phrase rows first (descending pn), then by cold-term count
        # (the body sweep's bound under the hot split), then total keywords:
        # keyword row blocks keep the kernel's qn compare-loop bound
        perm = np.lexsort((-qn, -qnb, -pn))
        inv = np.empty_like(perm)
        inv[perm] = np.arange(b)
        term_ids, qlen, qn, pn = term_ids[perm], qlen[perm], qn[perm], pn[perm]
        qnb, hot_sids = qnb[perm], hot_sids[perm]
        ph_ids, ph_valid = ph_ids[perm], ph_valid[perm]
        topic_probs = topic_probs[perm]
        hot_kw = (
            {"qnb": jnp.asarray(qnb), "hot_sids": jnp.asarray(hot_sids)}
            if hot_map is not None
            else {}
        )

        with TRACER.span("rank.device"):
            scores, ids = model.score_mixed(
                idx,
                jnp.asarray(term_ids), jnp.asarray(qlen), jnp.asarray(topic_probs),
                jnp.asarray(ph_ids), jnp.asarray(ph_valid),
                topk=topk, qn=jnp.asarray(qn), pn=jnp.asarray(pn),
                **hot_kw,
            )
            return _RankHandle(scores, ids, inv, b_real)

    @staticmethod
    def _hot_map(model, idx) -> dict[int, int] | None:
        """term id -> hot slot when the model rides the hot-term dense
        body-weight cache (retrieval/device_index.py _build_hot_cache);
        None routes every term through the compare sweep as before."""
        if getattr(model, "supports_hot", None) and model.supports_hot(idx):
            return idx.hot_body_map
        return None

    @staticmethod
    def _fill_keyword_rows(parsed, b, q, snap, hot_map):
        """Build the keyword term tile (+ per-row counts) for a batch. With
        the hot split, each row is laid out COLD TERMS FIRST then hot terms
        (the title sweep reads all qn slots, the body sweep only the first
        qnb), and hot slots go to hot_sids (-1 pad) for the dense matmul."""
        term_ids = np.full((b, q), snap.n_words, dtype=np.int32)
        qlen = np.zeros(b, dtype=np.float32)
        qn = np.zeros(b, dtype=np.int32)  # active term slots per row
        qnb = np.zeros(b, dtype=np.int32)  # cold (swept-in-body) slots
        hot_sids = np.full((b, q), -1, dtype=np.int32)
        for i, p in enumerate(parsed):
            ids = snap.term_ids(p.keyword_hashes)[:q]
            qlen[i] = float(p.query_len)
            qn[i] = len(ids)
            if hot_map is None:
                term_ids[i, : len(ids)] = ids
                qnb[i] = len(ids)
                continue
            cold = [t for t in ids.tolist() if t not in hot_map]
            hots = [t for t in ids.tolist() if t in hot_map]
            row = cold + hots
            term_ids[i, : len(row)] = row
            qnb[i] = len(cold)
            for j, t in enumerate(hots):
                hot_sids[i, j] = hot_map[t]
        return term_ids, qlen, qn, qnb, hot_sids

    def _phrase_weights(self, idx, model=None):
        """Posting-weight arrays the phrase matcher sums: the ranking
        model's own (e.g. BM25) when it provides them, else tf-idf."""
        hook = getattr(model if model is not None else self.model,
                       "phrase_weights", None)
        if hook is not None:
            return hook(idx)
        return idx.title.weights, idx.body.weights

    def _match_phrases_batch(self, phrase_sets: list[list[str]], live=None):
        """Match every phrase query of a batch. Short phrases (<= P_BASE
        terms, the overwhelmingly common case) run as ONE batched device
        program; longer ones run one at a time at the next P_LEVELS bucket so
        the warmed compile-shape set stays finite. Returns per input a host
        (docs, title_w, body_w, flag) tuple."""
        short = [i for i, s in enumerate(phrase_sets) if len(s) <= P_BASE]
        out: list[tuple[np.ndarray, ...] | None] = [None] * len(phrase_sets)
        if short:
            res = self._match_phrases_fixed(
                [phrase_sets[i] for i in short], P_BASE, live
            )
            for i, r in zip(short, res):
                out[i] = r
        for i, s in enumerate(phrase_sets):
            if len(s) <= P_BASE:
                continue
            p = _p_level(len(s))
            if len(s) > p:
                import logging

                logging.getLogger("spaghettisearch.engine").warning(
                    "phrase has %d terms; matching the first %d", len(s), p
                )
            out[i] = self._match_phrases_fixed([s[:p]], p, live)[0]
        return out

    def _match_phrases_fixed(
        self, phrase_sets: list[list[str]], p: int, live=None
    ):
        """One device program matches `phrase_sets`, all padded to exactly
        `p` terms (a warmed compile shape)."""
        if live is None:
            live = self._live
        snap, idx = live[0], live[1]
        model = live[2] if len(live) > 2 else self.model
        n_sets = len(phrase_sets)
        ids_all = np.full((n_sets, p), snap.n_words, dtype=np.int32)
        valid_all = np.zeros((n_sets, p), dtype=bool)  # pad rows: no terms
        gens_all = np.zeros(n_sets, dtype=np.int32)
        need = np.ones(n_sets, dtype=np.int64)
        for i, hashes in enumerate(phrase_sets):
            row = snap.term_ids(hashes)
            ids_all[i, : len(row)] = row
            valid_all[i, : len(row)] = True
            t_df = snap.title.df(row)
            b_df = snap.body.df(row)
            g = int(np.argmin(t_df + b_df))
            gens_all[i] = g
            need[i] = max(1, int(t_df[g]), int(b_df[g]))

        t_w, b_w = self._phrase_weights(idx, model)
        if idx.dense_truncated:
            # a pathological doc's dense row was capped: the forward matcher
            # could under-match it, so use the exact CSR formulation (full
            # posting_cap — its membership searches every term's window)
            bp = max(_bp_bucket(n_sets), n_sets)  # CSR fallback: no chunking
            pad = bp - n_sets
            d, tw, bw, fl = match_phrase_batch(
                idx.title.offsets, idx.title.doc_ids, t_w,
                idx.title.pos_offsets, idx.title.positions,
                idx.body.offsets, idx.body.doc_ids, b_w,
                idx.body.pos_offsets, idx.body.positions,
                jnp.asarray(np.pad(ids_all, ((0, pad), (0, 0)),
                                   constant_values=snap.n_words)),
                jnp.asarray(np.pad(valid_all, ((0, pad), (0, 0)))),
                jnp.asarray(np.pad(gens_all, (0, pad))),
                posting_cap=idx.posting_cap, pos_cap=idx.pos_cap,
                n_docs=idx.n_docs,
            )
            d, tw, bw, fl = map(np.asarray, (d, tw, bw, fl))
            return [(d[i], tw[i], bw[i], fl[i]) for i in range(n_sets)]

        # group the sub-batch by cap level (each phrase pays ~its own
        # generator df, not the sub-batch max) and run one warmed program
        # per non-empty group
        levels = _cap_levels(idx.posting_cap)
        out: list[tuple[np.ndarray, ...] | None] = [None] * n_sets
        level_of = np.searchsorted(np.asarray(levels), need)
        pending = []  # dispatch every group async, fetch once at the end
        chunks = []
        for li, cap in enumerate(levels):
            rows = np.flatnonzero(level_of == li)
            # chunk oversized groups at the largest matcher width: matcher
            # pad rows are NOT free (unlike the qn-skipping scorer), so the
            # bp program set stays tiny and big groups loop
            for s0 in range(0, len(rows), MATCHER_BP[-1]):
                chunks.append((cap, rows[s0 : s0 + MATCHER_BP[-1]]))
        for cap, rows in chunks:
            bp = _bp_bucket(len(rows))
            ids = np.full((bp, p), snap.n_words, dtype=np.int32)
            valid = np.zeros((bp, p), dtype=bool)
            gens = np.zeros(bp, dtype=np.int32)
            ids[: len(rows)] = ids_all[rows]
            valid[: len(rows)] = valid_all[rows]
            gens[: len(rows)] = gens_all[rows]
            t_fwd = idx.title.fwd_device()  # lazy ft/fj upload >1.4M docs
            b_fwd = idx.body.fwd_device()
            res = match_phrase_fwd_batch(
                t_fwd.ft, t_fwd.fj, t_w,
                idx.title.pos_offsets, idx.title.positions,
                b_fwd.ft, b_fwd.fj, b_w,
                idx.body.pos_offsets, idx.body.positions,
                idx.title.offsets, idx.title.doc_ids,
                idx.body.offsets, idx.body.doc_ids,
                jnp.asarray(ids), jnp.asarray(valid), jnp.asarray(gens),
                idx.title.pos_mat, idx.body.pos_mat,
                posting_cap=cap, pos_cap=idx.pos_cap, n_docs=idx.match_pad,
            )
            pending.append((rows, res))
        # ONE host sync for every group, COMPRESSED: the raw outputs are
        # [bp, E] padded (E = 2*cap, multi-MB at the full cap), so each
        # group is first compacted on device to its top-K real matches
        # (top_k on -doc: real ids sort before the n_docs pad). Rows with
        # more than K matches fall back to a full fetch of that group —
        # rare, and the device arrays are still alive.
        K = _MATCH_FETCH_K
        compressed = []
        for rows, res in pending:
            d, tw, bw, fl = res
            k = min(K, d.shape[1])
            negd, sel = jax.lax.top_k(-d, k)
            dk = (-negd).astype(jnp.float32)
            twk = jnp.take_along_axis(tw, sel, axis=1)
            bwk = jnp.take_along_axis(bw, sel, axis=1)
            flk = jnp.take_along_axis(fl, sel, axis=1)
            nreal = (d < idx.match_pad).sum(axis=1).astype(jnp.float32)
            compressed.append(
                (rows, res, k,
                 jnp.concatenate(
                     [jnp.stack([dk, twk, bwk, flk], axis=-1).reshape(-1),
                      nreal]
                 ))
            )
        packed = np.asarray(
            jnp.concatenate([c[3] for c in compressed])
        )
        off = 0
        for rows, res, k, _ in compressed:
            bp = res[0].shape[0]
            n_elem = bp * k * 4
            blk = packed[off : off + n_elem].reshape(bp, k, 4)
            nreal = packed[off + n_elem : off + n_elem + bp].astype(np.int64)
            off += n_elem + bp
            overflow = None
            for j, r in enumerate(rows):
                if nreal[j] > k:
                    # >K matches: fetch this group's full arrays once
                    if overflow is None:
                        overflow = tuple(map(np.asarray, res))
                    out[r] = tuple(a[j] for a in overflow)
                else:
                    out[r] = (
                        blk[j, :, 0].astype(np.int32), blk[j, :, 1],
                        blk[j, :, 2], blk[j, :, 3],
                    )
        return out

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #

    def warmup(self, max_batch: int = WARM_B_MAX) -> None:
        """Compile EVERY query program a live query can reach before serving
        traffic: a fresh jit can take seconds, which would otherwise stall
        the micro-batcher —
        and all traffic behind it — mid-request. The compile-shape policy
        (see module header) keeps the reachable set finite; this walks it:

        - keyword scorer at every batch bucket (q=Q_BASE) + the long-keyword
          catch-all (WARM_B_MAX, Q_CATCHALL);
        - phrase scorer at every batch bucket (e=E_BASE) + the wide-fold
          catch-alls (WARM_B_MAX, Q_CATCHALL, each e level);
        - the phrase matcher at every sub-batch bucket (p=P_BASE, both cap
          levels) + the long-phrase buckets (bp=1, p=8/16);
        - the exact-CSR variants instead when the index is dense-truncated
          (rank() routes there automatically).

        Compiles run CONCURRENTLY over a thread pool: XLA compiles
        independent programs in parallel.
        """
        if self.index.n_docs == 0:
            return
        fused_ok = bool(
            getattr(self.model, "supports_mixed", None)
            and self.model.supports_mixed(self.index)
        )
        jobs = []
        kw = parse_query("warmup")
        kw_long = ParsedQuery(
            raw="", stripped="", phrases=[],
            keyword_hashes=["0" * 32] * (Q_BASE + 1), phrase_hashes=[],
        )
        ph = parse_query('"warm up"')

        def ph_n(n: int, kws: int = 0) -> ParsedQuery:  # n-term phrase
            return ParsedQuery(
                raw="", stripped="", phrases=["w " * n],
                keyword_hashes=["0" * 32] * kws,
                phrase_hashes=["0" * 32] * n,
            )

        from functools import partial as _partial

        # with big_batch the single catch-all moves to (B_BIG, Q_CATCHALL):
        # the 1-row catch-all jobs below reach it through rank_async's
        # b_catch forcing, so no extra catch-all jobs are needed
        buckets = tuple(dict.fromkeys(
            (B_SMALL, WARM_B_MAX, max_batch)
            + ((B_BIG,) if self.big_batch else ())
        ))
        for b in buckets:
            jobs.append(_partial(self.rank, [kw] * b, MAX_RESULTS))  # keyword (b, Q_BASE)
        jobs.append(_partial(self.rank, [kw_long], MAX_RESULTS))  # keyword catch-all

        if fused_ok:
            # the mixed lane's whole program space: (b, q) in
            # {(16, Q_BASE), (128, Q_BASE), (128, Q_CATCHALL)} (+ the B_BIG
            # bucket when opted in) — phrase length is dynamic in the
            # program, not a compile shape
            for b in buckets:
                jobs.append(_partial(self.rank, [ph] * b, MAX_RESULTS))
            if self.phrase_b32:
                # the opt-in stale-cohort (B_PHRASE, Q_BASE) mixed program
                jobs.append(_partial(self.rank, [ph] * B_PHRASE, MAX_RESULTS))
            jobs.append(_partial(self.rank, [ph_n(2, kws=Q_BASE + 1)], MAX_RESULTS))
        else:
            # legacy two-phase lane: matcher bp buckets + fold programs
            # (B_BIG never routes here — rank_async drops the flag for
            # phrase batches without the fused lane)
            for b in (B_SMALL, max_batch):
                jobs.append(_partial(self.rank, [ph] * b, MAX_RESULTS))
            for n in (P_BASE + 1, P_LEVELS[-1]):  # long-phrase buckets (bp=1)
                jobs.append(_partial(self.rank, [ph_n(n)], MAX_RESULTS))

        idx = self.index
        snap = self.snapshot
        if fused_ok:
            # the mixed lane has no matcher/fold program families; the jobs
            # above covered everything reachable
            self._run_warm_jobs(jobs)
            self._settle_live()
            return
        # matcher cap levels can't be reached with sentinel (df=0) terms;
        # compile them directly at every sub-batch bucket
        caps = _cap_levels(idx.posting_cap)
        t_w, b_w = self._phrase_weights(idx)

        def warm_matcher(bp: int, p: int, cap: int) -> None:
            ids = jnp.asarray(np.full((bp, p), snap.n_words, np.int32))
            valid = jnp.asarray(np.zeros((bp, p), bool))
            gens = jnp.asarray(np.zeros(bp, np.int32))
            if idx.dense_truncated:
                match_phrase_batch(
                    idx.title.offsets, idx.title.doc_ids, t_w,
                    idx.title.pos_offsets, idx.title.positions,
                    idx.body.offsets, idx.body.doc_ids, b_w,
                    idx.body.pos_offsets, idx.body.positions,
                    ids, valid, gens,
                    posting_cap=idx.posting_cap, pos_cap=idx.pos_cap,
                    n_docs=idx.n_docs,
                )
                return
            t_fwd = idx.title.fwd_device()  # lazy ft/fj upload >1.4M docs
            b_fwd = idx.body.fwd_device()
            match_phrase_fwd_batch(
                t_fwd.ft, t_fwd.fj, t_w,
                idx.title.pos_offsets, idx.title.positions,
                b_fwd.ft, b_fwd.fj, b_w,
                idx.body.pos_offsets, idx.body.positions,
                idx.title.offsets, idx.title.doc_ids,
                idx.body.offsets, idx.body.doc_ids,
                ids, valid, gens,
                idx.title.pos_mat, idx.body.pos_mat,
                posting_cap=cap, pos_cap=idx.pos_cap, n_docs=idx.match_pad,
            )

        for bp in MATCHER_BP:
            for cap in caps:
                jobs.append(_partial(warm_matcher, bp, P_BASE, cap))
        for p in P_LEVELS[1:]:
            for cap in caps:
                jobs.append(_partial(warm_matcher, 1, p, cap))

        # rare-family catch-alls at (WARM_B_MAX, q, e) for EVERY fold level
        # INCLUDING E_BASE and BOTH q families: wide phrases keep the
        # query's own q bucket (Q_BASE) so they don't pay the Q_CATCHALL
        # compare scan; >Q_BASE-keyword queries reach the Q_CATCHALL one
        pad_doc = idx.n_docs if idx.dense_truncated else idx.n_docs_padded

        def warm_fold(e: int, qw: int) -> None:
            term_ids = jnp.asarray(
                np.full((WARM_B_MAX, qw), snap.n_words, np.int32)
            )
            qlen = jnp.asarray(np.ones(WARM_B_MAX, np.float32))
            tp = jnp.asarray(
                np.zeros((WARM_B_MAX, idx.n_categories), np.float32)
            )
            ph_docs = jnp.asarray(np.full((WARM_B_MAX, e), pad_doc, np.int32))
            zeros = jnp.asarray(np.zeros((WARM_B_MAX, e), np.float32))
            if idx.dense_truncated:
                self.model.score_csr(
                    idx, term_ids, qlen, tp, ph_docs, zeros, zeros, zeros,
                    topk=MAX_RESULTS,
                )
            else:
                self.model.score_with_phrase(
                    idx, term_ids, qlen, tp, ph_docs, zeros, zeros, zeros,
                    topk=MAX_RESULTS,
                    # rank() always passes a qn array; warm that signature
                    qn=jnp.asarray(np.zeros(WARM_B_MAX, np.int32)),
                )

        for e in _e_levels(idx.n_docs):
            for qw in (Q_BASE, Q_CATCHALL):
                if e == E_BASE and qw == Q_BASE:
                    continue  # covered by the per-bucket warms above
                jobs.append(_partial(warm_fold, e, qw))

        self._run_warm_jobs(jobs)
        self._settle_live()

    @staticmethod
    def _run_warm_jobs(jobs) -> None:
        """Run warmup compiles concurrently (XLA compiles independent
        programs in parallel)."""
        import os as _os
        from concurrent.futures import ThreadPoolExecutor

        workers = int(_os.environ.get("SPAGHETTI_WARM_POOL", "8") or "1")
        if workers <= 1:
            for job in jobs:
                job()
        else:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                list(ex.map(lambda job: job(), jobs))

    def _settle_live(self) -> None:
        """Post-warmup settling with REAL vocabulary terms.

        Warmup executes each program on sentinel terms, which match nothing;
        a first live batch of a program family can still pay one-time costs
        that only real-term executions meet (first-touch allocations, the
        data-dependent loop trips). Running a handful of batches built from
        real snapshot terms — one keyword batch per b bucket edge and one
        phrase per matcher cap level — pays those costs here rather than on
        the first seconds of live traffic."""
        snap = self.snapshot
        idx = self.index
        if snap.n_docs == 0 or snap.n_words == 0:
            return
        df = (
            np.diff(np.asarray(snap.body.post_offsets[: snap.n_words + 1]))
            + np.diff(np.asarray(snap.title.post_offsets[: snap.n_words + 1]))
        )

        def word_at(level_lo: int, level_hi: int) -> str | None:
            cand = np.flatnonzero((df > level_lo) & (df <= level_hi))
            return snap.word_hashes[int(cand[0])] if cand.size else None

        kw_hash = snap.word_hashes[int(np.argmax(df > 0))] if (df > 0).any() else None
        if kw_hash is None:
            return

        def P(kws=(), phs=()):
            return ParsedQuery(
                raw="", stripped="", phrases=["settle"] if phs else [],
                keyword_hashes=list(kws), phrase_hashes=list(phs),
            )

        kw_q = P(kws=[kw_hash])
        kw_long = P(kws=[kw_hash] * (Q_BASE + 1))
        batches = [
            [kw_q],                      # keyword (B_SMALL, Q_BASE)
            [kw_q] * WARM_B_MAX,         # keyword (WARM_B_MAX, Q_BASE)
            [kw_long],                   # keyword catch-all ((b_catch, Q_CATCHALL))
        ]
        if self.big_batch:
            batches.append([kw_q] * B_BIG)  # keyword (B_BIG, Q_BASE)
        fused_ok = bool(
            getattr(self.model, "supports_mixed", None)
            and self.model.supports_mixed(idx)
        )
        if fused_ok:
            # one real-vocabulary batch per mixed program (the dense phrase
            # stage's cost does not depend on df, so no band walk needed);
            # a 2-term phrase also exercises the positional chain
            wh2 = word_at(0, 1 << 30) or kw_hash
            ph_q = P(kws=[kw_hash], phs=[kw_hash, wh2])
            batches += [
                [ph_q],                                # (B_SMALL, Q_BASE)
                [ph_q] + [kw_q] * (WARM_B_MAX - 1),    # (WARM_B_MAX, Q_BASE)
                [P(kws=[kw_hash] * (Q_BASE + 1), phs=[kw_hash, wh2])],
            ]
            if self.big_batch:
                batches.append([ph_q] + [kw_q] * (B_BIG - 1))  # (B_BIG, Q_BASE)
        else:
            # df bands aligned to BOTH the matcher cap levels and the
            # e-fold levels (a single-term phrase of df=D matches ~D docs,
            # so one word per band settles its whole (cap, e) family)
            bounds = sorted(
                set(_cap_levels(idx.posting_cap))
                | {lv for lv in _e_levels(idx.n_docs)}
            )
            lo = 0
            for hi in bounds:
                wh = word_at(lo, hi)
                lo = hi
                if wh is None:
                    continue
                ph_q = P(kws=[kw_hash], phs=[wh])
                for bp in MATCHER_BP:
                    batches.append([ph_q] * bp)
                batches.append([ph_q] + [kw_q] * (WARM_B_MAX - 1))
                batches.append([P(kws=[kw_hash] * (Q_BASE + 1), phs=[wh])])
            # long-phrase p levels (bp=1), real generator term
            for p in P_LEVELS[1:]:
                batches.append([P(phs=[kw_hash] * p)])
        for batch in batches:
            self.rank(batch, topk=MAX_RESULTS)

    def query(self, text: str, max_results: int = MAX_RESULTS) -> list[dict]:
        return self.query_batch([text], max_results)[0]

    def query_batch(self, texts: list[str], max_results: int = MAX_RESULTS) -> list[list[dict]]:
        parsed = [parse_query(t) for t in texts]
        results: list[list[dict]] = [[] for _ in texts]
        rows = [i for i, p in enumerate(parsed) if not p.is_empty]
        live = self._live  # one consistent live state for the request
        if not rows or live[1].n_docs == 0:
            return results
        scores, ids = self.rank([parsed[i] for i in rows], topk=max_results, live=live)
        for row, i in enumerate(rows):
            results[i] = self.hydrate_row(scores[row], ids[row], parsed[i], live)
        return results

    # ------------------------------------------------------------------ #
    # hydration (reference: retrieval/util.go:56-149, get_metadata.go:16-411)
    #
    # The reference overlaps per-result DB reads with goroutine futures; the
    # equivalent here is a per-doc record cache: every field except
    # Summary/PageRank/FinalRank is query-independent, so it is resolved
    # from the store ONCE per (snapshot, doc) — both as a dict and as a
    # pre-serialized JSON fragment for the wire fast path.
    # ------------------------------------------------------------------ #

    #: hydration-record prewarm memory budget (bytes, JSON-size proxy): at
    #: the measured ~0.4 KB/record this covers several million docs; when
    #: the estimate would blow past it, the remaining docs stay on the
    #: (exact, just colder) lazy path
    PREWARM_BUDGET_BYTES: int = 4 << 30

    def prewarm_hydration(self, live=None, max_docs: int | None = None) -> int:
        """Bulk-build every doc's hydration record (and summary text bytes)
        in two store iterations instead of ~15 point reads per doc on first
        touch — cold _doc_record misses measured 0.3-0.5 ms each, which
        made the first serving sweep over a fresh snapshot GIL-crawl. Runs
        at server startup and inside prepare_refresh (off-lock). Returns
        the number of records built. Memory-bounded: a running record-bytes
        estimate is tracked and the build stops at PREWARM_BUDGET_BYTES
        (the lazy path still works for the rest, it is just cold)."""
        if live is None:
            live = self._live
        snap = live[0]
        if snap.n_docs == 0 or (max_docs is not None and snap.n_docs > max_docs):
            return 0
        import json as _json

        # persisted sidecar fast path: a snapshot loaded from disk keeps its
        # prebuilt records next to it (fingerprint-validated against the
        # store) — the 1M-doc build measured ~280 s, the reload ~20 s
        blob = getattr(snap, "_hyd_blob", None)
        if blob is not None:  # already attached: prewarm is a no-op
            return int(np.count_nonzero(blob[0] & 1))
        loaded = self._load_hyd_sidecar(snap)
        if loaded is not None:
            return loaded
        key = self._hyd_sidecar_key(snap)
        if key is not None:
            # disk-backed snapshot (the crawl-scale tier): stream the store
            # walks instead of materializing full DocInfo/record dicts —
            # the dict build measured 38 GB peak RSS at 1M docs
            return self._prewarm_streaming(snap, key)

        infos: dict[str, DocInfo] = dict(self.db.doc_info.items())
        words: dict[str, str] = dict(self.db.word.items())
        cache = getattr(snap, "_hyd_records", None)
        if cache is None:
            cache = {}
            snap._hyd_records = cache
        # native response assembler: register (fragment, summary text) per
        # doc into a fastserve generation hanging off this snapshot — the
        # wire path then assembles whole responses GIL-released
        # (native/fastserve.cpp; measured 0.52 ms -> ~0.03 ms per request)
        gen = getattr(snap, "_native_hyd", None)
        texts: dict[str, str] = {}
        texts_walked = False
        if gen is None:
            from .native_hydrate import HydrationGen, native_available

            if native_available():
                texts = dict(self.db.doc_summary.items())
                texts_walked = True
                if texts:
                    gen = HydrationGen(snap.n_docs)
                    snap._native_hyd = gen
        spent = 0
        budget = self.PREWARM_BUDGET_BYTES
        for doc_id, doc_hash in enumerate(snap.doc_hashes):
            if doc_id in cache:
                if gen is not None:
                    text = texts.get(doc_hash)
                    if text is not None:
                        gen.set_doc(doc_id, cache[doc_id][1].encode(), text.encode())
                continue
            if spent > budget:
                import logging

                logging.getLogger("spaghettisearch.engine").warning(
                    "hydration prewarm stopped at %d/%d docs "
                    "(~%d MB record budget); remaining docs hydrate lazily",
                    len(cache), snap.n_docs, budget >> 20,
                )
                break
            info = infos.get(doc_hash) or DocInfo(url="")
            parents = [
                u for u in (
                    infos[h].url if h in infos else None
                    for h in list(info.parents)[:MAX_LINKED_DOCS]
                ) if u
            ]
            children = [
                u for u in (
                    infos[h].url if h in infos else None
                    for h in info.children[:MAX_LINKED_DOCS]
                ) if u
            ]
            top_words = sorted(
                info.words_mapping.items(), key=lambda kv: -kv[1]
            )[:MAX_KEYWORDS]
            words_mapping = {}
            for wh, freq in top_words:
                w = words.get(wh)
                if w is not None:
                    words_mapping[w] = freq
            title = " ".join(info.page_title) if info.page_title else info.host
            base = {
                "Url": info.url,
                "Page_title": title,
                "Mod_date": info.mod_date.isoformat(),
                "Page_size": info.page_size,
                "Children": children or None,
                "Parents": parents or None,
                "Words_mapping": words_mapping or None,
            }
            frag = _json.dumps(base, separators=(",", ":"))[:-1]
            # record cost proxy: JSON length ~ dict payload; 3x covers dict
            # + key overheads without a per-record deep sizeof walk
            spent += 3 * len(frag) + 200
            cache[doc_id] = (base, frag)
            if gen is not None:
                text = texts.get(doc_hash)
                if text is not None:
                    tb = text.encode()
                    gen.set_doc(doc_id, frag.encode(), tb)
                    # charge BYTES, same unit as _prewarm_streaming, so the
                    # budget cuts off at the same doc on non-ASCII corpora
                    spent += len(tb)
        self._save_hyd_sidecar(snap, cache, texts, texts_walked)
        return len(cache)

    def _prewarm_streaming(self, snap, key: tuple[str, str]) -> int:
        """Sidecar-building prewarm with bounded host RAM:
        instead of materializing the doc_info/word/summary tables as full
        decoded dicts (38 GB peak RSS measured at 1M docs), stream each
        table once, keeping only a compact per-doc skeleton (url, joined
        title, date string, truncated link/keyword lists) plus a hash->url
        map, then build fragments in doc-id order — the same record bytes,
        the same budget accounting, the same sidecar file as the dict path
        (tests/test_hydration_sidecar.py pins builder equality). The built
        records attach as the flat sidecar blob (lazy decode), not as 1M
        resident (dict, str) pairs."""
        import json as _json

        from .hydration_sidecar import FLAG_FRAG, FLAG_TEXT, save_sidecar

        n = snap.n_docs
        doc_id_of = snap.doc_id

        # 1) summary texts, doc-id aligned (only when the native assembler
        # will register them — the same gate as the dict path)
        texts_walked = False
        text_bs: list[bytes] = [b""] * n
        text_present = np.zeros(n, bool)
        n_texts = 0
        if getattr(snap, "_native_hyd", None) is None:
            from .native_hydrate import native_available

            if native_available():
                texts_walked = True
                for dh, text in self.db.doc_summary.items():
                    did = doc_id_of.get(dh)
                    if did is not None:
                        text_bs[did] = text.encode()
                        text_present[did] = True
                        n_texts += 1

        # 2) doc_info: url map + compact skeletons (no DocInfo retained)
        urls: dict[str, str] = {}
        skel: dict[int, tuple] = {}
        for dh, info in self.db.doc_info.items():
            urls[dh] = info.url
            did = doc_id_of.get(dh)
            if did is None:
                continue
            top = sorted(
                info.words_mapping.items(), key=lambda kv: -kv[1]
            )[:MAX_KEYWORDS]
            skel[did] = (
                info.url,
                " ".join(info.page_title) if info.page_title else info.host,
                info.mod_date.isoformat(),
                info.page_size,
                list(info.parents)[:MAX_LINKED_DOCS],
                info.children[:MAX_LINKED_DOCS],
                top,
            )
        words: dict[str, str] = dict(self.db.word.items())

        # 3) fragments in doc-id order (byte-identical to the dict builder)
        flags = np.zeros(n, np.uint8)
        frags: list[bytes] = [b""] * n
        spent = 0
        budget = self.PREWARM_BUDGET_BYTES
        built = 0
        for doc_id in range(n):
            if spent > budget:
                import logging

                logging.getLogger("spaghettisearch.engine").warning(
                    "hydration prewarm stopped at %d/%d docs "
                    "(~%d MB record budget); remaining docs hydrate lazily",
                    built, n, budget >> 20,
                )
                break
            sk = skel.get(doc_id)
            if sk is None:
                url = title = ""
                date_s, size = ZERO_TIME.isoformat(), 0
                par_h: list[str] = []
                kid_h: list[str] = []
                top = []
            else:
                url, title, date_s, size, par_h, kid_h, top = sk
            parents = [u for u in (urls.get(h) for h in par_h) if u]
            children = [u for u in (urls.get(h) for h in kid_h) if u]
            words_mapping = {}
            for wh, freq in top:
                w = words.get(wh)
                if w is not None:
                    words_mapping[w] = freq
            base = {
                "Url": url,
                "Page_title": title,
                "Mod_date": date_s,
                "Page_size": size,
                "Children": children or None,
                "Parents": parents or None,
                "Words_mapping": words_mapping or None,
            }
            frag = _json.dumps(base, separators=(",", ":"))[:-1]
            spent += 3 * len(frag) + 200
            frags[doc_id] = frag.encode()
            flags[doc_id] |= FLAG_FRAG
            built += 1
            if texts_walked and n_texts and text_present[doc_id]:
                flags[doc_id] |= FLAG_TEXT
                spent += len(text_bs[doc_id])

        try:
            save_sidecar(key[0], key[1], flags, frags, text_bs, texts_walked)
        except OSError as e:
            import logging

            logging.getLogger("spaghettisearch.engine").warning(
                "hydration sidecar save failed (%s); startup stays slow", e
            )

        # 4) attach as the flat blob (lazy per-doc decode) + bulk-register
        # the native assembler — never 1M resident (dict, str) pairs
        frag_off = np.zeros(n + 1, np.int64)
        np.cumsum([len(f) for f in frags], out=frag_off[1:])
        frag_blob = b"".join(frags)
        snap._hyd_blob = (flags, frag_off, frag_blob)
        if texts_walked and n_texts:
            from .native_hydrate import HydrationGen

            text_off = np.zeros(n + 1, np.int64)
            np.cumsum([len(t) for t in text_bs], out=text_off[1:])
            gen = HydrationGen(n)
            gen.set_bulk(flags, frag_blob, frag_off, b"".join(text_bs), text_off)
            snap._native_hyd = gen
        return built

    # ------------------------------------------------------------------ #
    # hydration sidecar: persisted prewarm records (hydration_sidecar.py)
    # ------------------------------------------------------------------ #

    def _hyd_sidecar_key(self, snap) -> tuple[str, str] | None:
        """-> (path, fingerprint) when this (snapshot, store) pair supports
        a persisted hydration cache; None otherwise (in-memory store or
        snapshot that was never saved to disk)."""
        sdir = getattr(snap, "source_dir", None)
        if not sdir or not os.path.isdir(sdir):
            return None
        from .hydration_sidecar import SIDECAR_NAME, store_fingerprint

        fp = store_fingerprint(self.db, snap)
        if fp is None:
            return None
        return os.path.join(sdir, SIDECAR_NAME), fp

    def _load_hyd_sidecar(self, snap) -> int | None:
        """Attach a valid persisted sidecar to the snapshot (lazy record
        blob + bulk native-assembler registration). -> record count, or
        None when a fresh build must run."""
        key = self._hyd_sidecar_key(snap)
        if key is None:
            return None
        from .hydration_sidecar import FLAG_FRAG, load_sidecar
        from .native_hydrate import HydrationGen, native_available

        native_ok = (
            getattr(snap, "_native_hyd", None) is None and native_available()
        )
        loaded = load_sidecar(key[0], key[1], need_texts=native_ok)
        if loaded is None:
            return None
        flags, frag_off, frag_blob, text_off, text_blob = loaded
        snap._hyd_blob = (flags, frag_off, frag_blob)
        if native_ok:
            gen = HydrationGen(snap.n_docs)
            gen.set_bulk(flags, frag_blob, frag_off, text_blob, text_off)
            snap._native_hyd = gen
        return int(np.count_nonzero(flags & FLAG_FRAG))

    def _save_hyd_sidecar(
        self, snap, cache: dict, texts: dict, texts_walked: bool
    ) -> None:
        """Persist freshly built prewarm records next to the snapshot (only
        when it was loaded from disk against a durable store)."""
        key = self._hyd_sidecar_key(snap)
        if key is None or not cache:
            return
        from .hydration_sidecar import FLAG_FRAG, FLAG_TEXT, save_sidecar

        n = snap.n_docs
        flags = np.zeros(n, np.uint8)
        frags: list[bytes] = [b""] * n
        text_bs: list[bytes] = [b""] * n
        for doc_id, rec in cache.items():
            flags[doc_id] |= FLAG_FRAG
            frags[doc_id] = rec[1].encode()
            if texts_walked:
                text = texts.get(snap.doc_hashes[doc_id])
                if text is not None:
                    flags[doc_id] |= FLAG_TEXT
                    text_bs[doc_id] = text.encode()
        try:
            save_sidecar(key[0], key[1], flags, frags, text_bs, texts_walked)
        except OSError as e:
            import logging

            logging.getLogger("spaghettisearch.engine").warning(
                "hydration sidecar save failed (%s); startup stays slow", e
            )

    def _doc_record(self, doc_id: int, snapshot) -> tuple[dict, str]:
        """-> (static result fields, their JSON fragment without the closing
        brace). Cached on the snapshot object so /refresh swaps it away with
        the doc-id space it belongs to (prewarm_hydration bulk-builds it)."""
        cache = getattr(snapshot, "_hyd_records", None)
        if cache is None:
            cache = {}
            snapshot._hyd_records = cache  # benign race: duplicate build
        rec = cache.get(doc_id)
        if rec is not None:
            return rec

        import json as _json

        # persisted-sidecar docs decode lazily from the flat blob: the frag
        # IS json.dumps(base)[:-1], so loads(frag + "}") round-trips the
        # dict exactly (key order preserved, values parse-equal)
        blob = getattr(snapshot, "_hyd_blob", None)
        if blob is not None:
            flags, off, data = blob
            if flags[doc_id] & 1:
                frag = data[off[doc_id]: off[doc_id + 1]].decode()
                rec = (_json.loads(frag + "}"), frag)
                cache[doc_id] = rec
                return rec

        doc_hash = snapshot.doc_hashes[doc_id]
        info: DocInfo | None = self.db.doc_info.get(doc_hash)
        if info is None:
            info = DocInfo(url="")

        def url_of(h: str) -> str | None:
            d = self.db.doc_info.get(h)
            return d.url if d is not None else None

        parents = [
            u for u in (url_of(h) for h in list(info.parents)[:MAX_LINKED_DOCS]) if u
        ]
        children = [
            u for u in (url_of(h) for h in info.children[:MAX_LINKED_DOCS]) if u
        ]
        top_words = sorted(info.words_mapping.items(), key=lambda kv: -kv[1])[:MAX_KEYWORDS]
        words_mapping = {}
        for wh, freq in top_words:
            w = self.db.word.get(wh)
            if w is not None:
                words_mapping[w] = freq
        title = " ".join(info.page_title) if info.page_title else info.host

        base = {
            "Url": info.url,
            "Page_title": title,
            "Mod_date": info.mod_date.isoformat(),
            "Page_size": info.page_size,
            "Children": children or None,
            "Parents": parents or None,
            "Words_mapping": words_mapping or None,
        }
        rec = (base, _json.dumps(base, separators=(",", ":"))[:-1])
        cache[doc_id] = rec
        return rec

    def _topic_pagerank(self, parsed: ParsedQuery):
        """Per-query topic probabilities (None when the model is off)."""
        if not self.use_topic_model:
            return None
        return compute_topic_probs(
            self.db, parsed.keyword_hashes, fixed=self.topic_model_fixed
        )

    @staticmethod
    def _keep(score: float) -> bool:
        # -inf marks non-candidates; +inf is a legitimate score for a
        # candidate whose magnitude is 0 (not yet weighted), matching the
        # reference's IsNaN-only guard (get_metadata.go:61-66)
        return score != -np.inf and not np.isnan(score)

    def hydrate_row(self, scores_row, ids_row, parsed: ParsedQuery, live) -> list[dict]:
        """One query's ranked (scores, ids) -> full Rank_combined dicts."""
        from .summary import prepare_summary_query

        snap = live[0]
        probs = self._topic_pagerank(parsed)
        prep = prepare_summary_query(parsed.stripped, parsed.phrases)
        out = []
        for score, doc_id in zip(scores_row, ids_row):
            score = float(score)
            if not self._keep(score):
                continue
            doc_id = int(doc_id)
            base, _ = self._doc_record(doc_id, snap)
            doc_hash = snap.doc_hashes[doc_id]
            pagerank = 0.0
            if probs is not None:
                ranks = self.db.doc_rank.get(doc_hash) or {}
                pagerank = sum(p * ranks.get(t, 0.0) for t, p in probs.items())
            d = dict(base)
            d["Summary"] = get_summary(
                self.db, doc_hash, parsed.stripped, parsed.phrases, prep
            )
            d["PageRank"] = pagerank
            d["FinalRank"] = score
            out.append(d)
        return out

    def hydrate_row_json(self, scores_row, ids_row, parsed: ParsedQuery, live) -> bytes:
        """Wire fast path: same contract as hydrate_row, assembled from the
        cached JSON fragments (parse-equal to json.dumps(hydrate_row(...)),
        tested in tests/test_serving.py) without re-serializing the static
        fields per request."""
        import json as _json

        from .summary import prepare_summary_query

        snap = live[0]
        probs = self._topic_pagerank(parsed)
        prep = prepare_summary_query(parsed.stripped, parsed.phrases)
        if probs is None:
            # native assembler: fragments + summaries + scores -> response
            # bytes in one GIL-released call (native/fastserve.cpp); falls
            # through to the Python loop on unregistered docs / no gen
            gen = getattr(snap, "_native_hyd", None)
            if gen is not None:
                from .summary import _packed_query

                body = gen.assemble(ids_row, scores_row, _packed_query(prep))
                if body is not None:
                    return body
        parts = []
        for score, doc_id in zip(scores_row, ids_row):
            score = float(score)
            if not self._keep(score):
                continue
            doc_id = int(doc_id)
            _, prefix = self._doc_record(doc_id, snap)
            doc_hash = snap.doc_hashes[doc_id]
            pagerank = 0.0
            if probs is not None:
                ranks = self.db.doc_rank.get(doc_hash) or {}
                pagerank = sum(p * ranks.get(t, 0.0) for t, p in probs.items())
            summary = get_summary(
                self.db, doc_hash, parsed.stripped, parsed.phrases, prep
            )
            parts.append(
                f'{prefix},"Summary":{_json.dumps(summary)}'
                f',"PageRank":{_json.dumps(pagerank)}'
                f',"FinalRank":{_json.dumps(score)}}}'
            )
        return ("[" + ",".join(parts) + "]").encode()

    def prewarm_wordlist(self, live=None) -> int:
        """Build the sorted vocabulary cache onto the snapshot, OFF the
        serving lock (called at startup and inside prepare_refresh): the
        O(V) word-table walk previously ran lazily under the serving read
        lock, so the first /wordlist after every /refresh ate the full
        vocabulary scan. Keyed on the snapshot object
        so /refresh swaps it with the vocabulary it belongs to."""
        if live is None:
            live = self._live
        snap = live[0]
        cache = getattr(snap, "_wordlist", None)
        if cache is None:
            words = dict(self.db.word.items())
            cache = sorted(
                {w for wh in snap.word_hashes if (w := words.get(wh)) is not None}
            )
            snap._wordlist = cache  # benign race: duplicate build
        return len(cache)

    def wordlist(self, prefix: str) -> list[str]:
        """Vocabulary dump filtered by prefix (reference:
        cmd/server/server.go:54-85 + database.go:414-454)."""
        live = self._live
        cache = getattr(live[0], "_wordlist", None)
        if cache is None:
            self.prewarm_wordlist(live)
            cache = live[0]._wordlist
        if not prefix:
            return list(cache)
        # the cache is sorted: prefix matches are one contiguous run
        import bisect

        lo = bisect.bisect_left(cache, prefix)
        out: list[str] = []
        for i in range(lo, len(cache)):
            if not cache[i].startswith(prefix):
                break
            out.append(cache[i])
        return out
