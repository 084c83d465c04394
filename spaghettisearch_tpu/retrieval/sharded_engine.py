"""Multi-device serving: a QueryEngine whose device program is the
doc-sharded shard_map scorer (parallel/sharded.py) instead of the
single-device DeviceIndex path.

Everything host-side (parsing, hydration, summaries, wordlist) is inherited;
only `rank` changes — the batch is scored per shard with a local top-k and
an all-gather merge. Phrase sets are per row (the block vmaps the
forward matcher over the batch).

Request consistency: everything a query touches — snapshot, sharded index,
compiled scorers — is bundled into ONE atomically-swapped `_live` tuple, so
a /refresh concurrent with a query can never mix the new index with the old
snapshot's doc-id space. Compiled scorers are reused across refreshes when
the padded index geometry is unchanged (the index arrays are call-time jit
arguments, parallel/sharded.py scorer_meta).

Use `cli.server --meshShards N` (and optionally `--meshBatch Q` for a 2-D
query-data-parallel x doc mesh) to serve this way.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..config import MAX_RESULTS
from ..parallel.mesh import make_mesh, make_mesh2d
from ..parallel.sharded import ShardedIndex, make_sharded_scorer, scorer_meta
from ..utils.timing import TRACER
from .engine import (
    P_LEVELS,
    Q_BASE,
    Q_CATCHALL,
    SEGREGATE_MIN_DOCS,
    WARM_B_MAX,
    ParsedQuery,
    QueryEngine,
    _pow2,
    parse_query,
)

#: sharded phrase-term buckets: P_BASE batched (common), one catch-all
_P_SHARD_MAX = P_LEVELS[-1]


class _ShardedRankHandle:
    """Dispatched-but-unfetched sharded batch rank (cf. engine._RankHandle):
    scores+ids pack into one device array at dispatch, finish() blocks for
    the single packed fetch, undoes the batch sort permutation (mixed lane),
    slices the real batch rows and masks padded doc slots (which only
    appear with -inf scores) for hydration."""

    __slots__ = ("_packed", "_shape", "_b_real", "_n_docs", "_inv")

    def __init__(self, scores, ids, b_real: int, n_docs: int, inv=None) -> None:
        self._packed = jnp.concatenate(
            [scores.reshape(-1), ids.astype(jnp.float32).reshape(-1)]
        )
        try:  # pre-stage the d2h transfer (see engine._RankHandle)
            self._packed.copy_to_host_async()
        except AttributeError:
            pass
        self._shape = scores.shape
        self._b_real = b_real
        self._n_docs = n_docs
        self._inv = inv

    def finish(self) -> tuple[np.ndarray, np.ndarray]:
        packed = np.asarray(self._packed)
        n = packed.shape[0] // 2
        scores = packed[:n].reshape(self._shape)
        ids = packed[n:].reshape(self._shape).astype(np.int32)
        if self._inv is not None:
            scores, ids = scores[self._inv], ids[self._inv]
        scores = scores[: self._b_real]
        ids = ids[: self._b_real]
        pad_mask = ids >= self._n_docs
        return (
            np.where(pad_mask, -np.inf, scores),
            np.where(pad_mask, 0, ids),
        )


class _ShardedLive:
    """Everything a request resolves through, swapped atomically as one
    object: snapshot-level facts for generic engine/server code (healthz,
    emptiness checks) plus the sharded index and its compiled scorers."""

    def __init__(self, snap, sidx: ShardedIndex, scorers: dict) -> None:
        self.n_docs = snap.n_docs
        self.n_words = snap.n_words
        self.n_categories = max(
            snap.pagerank.shape[1] if snap.pagerank is not None else 1, 1
        )
        self.sidx = sidx
        self.scorers = scorers  # topk -> run(sidx, ...) fn


def _index_sig(sidx: ShardedIndex) -> tuple:
    """The full jit cache key a compiled sharded scorer sees: scorer_meta
    PLUS every index array's (shape, dtype) — the arrays are call-time jit
    arguments, so padded-shape drift (vocab growth, a posting-pad boundary
    crossed by appends) recompiles even at equal scorer_meta. Drives the
    CPU-mesh refresh-warm gate in prepare_refresh."""
    from ..parallel.sharded import index_args

    arrs = index_args(
        sidx,
        mixed=bool(sidx.pos_dense),
        hot=sidx.hot_body_w is not None,
        doc_sorted=sidx.doc_perm is not None,
    )
    return (scorer_meta(sidx),) + tuple(
        (tuple(a.shape), str(a.dtype)) for a in arrs
    )


@dataclass
class ShardedQueryEngine(QueryEngine):
    n_shards: int = 1
    n_query_rows: int = 1  # >1: 2-D mesh, query batch data-parallel

    def __post_init__(self) -> None:
        # skip the single-chip DeviceIndex: postings live once, in the
        # ShardedIndex (at 1M docs the dense forward arrays are GBs)
        if self.snapshot is None:
            from ..index.snapshot import build_snapshot

            self.snapshot = build_snapshot(self.db)
        if self.n_query_rows > 1:
            self._mesh = make_mesh2d(self.n_query_rows, self.n_shards)
        else:
            self._mesh = make_mesh(self.n_shards)
        from ..models.bm25 import BM25Ranker

        self._bm25 = isinstance(self.model, BM25Ranker)
        # compiled scorers survive refresh while the padded geometry is
        # unchanged: keyed by (meta, topk), arrays passed per call
        self._scorer_cache: dict[tuple, object] = {}
        self._live = (self.snapshot, self._build_sharded(self.snapshot))
        self.snapshot, self.index = self._live

    def _build_sharded(self, snapshot) -> _ShardedLive:
        sidx = ShardedIndex.from_snapshot(
            snapshot, self._mesh, weights="bm25" if self._bm25 else "tfidf"
        )
        return _ShardedLive(snapshot, sidx, {})

    def prepare_refresh(self, warm: bool = True):
        """Off-lock rebuild: fresh store view + snapshot + sharded index
        (compiled scorers are reused from the geometry-keyed cache). With
        warm=True the new geometry's scorer/matcher programs are compiled
        here, off-lock, so a corpus that grew past a padding boundary never
        makes a live query pay the fresh compile (same policy as the
        single-chip engine)."""
        import copy

        from ..index.snapshot import build_snapshot
        from ..store.tables import Database

        new_db = None
        db = self.db
        if self.db.root is not None:
            for t in self.db.tables.values():
                t.flush_bulk()
                if hasattr(t._kv, "flush"):
                    t._kv.flush()
            new_db = Database(self.db.root, backend=self.db.backend_kind)
            db = new_db
        snapshot = build_snapshot(db)
        facts = self._build_sharded(snapshot)
        if warm:
            import jax

            ghost = copy.copy(self)
            ghost.db = db
            ghost._live = (snapshot, facts)
            ghost.snapshot, ghost.index = snapshot, facts
            # warm policy: on an accelerator always; on the CPU mesh only
            # when the jit-relevant signature CHANGED — a same-shape swap is
            # fully covered by the geometry-keyed scorer cache + jit cache,
            # and re-executing every program at half-million-doc scale
            # costs minutes of host time. A changed signature MUST warm
            # even on CPU: a lazy shard_map compile under live load starves
            # in-flight collectives past XLA's ~40 s rendezvous watchdog
            # and aborts the process.
            # NOTE scorer_meta alone is NOT the compile key — the index
            # arrays are jit ARGUMENTS, so any padded-shape drift (vocab
            # growth, a posting pad boundary) recompiles too; compare the
            # full array signature.
            geometry_changed = _index_sig(facts.sidx) != _index_sig(
                self._live[1].sidx
            )
            if jax.default_backend() != "cpu" or geometry_changed:
                ghost.warmup()
            ghost.prewarm_hydration()
            ghost.prewarm_wordlist()
        return (new_db, snapshot, facts)

    def commit_refresh(self, state):
        """O(pointer) swap; returns the superseded Database for the caller
        to close OFF the serving lock (see QueryEngine.commit_refresh)."""
        new_db, snapshot, facts = state
        old_db = self.db if new_db is not None else None
        if new_db is not None:
            self.db = new_db
        self._live = (snapshot, facts)
        self.snapshot, self.index = snapshot, facts
        return old_db

    def refresh(self) -> None:
        old_db = self.commit_refresh(self.prepare_refresh(warm=False))
        if old_db is not None:
            old_db.close()

    def _scorer(self, facts: _ShardedLive, topk: int):
        s = facts.scorers.get(topk)
        if s is None:
            key = (scorer_meta(facts.sidx), topk)
            s = self._scorer_cache.get(key)
            if s is None:
                kwargs = {}
                if self._bm25:
                    kwargs = dict(
                        scoring="bm25",
                        title_boost=self.model.title_boost,
                        body_boost=self.model.body_boost,
                    )
                s = make_sharded_scorer(key[0], topk=topk, **kwargs)
                self._scorer_cache[key] = s
            facts.scorers[topk] = s
        return s

    def _mixed_scorer(self, facts: _ShardedLive, topk: int):
        key_local = ("mixed", topk)
        s = facts.scorers.get(key_local)
        if s is None:
            key = ("mixed", scorer_meta(facts.sidx), topk)
            s = self._scorer_cache.get(key)
            if s is None:
                from ..parallel.sharded import make_sharded_mixed_scorer

                s = make_sharded_mixed_scorer(key[1], topk=topk)
                self._scorer_cache[key] = s
            facts.scorers[key_local] = s
        return s

    def _use_mixed(self, sidx, parsed: list[ParsedQuery]) -> bool:
        """Mirror of the single-chip fused-lane routing (engine.rank /
        BlendedRanker.supports_mixed): reference blend + dense position
        layout; BM25/custom blends and truncated dense rows keep the
        sparse two-phase lane."""
        return (
            any(p.phrase_hashes for p in parsed)
            and not self._bm25
            and sidx.pos_dense
            and not sidx.dense_truncated
        )

    def class_batching_pays(self, live=None) -> bool:
        """Sharded mirror of QueryEngine.class_batching_pays (the inherited
        one walks DeviceIndex attributes this engine never builds): the
        mesh has the same keyword-program/mixed-program split, so
        phrase-class segregation pays under the same conditions — fused
        mixed lane available and a large corpus."""
        if live is None:
            live = self._live
        snap, facts = live
        sidx = facts.sidx
        return (
            not self._bm25
            and sidx.pos_dense
            and not sidx.dense_truncated
            and snap.n_docs >= SEGREGATE_MIN_DOCS
        )

    def rank(
        self, parsed: list[ParsedQuery], topk: int = MAX_RESULTS, live=None
    ) -> tuple[np.ndarray, np.ndarray]:
        return self.rank_async(parsed, topk, live).finish()

    def rank_async(
        self, parsed: list[ParsedQuery], topk: int = MAX_RESULTS, live=None
    ):
        """Dispatch/fetch split for the micro-batcher pipeline (cf.
        QueryEngine.rank_async): the shard_map program launches here, the
        returned handle's finish() blocks for the packed fetch. MUST shadow
        the inherited single-chip rank_async — that one walks the
        DeviceIndex live structure this engine never builds."""
        if live is None:
            live = self._live
        snap, facts = live
        sidx = facts.sidx
        b_real = len(parsed)
        # batch bucket: {B_SMALL, WARM_B_MAX} like the single-device engine
        # (a per-pow2 ladder would mean 8 live batch shapes, each a long
        # shard_map compile at large doc counts), also rounded up to the
        # query-row mesh axis
        from .engine import _b_bucket, _MultiRankHandle

        if b_real > WARM_B_MAX:
            # wider than any warmed shard_map program (warmup() stops at
            # WARM_B_MAX): split instead of compiling a live batch shape
            return _MultiRankHandle([
                self.rank_async(parsed[i : i + WARM_B_MAX], topk, live)
                for i in range(0, b_real, WARM_B_MAX)
            ])
        b = max(_b_bucket(b_real), self.n_query_rows, 1)
        if self._use_mixed(sidx, parsed):
            return self._rank_fused(parsed, topk, live, b)
        q_real = max((len(p.keyword_hashes) for p in parsed), default=1)
        p_real = max((len(p.phrase_hashes) for p in parsed), default=0)
        n_ph = sum(1 for p in parsed if p.phrase_hashes)
        # compile-shape policy (see engine.py): common shapes ride fine
        # buckets, any rare axis collapses onto the single catch-all program
        rare = q_real > Q_BASE or p_real > Q_BASE
        if rare:
            q = Q_CATCHALL
            p_max = _P_SHARD_MAX
            b = max(b, WARM_B_MAX)
        else:
            q = Q_BASE
            p_max = Q_BASE
        # phrase sets ride a COMPRESSED axis (bp rows) + a batch-row map, so
        # the in-block matcher's temporaries scale with the number of phrase
        # queries, not the whole batch; bp is clamped to {1, b} so the
        # warmed shape set stays finite
        bp = 1 if n_ph <= 1 and not rare else b
        if q_real > Q_CATCHALL:
            import logging

            logging.getLogger("spaghettisearch.engine").warning(
                "query has %d keyword terms; scoring the first %d",
                q_real, Q_CATCHALL,
            )
        if p_real > p_max:
            import logging

            logging.getLogger("spaghettisearch.engine").warning(
                "phrase has %d terms; matching the first %d", p_real, p_max
            )

        hot_map = self._hot_map(self.model, sidx)
        term_ids, qlen, qn, qnb, hot_sids = self._fill_keyword_rows(
            parsed, b, q, snap, hot_map
        )
        ph_ids = np.full((bp, p_max), snap.n_words, dtype=np.int32)
        ph_valid = np.zeros((bp, p_max), dtype=bool)
        gens = np.zeros(bp, dtype=np.int32)
        ph_rows = np.full(bp, b, dtype=np.int32)  # pad rows drop in the fold
        ph_i = 0
        for i, p in enumerate(parsed):
            if p.phrase_hashes:
                row = snap.term_ids(p.phrase_hashes)[:p_max]
                ph_ids[ph_i, : len(row)] = row
                ph_valid[ph_i, : len(row)] = True
                t_df = snap.title.df(row)
                b_df = snap.body.df(row)
                gens[ph_i] = int(np.argmin(t_df + b_df))
                ph_rows[ph_i] = i
                ph_i += 1

        topic_probs = np.zeros((b, facts.n_categories), dtype=np.float32)
        if self.use_topic_model:
            from .topics import compute_topic_probs

            for i, p in enumerate(parsed):
                probs = compute_topic_probs(
                    self.db, p.keyword_hashes, fixed=self.topic_model_fixed
                )
                for j, c in enumerate(snap.categories):
                    topic_probs[i, j] = probs.get(c, 0.0)

        # sort by descending (cold-bounded) term count: each shard's keyword
        # kernel then bounds its compare loop by the row-block max (the
        # single-device qn bound); phrase-row map indices follow the sort
        perm = np.lexsort((-qn, -qnb))
        inv = np.empty_like(perm)
        inv[perm] = np.arange(b)
        term_ids, qlen, qn, qnb = term_ids[perm], qlen[perm], qn[perm], qnb[perm]
        hot_sids = hot_sids[perm]
        topic_probs = topic_probs[perm]
        ph_rows = np.where(ph_rows < b, inv[np.minimum(ph_rows, b - 1)], b)

        with TRACER.span("rank.sharded"):
            scores, ids = self._scorer(facts, topk)(
                sidx,
                jnp.asarray(term_ids), jnp.asarray(qlen), jnp.asarray(topic_probs),
                jnp.asarray(ph_ids), jnp.asarray(ph_valid), jnp.asarray(gens),
                jnp.asarray(ph_rows), jnp.asarray(qn), jnp.asarray(qnb),
                jnp.asarray(hot_sids),
            )
            return _ShardedRankHandle(scores, ids, b_real, snap.n_docs, inv)

    def _rank_fused(
        self, parsed: list[ParsedQuery], topk: int, live, b: int
    ) -> _ShardedRankHandle:
        """Fused mixed lane on the mesh (cf. QueryEngine._rank_fused): one
        shard_map program per (b, q) bucket scores keywords AND matches
        phrases densely in-kernel, per batch ROW — no compressed-bp axis, no
        matcher fetch, one dispatch + one packed fetch per mixed batch.
        Phrase width is the single static P_LEVELS[-1] pad (the kernel's
        phrase loops are dynamic-trip, a wide pad column costs nothing)."""
        snap, facts = live
        sidx = facts.sidx
        b_real = len(parsed)
        q_real = max((len(p.keyword_hashes) for p in parsed), default=1)
        if q_real <= Q_BASE:
            q = Q_BASE
        else:
            q = Q_CATCHALL
            b = max(b, WARM_B_MAX)
            if q_real > Q_CATCHALL:
                import logging

                logging.getLogger("spaghettisearch.engine").warning(
                    "query has %d keyword terms; scoring the first %d",
                    q_real, Q_CATCHALL,
                )
        p_lvl = _P_SHARD_MAX
        p_real = max((len(p.phrase_hashes) for p in parsed), default=0)
        if p_real > p_lvl:
            import logging

            logging.getLogger("spaghettisearch.engine").warning(
                "phrase has %d terms; matching the first %d", p_real, p_lvl
            )

        hot_map = self._hot_map(self.model, sidx)
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

        topic_probs = np.zeros((b, facts.n_categories), dtype=np.float32)
        if self.use_topic_model:
            from .topics import compute_topic_probs

            for i, pq in enumerate(parsed):
                probs = compute_topic_probs(
                    self.db, pq.keyword_hashes, fixed=self.topic_model_fixed
                )
                for j, c in enumerate(snap.categories):
                    topic_probs[i, j] = probs.get(c, 0.0)

        # phrase rows first (descending pn), then by cold-term count (the
        # body sweep's bound under the hot split), then total keywords:
        # phrase-free 8-row blocks skip the kernel's phrase stage, keyword
        # blocks keep the qn compare-loop dispatch win
        perm = np.lexsort((-qn, -qnb, -pn))
        inv = np.empty_like(perm)
        inv[perm] = np.arange(b)
        term_ids, qlen, qn, pn = term_ids[perm], qlen[perm], qn[perm], pn[perm]
        qnb, hot_sids = qnb[perm], hot_sids[perm]
        ph_ids, ph_valid = ph_ids[perm], ph_valid[perm]
        topic_probs = topic_probs[perm]

        with TRACER.span("rank.sharded"):
            scores, ids = self._mixed_scorer(facts, topk)(
                sidx,
                jnp.asarray(term_ids), jnp.asarray(qlen),
                jnp.asarray(topic_probs), jnp.asarray(ph_ids),
                jnp.asarray(ph_valid), jnp.asarray(qn), jnp.asarray(pn),
                jnp.asarray(qnb), jnp.asarray(hot_sids),
            )
            return _ShardedRankHandle(scores, ids, b_real, snap.n_docs, inv)

    def warmup(self, max_batch: int = WARM_B_MAX) -> None:  # pragma: no cover - timing
        """Walk the reachable sharded compile shapes (cf. QueryEngine.warmup):
        per batch BUCKET ({B_SMALL, WARM_B_MAX}) the keyword program plus —
        fused mixed lane active — one mixed (b, Q_BASE) program (pn/qn are
        dynamic, so one program covers 1-phrase through all-phrase), or —
        sparse lane — the single-phrase (bp=1) and all-phrase (bp=b)
        matcher programs; plus the rare catch-alls (q=Q_CATCHALL) for both
        the keyword-only and the phrase grammar."""
        from .engine import B_SMALL

        if self.index.n_docs == 0:
            return
        kw = parse_query("warmup")
        ph = parse_query('"warm up"')
        mixed = self._use_mixed(self.index.sidx, [ph])
        rare_kw = ParsedQuery(
            raw="", stripped="", phrases=[],
            keyword_hashes=["0" * 32] * (Q_BASE + 1),
            phrase_hashes=[],
        )
        rare = ParsedQuery(
            raw="", stripped="", phrases=["w"],
            keyword_hashes=["0" * 32] * (Q_BASE + 1),
            phrase_hashes=["0" * 32] * (Q_BASE + 1),
        )
        for b in sorted({max(B_SMALL, self.n_query_rows, 1),
                         max(max_batch, self.n_query_rows, 1)}):
            self.rank([kw] * b, topk=MAX_RESULTS)
            self.rank([ph] + [kw] * (b - 1), topk=MAX_RESULTS)  # mixed/bp=1
            if b > 1 and not mixed:
                self.rank([ph] * b, topk=MAX_RESULTS)  # bp=b
        self.rank([rare], topk=MAX_RESULTS)  # phrase catch-all program
        self.rank([rare_kw], topk=MAX_RESULTS)  # keyword catch-all program
