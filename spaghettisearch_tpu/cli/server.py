"""Server CLI (reference: cmd/server/server.go:87-125 with $PORT env)."""

from __future__ import annotations

import argparse
import logging
import os

from ..retrieval.engine import QueryEngine
from ..serve.server import SearchServer
from ..store.tables import Database
from ..utils.jaxcache import enable_persistent_cache


def main(argv: list[str] | None = None) -> None:
    enable_persistent_cache()
    ap = argparse.ArgumentParser(description="SpaghettiSearch server")
    ap.add_argument("--db", default="./db_data")
    ap.add_argument("--port", type=int, default=int(os.environ.get("PORT") or 8080))
    ap.add_argument("--topicModel", action="store_true",
                    help="enable the topic-sensitive PageRank blend "
                         "(repaired probability model)")
    ap.add_argument("--topicQuirk", action="store_true",
                    help="with --topicModel: reproduce the reference's "
                         "zero-seeded probability product, which always "
                         "yields 0 (retrieval/main_retrieve.go:142-145)")
    ap.add_argument("--snapshot", default=None,
                    help="load a saved columnar snapshot instead of walking the store")
    ap.add_argument("--ranker", choices=("blended", "bm25"), default="blended",
                    help="blended = the reference's TF-IDF/PageRank formula; "
                         "bm25 = Okapi BM25 with field boosts")
    ap.add_argument("--meshShards", type=int, default=0,
                    help="serve with the doc-sharded multi-chip scorer over "
                         "N mesh shards (0 = single-chip engine)")
    ap.add_argument("--meshBatch", type=int, default=1,
                    help="with --meshShards: query-data-parallel rows of a "
                         "2-D mesh")
    ap.add_argument("--bigBatch", action="store_true",
                    help="serve with a 256-row micro-batch ceiling (adds "
                         "the B_BIG program bucket; single-device engine "
                         "only). Costs extra warmup compiles; pays when "
                         "per-execution overhead, not the kernel, bounds "
                         "throughput")
    ap.add_argument("--noBatching", action="store_true")
    ap.add_argument("--fetchers", type=int, default=1,
                    help="concurrent device->host fetch threads in the "
                         "micro-batcher")
    ap.add_argument("--phraseSegregate", default="auto",
                    choices=("auto", "on", "off"),
                    help="phrase-class batch segregation: keep keyword-only "
                         "traffic on the leveled keyword program (auto = "
                         "engine decides by tier; see MicroBatcher)")
    ap.add_argument("--phrasePatienceMs", type=float, default=250.0,
                    help="max extra wait for a non-full phrase-class batch "
                         "while keyword work is pending")
    ap.add_argument("--phrasePoolMin", type=int, default=0,
                    help="merge the pooled phrase cohort into one mixed "
                         "batch once this many phrases wait (0 = off; "
                         "trades throughput for phrase latency — merged "
                         "batches give up the leveled keyword program)")
    ap.add_argument("--phraseStale", choices=("merge", "pure"),
                    default="merge",
                    help="patience-expired phrase cohort policy: merge "
                         "into the next arrival-order batch (default) or "
                         "dispatch standalone as a small pure-phrase batch "
                         "(adds one mixed (32,4) program; a latency-vs-qps "
                         "trade)")
    ap.add_argument("--resultTimeoutS", type=float, default=300.0,
                    help="per-request batcher future timeout; raise when "
                         "serving --noWarmup on a slow mesh where a cold "
                         "lazy compile can hold a batch for >5 min")
    ap.add_argument("--noWarmup", action="store_true",
                    help="skip pre-compiling the query programs at startup")
    ap.add_argument("--resultCache", type=int, default=0,
                    help="cache up to N finished /query responses per "
                         "refresh generation (0 = off; benchmarks run "
                         "uncached)")
    ap.add_argument("--platform", default=None, choices=("cpu", "gpu"),
                    help="force the JAX backend: gpu (the Triton keyword "
                         "kernel) or cpu (the XLA formulation, no "
                         "accelerator)")
    args = ap.parse_args(argv)
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    # NOTE: the serving process must NOT run the store GC daemon — compaction
    # rewrites data.log from this process's in-RAM map, and the documented
    # crawl-subprocess-then-/refresh workflow appends from ANOTHER process;
    # compaction belongs to the single writer (the crawl CLI). The backends
    # also refuse foreign-append compaction as defense in depth.
    db = Database(args.db)
    snapshot = None
    if args.snapshot:
        from ..index.persist import load_snapshot

        snapshot = load_snapshot(args.snapshot)
    kwargs = {}
    if args.ranker == "bm25":
        from ..models.bm25 import BM25Ranker

        kwargs["model"] = BM25Ranker()
    cls = QueryEngine
    if args.meshShards:
        from ..retrieval.sharded_engine import ShardedQueryEngine

        cls = ShardedQueryEngine
        kwargs["n_shards"] = args.meshShards
        kwargs["n_query_rows"] = args.meshBatch
        if args.bigBatch:
            logging.getLogger("spaghettisearch.serve").warning(
                "--bigBatch is single-chip only; ignoring with --meshShards"
            )
            args.bigBatch = False
    elif args.bigBatch:
        kwargs["big_batch"] = True
    if args.phraseStale == "pure" and "n_shards" not in kwargs:
        kwargs["phrase_b32"] = True  # warm the (32, Q_BASE) mixed program
    engine = cls(
        db, snapshot=snapshot, use_topic_model=args.topicModel,
        topic_model_fixed=args.topicModel and not args.topicQuirk,
        **kwargs,
    )
    print(f"Loaded index: {engine.index.n_docs} docs, {engine.index.n_words} words")
    if not args.noWarmup:
        import time as _time

        t0 = _time.perf_counter()
        print("Warming up query programs...", flush=True)
        engine.warmup()
        built = engine.prewarm_hydration()
        engine.prewarm_wordlist()
        print(f"Warmup done in {_time.perf_counter() - t0:.1f}s "
              f"({built} hydration records prebuilt)")
        from ..utils.timing import TRACER

        TRACER.reset()  # /stats should reflect live traffic, not warmup
    print(f"\nServer is running on port {args.port}")
    SearchServer(
        engine, batching=not args.noBatching, result_cache=args.resultCache,
        max_batch=256 if args.bigBatch else 128, n_fetchers=args.fetchers,
        segregate=args.phraseSegregate, ph_patience_ms=args.phrasePatienceMs,
        ph_pool_min=args.phrasePoolMin, ph_stale=args.phraseStale,
        result_timeout_s=args.resultTimeoutS,
    ).serve(port=args.port)


if __name__ == "__main__":
    main()
