"""Crawl driver CLI.

Equivalent of the reference's bin/crawl (reference:
cmd/crawl/start_crawl.go:25-181): flags -numPages/-startURL/-domainOnly,
one-time ODP topic scrape (skipped when Topic_metadata is already populated),
BFS crawl, then the post-crawl batch jobs: topic-sensitive PageRank followed
by tf-idf term weighting for title and body.

Usage:
  python -m spaghettisearch_tpu.cli.crawl [--numPages N] [--startURL URL]
      [--domainOnly {true,false}] [--db PATH]
"""

from __future__ import annotations

import argparse
import asyncio
import time

from ..config import (
    CRAWL_DEFAULT_DOMAIN_ONLY,
    CRAWL_DEFAULT_PAGES,
    CRAWL_DEFAULT_START,
    PAGERANK_CONVERGENCE,
    PAGERANK_DAMPING,
)
from ..crawl.frontier import crawl
from ..crawl.odp import parse_odp
from ..ops.pagerank import update_pagerank
from ..ops.weighting import update_term_weights
from ..store.tables import Database
from ..utils.jaxcache import enable_persistent_cache
from ..utils.timing import TRACER


def _bool(v: str) -> bool:
    return v.lower() not in ("false", "0", "no")


def main(argv: list[str] | None = None) -> None:
    enable_persistent_cache()
    ap = argparse.ArgumentParser(description="SpaghettiSearch crawler")
    ap.add_argument("--numPages", type=int, default=CRAWL_DEFAULT_PAGES)
    ap.add_argument("--startURL", default=CRAWL_DEFAULT_START)
    ap.add_argument("--domainOnly", type=_bool, default=CRAWL_DEFAULT_DOMAIN_ONLY)
    ap.add_argument("--db", default="./db_data", help="store root directory")
    ap.add_argument("--odpURL", default="http://odp.org/")
    ap.add_argument("--skipODP", action="store_true")
    ap.add_argument("--damping", type=float, default=PAGERANK_DAMPING)
    ap.add_argument("--convergence", type=float, default=PAGERANK_CONVERGENCE)
    ap.add_argument("--topicPagerank", action="store_true",
                    help="repaired topic-sensitive PageRank: per-category "
                         "ODP teleport vectors, so categories converge to "
                         "genuinely different ranks (the reference's "
                         "category loop is decorative, pagerank.go:60-61); "
                         "serve with --topicModel to blend them")
    ap.add_argument("--saveSnapshot", default=None,
                    help="also export the columnar snapshot to this directory")
    args = ap.parse_args(argv)

    print("Crawler started...")
    start = time.time()
    db = Database(args.db)

    async def run() -> None:
        # one-time topic scrape (reference: start_crawl.go:74-77)
        if not args.skipODP and len(db.topic_meta) == 0:
            from ..crawl.fetch import AiohttpFetcher

            t0 = time.time()
            async with AiohttpFetcher() as fetcher:
                await parse_odp(db, fetcher, seed_url=args.odpURL)
            print(f"ODP topic scrape: {time.time() - t0:.1f}s")

        stats = await crawl(
            db,
            args.startURL,
            num_pages=args.numPages,
            domain_only=args.domainOnly,
        )
        print(f"\nTotal visited length: {stats.visited} "
              f"(indexed {stats.indexed}, errors {stats.errors})")

    asyncio.run(run())
    print(f"\nTotal crawling and indexing time: {time.time() - start:.1f}s")

    timer = time.time()
    update_pagerank(db, damping=args.damping, eps=args.convergence,
                    personalized=args.topicPagerank)
    update_term_weights(db, "title")
    update_term_weights(db, "body")
    print(f"Updating pagerank and idf takes {time.time() - timer:.1f}s")
    db.flush()
    if args.saveSnapshot:
        from ..index.persist import save_snapshot
        from ..index.snapshot import build_snapshot

        save_snapshot(build_snapshot(db), args.saveSnapshot)
        print(f"Snapshot saved to {args.saveSnapshot}")
    db.close()
    print(f"\nTotal elapsed time: {time.time() - start:.1f}s")
    print(TRACER.report())


if __name__ == "__main__":
    main()
