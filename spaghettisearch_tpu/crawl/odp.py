"""ODP (Open Directory) topic scraper for topic-sensitive PageRank.

Equivalent of the reference's colly-based scraper (reference:
crawler/ODP-scraper.go:55-235): scrape the directory's top categories, fan
out per-topic crawls over subcategory pages (same host, path-prefixed) and
listed external resource pages, aggregate per-category term frequencies, and
store:

  topic_meta[category]   = {"numPages": pages visited, "wordCount": #terms}
  inv_topic[wordHash]    = {category: frequency}

Parity notes:
- like the reference (ODP-scraper.go:201-208), only *title* terms of external
  resource pages feed the category term vector (its body aggregation is dead
  code);
- deliberate fix: the reference keys invTopic_PR by the raw stemmed word but
  queries it by md5 hash (retrieval/main_retrieve.go:30,120), so its topic
  model could never match; we key by md5 hash so the (optional) topic model
  actually works.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from urllib.parse import urljoin, urlsplit

from ..store.tables import Database
from ..text.page import parse_page
from ..utils.hashing import md5_hex


@dataclass
class TopicData:
    category: str
    values: dict[str, int] = field(default_factory=dict)
    num_pages: int = 0


def _dom(body: bytes):
    # lxml is needed only by the ODP topic scraper, never by serving
    from lxml import html as lxml_html

    try:
        return lxml_html.fromstring(body)
    except Exception:
        return None


def extract_top_categories(body: bytes, base_url: str) -> list[str]:
    """First link of each <li> under #triple (reference: ODP-scraper.go:64-75)."""
    root = _dom(body)
    if root is None:
        return []
    out = []
    for el in root.xpath('//*[@id="triple"]//li'):
        links = el.xpath(".//a[@href]")
        if links:
            out.append(urljoin(base_url, links[0].get("href")))
    return out


def extract_subcategories(body: bytes, page_url: str, topic_path: str) -> list[str]:
    """Same-host subcategory links whose path extends the topic's
    (reference: ODP-scraper.go:169-179)."""
    root = _dom(body)
    if root is None:
        return []
    # netloc, not hostname: keep the port so :port directory sites
    # distinguish their own pages from external resources (same deliberate
    # fix as resolve_href; the reference uses Hostname(), ODP-scraper.go:169)
    host = urlsplit(page_url).netloc
    out = []
    for a in root.xpath('//body//div[contains(@class,"container")]//ul[@id="triple"]//li//a[@href]'):
        link = a.get("href")
        if link and link.startswith(topic_path):
            u = urljoin(page_url, link)
            if urlsplit(u).netloc == host:
                out.append(u)
    return out


def extract_resources(body: bytes, page_url: str) -> list[str]:
    """External resource links from listing entries
    (reference: ODP-scraper.go:182-188)."""
    root = _dom(body)
    if root is None:
        return []
    out = []
    for a in root.xpath(
        '//body//div[contains(@class,"container")]//ul//li[contains(@class,"listings")]//h4//a[@href]'
    ):
        out.append(urljoin(page_url, a.get("href")))
    return out


async def crawl_topic(
    fetcher,
    topic_url: str,
    parallelism: int = 100,
    max_pages: int = 1000,
) -> TopicData:
    parts = urlsplit(topic_url)
    category = parts.path.replace("/", "")
    data = TopicData(category=category)
    host = parts.netloc
    sem = asyncio.Semaphore(parallelism)
    visited: set[str] = set()
    lock = asyncio.Lock()

    async def visit(url: str) -> None:
        async with sem:
            data.num_pages += 1  # counts every request (ODP-scraper.go:212-218)
            try:
                result = await fetcher(url)
            except Exception:
                return
        if urlsplit(url).netloc == host:
            children = []
            if data.num_pages <= max_pages:
                children += extract_subcategories(result.body, url, parts.path)
                children += extract_resources(result.body, url)
            tasks = []
            async with lock:
                for c in children:
                    if c not in visited:
                        visited.add(c)
                        tasks.append(asyncio.create_task(visit(c)))
            for t in tasks:
                await t
        else:
            page = parse_page(result.body, url)
            async with lock:
                for term, freq in page.title.freq.items():
                    data.values[term] = data.values.get(term, 0) + freq

    visited.add(topic_url)
    await visit(topic_url)
    return data


async def parse_odp(
    db: Database,
    fetcher,
    seed_url: str = "http://odp.org/",
    parallelism: int = 100,
    log=print,
) -> list[TopicData]:
    """Scrape all topics and populate topic_meta + inv_topic
    (reference: ODP-scraper.go:55-142)."""
    try:
        seed = await fetcher(seed_url)
    except Exception as e:
        log(f"ODP seed fetch failed ({e}); skipping topic scrape")
        return []
    topics = extract_top_categories(seed.body, seed_url)
    results = await asyncio.gather(
        *(crawl_topic(fetcher, t, parallelism) for t in topics)
    )

    final: dict[str, dict[str, int]] = {}
    with db.topic_meta.batch() as bw:
        for data in results:
            bw.set(
                data.category,
                {"numPages": float(data.num_pages), "wordCount": float(len(data.values))},
            )
            for term, freq in data.values.items():
                final.setdefault(term, {})[data.category] = freq

    with db.inv_topic.batch() as bw:
        for term, cats in final.items():
            bw.set(md5_hex(term), cats)
    return list(results)
