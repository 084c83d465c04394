"""spaghettisearch_tpu — a batched, device-resident search-engine framework.

A from-scratch rebuild of the capabilities of nwihardjo/SpaghettiSearch
(a concurrent Go/BadgerDB web search engine) in JAX, run on an NVIDIA GPU:

- The inverted index lives in device memory as padded CSR postings +
  positional arrays (reference: Go map-of-maps rows in BadgerDB,
  database/database.go:85-99).
- Query scoring (TF-IDF cosine + PageRank blend + top-k) is a single jit'd
  XLA program over a query *batch* (reference: goroutine fan-out/fan-in per
  term/doc, retrieval/main_retrieve.go:50-97); its keyword sweep is a
  Pallas kernel through Triton.
- Topic-sensitive PageRank is a batched power iteration with a category axis
  (reference: per-category Go loops, ranking/pagerank.go:14-124).
- Phrase search is a vectorized positional-intersection program
  (reference: sort-merge per doc, retrieval/phrase.go).
- The crawler, HTML tokenizer, durable store, and HTTP API stay host-side and
  stream columnar snapshots to the device.
- Multi-device scale-out uses jax.sharding.Mesh + shard_map
  (doc-sharded postings, per-shard top-k + all-gather merge).
"""

__version__ = "0.1.0"
