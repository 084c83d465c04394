"""Topic-sensitive PageRank as batched on-device power iteration.

The reference runs one Go power-iteration loop per ODP category over a
map-based link graph (reference: ranking/pagerank.go:14-145). Here the link
graph is two flat edge arrays (src, dst) sorted by destination, the rank
vector is dense, and one jit'd lax.while_loop iterates all categories as a
leading batch axis:

    contrib[p] = d * r[p] / outdeg[p]           (0 when outdeg == 0)
    inherited  = segment_sum(contrib[src] -> dst)
    total      = sum(contrib) + (1-d) * N
    r'         = (first_iter * r + inherited + (1-d)) / total
    delta      = sum(|r' - r|)   ; stop when delta <= eps (or max_iters)

Reference quirks preserved: the first iteration adds the uniform init value
on top of the inherited mass (pagerank.go:97-107 only clears currentRank from
iteration 2), and the init is 1/numPages with numPages taken from the
*category metadata*, not the node count (pagerank.go:60-61,104).

Converged categories yield identical vectors (same fixed point) — a
faithfully preserved reference quirk: its per-category runs differ only in a
log line (pagerank.go:60-61,104), so the category axis is decorative.

`personalized=True` transcends the quirk (the analogue of topics.py
fixed=True): each category teleports to a personalization vector derived
from the ODP term profiles (invTopic_PR word->category frequencies) crossed
with each document's term frequencies, i.e. true topic-sensitive PageRank —
categories converge to genuinely different vectors, blended at query time
through --topicModel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PAGERANK_CONVERGENCE, PAGERANK_DAMPING
from ..store.tables import Database

DEFAULT_MAX_ITERS = 200


def pagerank_power(
    edge_src: jax.Array,  # int32 [E] parent node ids (sorted by edge_dst)
    edge_dst: jax.Array,  # int32 [E] child node ids
    outdeg: jax.Array,  # f [N]
    n_pages: jax.Array,  # f [C] per-category page count (init 1/n)
    n_nodes: int,
    damping: float = PAGERANK_DAMPING,
    eps: float = PAGERANK_CONVERGENCE,
    max_iters: int = DEFAULT_MAX_ITERS,
    valid: jax.Array | None = None,  # f [N_pad] 1/0; rows past n_nodes
) -> jax.Array:
    """Returns ranks [C, N]. Dtype follows `outdeg`/`n_pages` (f32 on the
    device; pass float64 arrays under jax_enable_x64 for bit-level parity tests).

    Arrays may be padded past n_nodes (pass `valid` to mask pad rows, and
    point pad edges at dst >= N_pad so segment_sum drops them): padded
    shapes bucket to powers of two so different crawl sizes reuse compiled
    programs. Pad rows hold rank 0 and never touch totals or deltas."""
    dtype = outdeg.dtype
    c = n_pages.shape[0]
    n_pad = outdeg.shape[0]
    teleport = jnp.asarray(1.0 - damping, dtype)
    n = jnp.asarray(n_nodes, dtype)
    inv_out = jnp.where(outdeg > 0, damping / jnp.maximum(outdeg, 1), 0.0).astype(dtype)
    if valid is None:
        valid = jnp.ones(n_pad, dtype)
    valid = valid.astype(dtype)

    r0 = jnp.broadcast_to((1.0 / n_pages)[:, None], (c, n_pad)).astype(dtype) * valid

    def step(state):
        r, it, _ = state
        contrib = r * inv_out[None, :]  # [C, N]
        inherited = jax.ops.segment_sum(
            contrib[:, edge_src].T, edge_dst, num_segments=n_pad,
            indices_are_sorted=True,  # edges sorted by dst (pads at the end)
        ).T  # [C, N]
        total = jnp.sum(contrib, axis=1, keepdims=True) + teleport * n
        base = jnp.where(it == 0, r, 0.0)
        r_new = (base + inherited + teleport * valid[None, :]) / total
        delta = jnp.max(jnp.sum(jnp.abs(r_new - r), axis=1))
        return r_new, it + 1, delta

    def cond(state):
        _, it, delta = state
        return jnp.logical_and(delta > eps, it < max_iters)

    init = (r0, jnp.array(0, jnp.int32), jnp.asarray(jnp.inf, dtype))
    r_final, _, _ = jax.lax.while_loop(cond, step, init)
    return r_final[:, :n_nodes]


def pagerank_personalized(
    edge_src: jax.Array,  # int32 [E] (sorted by edge_dst; pads -> dst >= N_pad)
    edge_dst: jax.Array,  # int32 [E]
    outdeg: jax.Array,  # f [N_pad]
    personalization: jax.Array,  # f [C, N_pad] (row-normalized; pads 0)
    n_nodes: int,
    damping: float = PAGERANK_DAMPING,
    eps: float = 1e-12,
    max_iters: int = DEFAULT_MAX_ITERS,
) -> jax.Array:
    """Textbook topic-sensitive PageRank (one batched power iteration, the
    category axis leading): r' = d*(A r + dangling_mass * p) + (1-d) * p.
    Returns ranks [C, N] (each category sums to 1). This is the repaired
    model the reference's decorative category loop was meant to be."""
    dtype = outdeg.dtype
    n_pad = outdeg.shape[0]
    p = personalization.astype(dtype)
    inv_out = jnp.where(outdeg > 0, 1.0 / jnp.maximum(outdeg, 1), 0.0).astype(dtype)
    has_out = (outdeg > 0).astype(dtype)
    r0 = p

    def step(state):
        r, it, _ = state
        contrib = r * inv_out[None, :]
        inherited = jax.ops.segment_sum(
            contrib[:, edge_src].T, edge_dst, num_segments=n_pad,
            indices_are_sorted=True,
        ).T
        dangling = jnp.sum(r * (1.0 - has_out)[None, :], axis=1, keepdims=True)
        r_new = damping * (inherited + dangling * p) + (1.0 - damping) * p
        delta = jnp.max(jnp.sum(jnp.abs(r_new - r), axis=1))
        return r_new, it + 1, delta

    def cond(state):
        _, it, delta = state
        return jnp.logical_and(delta > eps, it < max_iters)

    init = (r0, jnp.array(0, jnp.int32), jnp.asarray(jnp.inf, dtype))
    r_final, _, _ = jax.lax.while_loop(cond, step, init)
    return r_final[:, :n_nodes]


def topic_personalization(
    db: Database, node_list: list[str], categories: list[str]
) -> np.ndarray:
    """Per-category teleport vectors [C, N] from the ODP term profiles:
    affinity(doc, cat) = sum over the doc's terms of the category's ODP
    frequency for that term (invTopic_PR, ODP-scraper.go:128-139) weighted
    by the doc's term frequency (DocInfo words_mapping), row-normalized.
    Categories with zero affinity everywhere fall back to uniform."""
    node_id = {h: i for i, h in enumerate(node_list)}
    cat_id = {c: j for j, c in enumerate(categories)}
    n, c = len(node_list), len(categories)
    # word -> per-category freq (the ODP vocabulary is small)
    word_cat = {wh: row for wh, row in db.inv_topic.items()}
    aff = np.zeros((c, n), dtype=np.float64)
    for dh, info in db.doc_info.items():
        i = node_id.get(dh)
        if i is None:
            continue
        for wh, tf in info.words_mapping.items():
            row = word_cat.get(wh)
            if not row:
                continue
            for cat, freq in row.items():
                j = cat_id.get(cat)
                if j is not None:
                    aff[j, i] += float(freq) * float(tf)
    sums = aff.sum(axis=1, keepdims=True)
    uniform = np.full((1, n), 1.0 / max(n, 1))
    return np.where(sums > 0, aff / np.maximum(sums, 1e-30), uniform)


def _load_graph(db: Database) -> tuple[list[str], np.ndarray, np.ndarray, np.ndarray]:
    """Node census + edge arrays from the children table
    (reference: pagerank.go:18-43 builds the same node set)."""
    children_rows = dict(db.doc_children.items())
    nodes: set[str] = set(children_rows)
    for kids in children_rows.values():
        nodes.update(kids)
    node_list = sorted(nodes)
    node_id = {h: i for i, h in enumerate(node_list)}

    srcs: list[int] = []
    dsts: list[int] = []
    outdeg = np.zeros(len(node_list), dtype=np.float64)
    for parent, kids in children_rows.items():
        p = node_id[parent]
        outdeg[p] = len(kids)
        for kid in kids:
            srcs.append(p)
            dsts.append(node_id[kid])

    edge_src = np.asarray(srcs, dtype=np.int32)
    edge_dst = np.asarray(dsts, dtype=np.int32)
    order = np.argsort(edge_dst, kind="stable")
    return node_list, edge_src[order], edge_dst[order], outdeg


def update_pagerank(
    db: Database,
    damping: float = PAGERANK_DAMPING,
    eps: float = PAGERANK_CONVERGENCE,
    max_iters: int = DEFAULT_MAX_ITERS,
    personalized: bool = False,
) -> None:
    """Recompute per-category PageRank and store doc_rank rows
    (reference: ranking/pagerank.go:14-83). personalized=True runs the
    repaired topic-sensitive model (per-category ODP teleport vectors)
    instead of the reference's decorative category loop."""
    node_list, edge_src, edge_dst, outdeg = _load_graph(db)
    n_nodes = len(node_list)
    if n_nodes == 0:
        return

    categories = sorted(db.topic_meta.keys())
    if categories and personalized:
        dtype = jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32

        def _pow2(x: int, floor: int = 256) -> int:
            p = floor
            while p < x:
                p *= 2
            return p

        n_pad = _pow2(n_nodes)
        e_pad = _pow2(max(len(edge_src), 1))
        src_p = np.zeros(e_pad, np.int32)
        src_p[: len(edge_src)] = edge_src
        dst_p = np.full(e_pad, n_pad, np.int32)
        dst_p[: len(edge_dst)] = edge_dst
        out_p = np.zeros(n_pad, outdeg.dtype)
        out_p[:n_nodes] = outdeg
        pers = topic_personalization(db, node_list, categories)
        pers_p = np.zeros((len(categories), n_pad), pers.dtype)
        pers_p[:, :n_nodes] = pers
        ranks = np.asarray(
            pagerank_personalized(
                jnp.asarray(src_p), jnp.asarray(dst_p),
                jnp.asarray(out_p, dtype=dtype),
                jnp.asarray(pers_p, dtype=dtype),
                n_nodes, damping=damping,
                eps=max(eps, 1e-12), max_iters=max_iters,
            )
        )
    elif categories:
        n_pages = np.array(
            [max(float((db.topic_meta.get(c) or {}).get("numPages", 0.0)), 1.0) for c in categories]
        )
        dtype = jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32

        # bucket node/edge counts to powers of two so successive crawls of
        # different sizes reuse the compiled while_loop
        def _pow2(x: int, floor: int = 256) -> int:
            p = floor
            while p < x:
                p *= 2
            return p

        n_pad = _pow2(n_nodes)
        e_pad = _pow2(max(len(edge_src), 1))
        src_p = np.zeros(e_pad, np.int32)
        src_p[: len(edge_src)] = edge_src
        dst_p = np.full(e_pad, n_pad, np.int32)  # pad edges -> dropped segment
        dst_p[: len(edge_dst)] = edge_dst
        out_p = np.zeros(n_pad, outdeg.dtype)
        out_p[:n_nodes] = outdeg
        valid = np.zeros(n_pad, np.float32)
        valid[:n_nodes] = 1.0

        ranks = np.asarray(
            pagerank_power(
                jnp.asarray(src_p),
                jnp.asarray(dst_p),
                jnp.asarray(out_p, dtype=dtype),
                jnp.asarray(n_pages, dtype=dtype),
                n_nodes,
                damping=damping,
                eps=eps,
                max_iters=max_iters,
                valid=jnp.asarray(valid, dtype=dtype),
            )
        )
    else:
        ranks = np.zeros((0, n_nodes))

    with db.doc_rank.batch() as bw:
        for i, node in enumerate(node_list):
            bw.set(node, {c: float(ranks[j, i]) for j, c in enumerate(categories)})
