"""Multi-device scale-out: doc-sharded postings + link graph.

The reference is a single Go process with no distributed layer (SURVEY §2.4);
this module is the scale path called for by BASELINE.json configs 4-5:
postings and the link graph are sharded across a jax.sharding.Mesh, the
query path does per-shard top-k + all-gather merge, and PageRank's matvec
rides collectives between the devices.

Layout:
- documents are split into contiguous id ranges, one per shard;
- each shard holds a complete local CSR (its docs' postings for every word),
  so any query term is resolvable locally — queries broadcast, docs shard;
- one shard_map program per query batch: local phrase intersection ->
  local dense scoring -> local top-k -> all_gather([S, B, K]) -> merged
  top-k. Only B*K*S scores cross devices, never the [B, D] score matrix.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..index.snapshot import IndexSnapshot, SectionCSR

#: bound on per-doc dense forward terms (matches DeviceSection's default)
DOC_TERM_CAP = 4096
from ..ops.phrase import match_phrase, match_phrase_fwd
from ..ops.scoring import (
    _both_section_scores,
    exact_top_k,
    finalize_scores,
    mixed_section_scores,
    use_gpu_kernel,
)
from ..ops.kernels.mixed import derive_mixed_counts
from ..retrieval.device_index import ForwardArrays


def _repeat_blocks(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Flat gather indices for variable-length blocks [starts[i], starts[i]+lens[i])."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    shift = np.repeat(np.cumsum(lens) - lens, lens)
    return np.arange(total, dtype=np.int64) - shift + np.repeat(starts, lens)


def _shard_csr(
    csr: SectionCSR, n_shards: int, docs_per_shard: int, t_pad: int,
    inv_perm: np.ndarray | None = None,  # [S, Dl] local natural -> permuted
    t_multiple: int = 8,
    pos_t_budget: int | None = None,  # per-shard posT bytes; None = no gate
) -> dict[str, np.ndarray]:
    """Split a global CSR into per-shard local CSRs (stacked, equal shapes),
    plus per-shard doc-major forward views (ft global word ids, fw weights,
    fj posting index into the shard-LOCAL padded posting arrays).

    With inv_perm (the doc-sorted layout, cf. DeviceIndex), every doc-axis
    structure comes out in PERMUTED local doc space: CSR doc_ids are
    remapped through inv_perm (row order untouched, matching the
    single-chip remap), so the forward/posT views build permuted
    directly."""
    n_words = csr.post_offsets.shape[0] - 1
    n_post = csr.n_postings
    word_of_post = np.repeat(
        np.arange(n_words, dtype=np.int32), np.diff(csr.post_offsets)
    )
    doc = csr.doc_ids[:n_post]
    shard_of_post = doc // docs_per_shard

    parts = []
    for s in range(n_shards):
        sel = np.flatnonzero(shard_of_post == s)
        counts = np.bincount(word_of_post[sel], minlength=n_words)
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        starts = csr.pos_offsets[sel]
        lens = (csr.pos_offsets[sel + 1] - starts).astype(np.int64)
        pos_offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        local_doc = (doc[sel] - s * docs_per_shard).astype(np.int32)
        if inv_perm is not None:
            # doc-sorted layout: remap values only — posting order within
            # each word row stays CSR order, like the single-chip remap
            # (device_index.py DeviceSection.from_csr doc_ids_np)
            local_doc = inv_perm[s][local_doc]
        parts.append(
            dict(
                offsets=offsets,
                doc_ids=local_doc,
                weights=csr.weights[sel],
                pos_offsets=pos_offsets,
                positions=csr.positions[_repeat_blocks(starts, lens)],
            )
        )

    def stack(key: str, pad_value, width: int, tail_fill: bool = False) -> np.ndarray:
        arrs = [p[key] for p in parts]
        out = np.full((n_shards, width), pad_value, dtype=arrs[0].dtype)
        for s, a in enumerate(arrs):
            out[s, : a.shape[0]] = a
            if tail_fill and a.shape[0]:
                out[s, a.shape[0] :] = a[-1]
        return out

    def rounded(key: str, extra: int = 1) -> int:
        return -(-(max(p[key].shape[0] for p in parts) + extra) // 128) * 128

    post_width = rounded("doc_ids")

    # per-shard forward views over the padded slot space [S, dl, t_pad];
    # t_pad is bounded (DOC_TERM_CAP): docs past it keep only their
    # top-weight terms in the dense view (same policy as DeviceSection),
    # and the scorer falls back to the exact CSR phrase matcher
    truncated = t_pad > DOC_TERM_CAP
    t_pad = min(t_pad, DOC_TERM_CAP)
    # the dynamic-T sweep reads t_multiple-row chunks (DOC_SORT_TC under
    # the doc-sorted layout): pad T up, extra slots are sentinels
    t_pad = -(-t_pad // t_multiple) * t_multiple
    ft = np.full((n_shards, docs_per_shard, t_pad), -1, np.int32)
    fw = np.zeros((n_shards, docs_per_shard, t_pad), np.float32)
    fj = np.full((n_shards, docs_per_shard, t_pad), post_width - 1, np.int32)
    for s, p in enumerate(parts):
        n_local = p["doc_ids"].shape[0]
        if n_local == 0:
            continue
        w_of = np.repeat(
            np.arange(n_words, dtype=np.int32), np.diff(p["offsets"])
        )
        keep = np.arange(n_local, dtype=np.int64)
        if truncated:
            rank_order = np.lexsort((-p["weights"], p["doc_ids"]))
            docs_r = p["doc_ids"][rank_order]
            off = np.concatenate(
                [[0], np.cumsum(np.bincount(docs_r, minlength=docs_per_shard))]
            )
            rank_in_doc = np.arange(n_local, dtype=np.int64) - off[docs_r]
            keep = rank_order[rank_in_doc < DOC_TERM_CAP]
        order = keep[np.argsort(p["doc_ids"][keep], kind="stable")]
        docs_s = p["doc_ids"][order]
        row_off = np.zeros(docs_per_shard + 1, np.int64)
        # bincount+cumsum, NOT np.add.at (10-30x slower on multi-M arrays)
        row_off[1:] = np.cumsum(np.bincount(docs_s, minlength=docs_per_shard))
        slot = np.arange(len(order), dtype=np.int64) - row_off[docs_s]
        ft[s, docs_s, slot] = w_of[order]
        fw[s, docs_s, slot] = p["weights"][order]
        fj[s, docs_s, slot] = order.astype(np.int32)

    # per-shard doc-major position planes for the mixed lane's phrase stage
    # (ops/kernels/mixed.py posT layout), stacked at the max unique-position
    # count across shards; None when any shard is over the budget or the
    # dense rows were truncated (those route to the sparse CSR matcher)
    posT = None
    pos_c = 0
    if not truncated:
        from ..retrieval.device_index import build_posT_raw
        from ..ops.kernels.mixed import POS_BIG

        shard_posT = []
        for s, p in enumerate(parts):
            # IMPORTANT: fj indexes the PADDED local posting space; the pad
            # slot (post_width-1) must resolve to an empty position range,
            # which the tail_fill'd stacked pos_offsets guarantee — rebuild
            # that view here for the raw builder
            n_post_local = p["doc_ids"].shape[0]
            off_ext = np.full(post_width + 1, 0, np.int32)
            off_ext[: n_post_local + 1] = p["pos_offsets"]
            off_ext[n_post_local + 1 :] = p["pos_offsets"][-1]
            from ..retrieval.device_index import POS_T_INT16 as _p16

            built = build_posT_raw(
                off_ext, p["positions"], n_post_local, post_width,
                fj[s], docs_per_shard, POS_BIG,
                bytes_per_el=2 if _p16 else 4, budget=pos_t_budget,
            )
            if built is None:
                shard_posT = None
                break
            shard_posT.append(built)
        if shard_posT is not None:
            pos_c = max(c for _, c in shard_posT)
            posT = np.full(
                (n_shards, pos_c * t_pad, docs_per_shard), POS_BIG, np.float32
            )
            for s, (arr, c) in enumerate(shard_posT):
                posT[s, : c * t_pad] = arr
            # int16 planes, same policy as the single-chip DeviceIndex
            # (exact dequant in the phrase stage — scores identical)
            from ..retrieval.device_index import POS_T_INT16, _fits
            from ..ops.kernels.mixed import quantize_posT

            if POS_T_INT16:
                q16 = quantize_posT(posT.reshape(n_shards * pos_c * t_pad, -1))
                if q16 is not None:
                    posT = q16.reshape(posT.shape)
                elif not _fits(pos_c * t_pad * docs_per_shard * 4, pos_t_budget):
                    # built under the 2-byte budget but unquantizable: the
                    # f32 plane is over budget — drop to the sparse lane
                    posT, pos_c = None, 0

    return dict(
        posT=posT,
        pos_c=pos_c,
        # +1 word row as the sentinel empty row; pad rows repeat the final
        # offset so their postings ranges are empty
        offsets=stack("offsets", 0, rounded("offsets"), tail_fill=True),
        doc_ids=stack("doc_ids", docs_per_shard, post_width),
        weights=stack("weights", 0.0, post_width),
        # exactly one offset per (padded) posting slot plus one: gather
        # kernels index pos_offsets[j + 1] for j < post_width
        pos_offsets=stack("pos_offsets", 0, post_width + 1, tail_fill=True),
        positions=stack("positions", np.inf, rounded("positions")),
        ft=ft, fw=fw, fj=fj, truncated=truncated,
    )


def _shard_hot_cache(
    csr: SectionCSR, n_shards: int, dl: int,
    inv_perm: np.ndarray | None = None,  # [S, Dl] local natural -> permuted
    budget: int | None = None,  # per-device bytes; None = no gate
) -> tuple[np.ndarray, dict[int, int]] | None:
    """Per-shard slices [S, H_pad, Dl] of the hot-term dense weight cache
    (cf. device_index._build_hot_cache): the top-H GLOBAL-df body terms get
    exact dense weight rows so a query's hot terms cost one dense product
    per shard instead of a compare sweep each. The hot SET (and the term-id
    -> slot map) is global — every shard answers the same hot split — while
    the H budget is per device ([H, Dl] f32 in each shard's memory)."""
    from ..retrieval.device_index import HOT_H_MAX, _round_up

    n_post = csr.n_postings
    if n_post == 0:
        return None
    n_words = csr.post_offsets.shape[0] - 1
    df = np.diff(csr.post_offsets[: n_words + 1])
    h = min(HOT_H_MAX, n_words)
    if budget is not None:
        h = min(h, int(budget // max(dl * 4, 1)))
    if h < 8:
        return None
    top = np.argsort(-df, kind="stable")[:h]
    top = top[df[top] > 0]
    if top.size == 0:
        return None
    h_pad = _round_up(int(top.size), 128)  # 128-row multiple; pad rows 0
    w = np.zeros((n_shards, h_pad, dl), np.float32)
    for slot, wid in enumerate(top.tolist()):
        s, e = int(csr.post_offsets[wid]), int(csr.post_offsets[wid + 1])
        cols = csr.doc_ids[s:e]
        shard = cols // dl
        local = cols % dl
        if inv_perm is not None:
            local = inv_perm[shard, local]
        w[shard, slot, local] = csr.weights[s:e]
    return w, {int(wid): slot for slot, wid in enumerate(top.tolist())}


@dataclass
class ShardedIndex:
    mesh: Mesh
    axis: str
    n_shards: int
    n_docs: int  # global (unpadded)
    docs_per_shard: int
    n_words: int
    posting_cap: int
    pos_cap: int
    # stacked [S, ...] arrays, sharded over `axis` on the leading dim
    title: dict[str, jax.Array]
    body: dict[str, jax.Array]
    mag_title: jax.Array  # [S, Dl]
    mag_body: jax.Array  # [S, Dl]
    pagerank: jax.Array  # [S, Dl, C]
    # doc-major forward views (per-shard local docs); fj maps each doc-term
    # slot to its posting in the shard-LOCAL padded posting arrays
    title_ft: jax.Array  # [S, Dl, Tt]
    title_fw: jax.Array
    title_fj: jax.Array
    body_ft: jax.Array  # [S, Dl, Tb]
    body_fw: jax.Array
    body_fj: jax.Array
    # transposed tiles [S, T, Dl] (doc axis contiguous) for the keyword
    # kernel and the phrase stage
    title_ftT: jax.Array = None
    title_fwT: jax.Array = None
    body_ftT: jax.Array = None
    body_fwT: jax.Array = None
    dense_truncated: bool = False  # some doc's dense row was capped
    # doc-major position planes [S, C*T, Dl] for the fused mixed kernel
    # (ops/kernels/mixed.py); None when over budget / rows truncated — the
    # engine then serves phrases through the sparse matcher lane
    title_posT: jax.Array | None = None
    body_posT: jax.Array | None = None
    has_zero_weight: bool = False  # some posting weight <= 0 (idf-0 corner)
    # hot-term dense body-weight cache (per-shard slices of the GLOBAL
    # top-df set, _shard_hot_cache); None when zero weights / truncated /
    # budget bars it — same gates as the single-chip DeviceIndex
    hot_body_w: jax.Array | None = None  # f32 [S, H_pad, Dl]
    hot_body_map: dict[int, int] | None = None  # term id -> hot slot
    # doc-sorted layout (device_index._doc_sort_perm applied PER SHARD):
    # every doc-axis array lives in permuted local doc space; doc_perm maps
    # permuted position -> local natural id and the scorers gather through
    # it after the local top-k, so callers always see natural global ids
    doc_perm: jax.Array | None = None  # int32 [S, Dl]
    body_tmax: jax.Array | None = None  # int32 [S, Dl//DOC_BLOCK]

    @classmethod
    def from_snapshot(
        cls,
        snap: IndexSnapshot,
        mesh: Mesh,
        axis: str = "d",
        weights: str = "tfidf",  # "bm25": per-posting Okapi weights instead
        doc_sort: bool | None = None,  # None: auto-gate like DeviceIndex
    ) -> "ShardedIndex":
        if weights == "bm25":
            from dataclasses import replace as _replace

            from ..models.bm25 import bm25_posting_weights

            snap = _replace(
                snap,
                title=_replace(
                    snap.title,
                    weights=bm25_posting_weights(snap.title, snap.n_docs),
                ),
                body=_replace(
                    snap.body,
                    weights=bm25_posting_weights(snap.body, snap.n_docs),
                ),
            )
        from ..retrieval.device_index import (
            DOC_BLOCK,
            DOC_SORT_MIN_DOCS,
            DOC_SORT_TC,
            MemoryBudget,
            _doc_sort_pays,
            _doc_sort_perm,
        )

        n_shards = mesh.shape[axis]
        budget = MemoryBudget.for_device(mesh.devices.flat[0])
        dl = -(-max(snap.n_docs, 1) // n_shards)
        dl = -(-dl // DOC_BLOCK) * DOC_BLOCK  # doc-block aligned local count

        def nt_of(csr: SectionCSR) -> np.ndarray:
            n_post = csr.n_postings
            if n_post == 0:
                return np.zeros(n_shards * dl, np.int32)
            out = np.zeros(n_shards * dl, np.int64)
            out[: max(snap.n_docs, 1)] = np.bincount(
                csr.doc_ids[:n_post], minlength=max(snap.n_docs, 1)
            )
            return out.astype(np.int32)

        title_nt = nt_of(snap.title)
        body_nt = nt_of(snap.body)
        truncatable = (
            int(title_nt.max(initial=0)) > DOC_TERM_CAP
            or int(body_nt.max(initial=0)) > DOC_TERM_CAP
        )
        # doc-sorted layout: the same auto gate as the single-chip
        # DeviceIndex, evaluated on the per-shard padded doc space (each
        # shard sorts its OWN docs; the projected sweep win uses the global
        # nt distribution, which every contiguous shard approximates)
        if doc_sort is None:
            # gate on the PER-SHARD padded count: each shard runs its own
            # sweep, and below the gate (device_index.py) the dynamic-T
            # machinery does not pay even if the global corpus is large
            doc_sort = dl >= DOC_SORT_MIN_DOCS and _doc_sort_pays(body_nt)
        doc_sort = doc_sort and not truncatable and snap.n_docs > 0
        perm_all = inv_all = body_tmax_np = None
        t_multiple = 8
        if doc_sort:
            t_multiple = DOC_SORT_TC
            nt2 = body_nt.reshape(n_shards, dl)
            perm_all = np.empty((n_shards, dl), np.int64)
            inv_all = np.empty((n_shards, dl), np.int32)
            tmaxes = []
            for s in range(n_shards):
                p, tm = _doc_sort_perm(nt2[s], dl)
                perm_all[s] = p
                inv_all[s, p] = np.arange(dl, dtype=np.int32)
                tmaxes.append(tm)
            body_tmax_np = np.stack(tmaxes)

        def t_pad_of(csr: SectionCSR) -> int:
            n_post = csr.n_postings
            if n_post == 0:
                return 1
            per_doc = np.bincount(
                csr.doc_ids[:n_post], minlength=max(snap.n_docs, 1)
            )
            return max(int(per_doc.max()), 1)

        title_np = _shard_csr(
            snap.title, n_shards, dl, t_pad_of(snap.title),
            inv_perm=inv_all, t_multiple=t_multiple,
            pos_t_budget=budget.pos_t_bytes,
        )
        body_np = _shard_csr(
            snap.body, n_shards, dl, t_pad_of(snap.body),
            inv_perm=inv_all, t_multiple=t_multiple,
            pos_t_budget=budget.pos_t_bytes,
        )

        def pad_docs(arr: np.ndarray) -> np.ndarray:
            out = np.zeros((n_shards * dl,) + arr.shape[1:], dtype=arr.dtype)
            out[: arr.shape[0]] = arr
            out = out.reshape((n_shards, dl) + arr.shape[1:])
            if perm_all is not None:
                out = np.stack([out[s][perm_all[s]] for s in range(n_shards)])
            return out

        if snap.pagerank is not None and snap.pagerank.shape[1] > 0:
            pr = snap.pagerank
        else:
            pr = np.zeros((snap.n_docs, 1), dtype=np.float32)

        shard1 = NamedSharding(mesh, P(axis))
        put = partial(jax.device_put, device=shard1)
        posting_cap = min(
            -(-max(snap.title.max_df, snap.body.max_df, 1) // 128) * 128,
            title_np["doc_ids"].shape[1],
        )

        has_zero_w = bool(
            (snap.title.weights[: snap.title.n_postings] <= 0).any()
            or (snap.body.weights[: snap.body.n_postings] <= 0).any()
        )
        hot_w = hot_map = None
        if not (has_zero_w or title_np["truncated"] or body_np["truncated"]):
            built = _shard_hot_cache(
                snap.body, n_shards, dl, inv_perm=inv_all,
                budget=budget.hot_w_bytes,
            )
            if built is not None:
                hot_np, hot_map = built
                hot_w = put(hot_np)

        return cls(
            mesh=mesh,
            axis=axis,
            n_shards=n_shards,
            n_docs=snap.n_docs,
            docs_per_shard=dl,
            n_words=snap.n_words,
            posting_cap=posting_cap,
            pos_cap=-(-max(snap.title.max_positions, snap.body.max_positions, 1) // 8) * 8,
            title={k: put(v) for k, v in title_np.items()
                   if k not in ("ft", "fw", "fj", "truncated", "posT", "pos_c")},
            body={k: put(v) for k, v in body_np.items()
                  if k not in ("ft", "fw", "fj", "truncated", "posT", "pos_c")},
            mag_title=put(pad_docs(snap.mag_title)),
            mag_body=put(pad_docs(snap.mag_body)),
            pagerank=put(pad_docs(pr)),
            title_ft=put(title_np["ft"]),
            title_fw=put(title_np["fw"]),
            title_fj=put(title_np["fj"]),
            body_ft=put(body_np["ft"]),
            body_fw=put(body_np["fw"]),
            body_fj=put(body_np["fj"]),
            title_ftT=put(np.ascontiguousarray(title_np["ft"].transpose(0, 2, 1))),
            title_fwT=put(np.ascontiguousarray(title_np["fw"].transpose(0, 2, 1))),
            body_ftT=put(np.ascontiguousarray(body_np["ft"].transpose(0, 2, 1))),
            body_fwT=put(np.ascontiguousarray(body_np["fw"].transpose(0, 2, 1))),
            dense_truncated=bool(title_np["truncated"] or body_np["truncated"]),
            title_posT=(
                put(title_np["posT"]) if title_np["posT"] is not None else None
            ),
            body_posT=(
                put(body_np["posT"]) if body_np["posT"] is not None else None
            ),
            has_zero_weight=has_zero_w,
            hot_body_w=hot_w,
            hot_body_map=hot_map,
            doc_perm=(
                None if perm_all is None else put(perm_all.astype(np.int32))
            ),
            body_tmax=(
                None if body_tmax_np is None
                else put(body_tmax_np.astype(np.int32))
            ),
        )

    @property
    def pos_dense(self) -> bool:
        """True when both sections carry the doc-major position layout the
        fused mixed kernel streams (cf. DeviceIndex.pos_dense)."""
        return self.title_posT is not None and self.body_posT is not None


def scorer_meta(sidx: ShardedIndex) -> tuple:
    """The static facts a compiled sharded scorer depends on. Two snapshots
    with equal meta (same mesh geometry + padded dims) can share compiled
    programs — the index arrays are call-time jit ARGUMENTS, so a /refresh
    that doesn't change padded shapes reuses every compile."""
    return (
        sidx.mesh, sidx.axis, sidx.docs_per_shard,
        sidx.posting_cap, sidx.pos_cap, sidx.dense_truncated,
        sidx.pos_dense, sidx.has_zero_weight,
        0 if sidx.hot_body_w is None else int(sidx.hot_body_w.shape[1]),
        sidx.doc_perm is not None,
    )


def index_args(
    sidx: ShardedIndex, mixed: bool = False,
    hot: bool = False, doc_sorted: bool = False,
) -> tuple:
    """The 23 sharded arrays a scorer takes, in block order (+2 doc-major
    position planes for the fused mixed scorer, +1 hot-term weight cache,
    +2 doc-sorted layout arrays — each gated by the scorer's meta so the
    compiled signature is stable per scorer instance)."""
    t, bd = sidx.title, sidx.body
    base = (
        t["offsets"], t["doc_ids"], t["weights"], t["pos_offsets"], t["positions"],
        bd["offsets"], bd["doc_ids"], bd["weights"], bd["pos_offsets"], bd["positions"],
        sidx.mag_title, sidx.mag_body, sidx.pagerank,
        sidx.title_ft, sidx.title_fw, sidx.title_fj,
        sidx.body_ft, sidx.body_fw, sidx.body_fj,
        sidx.title_ftT, sidx.title_fwT, sidx.body_ftT, sidx.body_fwT,
    )
    if mixed:
        base = base + (sidx.title_posT, sidx.body_posT)
    if hot:
        base = base + (sidx.hot_body_w,)
    if doc_sorted:
        base = base + (sidx.doc_perm, sidx.body_tmax)
    return base


def make_sharded_scorer(
    sidx_or_meta,
    topk: int,
    batch_axis: str | None = None,
    scoring: str = "blended",  # "bm25": boosted field sums, no cosine/PR
    title_boost: float = 2.0,
    body_boost: float = 1.0,
):
    """Build the jit'd multi-chip query step.

    Accepts a ShardedIndex or its scorer_meta(). Returns
    run(sidx, term_ids [B,Q], qlen [B], topic_probs [B,C],
        phrase_term_ids [P], phrase_valid [P], gen_idx, phrase_rows,
        qn [B], qnb [B], hot_sids [B,Q]) ->
    (scores [B,K], global doc ids [B,K]). Pass phrase_valid all-False for
    keyword-only batches. The index arrays are call-time arguments: any
    ShardedIndex whose scorer_meta() (and array shapes) match can be passed,
    so a refreshed index reuses the compiled programs.

    Kernel levels (single-device parity): the keyword kernel's row-block
    qn bound, the hot-term dense body-weight product (qnb cold
    split + hot_sids slots, reference-blend scoring only), the doc-sorted
    dynamic-T body sweep (per-shard body_tmax; ids gather back through
    doc_perm so callers see natural ids), count elision when every index
    weight is positive, and chunk-max exact top-k.

    On a 2-D mesh (make_mesh2d), the query batch is additionally split
    data-parallel over `batch_axis` (auto-detected: any mesh axis other than
    the doc axis): each q-row scores B/n_q queries against the full
    doc-sharded index, and no data crosses the q axis. B must divide by n_q.
    """
    meta = scorer_meta(sidx_or_meta) if isinstance(sidx_or_meta, ShardedIndex) else sidx_or_meta
    mesh, ax, dl, cap, pcap, dense_truncated = meta[:6]
    has_zero_w = meta[7] if len(meta) > 7 else True
    hot_h = meta[8] if len(meta) > 8 else 0
    doc_sorted = bool(meta[9]) if len(meta) > 9 else False
    # hot split rides the reference blend only (cf. BlendedRanker
    # supports_hot); BM25 sums need true counts for candidacy
    use_hot = hot_h > 0 and scoring != "bm25"
    emit_counts = has_zero_w or scoring == "bm25"
    if batch_axis is None:
        others = [a for a in mesh.axis_names if a != ax and mesh.shape[a] > 1]
        batch_axis = others[0] if others else None
    bspec = P(batch_axis) if batch_axis else P()
    k = topk
    use_kernel = use_gpu_kernel()
    n_extra = (1 if use_hot else 0) + (2 if doc_sorted else 0)

    def block(*args):
        (t_off, t_did, t_w, t_poff, t_pos,
         b_off, b_did, b_w, b_poff, b_pos,
         mt, mb, pr, tft, tfw, tfj, bft, bfw, bfj,
         tftT, tfwT, bftT, bfwT) = jax.tree.map(lambda a: a[0], args[:23])
        i = 23
        hot_w = doc_perm = body_tmax = None
        if use_hot:
            hot_w = args[i][0]
            i += 1
        if doc_sorted:
            doc_perm, body_tmax = args[i][0], args[i + 1][0]
            i += 2
        (term_ids, qlen, topic_probs, qn, qnb, hot_sids,
         ph_ids, ph_valid, gen_idx, phrase_rows) = args[i:]
        b = term_ids.shape[0]
        e = 2 * cap

        # phrase sets ride a COMPRESSED axis [BP, P] plus a row map [BP]
        # (bp << b in real traffic — matching the full batch axis would
        # multiply the matcher's [BP, E, T] temporaries by the batch size).
        # A 1-D [P] input broadcasts to every row (legacy callers).
        if ph_ids.ndim == 1:
            ph_ids_b = jnp.broadcast_to(ph_ids, (b,) + ph_ids.shape)
            ph_valid_b = jnp.broadcast_to(ph_valid, (b,) + ph_valid.shape)
            gen_b = jnp.broadcast_to(jnp.atleast_1d(gen_idx), (b,))
            ph_row = jnp.arange(b, dtype=jnp.int32)
        else:
            ph_ids_b, ph_valid_b = ph_ids, ph_valid
            gen_b = gen_idx
            # phrase_rows are GLOBAL batch indices; this q-row holds the
            # local slice [qi*b, (qi+1)*b) — localize and drop the rest
            if batch_axis:
                qi = jax.lax.axis_index(batch_axis)
            else:
                qi = 0
            local = phrase_rows - qi * b
            ph_row = jnp.where((local >= 0) & (local < b), local, b)
        bp = ph_ids_b.shape[0]

        def with_phrase(_):
            if dense_truncated:
                # capped dense rows would under-match: exact CSR matcher
                fn = lambda t, v, g: match_phrase(
                    t_off, t_did, t_w, t_poff, t_pos,
                    b_off, b_did, b_w, b_poff, b_pos,
                    t, v, g,
                    posting_cap=cap, pos_cap=pcap, n_docs=dl,
                )
            else:
                # forward-index matcher, same formulation as the single-chip
                # production path (ops/phrase.py match_phrase_fwd)
                fn = lambda t, v, g: match_phrase_fwd(
                    tft, tfj, t_w, t_poff, t_pos,
                    bft, bfj, b_w, b_poff, b_pos,
                    t_off, t_did, b_off, b_did,
                    t, v, g,
                    posting_cap=cap, pos_cap=pcap, n_docs=dl,
                )
            return jax.vmap(fn)(ph_ids_b, ph_valid_b, gen_b)

        def without_phrase(_):
            return (
                jnp.full((bp, e), dl, jnp.int32),
                jnp.zeros((bp, e), jnp.float32),
                jnp.zeros((bp, e), jnp.float32),
                jnp.zeros((bp, e), jnp.float32),
            )

        ph_docs, ph_tw, ph_bw, ph_fl = jax.lax.cond(
            jnp.any(ph_valid_b), with_phrase, without_phrase, None
        )

        # local keyword scores: the Triton kernel on the GPU (row-block qn
        # bounds + cold-slot body sweep + dynamic-T bound + count elision),
        # the XLA formulation on the CPU (+ phrase/hot folds below)
        ts, tc, bs, bc = _both_section_scores(
            ForwardArrays(tft, tfw, tfj, tftT, tfwT),
            ForwardArrays(bft, bfw, bfj, bftT, bfwT),
            term_ids, use_kernel, qn, emit_counts,
            qnb=qnb if use_hot else None, body_tmax=body_tmax,
        )
        if use_hot:
            from ..ops.scoring import hot_body_scores

            hot = hot_body_scores(hot_w, hot_sids)[:, :dl]
            bs = bs + hot
            if bc is not None:  # true-count path: hot candidacy counts too
                bc = bc + (hot > 0).astype(bs.dtype)
        # fold the compressed phrase rows onto their batch rows (pad rows of
        # the map point past b and drop); keyword-only batches skip the
        # scatter entirely
        def fold(_):
            pacc = jnp.zeros((b + 1, dl + 1, 3), dtype=ts.dtype)
            pacc = pacc.at[
                jnp.minimum(ph_row, b)[:, None], ph_docs
            ].add(jnp.stack([ph_tw, ph_bw, ph_fl], axis=-1), mode="drop")
            pacc = pacc[:b]
            return pacc[:, :dl, 0], pacc[:, :dl, 1], pacc[:, :dl, 2]

        def nofold(_):
            z = jnp.zeros((b, dl), dtype=ts.dtype)
            return z, z, z

        d_ts, d_bs, d_fl = jax.lax.cond(
            jnp.any(ph_valid_b), fold, nofold, None
        )
        ts = ts + d_ts
        bs = bs + d_bs
        if tc is None:  # counts elided: all weights > 0, candidacy by score
            tc = ((ts + bs > 0) | (d_fl > 0)).astype(ts.dtype)
            bc = jnp.zeros_like(tc)
        else:
            tc = tc + d_fl
        if scoring == "bm25":
            final = title_boost * ts + body_boost * bs
            final = jnp.where(tc + bc > 0, final, -jnp.inf)
        else:
            final = finalize_scores(ts, tc, bs, bc, mt, mb, pr, qlen, topic_probs)

        # chunk-max exact top-k (ops/scoring.py): self-gating — identical
        # to lax.top_k below 262k docs/shard, ~2.7x cheaper above it (the
        # single-chip 1M measurement), so big-shard meshes keep the win;
        # the doc-sorted layout gathers back to local NATURAL ids here
        scores, ids = exact_top_k(final, min(k, dl), doc_map=doc_perm)
        ids = ids + jax.lax.axis_index(ax) * dl

        all_scores = jax.lax.all_gather(scores, ax)  # [S, B, k]
        all_ids = jax.lax.all_gather(ids, ax)
        s = all_scores.shape[0]
        flat_scores = jnp.moveaxis(all_scores, 0, 1).reshape(b, -1)
        flat_ids = jnp.moveaxis(all_ids, 0, 1).reshape(b, -1)
        top_s, pos = jax.lax.top_k(flat_scores, min(k, s * min(k, dl)))
        top_i = jnp.take_along_axis(flat_ids, pos, axis=1)
        return top_s, top_i

    sharded = jax.shard_map(
        block,
        mesh=mesh,
        in_specs=tuple(
            [P(ax)] * (23 + n_extra)
            + [bspec] * 6  # term_ids, qlen, topic_probs, qn, qnb, hot_sids
            + [P(), P(), P(), P()]
        ),
        out_specs=(bspec, bspec),
        check_vma=False,
    )

    _run = jax.jit(sharded)

    def run(sidx, term_ids, qlen, topic_probs, ph_ids, ph_valid, gen_idx,
            phrase_rows=None, qn=None, qnb=None, hot_sids=None):
        b, q = term_ids.shape
        if phrase_rows is None:  # legacy broadcast callers ([P] phrase set)
            phrase_rows = jnp.arange(b, dtype=jnp.int32)
        if qn is None:  # full-width sweep (sentinel slots never match)
            qn = jnp.full((b,), q, jnp.int32)
        if qnb is None:  # no hot split: every slot is cold
            qnb = qn
        if hot_sids is None:
            hot_sids = jnp.full((b, q), -1, jnp.int32)
        return _run(
            *index_args(sidx, hot=use_hot, doc_sorted=doc_sorted),
            term_ids, qlen, topic_probs, qn, qnb, hot_sids,
            ph_ids, ph_valid, gen_idx, phrase_rows,
        )

    run._jit = _run  # compile-count introspection (tests, /stats)
    return run


def make_sharded_mixed_scorer(
    sidx_or_meta,
    topk: int,
    batch_axis: str | None = None,
):
    """The FUSED mixed lane on the mesh: keyword scoring + dense in-kernel
    phrase matching + finalize + local top-k + all-gather merge as ONE
    shard_map program with per-ROW phrase inputs (cf. the single-chip
    engine._rank_fused / ops/scoring.py score_queries_mixed). Requires the
    index to carry the doc-major position planes (ShardedIndex.pos_dense).

    Returns run(sidx, term_ids [B,Q], qlen [B], topic_probs [B,C],
    ph_ids [B,P], ph_valid [B,P] f32, qn [B], pn [B], qnb [B],
    hot_sids [B,Q]) -> (scores [B,K], global doc ids [B,K]).
    Reference-blend scoring only — custom blends/BM25 keep the sparse
    two-phase lane. Mirrors the single-chip score_queries_mixed: hot-term
    product via the qnb cold split, the dynamic-T body bound, doc-sorted
    ids gathered back through doc_perm."""
    meta = (
        scorer_meta(sidx_or_meta)
        if isinstance(sidx_or_meta, ShardedIndex)
        else sidx_or_meta
    )
    mesh, ax, dl, cap, pcap, dense_truncated, pos_dense, has_zero_w = meta[:8]
    hot_h = meta[8] if len(meta) > 8 else 0
    doc_sorted = bool(meta[9]) if len(meta) > 9 else False
    use_hot = hot_h > 0
    if not pos_dense or dense_truncated:
        raise ValueError("mixed scorer needs the dense position layout")
    if batch_axis is None:
        others = [a for a in mesh.axis_names if a != ax and mesh.shape[a] > 1]
        batch_axis = others[0] if others else None
    bspec = P(batch_axis) if batch_axis else P()
    k = topk
    emit_counts = has_zero_w
    use_kernel = use_gpu_kernel()
    n_extra = (1 if use_hot else 0) + (2 if doc_sorted else 0)

    def block(*args):
        (t_off, t_did, t_w, t_poff, t_pos,
         b_off, b_did, b_w, b_poff, b_pos,
         mt, mb, pr, tft, tfw, tfj, bft, bfw, bfj,
         tftT, tfwT, bftT, bfwT, tposT, bposT) = jax.tree.map(
            lambda a: a[0], args[:25]
        )
        i = 25
        hot_w = doc_perm = body_tmax = None
        if use_hot:
            hot_w = args[i][0]
            i += 1
        if doc_sorted:
            doc_perm, body_tmax = args[i][0], args[i + 1][0]
            i += 2
        (term_ids, qlen, topic_probs, ph_ids, ph_valid, qn, pn,
         qnb, hot_sids) = args[i:]
        b = term_ids.shape[0]
        # derive candidacy AFTER the hot fold (a doc matched only by a hot
        # body term must still become a candidate)
        ts, tc, bs, bc = mixed_section_scores(
            ForwardArrays(tft, tfw, tfj, tftT, tfwT),
            ForwardArrays(bft, bfw, bfj, bftT, bfwT),
            tposT, bposT, term_ids, ph_ids, ph_valid, use_kernel, qn, pn,
            emit_counts, qnb if use_hot else None, body_tmax,
        )
        if use_hot:
            from ..ops.scoring import hot_body_scores

            hot = hot_body_scores(hot_w, hot_sids)[:, : bs.shape[1]]
            bs = bs + hot
            if bc is not None:
                bc = bc + (hot > 0).astype(bs.dtype)
        ts, tc, bs, bc = derive_mixed_counts(ts, tc, bs, bc)
        final = finalize_scores(ts, tc, bs, bc, mt, mb, pr, qlen, topic_probs)
        # chunk-max exact top-k (ops/scoring.py): self-gating — identical
        # to lax.top_k below 262k docs/shard, ~2.7x cheaper above it (the
        # single-chip 1M measurement), so big-shard meshes keep the win;
        # the doc-sorted layout gathers back to local NATURAL ids here
        scores, ids = exact_top_k(final, min(k, dl), doc_map=doc_perm)
        ids = ids + jax.lax.axis_index(ax) * dl
        all_scores = jax.lax.all_gather(scores, ax)  # [S, B, k]
        all_ids = jax.lax.all_gather(ids, ax)
        s = all_scores.shape[0]
        flat_scores = jnp.moveaxis(all_scores, 0, 1).reshape(b, -1)
        flat_ids = jnp.moveaxis(all_ids, 0, 1).reshape(b, -1)
        top_s, pos = jax.lax.top_k(flat_scores, min(k, s * min(k, dl)))
        top_i = jnp.take_along_axis(flat_ids, pos, axis=1)
        return top_s, top_i

    sharded = jax.shard_map(
        block,
        mesh=mesh,
        in_specs=tuple([P(ax)] * (25 + n_extra) + [bspec] * 9),
        out_specs=(bspec, bspec),
        check_vma=False,
    )

    _run = jax.jit(sharded)

    def run(sidx, term_ids, qlen, topic_probs, ph_ids, ph_valid, qn, pn,
            qnb=None, hot_sids=None):
        b, q = term_ids.shape
        if qnb is None:  # no hot split: every slot is cold
            qnb = qn
        if hot_sids is None:
            hot_sids = jnp.full((b, q), -1, jnp.int32)
        return _run(
            *index_args(sidx, mixed=True, hot=use_hot, doc_sorted=doc_sorted),
            term_ids, qlen, topic_probs, ph_ids, ph_valid, qn, pn,
            qnb, hot_sids,
        )

    run._jit = _run
    return run


def sharded_pagerank(
    mesh: Mesh,
    edge_src: np.ndarray,  # int32 [E] sorted by dst
    edge_dst: np.ndarray,  # int32 [E]
    outdeg: np.ndarray,  # f32 [N]
    n_pages: np.ndarray,  # f32 [C]
    n_nodes: int,
    damping: float = 0.75,
    eps: float = 1e-20,
    max_iters: int = 200,
    axis: str = "d",
) -> jax.Array:
    """PageRank power iteration with the edge set sharded over the mesh:
    each shard owns a contiguous destination-node range, computes its local
    inherited-mass segment-sum, and the full rank vector is reassembled with
    an all_gather per iteration (rank vector replicated, O(N) per step)."""
    s = mesh.shape[axis]
    nl = -(-max(n_nodes, 1) // s)
    n_pad = s * nl
    c = n_pages.shape[0]

    # pad node arrays; valid mask excludes padding from totals/teleport
    outdeg_p = np.zeros(n_pad, np.float32)
    outdeg_p[:n_nodes] = outdeg
    valid = np.zeros(n_pad, np.float32)
    valid[:n_nodes] = 1.0

    # shard edges by destination range, pad to equal length per shard
    shard_of_edge = edge_dst // nl
    per_shard = [np.flatnonzero(shard_of_edge == i) for i in range(s)]
    el = -(-max([1] + [len(p) for p in per_shard]) // 128) * 128
    esrc = np.zeros((s, el), np.int32)
    edst_local = np.full((s, el), nl, np.int32)  # pad -> dropped segment
    for i, sel in enumerate(per_shard):
        esrc[i, : len(sel)] = edge_src[sel]
        edst_local[i, : len(sel)] = edge_dst[sel] - i * nl

    shard1 = NamedSharding(mesh, P(axis))
    esrc_d = jax.device_put(esrc, shard1)
    edst_d = jax.device_put(edst_local, shard1)

    teleport = 1.0 - damping
    inv_out = np.where(outdeg_p > 0, damping / np.maximum(outdeg_p, 1), 0.0).astype(
        np.float32
    )

    def block(esrc_b, edst_b, inv_out_b, valid_b, n_pages_b):
        esrc_l, edst_l = esrc_b[0], edst_b[0]
        r0 = jnp.broadcast_to((1.0 / n_pages_b)[:, None], (c, n_pad)) * valid_b

        def step(state):
            r, it, _ = state
            contrib = r * inv_out_b[None, :]
            local = jax.ops.segment_sum(
                contrib[:, esrc_l].T, edst_l, num_segments=nl + 1,
                indices_are_sorted=True,  # per-shard edges sorted by dst
            ).T[:, :nl]
            inherited = jax.lax.all_gather(local, axis, axis=1, tiled=True)
            total = jnp.sum(contrib, axis=1, keepdims=True) + teleport * n_nodes
            base = jnp.where(it == 0, r, 0.0)
            r_new = (base + inherited + teleport * valid_b[None, :]) / total
            delta = jnp.max(jnp.sum(jnp.abs(r_new - r), axis=1))
            return r_new, it + 1, delta

        def cond(state):
            _, it, delta = state
            return jnp.logical_and(delta > eps, it < max_iters)

        r, _, _ = jax.lax.while_loop(
            cond, step, (r0, jnp.array(0, jnp.int32), jnp.asarray(jnp.inf, jnp.float32))
        )
        return r

    fn = jax.shard_map(
        block,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    r = jax.jit(fn)(
        esrc_d, edst_d, jnp.asarray(inv_out), jnp.asarray(valid), jnp.asarray(n_pages, jnp.float32)
    )
    return r[:, :n_nodes]
