"""Forward-membership keyword sweep: a Pallas kernel through Triton.

For one query batch and both index sections it computes

    mult[b, d, j]  = #occurrences of ft[d, j] among query b's terms
    score[b, d]    = sum_j fw[d, j] * mult[b, d, j]
    count[b, d]    = sum_j mult[b, d, j]

The XLA formulation (ops/scoring.py forward_section_scores) evaluates the
same sums block by block through device memory. Here each program owns one
[ROW_BLOCK, DOC_TILE] output tile: it reads the [T, DOC_TILE] slice of the
transposed forward index (ftT/fwT, doc axis contiguous) once, row by row,
and keeps the compare-and-accumulate in registers. It is ALU and bandwidth
work with no matrix product, so there is no tensor-core or TF32 question.

Grid: (doc tiles, query-row blocks). Each program loads its own bounds:

- the row block's active-term counts (qn for the title sweep, qnb for the
  body sweep) bound the inner loop over query slots: batches are sorted by
  term count (engine.rank), so 1-2 term rows stop paying for padded slots;
- under the doc-sorted layout (DeviceIndex doc_sort) the doc block's real
  max distinct-term count (body_tmax) bounds the body term loop: docs are
  sorted by term count, so blocks are T-homogeneous and the sweep stops at
  the block's longest doc. Skipped rows hold only pad slots, so the bound is
  exact.

Count elision (emit_counts=False): when every index weight is > 0 (no
df==N idf-zero postings, DeviceIndex.has_zero_weight), candidacy is
equivalent to score > 0, so the count accumulators and their [B, D]
outputs are dropped.

Hot split (qnb): a row's cold terms sit in slots [0, qnb) and its hot terms
after them; the title sweep reads every active slot, the body sweep only
the cold ones (the hot terms' body weight comes from the caller's dense
hot_body_scores product).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

#: query rows per program; a power of two (Triton block shapes)
ROW_BLOCK = 16
#: docs per program; a power of two dividing the index's DOC_BLOCK (512),
#: so one tile never straddles two body_tmax blocks
DOC_TILE = 128
NUM_WARPS = 4
NUM_STAGES = 2

_SENTINEL = jnp.iinfo(jnp.int32).max  # a pad term id no ft slot holds


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _sweep(ft_ref, fw_ref, tq_ref, nq, t_hi, emit_counts: bool):
    """One section's (score, count) tile: term rows [0, t_hi) of the
    [T, DOC_TILE] index slice against query slots [0, nq) of the row
    block's [Q, ROW_BLOCK] term tile."""
    zeros = jnp.zeros((ROW_BLOCK, DOC_TILE), jnp.float32)

    def t_body(t, acc):
        ft = ft_ref[t, :]  # [DOC_TILE]
        fw = fw_ref[t, :]

        def q_body(q, mult):
            tq = tq_ref[q, :]  # [ROW_BLOCK]
            return mult + (ft[None, :] == tq[:, None]).astype(jnp.float32)

        mult = jax.lax.fori_loop(0, nq, q_body, zeros)
        score = acc[0] + mult * fw[None, :]
        if not emit_counts:
            return (score,)
        return score, acc[1] + mult

    init = (zeros, zeros) if emit_counts else (zeros,)
    return jax.lax.fori_loop(0, t_hi, t_body, init)


def _kernel(
    qn_ref, qnb_ref, tmax_ref, tq_ref, btq_ref,
    tft_ref, tfw_ref, bft_ref, bfw_ref, *out_refs,
    emit_counts: bool, tiles_per_tmax: int,
):
    rb = pl.program_id(1)
    title = _sweep(tft_ref, tfw_ref, tq_ref, qn_ref[rb], tft_ref.shape[0],
                   emit_counts)
    t_hi = jnp.minimum(
        tmax_ref[pl.program_id(0) // tiles_per_tmax], bft_ref.shape[0]
    )
    body = _sweep(bft_ref, bfw_ref, btq_ref, qnb_ref[rb], t_hi, emit_counts)
    for ref, val in zip(out_refs, title + body):
        ref[...] = val


def _row_block_max(n: jax.Array, q: int) -> jax.Array:
    """Per-row-block max active slot count, i32 [B // ROW_BLOCK]."""
    return jnp.clip(n.reshape(-1, ROW_BLOCK).max(axis=1), 0, q).astype(jnp.int32)


@functools.partial(
    jax.jit, static_argnames=("emit_counts", "tmax_block", "interpret")
)
def keyword_scores_2sec(
    title_ftT: jax.Array,  # int32 [Tt, D] (transposed forward index, -1 pad)
    title_fwT: jax.Array,  # f32 [Tt, D]
    body_ftT: jax.Array,  # int32 [Tb, D]
    body_fwT: jax.Array,
    term_ids: jax.Array,  # int32 [B, Q]; unused slots hold a sentinel
    qn: jax.Array | None = None,  # i32 [B] active slots (batch sorted desc)
    *,
    emit_counts: bool = True,
    qnb: jax.Array | None = None,  # i32 [B] cold slots (hot split)
    body_tmax: jax.Array | None = None,  # i32 [D // tmax_block] (doc-sorted)
    tmax_block: int = 512,
    interpret: bool = False,
):
    """-> (title score, title count, body score, body count), each [B, D];
    the counts are None when emit_counts=False. Any B and D: the batch is
    padded to ROW_BLOCK rows (pad rows get the sentinel and no active
    slots) and the doc axis to DOC_TILE columns, and both are sliced off."""
    from ..scoring import mask_cold

    b, q = term_ids.shape
    d = title_ftT.shape[1]
    if qn is None:
        qn = jnp.full((b,), q, jnp.int32)
    if qnb is None:
        qnb, body_tq = qn, term_ids
    else:
        body_tq = mask_cold(term_ids, qnb)

    b_pad = -(-b // ROW_BLOCK) * ROW_BLOCK
    q_pad = _pow2(q)
    d_pad = -(-d // DOC_TILE) * DOC_TILE

    def rows(x, fill):
        return jnp.pad(x, ((0, b_pad - b), (0, q_pad - q)), constant_values=fill)

    def docs(x, fill):
        return x if d_pad == d else jnp.pad(
            x, ((0, 0), (0, d_pad - d)), constant_values=fill)

    # term tiles go in transposed ([Q, B]): one query slot is then a
    # contiguous ROW_BLOCK vector
    tqT = rows(term_ids, _SENTINEL).T
    btqT = rows(body_tq, _SENTINEL).T
    qn_b = _row_block_max(jnp.pad(qn.astype(jnp.int32), (0, b_pad - b)), q)
    qnb_b = _row_block_max(jnp.pad(qnb.astype(jnp.int32), (0, b_pad - b)), q)
    tt, tb = title_ftT.shape[0], body_ftT.shape[0]

    if body_tmax is None:  # one bound for every tile: the full sweep
        body_tmax, tiles_per_tmax = jnp.full((1,), tb, jnp.int32), d_pad // DOC_TILE
    else:
        assert tmax_block % DOC_TILE == 0, (tmax_block, DOC_TILE)
        tiles_per_tmax = tmax_block // DOC_TILE
    kernel = functools.partial(
        _kernel, emit_counts=emit_counts, tiles_per_tmax=tiles_per_tmax
    )
    n_out = 4 if emit_counts else 2
    out = pl.pallas_call(
        kernel,
        grid=(d_pad // DOC_TILE, b_pad // ROW_BLOCK),
        in_specs=[
            pl.no_block_spec,  # per-row-block qn bounds
            pl.no_block_spec,  # per-row-block qnb bounds
            pl.no_block_spec,  # per-doc-block body T bounds
            pl.BlockSpec((q_pad, ROW_BLOCK), lambda i, j: (0, j)),
            pl.BlockSpec((q_pad, ROW_BLOCK), lambda i, j: (0, j)),
            pl.BlockSpec((tt, DOC_TILE), lambda i, j: (0, i)),
            pl.BlockSpec((tt, DOC_TILE), lambda i, j: (0, i)),
            pl.BlockSpec((tb, DOC_TILE), lambda i, j: (0, i)),
            pl.BlockSpec((tb, DOC_TILE), lambda i, j: (0, i)),
        ],
        out_specs=[pl.BlockSpec((ROW_BLOCK, DOC_TILE), lambda i, j: (j, i))] * n_out,
        out_shape=[jax.ShapeDtypeStruct((b_pad, d_pad), jnp.float32)] * n_out,
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        interpret=interpret,
        name="keyword_sweep",
    )(qn_b, qnb_b, body_tmax.astype(jnp.int32), tqT, btqT,
      docs(title_ftT, -1), docs(title_fwT, 0.0),
      docs(body_ftT, -1), docs(body_fwT, 0.0))
    out = [o[:b, :d] for o in out]
    if emit_counts:
        return out[0], out[1], out[2], out[3]
    return out[0], None, out[1], None
