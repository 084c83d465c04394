"""Snapshot persistence: save/load the columnar index to disk.

The store is the durable source of truth (checkpoint/resume semantics match
the reference, SURVEY §5); snapshots are derived artifacts, persisted so a
serving process can place the columnar arrays on the device without
re-walking the store (.npz for arrays + JSON sidecar for hashes/categories).
"""

from __future__ import annotations

import json
import os

import numpy as np

from .snapshot import IndexSnapshot, SectionCSR

_SECTION_FIELDS = ("post_offsets", "doc_ids", "weights", "pos_offsets", "positions")


def save_snapshot(snap: IndexSnapshot, path: str) -> None:
    """Atomic: builds the snapshot in a temp sibling directory and renames
    it into place, so a crash mid-write can never leave a half-written
    snapshot where a server would load it."""
    import shutil

    final = os.path.abspath(path)
    tmp = f"{final}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    _write_snapshot(snap, tmp)
    old = f"{final}.old-{os.getpid()}"
    if os.path.exists(final):
        os.rename(final, old)
    os.rename(tmp, final)
    shutil.rmtree(old, ignore_errors=True)


def _write_snapshot(snap: IndexSnapshot, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    arrays: dict[str, np.ndarray] = {}
    for name in ("title", "body"):
        csr: SectionCSR = getattr(snap, name)
        for f in _SECTION_FIELDS:
            arrays[f"{name}.{f}"] = getattr(csr, f)
    arrays["mag_title"] = snap.mag_title
    arrays["mag_body"] = snap.mag_body
    if snap.pagerank is not None:
        arrays["pagerank"] = snap.pagerank
    np.savez_compressed(os.path.join(path, "arrays.npz"), **arrays)
    meta = {
        "doc_hashes": snap.doc_hashes,
        "word_hashes": snap.word_hashes,
        "categories": snap.categories,
        "title": {
            "n_postings": snap.title.n_postings,
            "max_df": snap.title.max_df,
            "max_positions": snap.title.max_positions,
        },
        "body": {
            "n_postings": snap.body.n_postings,
            "max_df": snap.body.max_df,
            "max_positions": snap.body.max_positions,
        },
    }
    with open(os.path.join(path, "meta.json"), "w", encoding="utf-8") as f:
        json.dump(meta, f)


def load_snapshot(path: str) -> IndexSnapshot:
    with open(os.path.join(path, "meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    arrays = np.load(os.path.join(path, "arrays.npz"))

    def section(name: str) -> SectionCSR:
        return SectionCSR(
            **{f: arrays[f"{name}.{f}"] for f in _SECTION_FIELDS},
            n_postings=meta[name]["n_postings"],
            max_df=meta[name]["max_df"],
            max_positions=meta[name]["max_positions"],
        )

    return IndexSnapshot(
        doc_hashes=meta["doc_hashes"],
        word_hashes=meta["word_hashes"],
        doc_id={h: i for i, h in enumerate(meta["doc_hashes"])},
        word_id={h: i for i, h in enumerate(meta["word_hashes"])},
        title=section("title"),
        body=section("body"),
        mag_title=arrays["mag_title"],
        mag_body=arrays["mag_body"],
        categories=meta["categories"],
        pagerank=arrays["pagerank"] if "pagerank" in arrays else None,
        source_dir=os.path.abspath(path),
    )
