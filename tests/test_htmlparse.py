"""The standard-library HTML tokenizer against recorded token streams
(tests/data/htmlparse_golden.json, one entry per sample in
tests/html_samples.py, as bytes and as str)."""

from __future__ import annotations

import json
import os

import pytest

from html_samples import BASE, SAMPLES
from spaghettisearch_tpu.text.htmlparse import extract_summary_text, tokenize_page

with open(os.path.join(os.path.dirname(__file__), "data", "htmlparse_golden.json"),
          encoding="utf-8") as _f:
    GOLDEN = json.load(_f)


@pytest.mark.parametrize("kind", ["bytes", "str"])
@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_token_stream_matches_golden(name, kind):
    doc = SAMPLES[name]
    doc = doc.encode() if kind == "bytes" else doc
    page = tokenize_page(doc, BASE, with_summary=True)
    got = dict(
        title=page.title, words=page.words, meta=page.meta,
        fancy=[list(x) for x in page.fancy], links=page.links,
        summary=page.summary, summary_direct=extract_summary_text(doc),
    )
    assert got == GOLDEN[f"{name}/{kind}"]
