#!/usr/bin/env python3
"""Smoke run of the search engine's main path on an NVIDIA GPU.

    python chip_smoke.py [--seed N] [--pages N]     # one card
    python chip_smoke.py --cards 4 [--seed N]       # doc-sharded mesh, 4 cards

Each phase runs in its own process, so one JAX process holds the card at a
time; this parent process never imports JAX.

  preamble  JAX's devices and nvidia-smi's card name and power limit; fails
            unless JAX's backend is gpu.
  build     the crawl-built benchmark corpus (bench.build_bench_corpus:
            100,000 pages, Zipf vocabulary of 30k, 40-120 body words, 0-8
            links; real indexer -> PageRank on the card -> tf-idf ->
            snapshot) from --seed into .bench/.
  serve     `python -m spaghettisearch_tpu.cli.server` on that corpus with
            warmup on; POST /query, GET /query/{terms}, GET /wordlist/{pre}
            and POST /query_batch, every ranked answer checked against
            tests/oracle.py.
  device    a 1M-doc DeviceIndex (the scale1m shapes); the production
            keyword and mixed programs, called as models/blended.py calls
            them at B=128, checked against the CSR formulation; peak device
            memory; keyword-kernel vs XLA timings at 100k and 1M docs.

With --cards 4 only build and serve run, the server with --meshShards 4
across four cards. The last line is {"ok": true, "device": {...}}; a
failed phase exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FULL_PAGES = 100_000
#: score agreement with the oracle / CSR formulation: every scoring product
#: runs at full f32 precision, so only summation order differs
RTOL = 1e-5
TIME_LIMIT_S = 1150.0


def _say(msg: str) -> None:
    print(msg, flush=True)


def _corpus_root(pages: int, seed: int) -> str:
    return os.path.join(REPO, ".bench", f"smoke{pages}_seed{seed}")


# ---------------------------------------------------------------------- #
# phases that run in child processes (they import JAX)
# ---------------------------------------------------------------------- #


def phase_preamble(args) -> None:
    import jax

    devs = jax.devices()
    _say(f"jax devices: {devs}")
    _say(f"device_kind: {devs[0].device_kind}; backend: {jax.default_backend()}")
    if jax.default_backend() != "gpu":
        _say("chip_smoke: JAX found no GPU; this run needs one")
        sys.exit(1)
    if len(devs) < args.cards:
        _say(f"chip_smoke: need {args.cards} GPUs, JAX sees {len(devs)}")
        sys.exit(1)
    _say(json.dumps({"platform": devs[0].platform, "kind": devs[0].device_kind,
                     "count": len(devs)}))


def phase_build(args) -> None:
    import bench

    root = _corpus_root(args.pages, args.seed)
    t0 = time.perf_counter()
    bench.build_bench_corpus(root, n_pages=args.pages, seed=args.seed)
    _say(f"build: {args.pages} pages in {time.perf_counter() - t0:.1f} s "
         f"(indexer -> PageRank on the card -> tf-idf -> snapshot) "
         f"[{args.card}]")


def _time_call(fn, min_s: float = 0.5, max_reps: int = 50) -> float:
    """ms per call: one compiling call, then repeated calls each ending in
    block_until_ready."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    one = time.perf_counter() - t0
    reps = int(max(1, min(max_reps, min_s / max(one, 1e-6))))
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn())
    return (time.perf_counter() - t0) / reps * 1e3


def _batch_inputs(eng, parsed, b):
    """Device inputs for one batch, prepared as QueryEngine.rank_async /
    _rank_fused prepare them (row sort, hot split, phrase tiles)."""
    import jax.numpy as jnp
    import numpy as np

    from spaghettisearch_tpu.retrieval.engine import P_LEVELS, Q_BASE

    snap, idx, model = eng._live
    hot_map = eng._hot_map(model, idx)
    tids, qlen, qn, qnb, hot_sids = eng._fill_keyword_rows(
        parsed, b, Q_BASE, snap, hot_map)
    p = P_LEVELS[-1]
    ph_ids = np.full((b, p), snap.n_words, np.int32)
    ph_valid = np.zeros((b, p), np.float32)
    pn = np.zeros(b, np.int32)
    for i, pq in enumerate(parsed):
        pids = snap.term_ids(pq.phrase_hashes)[:p]
        ph_ids[i, : len(pids)] = pids
        ph_valid[i, : len(pids)] = 1.0
        pn[i] = len(pids)
    perm = np.lexsort((-qn, -qnb, -pn))
    hot = {} if hot_map is None else {
        "qnb": jnp.asarray(qnb[perm]), "hot_sids": jnp.asarray(hot_sids[perm])}
    tp = jnp.zeros((b, idx.n_categories), jnp.float32)
    kw = dict(idx=idx, tids=jnp.asarray(tids[perm]), qlen=jnp.asarray(qlen[perm]),
              tp=tp, qn=jnp.asarray(qn[perm]), hot=hot)
    mixed = dict(ph_ids=jnp.asarray(ph_ids[perm]),
                 ph_valid=jnp.asarray(ph_valid[perm]), pn=jnp.asarray(pn[perm]))
    return model, kw, mixed


def _timings(eng, kw_batches, mixed_batches, docs, card):
    """keyword and mixed programs, Triton kernel vs XLA formulation, at
    each batch size; -> list of result dicts (also printed)."""
    import jax
    import numpy as np

    from spaghettisearch_tpu.ops import scoring

    out = []
    gpu = jax.default_backend() == "gpu"
    real_route = scoring.use_gpu_kernel
    try:
        for b, parsed_kw in kw_batches.items():
            model, kw, _ = _batch_inputs(eng, parsed_kw, b)
            model_m, kwm, mixed = _batch_inputs(eng, mixed_batches[b], b)
            programs = {
                "keyword": lambda: model.score_keywords(
                    kw["idx"], kw["tids"], kw["qlen"], kw["tp"], topk=50,
                    qn=kw["qn"], **kw["hot"]),
                "mixed": lambda: model_m.score_mixed(
                    kwm["idx"], kwm["tids"], kwm["qlen"], kwm["tp"],
                    mixed["ph_ids"], mixed["ph_valid"], topk=50, qn=kwm["qn"],
                    pn=mixed["pn"], **kwm["hot"]),
            }
            for name, fn in programs.items():
                res = {}
                for route in ((True, False) if gpu else (False,)):
                    scoring.use_gpu_kernel = lambda r=route: r
                    res[route] = (_time_call(fn), [np.asarray(x) for x in fn()])
                if gpu:
                    (tk, (sk, _)), (tx, (sx, _)) = res[True], res[False]
                    fin = np.isfinite(sx)
                    same = bool(np.array_equal(np.isfinite(sk), fin)) and bool(
                        np.allclose(sk[fin], sx[fin], rtol=RTOL))
                    if not same:
                        raise SystemExit(
                            f"device: kernel and XLA {name} programs disagree "
                            f"(docs={docs}, B={b})")
                    row = dict(docs=docs, batch=b, program=name,
                               kernel_ms=tk, xla_ms=tx, card=card)
                    _say(f"timing docs={docs} B={b} {name}: kernel {tk:.3f} ms, "
                         f"xla {tx:.3f} ms, xla/kernel {tx / tk:.2f} [{card}]")
                else:
                    row = dict(docs=docs, batch=b, program=name,
                               xla_ms=res[False][0], card="cpu")
                    _say(f"timing docs={docs} B={b} {name}: xla "
                         f"{res[False][0]:.3f} ms (CPU rehearsal; kernel "
                         f"legs need the GPU)")
                out.append(row)
    finally:
        scoring.use_gpu_kernel = real_route
    return out


def _synth_queries(snap, rng, n: int, phrases: bool):
    """ParsedQuery rows on a synthetic snapshot: 1-4 df-weighted keywords;
    with phrases, every 4th row also carries a 2-term phrase of two body
    postings at adjacent positions of one document (so the positional
    chain matches somewhere)."""
    import numpy as np

    from spaghettisearch_tpu.retrieval.engine import ParsedQuery

    body = snap.body
    n_post = body.n_postings
    df = np.diff(body.post_offsets).astype(np.float64)
    pairs = []
    if phrases:
        docs = rng.choice(snap.n_docs, 4 * n, replace=False)
        sel = np.flatnonzero(np.isin(body.doc_ids[:n_post], docs))
        word_of = np.searchsorted(body.post_offsets, sel, side="right") - 1
        pos = body.positions[body.pos_offsets[sel]]
        for d in docs:
            mine = np.flatnonzero(body.doc_ids[sel] == d)
            order = mine[np.argsort(pos[mine])]
            adj = np.flatnonzero(np.diff(pos[order]) == 1)
            if adj.size:
                pairs.append((int(word_of[order[adj[0]]]),
                              int(word_of[order[adj[0] + 1]])))
    rows = []
    for i in range(n):
        kws = [snap.word_hashes[int(w)] for w in
               rng.choice(len(df), int(rng.integers(1, 5)), p=df / df.sum())]
        phs = []
        if phrases and i % 4 == 0 and i // 4 < len(pairs):
            phs = [snap.word_hashes[w] for w in pairs[i // 4]]
        rows.append(ParsedQuery(raw="", stripped="", phrases=["p"] if phs else [],
                                keyword_hashes=kws, phrase_hashes=phs))
    return rows


def _check_vs_csr(eng, parsed, label):
    """The production rank() against the CSR formulation with the sparse
    match_phrase_fwd fold, row by row."""
    import jax.numpy as jnp
    import numpy as np

    from bench import parity_verdict
    from spaghettisearch_tpu.retrieval.engine import Q_BASE

    snap, idx, model = eng._live
    b = len(parsed)
    s_prod, i_prod = eng.rank(parsed, topk=50)
    tids, qlen, _, _, _ = eng._fill_keyword_rows(parsed, b, Q_BASE, snap, None)
    ph_rows = [i for i, p in enumerate(parsed) if p.phrase_hashes]
    matches = {}
    if ph_rows:
        for i, m in zip(ph_rows, eng._match_phrases_batch(
                [parsed[i].phrase_hashes for i in ph_rows])):
            real = m[0] < idx.match_pad
            matches[i] = tuple(a[real] for a in m)
    e = max([64] + [len(m[0]) for m in matches.values()])
    ph = [np.full((b, e), idx.match_pad, np.int32)] + [
        np.zeros((b, e), np.float32) for _ in range(3)]
    for i, m in matches.items():
        for arr, vals in zip(ph, m):
            arr[i, : len(vals)] = vals
    s_csr, i_csr = model.score_csr(
        idx, jnp.asarray(tids), jnp.asarray(qlen),
        jnp.zeros((b, idx.n_categories), jnp.float32),
        *map(jnp.asarray, ph), topk=64)
    s_csr, i_csr = np.asarray(s_csr), np.asarray(i_csr)
    counts = {"exact": 0, "tie": 0, "mismatch": 0}
    worst = 0.0
    n_hits = 0
    for r in range(b):
        got = [(int(d), float(s)) for s, d in zip(s_prod[r], i_prod[r]) if np.isfinite(s)]
        want = [(int(d), float(s)) for s, d in zip(s_csr[r], i_csr[r]) if np.isfinite(s)]
        v, err = parity_verdict(got, want, k=min(50, len(want)))
        n_hits += len(got)
        counts[v] += 1
        worst = max(worst, err)
    _say(f"device: {label} vs CSR: {counts}, {n_hits} ranked docs, max rel "
         f"score err {worst:.3g} (limit {RTOL})")
    if counts["mismatch"] or worst > RTOL or n_hits == 0:
        raise SystemExit(f"device: {label} disagrees with the CSR formulation")


def phase_device(args) -> None:
    import jax
    import numpy as np

    import bench
    from spaghettisearch_tpu.retrieval.device_index import DeviceIndex
    from spaghettisearch_tpu.retrieval.engine import QueryEngine, parse_query

    card = args.card
    rng = np.random.default_rng(args.seed + 7)
    n_docs = args.docs
    t0 = time.perf_counter()
    snap = bench.synth_snapshot(
        n_docs=n_docs, n_words=200_000, body_terms_per_doc=48,
        title_terms_per_doc=4, max_df=32_768, seed=args.seed,
    )
    snap.word_id.update({h: i for i, h in enumerate(snap.word_hashes)})
    t1 = time.perf_counter()
    idx = DeviceIndex.from_snapshot(snap)
    t2 = time.perf_counter()
    _say(f"device: synth snapshot {n_docs} docs in {t1 - t0:.1f} s, "
         f"DeviceIndex in {t2 - t1:.1f} s; position lane live: "
         f"{idx.pos_dense}, hot cache live: {idx.hot_body_w is not None}, "
         f"doc-sorted: {idx.doc_perm is not None}, count elision: "
         f"{not idx.has_zero_weight}")
    if not (idx.pos_dense and idx.hot_body_w is not None):
        raise SystemExit("device: the position lane and the hot cache must "
                         "both be live at this size")
    eng = QueryEngine(None, snapshot=snap, index=idx)
    kw128 = _synth_queries(snap, rng, 128, phrases=False)
    mixed128 = _synth_queries(snap, rng, 128, phrases=True)
    _check_vs_csr(eng, kw128, f"keyword program {n_docs} docs B=128")
    _check_vs_csr(eng, mixed128, f"mixed program {n_docs} docs B=128")
    stats = jax.devices()[0].memory_stats() or {}
    _say(f"device: peak_bytes_in_use {stats.get('peak_bytes_in_use')} of "
         f"bytes_limit {stats.get('bytes_limit')} at {n_docs} docs [{card}]")
    results = _timings(
        eng, {16: kw128[:16], 128: kw128}, {16: mixed128[:16], 128: mixed128},
        n_docs, card)
    del eng, idx, snap

    if args.root:
        db, snap = bench.load_bench_corpus(args.root)
        eng = QueryEngine(db, snapshot=snap)
        qs = bench.bench_queries(snap, 128, seed=args.seed + 3, phrase_every=0, db=db)
        ms = bench.bench_queries(snap, 128, seed=args.seed + 4, phrase_every=4, db=db)
        kw = [parse_query(q) for q in qs]
        mx = [parse_query(q) for q in ms]
        results += _timings(eng, {16: kw[:16], 128: kw},
                            {16: mx[:16], 128: mx}, snap.n_docs, card)
        db.close()
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "smoke_timings.json"), "w") as f:
        json.dump(results, f, indent=1)


# ---------------------------------------------------------------------- #
# the parent: runs the phases, drives the server over HTTP (no JAX here)
# ---------------------------------------------------------------------- #


def _run_child(phase: str, args, deadline: float, extra=()) -> str:
    """Run one phase in its own process, echo its output; -> last line."""
    cmd = [sys.executable, os.path.abspath(__file__), "--phase", phase,
           "--seed", str(args.seed), "--pages", str(args.pages),
           "--cards", str(args.cards), "--card", args.card, *extra]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, text=True)
    last = ""
    try:
        for line in proc.stdout:
            print(line, end="", flush=True)
            if line.strip():
                last = line.strip()
        rc = proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        raise SystemExit(f"chip_smoke: phase {phase} failed (exit {rc})")
    return last


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        raise SystemExit("chip_smoke: nvidia-smi found no card")
    lines = out.stdout.strip().splitlines()
    for line in lines:
        _say(line.strip())
    return lines[0].strip()


def _query_set(snap, db, seed: int) -> dict[str, list[str]]:
    import numpy as np

    import bench

    rng = np.random.default_rng(seed + 11)
    df = np.diff(snap.body.post_offsets[: snap.n_words + 1]).astype(np.float64)
    word_of = {wh: db.word.get(wh) for wh in snap.word_hashes}

    def many_keywords() -> str:
        ids = rng.choice(len(df), size=int(rng.integers(6, 9)), p=df / df.sum())
        return " ".join(w for w in (word_of[snap.word_hashes[int(i)]] for i in ids) if w)

    phrases = [q for q in (bench._mine_ngram(snap, db, rng, 2) for _ in range(6)) if q]
    return {
        "keywords": bench.bench_queries(snap, 12, seed=seed + 1, phrase_every=0, db=db),
        "phrase": phrases + [q for q in [bench._mine_ngram(snap, db, rng, 4)] if q],
        "mixed": bench.bench_queries(snap, 6, seed=seed + 2, phrase_every=1, db=db),
        "catchall": [many_keywords() for _ in range(3)],
    }


def _http(port: int, method: str, path: str, body=None, timeout=300.0):
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"},
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        out = json.loads(resp.read())
    return out, (time.perf_counter() - t0) * 1e3


def _serve(args, deadline: float) -> None:
    from concurrent.futures import ThreadPoolExecutor
    from urllib.parse import quote

    import numpy as np

    import bench
    from spaghettisearch_tpu.utils.hashing import md5_hex

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from oracle import retrieve

    root = _corpus_root(args.pages, args.seed)
    db, snap = bench.load_bench_corpus(root)
    sets = _query_set(snap, db, args.seed)
    every = [q for qs in sets.values() for q in qs]
    # oracle rankings run past 50 so ties at the cutoff can be recognized
    want = {q: retrieve(db, q, topk=64) for q in every}
    vocab = sorted({w for wh in snap.word_hashes if (w := db.word.get(wh))})
    prefixes = sorted({q.strip('"')[:3] for q in sets["keywords"][:3]})
    db.close()
    _say(f"serve: {len(every)} queries ({', '.join(f'{k} {len(v)}' for k, v in sets.items())}); "
         f"oracle answers computed")

    port = bench._free_port()
    log_path = os.path.join(REPO, ".bench", f"smoke_server_{args.cards}.log")
    cmd = [sys.executable, "-m", "spaghettisearch_tpu.cli.server",
           "--db", os.path.join(root, "store"),
           "--snapshot", os.path.join(root, "snapshot"), "--port", str(port)]
    if args.cards > 1:
        cmd += ["--meshShards", str(args.cards)]
    t0 = time.monotonic()
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    try:
        while True:
            if proc.poll() is not None:
                print(open(log_path, encoding="utf-8", errors="replace").read()[-4000:])
                raise SystemExit("serve: the server exited during start-up")
            text = open(log_path, encoding="utf-8", errors="replace").read()
            if "Server is running on port" in text:
                break
            if time.monotonic() > deadline:
                raise SystemExit("serve: the server did not come up in time")
            time.sleep(1.0)
        warm = [ln for ln in text.splitlines() if ln.startswith(("Loaded index", "Warmup done"))]
        _say(f"serve: server up in {time.monotonic() - t0:.1f} s; "
             + "; ".join(warm) + f" [{args.card}]")

        counts = {"exact": 0, "tie": 0, "mismatch": 0}
        worst = [0.0]
        lat: dict[str, list[float]] = {}

        def check(q: str, rows: list[dict]) -> None:
            got = [(md5_hex(r["Url"]), float(r["FinalRank"])) for r in rows]
            v, err = bench.parity_verdict(got, want[q], k=50, rtol=RTOL)
            counts[v] += 1
            worst[0] = max(worst[0], err)
            if v == "mismatch":
                _say(f"serve: MISMATCH for {q!r}: got {got[:5]}..., "
                     f"want {want[q][:5]}...")

        for kind, qs in sets.items():
            for q in qs:
                rows, ms = _http(port, "POST", "/query", {"query": q})
                lat.setdefault(f"POST /query ({kind})", []).append(ms)
                check(q, rows)
        for q in every[:: max(len(every) // 4, 1)][:4]:
            rows, ms = _http(port, "GET", "/query/" + quote(q, safe=""))
            lat.setdefault("GET /query/{terms}", []).append(ms)
            check(q, rows)
        batch = every[::3][:8]
        res, ms = _http(port, "POST", "/query_batch", {"queries": batch})
        lat.setdefault("POST /query_batch (8)", []).append(ms)
        for q, rows in zip(batch, res):
            check(q, rows)
        # one concurrent burst: the micro-batcher coalesces these
        with ThreadPoolExecutor(16) as ex:
            outs = list(ex.map(lambda q: _http(port, "POST", "/query", {"query": q}), every))
        for q, (rows, ms) in zip(every, outs):
            lat.setdefault("POST /query (concurrent)", []).append(ms)
            check(q, rows)
        for pre in prefixes:
            words, ms = _http(port, "GET", "/wordlist/" + quote(pre, safe=""))
            lat.setdefault("GET /wordlist/{pre}", []).append(ms)
            expect = [w for w in vocab if w.startswith(pre)]
            if words != expect or not words:
                raise SystemExit(f"serve: /wordlist/{pre} returned {len(words)} "
                                 f"words, expected {len(expect)}")
        for route, xs in lat.items():
            _say(f"serve: {route}: n={len(xs)} p50 {np.percentile(xs, 50):.2f} ms "
                 f"max {max(xs):.2f} ms [{args.card}]")
        stats, _ = _http(port, "GET", "/stats")
        spans = {k: v for k, v in stats.items() if isinstance(v, dict) and "mean_ms" in v}
        _say("serve: /stats spans " + json.dumps(spans, sort_keys=True))
        _say(f"serve: oracle parity {counts}, max rel score err {worst[0]:.3g} "
             f"(limit {RTOL})")
        if counts["mismatch"] or worst[0] > RTOL:
            raise SystemExit("serve: answers disagree with tests/oracle.py")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pages", type=int, default=FULL_PAGES,
                    help="crawl-built corpus size; cut only when a time "
                         "limit forces it")
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: serve the doc-sharded mesh across four cards "
                         "(build and serve phases only)")
    ap.add_argument("--phase", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--card", default="", help=argparse.SUPPRESS)
    ap.add_argument("--docs", type=int, default=1_000_000, help=argparse.SUPPRESS)
    ap.add_argument("--root", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(REPO, "spaghettisearch_tpu")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, REPO)
    if args.phase:
        {"preamble": phase_preamble, "build": phase_build,
         "device": phase_device}[args.phase](args)
        return

    deadline = time.monotonic() + TIME_LIMIT_S
    device = json.loads(_run_child("preamble", args, deadline))
    args.card = _card_line()
    if args.pages < FULL_PAGES:
        _say(f"build: pages cut from {FULL_PAGES} to {args.pages}")
    _run_child("build", args, deadline)
    _serve(args, deadline)
    if args.cards == 1:
        _run_child("device", args, deadline,
                   ("--root", _corpus_root(args.pages, args.seed)))
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
