// Native serving-response assembler: the per-request wire path
// (engine.hydrate_row_json) in one GIL-released call.
//
// Motivation: the Python fragment-cache fast path costs ~150 tiny
// json.dumps calls + f-string assembly per top-50 response, which makes
// the host, not the device scorer, the serving wall. Here the whole
// response is assembled natively from a generation-tagged per-doc store:
//
//   response = "[" + join(",",
//       frag(doc) + ',"Summary":' + json(summary(doc, query))
//                 + ',"PageRank":0.0,"FinalRank":' + score + "}") + "]"
//
// matching the reference contract (retrieval/util.go:56-149,
// get_metadata.go:16-411). Summaries are rendered by the shared core
// (summary_core.h) and memoized in a fixed-size, sharded, overwrite-on-
// collision hash table keyed by (doc, 128-bit query hash): repeat
// (doc, query) pairs — the common case under production traffic — cost one
// hash probe + memcpy.
//
// The topic-PageRank path (disabled by default, like the reference's) and
// docs not registered in the generation fall back to the Python assembler:
// fv_assemble returns -2 and the caller takes the legacy path.
//
// Generations: Python builds one per snapshot (prewarm/refresh, off the
// serving lock) and frees it when the snapshot is dropped, so /refresh
// swaps doc-id spaces atomically with the rest of the live state.

#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <mutex>
#include <string>
#include <vector>

#include "summary_core.h"

namespace {

struct Doc {
  std::string frag;  // pre-serialized static fields, without closing '}'
  fsum::TokDoc tok;  // summary text, pre-tokenized ONCE at registration
  bool set = false;
};

constexpr int kCacheBits = 19;  // 512k slots
constexpr uint32_t kCacheMask = (1u << kCacheBits) - 1;
constexpr int kShards = 64;

struct Slot {
  uint64_t h1 = 0, h2 = 0;
  std::string val;  // escaped summary INCLUDING surrounding quotes
  bool used = false;
};

struct Gen {
  std::vector<Doc> docs;
  std::vector<Slot> cache{1u << kCacheBits};
  std::mutex shard_mu[kShards];
};

inline uint64_t fnv1a(const void* data, size_t n, uint64_t h) {
  const unsigned char* p = (const unsigned char*)data;
  for (size_t i = 0; i < n; i++) {
    h ^= p[i];
    h *= 0x100000001b3ULL;
  }
  return h;
}

// JSON string escape, parse-equal to json.dumps (raw utf-8 kept: loads()
// yields the identical str; control chars as \u00XX). Safe spans are
// appended in bulk rather than byte-at-a-time (summaries are ~99.9%
// escape-free, and the per-byte loop showed up in the serving profile).
inline void json_escape(const char* s, int n, std::string* out) {
  out->clear();
  out->reserve(n + 2);
  out->push_back('"');
  int run = 0;  // start of the current escape-free span
  for (int i = 0; i < n; i++) {
    unsigned char c = s[i];
    if (c >= 0x20 && c != '"' && c != '\\') continue;
    if (i > run) out->append(s + run, i - run);
    run = i + 1;
    if (c == '"') {
      out->append("\\\"");
    } else if (c == '\\') {
      out->append("\\\\");
    } else {
      char b[8];
      snprintf(b, sizeof(b), "\\u%04x", c);
      out->append(b);
    }
  }
  if (n > run) out->append(s + run, n - run);
  out->push_back('"');
}

// Shortest round-trip float formatting (std::to_chars), value-identical to
// (and ~10x faster than) the snprintf %.17g it replaces. Python's
// json.dumps uses repr's shortest round-trip too, so parsed-value parity
// with the Python assembler is exact. JSON needs a fraction/exponent mark
// for float (not int) parity on whole numbers; Infinity matches json.dumps.
inline int format_final_rank(double sd, char* num, size_t cap) {
  if (std::isinf(sd)) return snprintf(num, cap, "Infinity");
  auto res = std::to_chars(num, num + cap - 2, sd);
  int nn = (int)(res.ptr - num);
  bool has_mark = false;
  for (int c = 0; c < nn; c++) {
    if (num[c] == '.' || num[c] == 'e' || num[c] == 'E' || num[c] == 'n') {
      has_mark = true;
      break;
    }
  }
  if (!has_mark) {
    num[nn++] = '.';
    num[nn++] = '0';
  }
  return nn;
}

struct Writer {
  char* buf;
  int64_t cap;
  int64_t len = 0;
  bool overflow = false;
  void put(const char* s, int64_t n) {
    if (len + n > cap) {
      overflow = true;
      return;
    }
    memcpy(buf + len, s, n);
    len += n;
  }
  void put(const std::string& s) { put(s.data(), (int64_t)s.size()); }
};

thread_local std::vector<char> t_render(1 << 16);
thread_local std::string t_escaped;

}  // namespace

extern "C" {

void* fv_gen_new(int32_t n_docs) {
  Gen* g = new Gen();
  g->docs.resize(n_docs);
  return g;
}

void fv_gen_set(void* gen, int32_t doc_id, const char* frag, int32_t frag_len,
                const char* text, int32_t text_len) {
  Gen* g = (Gen*)gen;
  if (doc_id < 0 || (size_t)doc_id >= g->docs.size()) return;
  Doc& d = g->docs[doc_id];
  d.frag.assign(frag, frag_len);
  fsum::build_tokdoc(text, text_len, &d.tok);
  d.set = true;
}

// Bulk registration from the persisted hydration sidecar (one GIL-released
// pass instead of ~n_docs ctypes calls): doc-id-aligned byte blobs with
// [n+1] offset arrays; flags bit0 = fragment present, bit1 = summary text
// present. Only docs with BOTH are registered, mirroring the per-doc path
// (prewarm_hydration registers a doc iff its summary text exists).
void fv_gen_set_bulk(void* gen, int32_t n, const uint8_t* flags,
                     const char* frag_blob, const int64_t* frag_off,
                     const char* text_blob, const int64_t* text_off) {
  Gen* g = (Gen*)gen;
  if (n > (int32_t)g->docs.size()) n = (int32_t)g->docs.size();
  for (int32_t i = 0; i < n; i++) {
    if ((flags[i] & 3) != 3) continue;
    Doc& d = g->docs[i];
    d.frag.assign(frag_blob + frag_off[i],
                  (size_t)(frag_off[i + 1] - frag_off[i]));
    fsum::build_tokdoc(text_blob + text_off[i],
                       (int32_t)(text_off[i + 1] - text_off[i]), &d.tok);
    d.set = true;
  }
}

int64_t fv_gen_count(void* gen) {
  Gen* g = (Gen*)gen;
  int64_t n = 0;
  for (const Doc& d : g->docs) n += d.set;
  return n;
}

void fv_gen_free(void* gen) { delete (Gen*)gen; }

static int64_t assemble_row(Gen* g, const int32_t* ids, const float* scores,
                            int32_t k, const char* qtoks, int32_t n_q,
                            const char* phtoks, const int32_t* ph_lens,
                            int32_t n_ph, char* out, int64_t out_cap) {

  // query-side views + 128-bit query hash (token blobs incl. NULs)
  std::vector<fsum::TokView> qt, pt;
  fsum::split_toks(qtoks, n_q, &qt);
  int total_ph_toks = 0;
  for (int p = 0; p < n_ph; p++) total_ph_toks += ph_lens[p];
  fsum::split_toks(phtoks, total_ph_toks, &pt);
  size_t q_bytes = qt.empty() ? 0 : (qt.back().first + qt.back().second + 1 - qtoks);
  size_t p_bytes = pt.empty() ? 0 : (pt.back().first + pt.back().second + 1 - phtoks);
  uint64_t qh1 = fnv1a(qtoks, q_bytes, 0xcbf29ce484222325ULL);
  qh1 = fnv1a(phtoks, p_bytes, qh1);
  qh1 = fnv1a(ph_lens, sizeof(int32_t) * n_ph, qh1);
  uint64_t qh2 = fnv1a(qtoks, q_bytes, 0x9e3779b97f4a7c15ULL);
  qh2 = fnv1a(phtoks, p_bytes, qh2);
  qh2 = fnv1a(&n_q, sizeof(n_q), qh2);

  Writer w{out, out_cap};
  w.put("[", 1);
  bool first = true;
  char num[64];
  for (int i = 0; i < k; i++) {
    float s = scores[i];
    if (std::isnan(s) || s == -INFINITY) continue;
    int32_t id = ids[i];
    if (id < 0 || (size_t)id >= g->docs.size() || !g->docs[id].set) return -2;
    const Doc& d = g->docs[id];
    if (!first) w.put(",", 1);
    first = false;
    w.put(d.frag);
    w.put(",\"Summary\":", 11);

    uint64_t h1 = fnv1a(&id, sizeof(id), qh1);
    uint64_t h2 = fnv1a(&id, sizeof(id), qh2);
    uint32_t idx = (uint32_t)h1 & kCacheMask;
    Slot& slot = g->cache[idx];
    std::mutex& mu = g->shard_mu[idx % kShards];
    bool hit = false;
    {
      std::lock_guard<std::mutex> lk(mu);
      if (slot.used && slot.h1 == h1 && slot.h2 == h2) {
        w.put(slot.val);
        hit = true;
      }
    }
    if (!hit) {
      int n = fsum::render_tok(d.tok, qt, pt, ph_lens, n_ph, t_render.data(),
                               (int)t_render.size());
      while (n < 0 && t_render.size() < (1u << 24)) {
        t_render.resize(t_render.size() * 2);
        n = fsum::render_tok(d.tok, qt, pt, ph_lens, n_ph, t_render.data(),
                             (int)t_render.size());
      }
      if (n < 0) n = 0;  // pathological: empty summary
      json_escape(t_render.data(), n, &t_escaped);
      w.put(t_escaped);
      std::lock_guard<std::mutex> lk(mu);
      slot.h1 = h1;
      slot.h2 = h2;
      slot.val = t_escaped;
      slot.used = true;
    }

    w.put(",\"PageRank\":0.0,\"FinalRank\":", 28);
    int nn = format_final_rank((double)s, num, sizeof(num));
    w.put(num, nn);
    w.put("}", 1);
  }
  w.put("]", 1);
  if (w.overflow) return -1;
  return w.len;
}

// -> bytes written; -1: out_cap too small (caller grows + retries);
// -2: a kept doc is not registered (caller uses the Python assembler)
int64_t fv_assemble(void* gen, const int32_t* ids, const float* scores,
                    int32_t k, const char* qtoks, int32_t n_q,
                    const char* phtoks, const int32_t* ph_lens, int32_t n_ph,
                    char* out, int64_t out_cap) {
  return assemble_row((Gen*)gen, ids, scores, k, qtoks, n_q, phtoks, ph_lens,
                      n_ph, out, out_cap);
}

// Whole-batch assembly in ONE call: the serving profile measured per-row
// assembly from ~128 concurrent handler threads at ~3.5x its single-thread
// CPU (context-switch + cache thrash on the 1-core host); the micro-batcher
// thread instead assembles every row here back-to-back, cache-warm, and
// handler threads only write finished bytes to their sockets.
//
// Row r uses ids[r*k..], scores[r*k..], qtoks blob [q_off[r], q_off[r+1]),
// n_q[r] tokens, phrase blob [ph_off[r], ph_off[r+1]), ph_lens slice
// [phl_off[r], phl_off[r+1]). Bodies are written contiguously into out;
// out_lens[r] = row byte length, or -2 for a row that must fall back to the
// Python assembler (unregistered doc). Returns total bytes, or -1 when
// out_cap is too small (caller grows + retries).
int64_t fv_assemble_batch(void* gen, const int32_t* ids, const float* scores,
                          int32_t rows, int32_t k, const char* q_blob,
                          const int64_t* q_off, const int32_t* n_q,
                          const char* ph_blob, const int64_t* ph_off,
                          const int32_t* ph_lens_flat, const int64_t* phl_off,
                          char* out, int64_t out_cap, int64_t* out_lens) {
  Gen* g = (Gen*)gen;
  int64_t pos = 0;
  for (int32_t r = 0; r < rows; r++) {
    int64_t n = assemble_row(
        g, ids + (int64_t)r * k, scores + (int64_t)r * k, k,
        q_blob + q_off[r], n_q[r], ph_blob + ph_off[r],
        ph_lens_flat + phl_off[r], (int32_t)(phl_off[r + 1] - phl_off[r]),
        out + pos, out_cap - pos);
    if (n == -1) return -1;
    out_lens[r] = n;
    if (n > 0) pos += n;
  }
  return pos;
}

}  // extern "C"
