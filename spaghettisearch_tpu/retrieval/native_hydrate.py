"""ctypes binding for the native response assembler (native/fastserve.cpp).

One GIL-released call turns a ranked top-K row into the full JSON response
bytes (reference contract: retrieval/util.go:56-149, get_metadata.go:16-411)
from a generation-tagged per-doc store of pre-serialized fragments + summary
text. Replaces the Python hydrate_row_json hot loop, which made the host
the serving wall.

A HydrationGen is built per snapshot (prewarm/refresh, off the serving
lock) and freed with it; assemble() returns None when the caller must fall
back to the Python assembler (unregistered doc, buffer pathology), keeping
the native path an exact, optional accelerator.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_SO_PATH = os.path.join(_NATIVE_DIR, "libfastserve.so")
_lib = None
_lib_lock = threading.Lock()


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO_PATH):
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, "-s"],
                check=True, capture_output=True, timeout=120,
            )
        lib = ctypes.CDLL(_SO_PATH)
        lib.fv_gen_new.restype = ctypes.c_void_p
        lib.fv_gen_new.argtypes = [ctypes.c_int32]
        lib.fv_gen_set.restype = None
        lib.fv_gen_set.argtypes = [
            ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int32,
        ]
        lib.fv_gen_set_bulk.restype = None
        lib.fv_gen_set_bulk.argtypes = [
            ctypes.c_void_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ]
        lib.fv_gen_count.restype = ctypes.c_int64
        lib.fv_gen_count.argtypes = [ctypes.c_void_p]
        lib.fv_gen_free.restype = None
        lib.fv_gen_free.argtypes = [ctypes.c_void_p]
        lib.fv_assemble.restype = ctypes.c_int64
        lib.fv_assemble.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.fv_assemble_batch.restype = ctypes.c_int64
        lib.fv_assemble_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return lib


def native_available() -> bool:
    try:
        _load_lib()
        return True
    except (OSError, subprocess.SubprocessError, RuntimeError):
        return False


_local = threading.local()


def _out_buf(min_cap: int = 1 << 19):
    buf = getattr(_local, "buf", None)
    if buf is None or len(buf) < min_cap:
        buf = _local.buf = ctypes.create_string_buffer(min_cap)
    return buf


class HydrationGen:
    """Owns one fastserve generation (per-snapshot doc store + summary
    cache); freed with the snapshot it hangs off."""

    __slots__ = ("_ptr", "_lib", "n_docs")

    def __init__(self, n_docs: int) -> None:
        self._lib = _load_lib()
        self._ptr = self._lib.fv_gen_new(n_docs)
        if not self._ptr:
            raise MemoryError("fv_gen_new failed")
        self.n_docs = n_docs

    def set_doc(self, doc_id: int, frag: bytes, text: bytes) -> None:
        self._lib.fv_gen_set(self._ptr, doc_id, frag, len(frag), text, len(text))

    def set_bulk(self, flags, frag_blob: bytes, frag_off,
                 text_blob: bytes, text_off) -> None:
        """Register all sidecar docs in one GIL-released call (flags bit0 =
        fragment, bit1 = text; only 3 == both registers, mirroring
        set_doc's text-present gate)."""
        flags = np.ascontiguousarray(flags, dtype=np.uint8)
        frag_off = np.ascontiguousarray(frag_off, dtype=np.int64)
        text_off = np.ascontiguousarray(text_off, dtype=np.int64)
        i64 = ctypes.POINTER(ctypes.c_int64)
        self._lib.fv_gen_set_bulk(
            self._ptr, min(self.n_docs, len(flags)),
            flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            frag_blob, frag_off.ctypes.data_as(i64),
            text_blob, text_off.ctypes.data_as(i64),
        )

    def count(self) -> int:
        return int(self._lib.fv_gen_count(self._ptr))

    def assemble(self, ids_row, scores_row, packed) -> bytes | None:
        """(top-K ids, scores, native_summary.pack_query output) -> response
        bytes, or None when the Python assembler must run instead."""
        ids = np.ascontiguousarray(ids_row, dtype=np.int32)
        scores = np.ascontiguousarray(scores_row, dtype=np.float32)
        k = int(ids.shape[0])
        qtoks, n_q, phtoks, ph_lens, n_ph = packed
        ids_p = ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        sc_p = scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        buf = _out_buf()
        for _ in range(4):
            n = self._lib.fv_assemble(
                self._ptr, ids_p, sc_p, k, qtoks, n_q, phtoks, ph_lens, n_ph,
                buf, len(buf),
            )
            if n >= 0:
                # NOT buf.raw[:n] — .raw materializes the whole buffer
                # (512 KB) before slicing, ~40 us per call
                return ctypes.string_at(buf, n)
            if n == -1:
                buf = _out_buf(len(buf) * 2)
                continue
            return None  # -2: unregistered doc -> Python path
        return None

    def assemble_batch(self, ids, scores, packed_rows) -> list[bytes | None] | None:
        """Assemble a whole ranked batch in ONE GIL-released call (the
        micro-batcher thread owns this; per-row assembly from ~128
        concurrent handler threads measured ~3.5x the CPU from context
        switch + cache thrash on the 1-core host). ids/scores are [R, K];
        packed_rows[r] is native_summary.pack_query output for row r.
        Returns a body per row (None where that row must take the Python
        fallback), or None when the whole call cannot run."""
        ids = np.ascontiguousarray(ids, dtype=np.int32)
        scores = np.ascontiguousarray(scores, dtype=np.float32)
        rows, k = ids.shape
        q_parts: list[bytes] = []
        ph_parts: list[bytes] = []
        q_off = np.zeros(rows + 1, np.int64)
        ph_off = np.zeros(rows + 1, np.int64)
        phl_off = np.zeros(rows + 1, np.int64)
        n_q = np.zeros(rows, np.int32)
        ph_lens_flat: list[int] = []
        for r, (qtoks, nq, phtoks, ph_lens, n_ph) in enumerate(packed_rows):
            q_parts.append(qtoks)
            ph_parts.append(phtoks)
            n_q[r] = nq
            ph_lens_flat.extend(ph_lens[i] for i in range(n_ph))
            q_off[r + 1] = q_off[r] + len(qtoks)
            ph_off[r + 1] = ph_off[r] + len(phtoks)
            phl_off[r + 1] = len(ph_lens_flat)
        q_blob = b"".join(q_parts)
        ph_blob = b"".join(ph_parts)
        phl = np.asarray(ph_lens_flat or [0], np.int32)
        out_lens = np.zeros(rows, np.int64)
        ids_p = ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        sc_p = scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        i64 = ctypes.POINTER(ctypes.c_int64)
        i32 = ctypes.POINTER(ctypes.c_int32)
        buf = _out_buf(max(1 << 22, rows * (1 << 16)))
        for _ in range(4):
            total = self._lib.fv_assemble_batch(
                self._ptr, ids_p, sc_p, rows, k,
                q_blob, q_off.ctypes.data_as(i64), n_q.ctypes.data_as(i32),
                ph_blob, ph_off.ctypes.data_as(i64),
                phl.ctypes.data_as(i32), phl_off.ctypes.data_as(i64),
                buf, len(buf), out_lens.ctypes.data_as(i64),
            )
            if total >= 0:
                break
            buf = _out_buf(len(buf) * 2)
        else:
            return None
        bodies: list[bytes | None] = []
        pos = 0
        # slice rows straight out of the ctypes buffer (one copy per row);
        # string_at would first copy the WHOLE multi-MB batch buffer
        mv = memoryview(buf)
        for r in range(rows):
            n = int(out_lens[r])
            if n < 0:
                bodies.append(None)
                continue
            bodies.append(bytes(mv[pos: pos + n]))
            pos += n
        return bodies

    def __del__(self) -> None:
        ptr, self._ptr = getattr(self, "_ptr", None), None
        if ptr:
            try:
                self._lib.fv_gen_free(ptr)
            except Exception:  # noqa: BLE001 — interpreter teardown
                pass
