"""ctypes bindings to the native hostcodec library (native/hostcodec.cpp).

Builds with `make -C native` on first use, and again whenever the stamp
beside the shared object does not match the sources, the Makefile and the
host's machine type (so a library built for another host is never
loaded).  Every entry point has a NumPy fallback, so the engine works
without a toolchain; a failed build says so with a warning.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
import warnings
from typing import Optional

import numpy as np

__all__ = ["available", "pack_bits", "unpack_bits", "count_set_bits",
           "decode_zigzag_longs", "encode_rows", "argsort_rows",
           "encode_varlen_rows", "decode_varlen_rows"]

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO = os.path.join(_NATIVE_DIR, "libhostcodec.so")
_STAMP = _SO + ".stamp"

_lib: Optional[ctypes.CDLL] = None
_tried = False
_load_lock = threading.Lock()


def _build_id() -> str:
    h = hashlib.sha256()
    for name in ("hostcodec.cpp", "Makefile"):
        with open(os.path.join(_NATIVE_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(platform.machine().encode())
    return h.hexdigest()


def _read_stamp() -> str:
    try:
        with open(_STAMP) as f:
            return f.read().strip()
    except OSError:
        return ""


def _ensure_built() -> bool:
    """Build the library unless its stamp matches; True when a library
    for this host and these sources is on disk.  A file lock serializes
    builds across processes (test workers start together)."""
    want = _build_id()
    if _read_stamp() == want and os.path.exists(_SO):
        return True
    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _read_stamp() == want and os.path.exists(_SO):
            return True
        try:
            os.remove(_STAMP)
        except FileNotFoundError:
            pass
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR, "-s", "-B"],
                           check=True, capture_output=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            err = getattr(e, "stderr", None) or b""
            warnings.warn(
                "native hostcodec build failed; using NumPy fallbacks: "
                f"{e} {err.decode(errors='replace')[-500:]}")
            return False
        tmp = f"{_STAMP}.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(want)
        os.replace(tmp, _STAMP)
        return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _load_lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _ensure_built():
            return None
        try:
            _lib = _bind(ctypes.CDLL(_SO))
        except OSError as e:
            warnings.warn(f"native hostcodec failed to load: {e}")
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    lib.pack_bits.argtypes = [u8p, i64, u8p]
    lib.unpack_bits.argtypes = [u8p, i64, u8p]
    lib.count_set_bits.argtypes = [u8p, i64]
    lib.count_set_bits.restype = i64
    lib.decode_zigzag_longs.argtypes = [
        u8p, i64, i64, i64, ctypes.POINTER(ctypes.c_int64)]
    lib.decode_zigzag_longs.restype = i64
    lib.encode_rows.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        u8p, u8p, i64, ctypes.c_int32, u8p]
    lib.argsort_rows.argtypes = [u8p, i64, i64,
                                 ctypes.POINTER(ctypes.c_uint32)]
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8 = ctypes.c_uint8
    lib.encode_varlen_rows.argtypes = [i32p, u8p, u8p, i64,
                                       ctypes.c_int32, u8, u8, u8p]
    lib.decode_varlen_rows.argtypes = [u8p, i64, i64, i64,
                                       ctypes.c_int32, u8, u8,
                                       i32p, u8p, u8p]
    lib.decode_varlen_rows.restype = i64
    u64 = ctypes.c_uint64
    u64p = ctypes.POINTER(u64)
    lib.xxhash64.argtypes = [u8p, i64, u64]
    lib.xxhash64.restype = u64
    lib.xxhash64_fixed.argtypes = [u8p, i64, i64, u64, u64p]
    lib.xxhash64_varlen.argtypes = [i32p, u8p, i64, u64, u64p]
    lib.sbbf_insert.argtypes = [u8p, i64, u64p, i64]
    lib.sbbf_check.argtypes = [u8p, i64, u64p, i64, u8p]
    lib.xxhash32.argtypes = [u8p, i64, ctypes.c_uint32]
    lib.xxhash32.restype = ctypes.c_uint32
    lib.lz4_frame_compress.argtypes = [u8p, i64, u8p, i64]
    lib.lz4_frame_compress.restype = i64
    lib.lz4_frame_decompress.argtypes = [u8p, i64, u8p, i64]
    lib.lz4_frame_decompress.restype = i64
    return lib


def available() -> bool:
    return _load() is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def pack_bits(mask: np.ndarray) -> np.ndarray:
    mask = np.ascontiguousarray(mask, np.uint8)
    lib = _load()
    if lib is None:
        return np.packbits(mask.view(bool), bitorder="little")
    out = np.zeros((len(mask) + 7) // 8, np.uint8)
    lib.pack_bits(_u8(mask), len(mask), _u8(out))
    return out


def unpack_bits(bits: np.ndarray, n: int) -> np.ndarray:
    bits = np.ascontiguousarray(bits, np.uint8)
    lib = _load()
    if lib is None:
        return np.unpackbits(bits, count=n, bitorder="little").astype(bool)
    out = np.zeros(n, np.uint8)
    lib.unpack_bits(_u8(bits), n, _u8(out))
    return out.view(bool)


def count_set_bits(bits: np.ndarray, n: int) -> int:
    bits = np.ascontiguousarray(bits, np.uint8)
    lib = _load()
    if lib is None:
        return int(np.unpackbits(bits, count=n, bitorder="little").sum())
    return int(lib.count_set_bits(_u8(bits), n))


def decode_zigzag_longs(data: bytes, pos: int, count: int):
    """-> (values int64[count], new_pos); the avro hot loop."""
    lib = _load()
    if lib is None:
        out = np.zeros(count, np.int64)
        for k in range(count):
            shift = acc = 0
            while True:
                b = data[pos]
                pos += 1
                acc |= (b & 0x7F) << shift
                if not (b & 0x80):
                    break
                shift += 7
            out[k] = (acc >> 1) ^ -(acc & 1)
        return out, pos
    arr = np.frombuffer(data, np.uint8)
    out = np.zeros(count, np.int64)
    new_pos = lib.decode_zigzag_longs(
        _u8(arr), len(arr), pos, count,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if new_pos < 0:
        raise ValueError("truncated avro varint data")
    return out, int(new_pos)


def encode_rows(keys, valids, desc, nulls_first) -> np.ndarray:
    """keys: list of uint64[n]; valids: list of bool[n] or None.
    -> uint8[n, ncols*9] memcmp-comparable rows."""
    ncols = len(keys)
    n = len(keys[0])
    keys = [np.ascontiguousarray(k, np.uint64) for k in keys]
    valids_np = [None if v is None else np.ascontiguousarray(v, np.uint8)
                 for v in valids]
    lib = _load()
    out = np.zeros((n, ncols * 9), np.uint8)
    if lib is None:
        for c in range(ncols):
            k = keys[c].copy()
            ok = np.ones(n, bool) if valids_np[c] is None \
                else valids_np[c].view(bool)
            if desc[c]:
                k = ~k
            k[~ok] = 0
            tag = np.where(ok, 0x01, 0x00 if nulls_first[c] else 0xFF)
            out[:, c * 9] = tag
            out[:, c * 9 + 1: c * 9 + 9] = \
                k[:, None].view(np.uint8).reshape(n, 8)[:, ::-1]
        return out
    key_ptrs = (ctypes.c_void_p * ncols)(
        *[k.ctypes.data for k in keys])
    valid_ptrs = (ctypes.c_void_p * ncols)(
        *[0 if v is None else v.ctypes.data for v in valids_np])
    desc_a = np.ascontiguousarray(desc, np.uint8)
    nf_a = np.ascontiguousarray(nulls_first, np.uint8)
    lib.encode_rows(key_ptrs, valid_ptrs, _u8(desc_a), _u8(nf_a), n,
                    ncols, _u8(out))
    return out


def argsort_rows(rows: np.ndarray) -> np.ndarray:
    rows = np.ascontiguousarray(rows, np.uint8)
    n, width = rows.shape
    lib = _load()
    if lib is None:
        view = rows.view([("b", np.uint8, width)]).ravel()
        return np.argsort(view, kind="stable").astype(np.uint32)
    out = np.zeros(n, np.uint32)
    lib.argsort_rows(_u8(rows), n, width,
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out


def encode_varlen_rows(offsets: np.ndarray, data: np.ndarray,
                       valid, nblocks: int, descending: bool,
                       nulls_first: bool) -> np.ndarray:
    """Variable-length row encoding (arrow-row variable.rs:28-100):
    0x02 + 32-byte blocks with continuation tokens, padded to a fixed
    width of 1 + 33*nblocks so the result stays a memcmp matrix."""
    offsets = np.ascontiguousarray(offsets, np.int32)
    data = np.ascontiguousarray(data, np.uint8)
    n = len(offsets) - 1
    width = 1 + 33 * nblocks
    out = np.zeros((n, width), np.uint8)
    lib = _load()
    if lib is not None:
        v = None if valid is None else np.ascontiguousarray(valid, np.uint8)
        lib.encode_varlen_rows(
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            _u8(data), None if v is None else _u8(v), n, nblocks,
            1 if descending else 0, 1 if nulls_first else 0, _u8(out))
        return out
    # numpy fallback (slow; parity only)
    for i in range(n):
        ok = valid is None or bool(valid[i])
        row = out[i]
        if descending:
            row[:] = 0xFF
        if not ok:
            row[0] = 0x00 if nulls_first else 0xFF
            continue
        s, e = int(offsets[i]), int(offsets[i + 1])
        chunkv = data[s:e]

        def f(x):
            return (~np.asarray(x, np.uint8)) if descending \
                else np.asarray(x, np.uint8)
        if e == s:
            row[0] = f(0x01)
            continue
        row[0] = f(0x02)
        p = 1
        done = 0
        ln = e - s
        while done < ln:
            c = min(32, ln - done)
            row[p:p + c] = f(chunkv[done:done + c])
            row[p + c:p + 32] = f(np.zeros(32 - c, np.uint8))
            last = done + c >= ln
            row[p + 32] = f(c + 1 if last else 0xFF)
            p += 33
            done += c
    return out


def decode_varlen_rows(rows: np.ndarray, cell_offset: int, nblocks: int,
                       descending: bool, nulls_first: bool):
    """Inverse of encode_varlen_rows -> (offsets i32, data u8, valid u8)."""
    rows = np.ascontiguousarray(rows, np.uint8)
    n, stride = rows.shape
    out_offsets = np.zeros(n + 1, np.int32)
    out_data = np.zeros(max(n * 32 * nblocks, 1), np.uint8)
    out_valid = np.zeros(n, np.uint8)
    lib = _load()
    if lib is None:
        raise RuntimeError("decode_varlen_rows requires the native lib")
    total = lib.decode_varlen_rows(
        _u8(rows), n, stride, cell_offset, nblocks,
        1 if descending else 0, 1 if nulls_first else 0,
        out_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _u8(out_data), _u8(out_valid))
    return out_offsets, out_data[:total], out_valid


def lz4_frame_compress(data: bytes) -> bytes:
    """LZ4 frame (single frame; Arrow IPC LZ4_FRAME buffer codec)."""
    lib = _load()
    if lib is None:
        raise NotImplementedError("lz4 requires the native hostcodec")
    src = np.frombuffer(data, np.uint8)
    cap = len(data) + len(data) // 200 + 64
    out = np.zeros(cap, np.uint8)
    n = lib.lz4_frame_compress(_u8(src), len(src), _u8(out), cap)
    if n < 0:
        raise ValueError("lz4 frame compression overflow")
    return out[:n].tobytes()


def lz4_frame_decompress(data: bytes, uncompressed_len: int) -> bytes:
    lib = _load()
    if lib is None:
        raise NotImplementedError("lz4 requires the native hostcodec")
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(max(uncompressed_len, 1), np.uint8)
    n = lib.lz4_frame_decompress(_u8(src), len(src), _u8(out),
                                 uncompressed_len)
    if n != uncompressed_len:
        raise ValueError(
            f"lz4 frame decompressed to {n}, expected {uncompressed_len}")
    return out[:uncompressed_len].tobytes()


def _bind_parquet(lib):
    if getattr(lib, "_pq_bound", False):
        return
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.rle_bp_decode.argtypes = [u8p, i64, ctypes.c_int32, i64, u32p]
    lib.rle_bp_decode.restype = i64
    lib.rle_bp_encode.argtypes = [u32p, i64, ctypes.c_int32, u8p, i64]
    lib.rle_bp_encode.restype = i64
    lib.plain_byte_array_decode.argtypes = [u8p, i64, i64, i32p, u8p, i64]
    lib.plain_byte_array_decode.restype = i64
    lib.delta_binary_packed_decode.argtypes = [u8p, i64, i64, i64p]
    lib.delta_binary_packed_decode.restype = i64
    lib.delta_byte_array_build.argtypes = [i64p, i64p, u8p, i64, i64,
                                           i32p, u8p, i64]
    lib.delta_byte_array_build.restype = i64
    lib.snappy_decompress.argtypes = [u8p, i64, u8p, i64]
    lib.snappy_decompress.restype = i64
    lib.snappy_compress.argtypes = [u8p, i64, u8p, i64]
    lib.snappy_compress.restype = i64
    lib._pq_bound = True


def _req_lib():
    lib = _load()
    if lib is None:
        raise NotImplementedError("native hostcodec unavailable")
    _bind_parquet(lib)
    return lib


def rle_bp_decode(data: bytes, bit_width: int, count: int) -> np.ndarray:
    """RLE/bit-packed hybrid -> uint32[count] (parquet encodings/rle.rs)."""
    lib = _req_lib()
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(count, np.uint32)
    consumed = lib.rle_bp_decode(
        _u8(src), len(src), bit_width, count,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    if consumed < 0:
        raise ValueError("malformed RLE/bit-packed data")
    return out


def rle_bp_encode(vals: np.ndarray, bit_width: int) -> bytes:
    lib = _req_lib()
    vals = np.ascontiguousarray(vals, np.uint32)
    cap = len(vals) * ((bit_width + 7) // 8 + 1) + 64
    out = np.zeros(cap, np.uint8)
    n = lib.rle_bp_encode(
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(vals), bit_width, _u8(out), cap)
    if n < 0:
        raise ValueError("rle encode overflow")
    return out[:n].tobytes()


def plain_byte_array_decode(data: bytes, count: int):
    """u32-length-prefixed byte arrays -> (int32 offsets[count+1], u8 data)."""
    lib = _req_lib()
    src = np.frombuffer(data, np.uint8)
    offsets = np.zeros(count + 1, np.int32)
    out = np.zeros(max(len(src), 1), np.uint8)
    total = lib.plain_byte_array_decode(
        _u8(src), len(src), count,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _u8(out), len(out))
    if total < 0:
        raise ValueError("malformed PLAIN byte-array page")
    return offsets, out[:total]


def delta_binary_packed_decode(data: bytes, count: int):
    """-> (int64 values[count], bytes consumed)."""
    lib = _req_lib()
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(max(count, 1), np.int64)
    consumed = lib.delta_binary_packed_decode(
        _u8(src), len(src), count,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if consumed < 0:
        raise ValueError("malformed DELTA_BINARY_PACKED page")
    return out[:count], int(consumed)


def delta_byte_array_build(prefix_lens: np.ndarray, suffix_lens: np.ndarray,
                           suffixes: bytes):
    """-> (int32 offsets, u8 data) from incremental-encoded strings."""
    lib = _req_lib()
    count = len(prefix_lens)
    pl = np.ascontiguousarray(prefix_lens, np.int64)
    sl = np.ascontiguousarray(suffix_lens, np.int64)
    suf = np.frombuffer(suffixes, np.uint8)
    cap = int(pl.sum() + sl.sum()) + 1
    offsets = np.zeros(count + 1, np.int32)
    data = np.zeros(cap, np.uint8)
    total = lib.delta_byte_array_build(
        pl.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sl.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _u8(suf), len(suf), count,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _u8(data), cap)
    if total < 0:
        raise ValueError("malformed DELTA_BYTE_ARRAY page")
    return offsets, data[:total]


def snappy_decompress(data: bytes, uncompressed_len: int) -> np.ndarray:
    """-> uint8 ndarray view (buffer-protocol compatible with every
    consumer; skipping the bytes() copy saves a full output pass)."""
    lib = _req_lib()
    src = np.frombuffer(data, np.uint8)
    # 16B slack enables the C side's 8/16-byte chunked copy loops
    out = np.empty(max(uncompressed_len, 1) + 16, np.uint8)
    n = lib.snappy_decompress(_u8(src), len(src), _u8(out),
                              uncompressed_len + 16)
    if n != uncompressed_len:
        raise ValueError(
            f"snappy decompressed to {n}, expected {uncompressed_len}")
    return out[:uncompressed_len]


def snappy_compress(data: bytes) -> bytes:
    lib = _req_lib()
    src = np.frombuffer(data, np.uint8)
    cap = len(data) + len(data) // 4 + 64
    out = np.empty(cap, np.uint8)
    n = lib.snappy_compress(_u8(src), len(src), _u8(out), cap)
    return out[:n].tobytes()


def _bind_strings(lib):
    if getattr(lib, "_str_bound", False):
        return
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.intern_varlen.argtypes = [i64p, u8p, i64, i32p, i64p]
    lib.intern_varlen.restype = i64
    lib.bytes_match.argtypes = [i64p, u8p, i64, u8p, i64,
                                ctypes.c_int32, ctypes.c_uint8, u8p]
    lib.ascii_case.argtypes = [u8p, i64, ctypes.c_int32, u8p]
    lib.ascii_case.restype = i64
    lib.utf8_substring.argtypes = [i64p, u8p, i64, i64, i64, i64p, u8p]
    lib.utf8_substring.restype = i64
    lib.utf8_char_lengths.argtypes = [i64p, u8p, i64, i64p]
    lib._str_bound = True


def _str_lib():
    lib = _load()
    if lib is None:
        return None
    _bind_strings(lib)
    return lib


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def intern_varlen(offsets: np.ndarray, data: np.ndarray):
    """Hash-intern byte strings -> (codes i32, first-occurrence row idx).
    (generic_bytes_dictionary_builder.rs role, O(n) native)."""
    lib = _str_lib()
    offsets = np.ascontiguousarray(offsets, np.int64)
    data = np.ascontiguousarray(data, np.uint8)
    n = len(offsets) - 1
    if lib is None:
        # numpy fallback: object-array unique
        vals = np.array([data[offsets[i]:offsets[i + 1]].tobytes()
                         for i in range(n)], dtype=object)
        uniq, first, inv = np.unique(vals, return_index=True,
                                     return_inverse=True)
        # np.unique sorts; convert to first-occurrence order
        order = np.argsort(first, kind="stable")
        remap = np.empty(len(uniq), np.int32)
        remap[order] = np.arange(len(uniq), dtype=np.int32)
        return remap[inv], first[order].astype(np.int64)
    codes = np.zeros(max(n, 1), np.int32)
    uniq_idx = np.zeros(max(n, 1), np.int64)
    n_uniq = lib.intern_varlen(_i64p(offsets), _u8(data), n,
                               codes.ctypes.data_as(
                                   ctypes.POINTER(ctypes.c_int32)),
                               _i64p(uniq_idx))
    return codes[:n], uniq_idx[:n_uniq]


MATCH_LIKE, MATCH_STARTS, MATCH_ENDS, MATCH_CONTAINS, MATCH_EQ = range(5)


def bytes_match(offsets: np.ndarray, data: np.ndarray, pattern: bytes,
                op: int, case_insensitive: bool = False) -> np.ndarray:
    """O(n) native matcher (predicate.rs:28 fast paths + like.rs)."""
    lib = _str_lib()
    offsets = np.ascontiguousarray(offsets, np.int64)
    data = np.ascontiguousarray(data, np.uint8)
    n = len(offsets) - 1
    if lib is None:
        raise NotImplementedError("native matcher requires hostcodec")
    pat = np.frombuffer(pattern, np.uint8)
    out = np.zeros(max(n, 1), np.uint8)
    lib.bytes_match(_i64p(offsets), _u8(data), n, _u8(pat), len(pat),
                    op, 1 if case_insensitive else 0, _u8(out))
    return out[:n].view(bool)


def bytes_cmp_scalar(offsets: np.ndarray, data: np.ndarray,
                     pattern: bytes) -> np.ndarray:
    """Per-value lexicographic compare vs one scalar -> int8 -1/0/1."""
    lib = _str_lib()
    offsets = np.ascontiguousarray(offsets, np.int64)
    data = np.ascontiguousarray(data, np.uint8)
    n = len(offsets) - 1
    if lib is None:
        raise NotImplementedError("native compare requires hostcodec")
    if not getattr(lib, "_bcs_bound", False):
        lib.bytes_cmp_scalar.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int8)]
        lib._bcs_bound = True
    pat = np.frombuffer(pattern, np.uint8)
    out = np.zeros(max(n, 1), np.int8)
    lib.bytes_cmp_scalar(_i64p(offsets), _u8(data), n, _u8(pat),
                         len(pat),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    return out[:n]


def ascii_case(data: np.ndarray, to_upper: bool):
    """-> (transformed bytes, was_pure_ascii)."""
    lib = _str_lib()
    data = np.ascontiguousarray(data, np.uint8)
    if lib is None:
        return None, False
    out = np.zeros(max(len(data), 1), np.uint8)
    ok = lib.ascii_case(_u8(data), len(data), 1 if to_upper else 0,
                        _u8(out))
    return out[:len(data)], bool(ok)


def utf8_substring(offsets: np.ndarray, data: np.ndarray, start: int,
                   length: int):
    """Character-based substring -> (new offsets i64, new data)."""
    lib = _str_lib()
    if lib is None:
        raise NotImplementedError("native substring requires hostcodec")
    offsets = np.ascontiguousarray(offsets, np.int64)
    data = np.ascontiguousarray(data, np.uint8)
    n = len(offsets) - 1
    out_offs = np.zeros(n + 1, np.int64)
    out_data = np.zeros(max(len(data), 1), np.uint8)
    total = lib.utf8_substring(_i64p(offsets), _u8(data), n, start,
                               -1 if length is None else length,
                               _i64p(out_offs), _u8(out_data))
    return out_offs, out_data[:total]


def utf8_char_lengths(offsets: np.ndarray, data: np.ndarray) -> np.ndarray:
    lib = _str_lib()
    offsets = np.ascontiguousarray(offsets, np.int64)
    data = np.ascontiguousarray(data, np.uint8)
    n = len(offsets) - 1
    if lib is None:
        lens = np.diff(offsets)
        raise NotImplementedError("native char lengths requires hostcodec")
    out = np.zeros(max(n, 1), np.int64)
    lib.utf8_char_lengths(_i64p(offsets), _u8(data), n, _i64p(out))
    return out[:n]


def argsort_varlen(offsets: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Lexicographic argsort of byte strings -> uint32 order."""
    lib = _str_lib()
    offsets = np.ascontiguousarray(offsets, np.int64)
    data = np.ascontiguousarray(data, np.uint8)
    n = len(offsets) - 1
    if lib is None:
        vals = np.array([data[offsets[i]:offsets[i + 1]].tobytes()
                         for i in range(n)], dtype=object)
        return np.argsort(vals, kind="stable").astype(np.uint32)
    if not getattr(lib, "_vs_bound", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.argsort_varlen.argtypes = [i64p, u8p, ctypes.c_int64,
                                       ctypes.POINTER(ctypes.c_uint32)]
        lib.gather_varlen.argtypes = [i64p, u8p, i64p, ctypes.c_int64,
                                      i64p, u8p]
        lib.gather_varlen.restype = ctypes.c_int64
        lib._vs_bound = True
    out = np.zeros(max(n, 1), np.uint32)
    lib.argsort_varlen(_i64p(offsets), _u8(data), n,
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out[:n]


_REGEX_CACHE: dict = {}          # (pattern, ci) -> handle (0 = unsupported)


def _bind_regex(lib):
    if getattr(lib, "_rex_bound", False):
        return
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.regex_compile.argtypes = [u8p, ctypes.c_int64, ctypes.c_int32]
    lib.regex_compile.restype = ctypes.c_void_p
    lib.regex_free.argtypes = [ctypes.c_void_p]
    lib.regex_match_batch.argtypes = [ctypes.c_void_p, i64p, u8p,
                                      ctypes.c_int64, u8p]
    lib._rex_bound = True


def regex_compile(pattern: str, case_insensitive: bool = False):
    """Compile an ASCII pattern into the native NFA/lazy-DFA engine
    (hostcodec.cpp rex::). Returns an opaque handle, or None when the
    pattern uses unsupported constructs (caller falls back to `re`)."""
    key = (pattern, bool(case_insensitive))
    h = _REGEX_CACHE.get(key)
    if h is not None:
        return h or None
    lib = _str_lib()
    if lib is None:
        return None
    _bind_regex(lib)
    pat = np.frombuffer(pattern.encode() or b"\0", np.uint8)
    h = lib.regex_compile(_u8(pat), len(pattern.encode()),
                          1 if case_insensitive else 0)
    if len(_REGEX_CACHE) >= 256:         # bounded: free the oldest half
        for k in list(_REGEX_CACHE)[:128]:
            old = _REGEX_CACHE.pop(k)
            if old:
                lib.regex_free(old)
    _REGEX_CACHE[key] = h or 0
    return h or None


def regex_match(handle, offsets: np.ndarray, data: np.ndarray
                ) -> np.ndarray:
    """One DFA pass over all values -> bool hits."""
    lib = _str_lib()
    _bind_regex(lib)
    offsets = np.ascontiguousarray(offsets, np.int64)
    data = np.ascontiguousarray(data, np.uint8)
    n = len(offsets) - 1
    out = np.zeros(max(n, 1), np.uint8)
    lib.regex_match_batch(handle, _i64p(offsets), _u8(data), n,
                          _u8(out))
    return out[:n].view(bool)


def gather_ranges(src: np.ndarray, starts: np.ndarray,
                  lens: np.ndarray, out_offs: np.ndarray,
                  out: np.ndarray) -> None:
    """memcpy each (start, len) byte range of src to out[out_offs[i]:]."""
    lib = _req_lib()
    if not getattr(lib, "_gr_bound", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.gather_ranges.argtypes = [u8p, i64p, i64p, i64p,
                                      ctypes.c_int64, u8p]
        lib.gather_ranges.restype = None
        lib._gr_bound = True
    lib.gather_ranges(_u8(src), _i64p(np.ascontiguousarray(starts)),
                      _i64p(np.ascontiguousarray(lens)),
                      _i64p(np.ascontiguousarray(out_offs)),
                      len(starts), _u8(out))


def gather_varlen(offsets: np.ndarray, data: np.ndarray,
                  idx: np.ndarray):
    """Byte-string gather -> (offsets i64, data u8)."""
    lib = _str_lib()
    offsets = np.ascontiguousarray(offsets, np.int64)
    data = np.ascontiguousarray(data, np.uint8)
    idx = np.ascontiguousarray(idx, np.int64)
    n = len(idx)
    if lib is None:
        parts = [data[offsets[j]:offsets[j + 1]] for j in idx]
        lens = np.array([len(p) for p in parts], np.int64)
        oo = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=oo[1:])
        return oo, (np.concatenate(parts) if parts
                    else np.zeros(0, np.uint8))
    argsort_varlen(np.zeros(1, np.int64), np.zeros(0, np.uint8))  # bind
    lens = offsets[1:] - offsets[:-1]
    cap = int(lens[idx].sum()) if n else 0
    oo = np.zeros(n + 1, np.int64)
    od = np.zeros(max(cap, 1), np.uint8)
    lib.gather_varlen(_i64p(offsets), _u8(data), _i64p(idx), n,
                      _i64p(oo), _u8(od))
    return oo, od[:cap]


def _bind_csv(lib):
    if getattr(lib, "_csv_bound", False):
        return
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.csv_index.argtypes = [u8p, i64, ctypes.c_uint8, ctypes.c_uint8,
                              i64p, i64p, u8p, i64, i64p, i64p]
    lib.csv_index.restype = i64
    lib.csv_extract.argtypes = [u8p, i64p, i64p, u8p, i64,
                                ctypes.c_uint8, i64p, u8p]
    lib.csv_extract.restype = i64
    lib.csv_format_i64.argtypes = [i64p, i64, i64, u8p]
    lib.csv_format_i64.restype = None
    lib.json_join_rows.argtypes = [i64, ctypes.POINTER(ctypes.c_void_p),
                                   i64p, i64, u8p]
    lib.json_join_rows.restype = i64
    lib.csv_format_timestamp.argtypes = [i64p, i64, i64, i64, i64, u8p]
    lib.csv_format_timestamp.restype = None
    lib.csv_join_rows.argtypes = [i64, ctypes.POINTER(ctypes.c_void_p),
                                  i64p, i64, ctypes.c_uint8, u8p]
    lib.csv_join_rows.restype = i64
    lib.csv_parse_i64.argtypes = [u8p, i64p, i64p, i64, i64p, u8p]
    lib.csv_parse_i64.restype = i64
    lib.csv_parse_f64.argtypes = [u8p, i64p, i64p, i64, f64p, u8p]
    lib.csv_parse_f64.restype = i64
    lib.csv_parse_bool.argtypes = [u8p, i64p, i64p, i64, u8p, u8p]
    lib.csv_parse_bool.restype = i64
    lib.csv_parse_timestamp.argtypes = [u8p, i64p, i64p, i64, i64,
                                        ctypes.c_int32, i64p, u8p]
    lib.csv_parse_timestamp.restype = i64
    lib.csv_count_seps.argtypes = [u8p, i64, ctypes.c_uint8]
    lib.csv_count_seps.restype = i64
    lib._csv_bound = True


def csv_lib():
    lib = _load()
    if lib is None:
        raise NotImplementedError("native CSV engine requires hostcodec")
    _bind_csv(lib)
    return lib


def _bind_json(lib):
    if getattr(lib, "_json_bound", False):
        return
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.json_tape.argtypes = [u8p, i64, u8p, i64p, i64p, u8p, i64]
    lib.json_tape.restype = i64
    lib.json_unescape.argtypes = [u8p, i64p, i64p, u8p, i64, i64p, u8p]
    lib.json_unescape.restype = i64
    lib._json_bound = True


def json_lib():
    lib = _load()
    if lib is None:
        raise NotImplementedError("native JSON engine requires hostcodec")
    _bind_json(lib)
    return lib


def json_tape(data: bytes):
    """-> (types u8, starts i64, ends i64, escs u8) token tape."""
    lib = json_lib()
    src = np.frombuffer(data, np.uint8)
    cap = max(len(data) // 2 + 16, 64)
    while True:
        types = np.zeros(cap, np.uint8)
        starts = np.zeros(cap, np.int64)
        ends = np.zeros(cap, np.int64)
        escs = np.zeros(cap, np.uint8)
        nt = lib.json_tape(_u8(src), len(src), _u8(types), _i64p(starts),
                           _i64p(ends), _u8(escs), cap)
        if nt == -1:
            cap *= 2
            continue
        if nt == -2:
            raise ValueError("malformed JSON")
        return (types[:nt], starts[:nt], ends[:nt], escs[:nt])


def json_unescape(data: np.ndarray, starts, ends, escs):
    """-> (offsets i64, bytes u8) unescaped strings."""
    lib = json_lib()
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    escs = np.ascontiguousarray(escs, np.uint8)
    n = len(starts)
    cap = int((ends - starts).sum()) + 4 * max(n, 1)
    offs = np.zeros(n + 1, np.int64)
    out = np.zeros(max(cap, 1), np.uint8)
    total = lib.json_unescape(_u8(data), _i64p(starts), _i64p(ends),
                              _u8(escs), n, _i64p(offs), _u8(out))
    if total < 0:
        raise ValueError("malformed JSON string escape")
    return offs, out[:total]


def plain_byte_array_encode(offsets: np.ndarray, data: np.ndarray
                            ) -> bytes:
    """(offsets, data) -> u32-length-prefixed PLAIN byte-array stream."""
    lib = _req_lib()
    if not getattr(lib, "_pbae_bound", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.plain_byte_array_encode.argtypes = [
            ctypes.POINTER(ctypes.c_int64), u8p, ctypes.c_int64, u8p,
            ctypes.c_int64]
        lib.plain_byte_array_encode.restype = ctypes.c_int64
        lib._pbae_bound = True
    offsets = np.ascontiguousarray(offsets, np.int64)
    data = np.ascontiguousarray(data, np.uint8)
    n = len(offsets) - 1
    cap = int(offsets[-1]) + 4 * n + 8
    out = np.zeros(max(cap, 1), np.uint8)
    sz = lib.plain_byte_array_encode(_i64p(offsets), _u8(data), n,
                                     _u8(out), cap)
    if sz < 0:
        raise ValueError("byte-array encode overflow")
    return out[:sz].tobytes()


def _bind_avro(lib):
    if getattr(lib, "_avro_bound", False):
        return
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    vpp = ctypes.POINTER(ctypes.c_void_p)
    lib.avro_decode_block.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, u8p, i32p, i32p, i32p,
        i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i64p, i64p, vpp, vpp]
    lib.avro_decode_block.restype = ctypes.c_int64
    lib._avro_bound = True


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def avro_decode_block(payload: bytes, row_count: int, prog, fill: bool,
                      vals=None, lens=None):
    """One pass of the native Avro columnar block decoder
    (hostcodec.cpp avro_decode_block).  prog = (kind u8[], extra i32[],
    cstart i32[], ccount i32[], cidx i32[], root).  fill=False measures
    per-node occurrence/byte counts; fill=True writes into the
    caller-allocated numpy buffers in `vals`/`lens`.  Returns
    (consumed_bytes, occ i64[n_nodes], nbytes i64[n_nodes]) or None when
    the native lib is unavailable; consumed_bytes < 0 = malformed."""
    lib = _load()
    if lib is None:
        return None
    _bind_avro(lib)
    kind, extra, cstart, ccount, cidx, root = prog
    n_nodes = len(kind)
    data = np.frombuffer(payload, np.uint8)
    occ = np.zeros(n_nodes, np.int64)
    nb = np.zeros(n_nodes, np.int64)
    valp = (ctypes.c_void_p * n_nodes)()
    lenp = (ctypes.c_void_p * n_nodes)()
    if fill:
        for i in range(n_nodes):
            if vals[i] is not None:
                valp[i] = vals[i].ctypes.data
            if lens[i] is not None:
                lenp[i] = lens[i].ctypes.data
    pos = lib.avro_decode_block(
        _u8(data), len(data), row_count, _u8(kind), _i32p(extra),
        _i32p(cstart), _i32p(ccount), _i32p(cidx), n_nodes, root,
        1 if fill else 0, _i64p(occ), _i64p(nb), valp, lenp)
    return int(pos), occ, nb
