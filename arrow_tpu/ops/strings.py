"""String kernels via dictionary late-materialization.

The reference operates directly on UTF-8 buffers with specialized predicate
fast paths (arrow-string/src/{like.rs,predicate.rs}); its own hot paths
late-materialize dictionaries (arrow-ord/src/cmp.rs:387).  The device design
takes that idea to its conclusion: variable-width data dictionary-encodes at
ingest, string *predicates* evaluate once per distinct value (host, tiny),
and the result broadcasts to all rows through a device gather by code —
O(cardinality) string work + O(n) device work, instead of the reference's
O(n) string work.

Device-side kernels that don't need value inspection (octet_length,
character length via continuation-byte popcount) run directly on the
byte/offset tensors.
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional

import jax.numpy as jnp
import numpy as np

from .. import dtypes as dt
from ..core import validity as vd
from ..core.column import (Column, DictionaryColumn, PrimitiveColumn,
                           StringColumn)
from ..core.datum import Datum, Scalar, as_datum
from ..errors import ArrowNotImplementedError, ArrowTypeError
from ..utils import native as nt

__all__ = [
    "dictionary_encode", "dictionary_decode", "compare",
    "like", "ilike", "nlike", "nilike",
    "starts_with", "ends_with", "contains",
    "regexp_is_match", "regexp_match", "substring", "length",
    "octet_length", "bit_length",
    "upper", "lower", "concat_elements",
]


# ---- encoding ----------------------------------------------------------------

def dictionary_encode(col: Column, code_dtype=jnp.int32,
                      ordered: bool = False) -> DictionaryColumn:
    """StringColumn -> DictionaryColumn with sorted-unique values.

    Native O(n) hash interning (hostcodec intern_varlen, the
    generic_bytes_dictionary_builder.rs role) + an O(u log u) sort of the
    distinct values only, so codes double as ranks for the sort/groupby
    dict-rank keys.  No per-row Python.

    ordered=True marks the result's dtype ordered (the arrow-schema
    Dictionary ordered bool) — truthful here because values are always
    emitted value-sorted; downstream sorts then skip even the host
    rank-verification pass (row_format.key_parts)."""
    if isinstance(col, DictionaryColumn):
        return col
    if not isinstance(col, StringColumn):
        raise ArrowTypeError(f"dictionary_encode of {type(col)}")
    offs = np.asarray(col.offsets).astype(np.int64)
    data = np.asarray(col.data)
    codes, uniq_idx = nt.intern_varlen(offs, data)
    u = len(uniq_idx)
    # sort the DISTINCT values natively, remap codes to ranks
    uoffs, udata = nt.gather_varlen(offs, data, uniq_idx)
    order = nt.argsort_varlen(uoffs, udata).astype(np.int64)
    remap = np.empty(max(u, 1), np.int32)
    remap[order] = np.arange(u, dtype=np.int32)
    codes = remap[codes] if u else codes
    new_offs, new_data = nt.gather_varlen(uoffs, udata, order)
    values = StringColumn(jnp.asarray(new_offs.astype(np.int32)),
                          jnp.asarray(new_data), col.dtype)
    codes = jnp.asarray(codes.astype(np.dtype(code_dtype)))
    return DictionaryColumn(codes, values, col.validity,
                            _canonical=col.validity is None,
                            ordered=ordered)


def dictionary_decode(col: DictionaryColumn) -> StringColumn:
    """Materialize codes back to a StringColumn (take on the values)."""
    from .take import take
    idx = PrimitiveColumn(col.codes, dt.int32, col.validity)
    out = take(col.values, idx)
    assert isinstance(out, StringColumn)
    return out


def _dict_values_host(col: DictionaryColumn) -> List[Optional[str]]:
    v = col.values
    if isinstance(v, StringColumn):
        return v.to_pylist_host()
    raise ArrowNotImplementedError("non-string dictionary predicate")


def _as_dict(col: Column) -> DictionaryColumn:
    if isinstance(col, DictionaryColumn):
        return col
    return dictionary_encode(col)


def _scalar_str(x) -> Optional[str]:
    if isinstance(x, Scalar):
        if not x.valid:
            return None
        raise ArrowTypeError("string scalar must be python str")
    if isinstance(x, bytes):
        return x.decode()
    return x


# ---- comparisons ---------------------------------------------------------------

_CMP_FN = {
    "eq": lambda a, b: a == b, "neq": lambda a, b: a != b,
    "lt": lambda a, b: a < b, "lt_eq": lambda a, b: a <= b,
    "gt": lambda a, b: a > b, "gt_eq": lambda a, b: a >= b,
}


def compare(op: str, lhs, rhs) -> PrimitiveColumn:
    """Dictionary-aware comparison dispatch (called from ops.cmp)."""
    lhs_is_col = isinstance(lhs, Column)
    rhs_is_col = isinstance(rhs, Column)
    if lhs_is_col and not rhs_is_col:
        return _compare_scalar(op, lhs, rhs)
    if rhs_is_col and not lhs_is_col:
        flip = {"lt": "gt", "gt": "lt", "lt_eq": "gt_eq", "gt_eq": "lt_eq",
                "eq": "eq", "neq": "neq"}
        return _compare_scalar(flip[op], rhs, lhs)
    return _compare_cols(op, lhs, rhs)


_CMP_FROM_SIGN = {
    "eq": lambda c: c == 0, "neq": lambda c: c != 0,
    "lt": lambda c: c < 0, "lt_eq": lambda c: c <= 0,
    "gt": lambda c: c > 0, "gt_eq": lambda c: c >= 0,
}


def _compare_scalar(op: str, col: Column, scalar_val) -> PrimitiveColumn:
    s = _scalar_str(scalar_val)
    if s is None:
        n = len(col)
        return PrimitiveColumn(jnp.zeros((n,), jnp.bool_), dt.bool_,
                               jnp.zeros((n,), jnp.bool_))
    # direct StringColumn: one native byte-compare pass, O(n)
    if isinstance(col, StringColumn):
        try:
            signs = nt.bytes_cmp_scalar(
                np.asarray(col.offsets).astype(np.int64),
                np.asarray(col.data), s.encode("utf-8"))
            out = _CMP_FROM_SIGN[op](signs)
            return PrimitiveColumn(jnp.asarray(out), dt.bool_,
                                   col.validity)
        except NotImplementedError:
            pass
    dcol = _as_dict(col)
    values = dcol.values
    if isinstance(values, StringColumn):
        try:
            signs = nt.bytes_cmp_scalar(
                np.asarray(values.offsets).astype(np.int64),
                np.asarray(values.data), s.encode("utf-8"))
            per_code = _CMP_FROM_SIGN[op](signs)
            out = jnp.take(jnp.asarray(per_code), dcol.codes,
                           mode="clip")
            vals_valid = values.validity
            validity = dcol.validity if vals_valid is None else vd.union(
                dcol.validity, jnp.take(vals_valid, dcol.codes,
                                        mode="clip"))
            return PrimitiveColumn(out, dt.bool_, validity)
        except NotImplementedError:
            pass
    vals = _dict_values_host(dcol)
    per_code = np.array([False if v is None else _CMP_FN[op](v, s)
                         for v in vals], bool)
    out = jnp.take(jnp.asarray(per_code), dcol.codes, mode="clip")
    return PrimitiveColumn(out, dt.bool_, _effective_validity(dcol, vals))


def merged_string_ranks(lv: StringColumn, rv: StringColumn):
    """Dense ranks of two value sets in one merged byte-sorted domain —
    all native (intern + varlen argsort).  -> (lranks u64, rranks u64)
    per dictionary slot."""
    lo = np.asarray(lv.offsets).astype(np.int64)
    ld = np.asarray(lv.data)
    ro = np.asarray(rv.offsets).astype(np.int64)
    rd = np.asarray(rv.data)
    offs = np.concatenate([lo, ro[1:] + lo[-1]])
    data = np.concatenate([ld[:lo[-1]], rd[:ro[-1]]])
    codes, uniq_idx = nt.intern_varlen(offs, data)
    uoffs, udata = nt.gather_varlen(offs, data, uniq_idx)
    order = nt.argsort_varlen(uoffs, udata).astype(np.int64)
    remap = np.empty(max(len(uniq_idx), 1), np.uint64)
    remap[order] = np.arange(len(uniq_idx), dtype=np.uint64)
    ranks = remap[codes]
    return ranks[:len(lv)], ranks[len(lv):]


def _dict_slot_validity(dcol: DictionaryColumn) -> vd.Mask:
    values = dcol.values
    if getattr(values, "validity", None) is None:
        return dcol.validity
    return vd.union(dcol.validity,
                    jnp.take(values.validity, dcol.codes, mode="clip"))


def _compare_cols(op: str, lhs: Column, rhs: Column) -> PrimitiveColumn:
    """dict-dict compare: map both into one merged rank domain (vectored
    dictionary compare, cmp.rs:468) — ranks built natively — then
    compare ranks on device."""
    dl, dr = _as_dict(lhs), _as_dict(rhs)
    lv, rv = dl.values, dr.values
    if isinstance(lv, StringColumn) and isinstance(rv, StringColumn):
        lrank, rrank = merged_string_ranks(lv, rv)
        lk = jnp.take(jnp.asarray(lrank), dl.codes, mode="clip")
        rk = jnp.take(jnp.asarray(rrank), dr.codes, mode="clip")
        validity = vd.union(_dict_slot_validity(dl),
                            _dict_slot_validity(dr))
    else:
        lvals, rvals = _dict_values_host(dl), _dict_values_host(dr)
        uniq = sorted({v for v in lvals + rvals if v is not None})
        rank = {v: i for i, v in enumerate(uniq)}
        lrank = np.array([rank.get(v, 0) for v in lvals], np.int64)
        rrank = np.array([rank.get(v, 0) for v in rvals], np.int64)
        lk = jnp.take(jnp.asarray(lrank), dl.codes, mode="clip")
        rk = jnp.take(jnp.asarray(rrank), dr.codes, mode="clip")
        validity = vd.union(_effective_validity(dl, lvals),
                            _effective_validity(dr, rvals))
    fn = {"eq": jnp.equal, "neq": jnp.not_equal, "lt": jnp.less,
          "lt_eq": jnp.less_equal, "gt": jnp.greater,
          "gt_eq": jnp.greater_equal}[op]
    return PrimitiveColumn(fn(lk, rk), dt.bool_, validity)


def _effective_validity(col: DictionaryColumn, vals) -> vd.Mask:
    """Column validity folded with null dictionary entries."""
    entry_null = np.array([v is None for v in vals], bool)
    if entry_null.any():
        entry_valid = jnp.take(jnp.asarray(~entry_null), col.codes,
                               mode="clip")
        return vd.union(col.validity, entry_valid)
    return col.validity


# ---- predicates ----------------------------------------------------------------

def _per_value(col: Column, fn: Callable[[str], bool]) -> PrimitiveColumn:
    """Evaluate a predicate once per distinct value, broadcast by code."""
    dcol = _as_dict(col)
    vals = _dict_values_host(dcol)
    per_code = np.array([False if v is None else bool(fn(v)) for v in vals],
                        bool)
    out = jnp.take(jnp.asarray(per_code), dcol.codes, mode="clip")
    return PrimitiveColumn(out, dt.bool_, _effective_validity(dcol, vals))


def _is_ascii(b: bytes) -> bool:
    return not any(c & 0x80 for c in b)


def _match_mask(col: Column, op: int, pattern: str,
                ci: bool = False, negate: bool = False
                ) -> PrimitiveColumn:
    """Native O(n) matcher (predicate.rs:28 / like.rs:79-186 semantics):
    StringColumn -> one C pass over the byte buffer; DictionaryColumn ->
    one C pass over the distinct values, broadcast by code on device."""
    pat = pattern.encode("utf-8")
    if ci and not _is_ascii(pat):
        return _match_fallback(col, op, pattern, ci, negate)
    if isinstance(col, StringColumn):
        offs = np.asarray(col.offsets).astype(np.int64)
        data = np.asarray(col.data)
        if ci and (data & 0x80).any():
            return _match_fallback(col, op, pattern, ci, negate)
        try:
            hits = nt.bytes_match(offs, data, pat, op, ci)
        except NotImplementedError:
            return _match_fallback(col, op, pattern, ci, negate)
        if negate:
            hits = ~hits
        return PrimitiveColumn(jnp.asarray(hits), dt.bool_, col.validity)
    dcol = _as_dict(col)
    values = dcol.values
    if not isinstance(values, StringColumn):
        raise ArrowNotImplementedError("non-string dictionary predicate")
    inner = _match_mask(values, op, pattern, ci, negate)
    per_code = inner.values
    out = jnp.take(per_code, dcol.codes, mode="clip")
    validity = vd.union(dcol.validity,
                        None if values.validity is None else
                        jnp.take(values.validity, dcol.codes,
                                 mode="clip"))
    return PrimitiveColumn(out, dt.bool_, validity)


def _match_fallback(col, op, pattern, ci, negate) -> PrimitiveColumn:
    """Unicode-cased / no-native fallback: per-distinct-value Python."""
    if op == nt.MATCH_LIKE:
        flags = re.DOTALL | (re.IGNORECASE if ci else 0)
        rx = re.compile(_like_regex(pattern), flags)
        fn = lambda v: (rx.match(v) is not None) != negate
    elif op == nt.MATCH_STARTS:
        fn = lambda v: v.startswith(pattern) != negate
    elif op == nt.MATCH_ENDS:
        fn = lambda v: v.endswith(pattern) != negate
    else:
        fn = lambda v: (pattern in v) != negate
    return _per_value(col, fn)


def _like_regex(pattern: str) -> str:
    """LIKE pattern -> anchored regex (like.rs via predicate.rs:28, with
    its literal/prefix/suffix fast paths subsumed by the per-distinct-value
    evaluation)."""
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern) and pattern[i + 1] in "%_":
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return "^" + "".join(out) + "$"


def like(col, pattern: str):
    return _match_mask(col, nt.MATCH_LIKE, pattern)


def ilike(col, pattern: str):
    return _match_mask(col, nt.MATCH_LIKE, pattern, ci=True)


def nlike(col, pattern: str):
    return _match_mask(col, nt.MATCH_LIKE, pattern, negate=True)


def nilike(col, pattern: str):
    return _match_mask(col, nt.MATCH_LIKE, pattern, ci=True, negate=True)


def starts_with(col, prefix: str):
    return _match_mask(col, nt.MATCH_STARTS, prefix)


def ends_with(col, suffix: str):
    return _match_mask(col, nt.MATCH_ENDS, suffix)


def contains(col, needle: str):
    return _match_mask(col, nt.MATCH_CONTAINS, needle)


def _regex_native_mask(col, pattern: str, ci: bool):
    """One native lazy-DFA pass over all value bytes (regexp.rs:39
    compile-once role). None when the pattern/data need the Python
    fallback (non-ASCII, unsupported construct, no native lib)."""
    pat = pattern.encode()
    if not _is_ascii(pat):
        return None
    try:
        h = nt.regex_compile(pattern, ci)
    except (OSError, AttributeError):
        return None
    if h is None:
        return None
    if isinstance(col, StringColumn):
        data = np.asarray(col.data)
        if len(data) and (data & 0x80).any():
            return None                  # byte-DFA vs codepoint semantics
        offs = np.asarray(col.offsets).astype(np.int64)
        hits = nt.regex_match(h, offs, data)
        return PrimitiveColumn(jnp.asarray(hits), dt.bool_, col.validity)
    dcol = _as_dict(col)
    values = dcol.values
    if not isinstance(values, StringColumn):
        return None
    inner = _regex_native_mask(values, pattern, ci)
    if inner is None:
        return None
    out = jnp.take(inner.values, dcol.codes, mode="clip")
    validity = vd.union(dcol.validity,
                        None if values.validity is None else
                        jnp.take(values.validity, dcol.codes,
                                 mode="clip"))
    return PrimitiveColumn(out, dt.bool_, validity)


def regexp_is_match(col, pattern: str, flags: str = ""):
    ci = "i" in flags
    rx = re.compile(pattern, re.IGNORECASE if ci else 0)  # validates
    native = _regex_native_mask(col, pattern, ci)
    if native is not None:
        return native
    return _per_value(col, lambda v: rx.search(v) is not None)


def regexp_match(col, pattern: str, flags: str = ""):
    """First-match capture groups per row as List<Utf8> (regexp.rs
    regexp_match); no match / null input -> null entry.  Host-side over
    the dictionary values (strings are dictionary-encoded by design)."""
    from ..core.column import ListColumn
    from ..core.builders import ListBuilder, StringBuilder
    f = re.IGNORECASE if "i" in flags else 0
    rx = re.compile(pattern, f)
    d = _as_dict(col)
    vals = _dict_values_host(d)
    per_value = []
    for v in vals:
        if v is None:
            per_value.append(None)
            continue
        m = rx.search(v)
        if m is None:
            per_value.append(None)
        elif rx.groups:
            per_value.append([g if g is not None else None
                              for g in m.groups()])
        else:
            per_value.append([m.group(0)])
    codes = np.asarray(d.codes)
    valid = None if d.validity is None else np.asarray(d.validity)
    lb = ListBuilder(StringBuilder())
    for i in range(len(d)):
        ok = valid is None or valid[i]
        row = per_value[codes[i]] if ok else None
        if row is None:
            lb.append_null()
        else:
            lb.append_value(row)
    return lb.finish()


# ---- transforms ------------------------------------------------------------------

def _map_values(col: Column, fn: Callable[[str], str]) -> Column:
    """Apply a string transform to each distinct value, keep codes."""
    dcol = _as_dict(col)
    vals = _dict_values_host(dcol)
    new_vals = StringColumn.from_pylist(
        [None if v is None else fn(v) for v in vals])
    out = DictionaryColumn(dcol.codes, new_vals, dcol.validity,
                           _canonical=True)
    return out if isinstance(col, DictionaryColumn) else \
        dictionary_decode(out)


def substring(col, start: int, length: Optional[int] = None):
    """Character-based substring (substring.rs semantics: negative start
    counts from the end); native single pass over the byte buffer."""
    if isinstance(col, StringColumn):
        try:
            offs, data = nt.utf8_substring(
                np.asarray(col.offsets).astype(np.int64),
                np.asarray(col.data), start, length)
            return StringColumn(jnp.asarray(offs.astype(np.int32)),
                                jnp.asarray(data), col.dtype,
                                col.validity)
        except NotImplementedError:
            pass
    def f(v: str) -> str:
        s = start if start >= 0 else max(len(v) + start, 0)
        e = len(v) if length is None else min(s + length, len(v))
        return v[s:e]
    return _map_values(col, f)


def _case_transform(col, to_upper: bool):
    if isinstance(col, StringColumn):
        data = np.asarray(col.data)
        out, is_ascii = nt.ascii_case(data, to_upper)
        if is_ascii:
            return StringColumn(col.offsets, jnp.asarray(out),
                                col.dtype, col.validity)
        # fall through: non-ASCII needs Unicode case mapping
    return _map_values(col, str.upper if to_upper else str.lower)


def upper(col):
    return _case_transform(col, True)


def lower(col):
    return _case_transform(col, False)


def concat_elements(lhs: Column, rhs: Column) -> Column:
    """Element-wise string concatenation (concat_elements.rs)."""
    dl, dr = _as_dict(lhs), _as_dict(rhs)
    lv, rv = _dict_values_host(dl), _dict_values_host(dr)
    # pair codes -> combined dictionary over observed pairs (host)
    lc = np.asarray(dl.codes)
    rc = np.asarray(dr.codes)
    pair = lc.astype(np.int64) * max(len(rv), 1) + rc
    uniq, inv = np.unique(pair, return_inverse=True)
    vals = []
    for p in uniq:
        a = lv[p // max(len(rv), 1)]
        b = rv[p % max(len(rv), 1)]
        vals.append(None if a is None or b is None else a + b)
    out = DictionaryColumn(jnp.asarray(inv.astype(np.int32)),
                           StringColumn.from_pylist(vals),
                           vd.union(dl.validity, dr.validity))
    return out if isinstance(lhs, DictionaryColumn) else \
        dictionary_decode(out)


# ---- length kernels (pure device) ------------------------------------------------

def octet_length(col) -> PrimitiveColumn:
    """Byte length (length.rs octet_length) — pure device offset diff."""
    if isinstance(col, DictionaryColumn):
        inner = octet_length(col.values)
        out = jnp.take(inner.values, col.codes, mode="clip")
        return PrimitiveColumn(out, dt.int32, _dict_slot_validity(col))
    if not isinstance(col, StringColumn):
        raise ArrowTypeError(f"octet_length of {type(col)}")
    lens = (col.offsets[1:] - col.offsets[:-1]).astype(jnp.int32)
    return PrimitiveColumn(lens, dt.int32, col.validity)


def length(col) -> PrimitiveColumn:
    """Character count (length.rs length): bytes minus UTF-8 continuation
    bytes, via a prefix-sum over the byte tensor — no host round-trip."""
    if isinstance(col, DictionaryColumn):
        inner = length(col.values)
        out = jnp.take(inner.values, col.codes, mode="clip")
        return PrimitiveColumn(out, dt.int32, _dict_slot_validity(col))
    from ..core.column import ListColumn
    from ..core.nested import (FixedSizeBinaryColumn, FixedSizeListColumn,
                               ListViewColumn, MapColumn)
    if isinstance(col, (ListColumn, MapColumn)):
        # element counts (length.rs list arms); large_list yields i64
        counts = col.offsets[1:] - col.offsets[:-1]
        wide = col.dtype.name == "large_list"
        return PrimitiveColumn(counts.astype(jnp.int64 if wide
                                             else jnp.int32),
                               dt.int64 if wide else dt.int32,
                               col.validity)
    if isinstance(col, ListViewColumn):
        return PrimitiveColumn(col.sizes.astype(jnp.int32), dt.int32,
                               col.validity)
    if isinstance(col, FixedSizeListColumn):
        n = len(col)
        return PrimitiveColumn(jnp.full((n,), col.list_size, jnp.int32),
                               dt.int32, col.validity)
    if isinstance(col, FixedSizeBinaryColumn):
        n = len(col)
        return PrimitiveColumn(
            jnp.full((n,), int(col.data.shape[1]), jnp.int32),
            dt.int32, col.validity)
    if not isinstance(col, StringColumn):
        raise ArrowTypeError(f"length of {type(col)}")
    is_start = ((col.data & jnp.uint8(0xC0)) != jnp.uint8(0x80)) \
        .astype(jnp.int32)
    prefix = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(is_start, dtype=jnp.int32)])
    counts = prefix[col.offsets[1:]] - prefix[col.offsets[:-1]]
    return PrimitiveColumn(counts.astype(jnp.int32), dt.int32, col.validity)


def bit_length(col) -> PrimitiveColumn:
    o = octet_length(col)
    return PrimitiveColumn(o.values * 8, dt.int32, o.validity)
