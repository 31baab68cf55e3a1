"""Order-preserving row/key encoding — the engine's arrow-row.

The reference encodes rows as memcmp-comparable byte strings
(arrow-row/src/lib.rs:148-260: int -> sign-flip + big-endian + 0x01 validity
prefix; float -> totalOrder bit-twiddle; descending -> byte inversion).
The device re-design keeps the *order-preserving transform* but targets
the device sort: each column becomes one or two uint64 "radix
keys" (null class key + value key), and a multi-column sort is a stable
lexsort over the key stack — no byte-string materialization in the hot
path.  A byte-row materialization (`RowConverter`) is still provided for
API parity, spill, and merge interchange.

Key transforms (order-preserving into uint64, cf. arrow-row/src/fixed.rs:47):
  signed int   : cast int64, bitcast u64, flip sign bit
  unsigned int : zero-extend
  bool         : 0/1
  float        : cast f64, bitcast u64; if sign set -> ~bits
                 else bits | MSB   (IEEE totalOrder; matches the
                 reference's total_cmp sort semantics)
  temporal     : via the signed-int path
  dictionary   : dense rank of the dictionary values (host-computed once
                 per dictionary), gathered by code — the reference instead
                 encodes values inline (lib.rs Codec::Dictionary); rank
                 keys preserve order within a conversion context
  utf8/binary  : dictionary-encode, then as above
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import dtypes as dt
from ..core import validity as vd
from ..core.column import (Column, DictionaryColumn, PrimitiveColumn,
                           StringColumn)
from ..errors import ArrowNotImplementedError

__all__ = ["SortOptions", "SortField", "encode_value_key", "encode_keys",
           "RowConverter", "Rows"]

_SIGN64 = jnp.uint64(1) << jnp.uint64(63)


@dataclass(frozen=True)
class SortOptions:
    """arrow-schema SortOptions (lib.rs:84): defaults ascending,
    nulls first (lib.rs:161-169)."""
    descending: bool = False
    nulls_first: bool = True


@dataclass(frozen=True)
class SortField:
    """arrow-row SortField (lib.rs:576)."""
    options: SortOptions = SortOptions()


def _float_total_order_bits(f64: jnp.ndarray) -> jnp.ndarray:
    """IEEE totalOrder bits of f64 as u64 (arrow-row fixed.rs float map).

    Used by u64-keyed consumers (row materialization, join hashing,
    comparators); sort-shaped device paths use native float sort keys
    (_float_keys_native) instead.
    """
    bits = jax_bitcast_u64(f64)
    neg = bits >> jnp.uint64(63) == jnp.uint64(1)
    return jnp.where(neg, ~bits, bits | _SIGN64)


def jax_bitcast_u64(x: jnp.ndarray) -> jnp.ndarray:
    import jax
    return jax.lax.bitcast_convert_type(x, jnp.uint64)


def dictionary_value_ranks(values: Column) -> Tuple[np.ndarray, np.ndarray]:
    """Dense ranks of dictionary values (host, once per dictionary).
    Returns (ranks uint64, is_null bool) per dictionary slot."""
    if isinstance(values, StringColumn):
        lst = values.to_pylist_host()
        is_null = np.array([v is None for v in lst])
        keys = np.array([b"" if v is None else
                         (v.encode() if isinstance(v, str) else v)
                         for v in lst], dtype=object)
        # dense ranks: equal values share a rank; rank by (S-padded
        # bytes, length) because the S conversion NUL-pads — b'a' and
        # b'a\x00' must rank apart, and padded-tie + shorter-first IS
        # byte order (np.unique alone collapsed them)
        nb = keys[~is_null]
        if len(nb):
            padded = nb.astype(bytes)
            lens = np.array([len(x) for x in nb], np.int64)
            order = np.lexsort((lens, padded))
            sp, sl = padded[order], lens[order]
            neq = np.concatenate(
                [[True], (sp[1:] != sp[:-1]) | (sl[1:] != sl[:-1])])
            dense = np.cumsum(neq) - 1
            inv = np.empty(len(nb), np.int64)
            inv[order] = dense
        else:
            inv = np.zeros(0, np.int64)
        ranks = np.zeros(len(lst), np.uint64)
        ranks[~is_null] = inv.astype(np.uint64)
        return ranks, is_null
    if isinstance(values, PrimitiveColumn):
        vals = np.asarray(values.values)
        is_null = np.zeros(len(vals), bool) if values.validity is None \
            else ~np.asarray(values.validity)
        _, inv = np.unique(vals[~is_null], return_inverse=True) \
            if (~is_null).any() else (None, np.zeros(0, np.int64))
        ranks = np.zeros(len(vals), np.uint64)
        ranks[~is_null] = inv.astype(np.uint64)
        return ranks, is_null
    raise ArrowNotImplementedError(f"dictionary of {type(values)}")


def encode_value_key(col: Column) -> Tuple[jnp.ndarray, vd.Mask]:
    """uint64 order key per element (ascending), plus effective validity
    (folding in null dictionary entries)."""
    if isinstance(col, PrimitiveColumn):
        d = col.dtype
        v = col.values
        if d.is_floating:
            return _float_total_order_bits(v.astype(jnp.float64)), col.validity
        if d.is_boolean:
            return v.astype(jnp.uint64), col.validity
        if d.is_unsigned_integer:
            return v.astype(jnp.uint64), col.validity
        if d.name == "interval" and d.unit == "day_time":
            b = v.astype(jnp.int64) ^ jnp.int64(0x80000000)
            return (jax_bitcast_u64(b) ^ _SIGN64), col.validity
        # signed ints + temporal
        return (jax_bitcast_u64(v.astype(jnp.int64)) ^ _SIGN64), col.validity
    if isinstance(col, DictionaryColumn):
        ranks, dict_null = dictionary_value_ranks(col.values)
        key = jnp.take(jnp.asarray(ranks), col.codes, mode="clip")
        eff_validity = col.validity
        if dict_null.any():
            entry_valid = jnp.take(jnp.asarray(~dict_null), col.codes,
                                   mode="clip")
            eff_validity = vd.union(eff_validity, entry_valid)
        return key, eff_validity
    if isinstance(col, StringColumn):
        # encode via on-the-fly dictionary (host unique)
        from .strings import dictionary_encode
        return encode_value_key(dictionary_encode(col))
    raise ArrowNotImplementedError(f"row key for {type(col)}")


def encode_keys(cols: Sequence[Column],
                options: Sequence[SortOptions]) -> List[jnp.ndarray]:
    """Key stack for a stable lexsort, most-significant column FIRST.
    Each column contributes (null_class_key, value_key)."""
    keys: List[jnp.ndarray] = []
    for col, opt in zip(cols, options):
        vkey, validity = encode_value_key(col)
        if opt.descending:
            vkey = ~vkey
        n = vkey.shape[0]
        if validity is None:
            null_key = None
            vkey_final = vkey
        else:
            # null class: nulls_first -> null=0 valid=1; else null=1 valid=0
            if opt.nulls_first:
                null_key = validity.astype(jnp.uint64)
            else:
                null_key = (~validity).astype(jnp.uint64)
            vkey_final = jnp.where(validity, vkey, jnp.uint64(0))
        if null_key is not None:
            keys.append(null_key)
        keys.append(vkey_final)
    return keys


def lexsort_indices_from_keys(keys: List[jnp.ndarray],
                              dtype=jnp.uint32) -> jnp.ndarray:
    """Stable lexicographic argsort; keys[0] most significant.
    jnp.lexsort treats the LAST key as primary, so reverse."""
    if len(keys) == 1:
        idx = jnp.argsort(keys[0], stable=True)
    else:
        idx = jnp.lexsort(tuple(reversed(keys)))
    return idx.astype(dtype)


# ---- byte-row materialization (API parity with RowConverter) ----------------

@dataclass
class Rows:
    """Fixed-width memcmp-comparable rows: uint8 matrix (n, width).
    Row i sorts before row j iff bytes(i) < bytes(j) lexicographically
    (the arrow-row contract, lib.rs:1166)."""
    data: jnp.ndarray            # (n, width) uint8
    fields: Tuple[SortField, ...]
    layout: Tuple[Tuple[int, int], ...]  # (offset, nbytes) per column
    dtypes: Tuple[dt.DataType, ...]

    def __len__(self):
        return int(self.data.shape[0])

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.data)

    def argsort(self) -> jnp.ndarray:
        # lexsort over byte columns, most significant byte first
        cols = [self.data[:, i] for i in range(self.data.shape[1])]
        return jnp.lexsort(tuple(reversed(cols))).astype(jnp.uint32)


class RowConverter:
    """Columns -> comparable rows and back (arrow-row RowConverter,
    lib.rs:413,642,749).  Fixed-width values encode as tag byte +
    big-endian order key (fixed.rs); STRING columns use the reference's
    variable-length encoding — 0x02-prefixed 32-byte blocks with
    continuation tokens (variable.rs:28-100), via the native hostcodec —
    so string rows are byte-faithful to the arrow-row spec and decode
    without a dictionary.  Dictionary columns encode their dense value
    rank (order-preserving within this converter's lifetime).
"""

    def __init__(self, fields: Sequence[SortField]):
        self.fields = tuple(fields)

    def _column_width(self, col: Column) -> int:
        if isinstance(col, (DictionaryColumn, StringColumn)):
            return 1 + 8
        return 1 + 8  # tag byte + uint64 key

    def convert_columns(self, cols: Sequence[Column]) -> Rows:
        assert len(cols) == len(self.fields)
        n = len(cols[0])
        parts = []
        layout = []
        offset = 0
        for col, f in zip(cols, self.fields):
            opt = f.options
            if isinstance(col, StringColumn):
                from ..utils import native as _native
                offs = np.asarray(col.offsets, np.int32)
                max_len = int((offs[1:] - offs[:-1]).max()) if n else 0
                nblocks = max(1, -(-max_len // 32))
                v = None if col.validity is None \
                    else np.asarray(col.validity, np.uint8)
                enc = _native.encode_varlen_rows(
                    offs, np.asarray(col.data, np.uint8), v, nblocks,
                    opt.descending, opt.nulls_first)
                parts.append(jnp.asarray(enc))
                layout.append((offset, enc.shape[1]))
                offset += enc.shape[1]
                continue
            vkey, validity = encode_value_key(col)
            if opt.descending:
                vkey = ~vkey
            if validity is None:
                tag = jnp.full((n,), 0x01, jnp.uint8)
            else:
                null_tag = 0x00 if opt.nulls_first else 0xFF
                tag = jnp.where(validity, jnp.uint8(0x01),
                                jnp.uint8(null_tag))
                vkey = jnp.where(validity, vkey, jnp.uint64(0))
            # big-endian byte expansion of the u64 key
            shifts = jnp.arange(56, -8, -8, dtype=jnp.uint64)
            bytes_ = ((vkey[:, None] >> shifts[None, :])
                      & jnp.uint64(0xFF)).astype(jnp.uint8)
            parts.append(tag[:, None])
            parts.append(bytes_)
            layout.append((offset, 9))
            offset += 9
        data = jnp.concatenate(parts, axis=1)
        return Rows(data, self.fields, tuple(layout),
                    tuple(c.dtype for c in cols))

    def convert_rows(self, rows: Rows, like: Sequence[Column]
                     ) -> List[Column]:
        """Inverse transform.  `like` supplies dictionaries for
        dictionary-encoded fields (the reference stores interned values in
        the converter; we pass the source columns explicitly)."""
        out: List[Column] = []
        data = rows.data
        for (off, w), f, src in zip(rows.layout, self.fields, like):
            opt = f.options
            if isinstance(src, StringColumn):
                from ..utils import native as _native
                nblocks = (w - 1) // 33
                offs, bytes_, valid = _native.decode_varlen_rows(
                    np.asarray(data, np.uint8), off, nblocks,
                    opt.descending, opt.nulls_first)
                mask = None if valid.all() else jnp.asarray(valid.view(bool))
                out.append(StringColumn(jnp.asarray(offs),
                                        jnp.asarray(bytes_), src.dtype,
                                        mask))
                continue
            tag = data[:, off]
            validity = tag == 0x01
            shifts = jnp.arange(56, -8, -8, dtype=jnp.uint64)
            key = jnp.sum(data[:, off + 1: off + 9].astype(jnp.uint64)
                          << shifts[None, :], axis=1, dtype=jnp.uint64)
            if opt.descending:
                key = ~key
            out.append(_decode_key(key, validity, src))
        return out


def _decode_key(key: jnp.ndarray, validity: jnp.ndarray, src: Column
                ) -> Column:
    import jax
    all_valid = bool(jnp.all(validity))
    mask = None if all_valid else validity
    d = src.dtype
    if isinstance(src, PrimitiveColumn):
        if d.is_floating:
            neg = (key & _SIGN64) == jnp.uint64(0)
            bits = jnp.where(neg, ~key, key & ~_SIGN64)
            f = jax.lax.bitcast_convert_type(bits, jnp.float64)
            return PrimitiveColumn(f.astype(d.to_jax()), d, mask)
        if d.is_boolean:
            return PrimitiveColumn(key.astype(jnp.bool_), d, mask)
        if d.is_unsigned_integer:
            return PrimitiveColumn(key.astype(d.to_jax()), d, mask)
        i = jax.lax.bitcast_convert_type(key ^ _SIGN64, jnp.int64)
        return PrimitiveColumn(i.astype(d.to_jax()), d, mask)
    if isinstance(src, DictionaryColumn):
        # invert the rank mapping: rank -> dictionary code
        ranks, dict_null = dictionary_value_ranks(src.values)
        valid_codes = np.nonzero(~dict_null)[0]
        # first code for each rank (ranks are dense over valid entries)
        nranks = int(ranks[~dict_null].max()) + 1 if (~dict_null).any() else 0
        rank_to_code = np.zeros(max(nranks, 1), np.int64)
        for c in valid_codes[::-1]:
            rank_to_code[int(ranks[c])] = c
        codes = jnp.take(jnp.asarray(rank_to_code),
                         jnp.clip(key.astype(jnp.int64), 0,
                                  max(nranks - 1, 0)), mode="clip")
        return DictionaryColumn(codes.astype(src.codes.dtype), src.values,
                                mask)
    raise ArrowNotImplementedError(f"decode of {type(src)}")


# ---- jitted key-encode machinery (shared by sort / rank / group_by) ---------
#
# Every sort-shaped operator funnels its whole pipeline through one jit,
# so a query pays one dispatch per stage instead of one per array op.
# Host-side work is confined to dictionary-rank precomputation
# (dictionary-sized, key_parts) while the row-sized key build stays traced
# (encode_keys_traced).

def key_kind(c: Column) -> str:
    """Static tag for the traced key encoder."""
    from ..core.nested import DecimalColumn, RunEndColumn
    if isinstance(c, RunEndColumn):
        from .ree import run_end_decode
        return key_kind(run_end_decode(c))
    if isinstance(c, DictionaryColumn):
        return "dict"
    if isinstance(c, StringColumn):
        return "dict"            # host dictionary-encode in key_parts
    if isinstance(c, DecimalColumn):
        return f"dec{c.limbs.shape[1]}"     # dec2 / dec4 limb keys
    if isinstance(c, PrimitiveColumn):
        d = c.dtype
        if d.is_floating:
            return "float"
        if d.is_boolean or d.is_unsigned_integer:
            return "uint"
        if d.name == "interval" and d.unit == "day_time":
            # packed days<<32|ms: bias bit 31 so the SIGNED millis low
            # half orders correctly under the plain int key
            return "day_time"
        return "int"             # incl. decimal32/64 storage ints
    if _host_rankable(c):
        return "uint"            # host-computed u32 comparator ranks
    raise ArrowNotImplementedError(f"sort key of {type(c)}")


def _host_rankable(c: Column) -> bool:
    """Columns sorted via host comparator ranks — the reference's own
    design for these types (sort.rs:514 child_rank: rank children on
    CPU, then sort u32 ranks): list/large_list/fsl (sort.rs:208-210,
    238-240), fixed-size binary (sort.rs:237), interval (primitive
    dispatch; Ord derives (months, days, nanos) lexicographic,
    arrow-buffer/src/interval.rs:68), plus struct/list_view which the
    reference reaches through make_comparator."""
    from ..core.column import ListColumn, StructColumn
    from ..core.nested import (FixedSizeBinaryColumn, FixedSizeListColumn,
                               IntervalMDNColumn, ListViewColumn, MapColumn)
    return isinstance(c, (ListColumn, ListViewColumn, FixedSizeListColumn,
                          FixedSizeBinaryColumn, IntervalMDNColumn,
                          StructColumn, MapColumn))


def _pyval_key(v, d: dt.DataType, nf: bool):
    """Total-order key for a possibly-null python value of dtype `d`;
    child nulls order by `nf` (child_rank's nulls_first)."""
    if v is None:
        return (0,) if nf else (2,)
    return (1, _pyval_body(v, d, nf))


def _pyval_body(v, d: dt.DataType, nf: bool):
    n = d.name
    if d.is_floating:
        f = float(v)
        return (1, 0.0) if f != f else (0, f)   # NaN above all (totalOrder)
    if n in ("list", "large_list", "list_view", "large_list_view",
             "fixed_size_list"):
        return tuple(_pyval_key(x, d.value_type, nf) for x in v)
    if n == "struct":
        vals = [v.get(f.name) if isinstance(v, dict) else v[i]
                for i, f in enumerate(d.fields)]
        return tuple(_pyval_key(x, f.dtype, nf)
                     for x, f in zip(vals, d.fields))
    if n == "interval" and d.unit == "month_day_nano":
        m = getattr(v, "months", None)
        if m is None:
            m, dd, nn = v
        else:
            dd, nn = v.days, v.nanoseconds
        return (int(m), int(dd), int(nn))
    if n == "map":
        # a map cell is its entries list; order like list<struct<k,v>>
        kf, vf = d.value_type.fields
        out = []
        for e in v:
            if isinstance(e, dict):
                k, val = e.get(kf.name), e.get(vf.name)
            else:
                k, val = e
            out.append((_pyval_key(k, kf.dtype, nf),
                        _pyval_key(val, vf.dtype, nf)))
        return tuple(out)
    if d.is_dictionary:
        return _pyval_body(v, d.value_type, nf)
    if isinstance(v, list):          # any other container: hashable form
        return tuple(v)
    return v


def _host_rank_parts(c: Column, opt):
    """key_parts for nested/fsb/interval columns: dense u32 comparator
    ranks computed on host (the reference runs the same comparator work
    on CPU; the device then sorts ranks)."""
    desc = bool(opt.descending) if opt is not None else False
    nf = bool(opt.nulls_first) if opt is not None else True
    child_nf = nf != desc        # child_rank's inversion (sort.rs:516)
    py = c.to_pylist()
    keys = [_pyval_key(v, c.dtype, child_nf) for v in py]
    rank_of = {k: i for i, k in enumerate(sorted(set(keys)))}
    ranks = np.fromiter((rank_of[k] for k in keys), np.uint32, len(keys))
    validity = c.validity
    if validity is None and any(v is None for v in py):
        validity = jnp.asarray(np.asarray([v is not None for v in py]))
    return (jnp.asarray(ranks), None, None, validity)


def key_parts(c: Column, opt=None):
    """(values, ranks, entry_valid, validity) arrays for one key column;
    dictionary/string value ranks are computed on host here (small).
    `opt` (SortOptions) only matters for host-ranked nested columns,
    whose child null placement depends on it (sort.rs:514)."""
    from ..core.nested import DecimalColumn, RunEndColumn
    if isinstance(c, RunEndColumn):
        from .ree import run_end_decode
        c = run_end_decode(c)      # logical rows; runs re-expand
    if _host_rankable(c):
        return _host_rank_parts(c, opt)
    if isinstance(c, StringColumn):
        from .strings import dictionary_encode
        c = dictionary_encode(c)
    if isinstance(c, DictionaryColumn):
        if c.dtype.ordered and getattr(c.values, "validity",
                                       None) is None:
            # declared-ordered dictionary (datatype.rs Dictionary
            # ordered bool, set by dictionary_encode(ordered=True) or
            # carried in from IPC/C-ABI): codes ARE the ranks — skip
            # the O(u log u) host rank-verification entirely
            return (c.codes, None, None, c.validity)
        ranks, dict_null = dictionary_value_ranks(c.values)
        if not dict_null.any() and len(ranks) and \
                bool((np.diff(ranks.astype(np.int64)) > 0).all()):
            # VALUE-SORTED dictionary (strictly increasing ranks =
            # distinct values in slot order): codes ARE the ranks, so
            # the encoder can skip the row-sized rank-LUT gather inside
            # the sort program.  ranks=None marks this statically via
            # the pytree structure.
            return (c.codes, None, None, c.validity)
        entry_valid = jnp.asarray(~dict_null) if dict_null.any() else None
        return (c.codes, jnp.asarray(ranks), entry_valid, c.validity)
    if isinstance(c, DecimalColumn):
        return (c.limbs, None, None, c.validity)
    return (c.values, None, None, c.validity)


def _float_keys_native(vals, descending):
    """Float sort keys without a bit encoding: a NaN-class u64 key (NaN
    above everything, per totalOrder / pyarrow) + the native float
    value, which lax.sort orders directly.  NaN slots in the value key
    are normalized to 0 so run-boundary equality compares don't split
    the NaN group.
    Deviation from the bit encoding: -0.0 ties +0.0 and NaN payloads
    collapse — observable only through exotic bit patterns."""
    v = vals.astype(jnp.float64)
    isnan = jnp.isnan(v)
    nan_key = isnan.astype(jnp.uint64) if not descending \
        else (~isnan).astype(jnp.uint64)
    vclean = jnp.where(isnan, jnp.float64(0.0), v)
    vkey = -vclean if descending else vclean
    return nan_key, vkey


_UNSIGNED_BY_WIDTH = {1: (jnp.uint8, 0x80), 2: (jnp.uint16, 0x8000),
                      4: (jnp.uint32, 0x8000_0000),
                      8: (jnp.uint64, 0x8000_0000_0000_0000)}


def _int_key_native(vals, signed: bool):
    """Order key at the value's OWN width: multi-operand sorts move
    every key byte through every merge pass, so an i32 column keyed u32
    costs half the merge traffic of the u64 key it used to get."""
    if vals.dtype == jnp.bool_:
        return vals.astype(jnp.uint8)
    ut, sign = _UNSIGNED_BY_WIDTH[vals.dtype.itemsize]
    if not signed:
        return vals.astype(ut)
    # sign bit as a typed scalar: a bare python 2^63 overflows the
    # default-int argument parse
    return jax.lax.bitcast_convert_type(vals, ut) ^ jnp.asarray(sign, ut)


def _encode_one_traced(kind, opt, part) -> List[jnp.ndarray]:
    """One column's ordered key group, most significant first.

    Operand diet (every key byte rides every merge pass): value keys
    keep their source width (i32 -> u32, not u64), null and NaN class
    keys are u8, dictionary ranks are u32 (codes are i32, so
    vocabularies fit), and float columns sort by NATIVE float keys
    (a NaN class key plus the value, see _float_keys_native).

    The value keys are INVERTIBLE given the sorted class keys —
    decode_sorted_group below recovers values/codes/validity from the
    sorted key group, which lets sort_table skip the output gather for
    key columns entirely."""
    (descending, nulls_first) = opt
    (vals, ranks, entry_valid, validity) = part
    keys: List[jnp.ndarray] = []
    if kind == "float":
        isnan = jnp.isnan(vals)
        nan_key = isnan.astype(jnp.uint8) if not descending \
            else (~isnan).astype(jnp.uint8)
        vclean = jnp.where(isnan, jnp.zeros((), vals.dtype), vals)
        vkey = -vclean if descending else vclean
        if validity is not None:
            null_key = validity.astype(jnp.uint8) if nulls_first \
                else (~validity).astype(jnp.uint8)
            keys.append(null_key)
            nan_key = jnp.where(validity, nan_key, jnp.uint8(0))
            vkey = jnp.where(validity, vkey, jnp.zeros((), vkey.dtype))
        keys.append(nan_key)
        keys.append(vkey)
        return keys
    if kind.startswith("dec"):
        # decimal128/256: lexicographic u64 limb keys, most
        # significant limb first with its two's-complement sign bit
        # flipped (limbs are little-endian u64 planes)
        nlimb = int(kind[3:])
        limb_keys = []
        for j in range(nlimb - 1, -1, -1):
            k = vals[:, j]
            if j == nlimb - 1:
                k = k ^ _SIGN64
            limb_keys.append(k)
        if descending:
            limb_keys = [~k for k in limb_keys]
        if validity is not None:
            null_key = validity.astype(jnp.uint8) if nulls_first \
                else (~validity).astype(jnp.uint8)
            keys.append(null_key)
            limb_keys = [jnp.where(validity, k, jnp.uint64(0))
                         for k in limb_keys]
        keys.extend(limb_keys)
        return keys
    if kind == "dict":
        if ranks is None:          # value-sorted dictionary: code = rank
            vkey = vals.astype(jnp.uint32)
        else:
            vkey = jnp.take(ranks.astype(jnp.uint32), vals, mode="clip")
        if entry_valid is not None:
            ev = jnp.take(entry_valid, vals, mode="clip")
            validity = ev if validity is None else (validity & ev)
    elif kind == "uint":
        vkey = _int_key_native(vals, False)
    elif kind == "day_time":
        vkey = _int_key_native(vals ^ jnp.asarray(0x80000000, vals.dtype),
                               True)
    else:
        vkey = _int_key_native(vals, True)
    if descending:
        vkey = ~vkey
    if validity is not None:
        null_key = validity.astype(jnp.uint8) if nulls_first \
            else (~validity).astype(jnp.uint8)
        keys.append(null_key)
        vkey = jnp.where(validity, vkey, jnp.zeros((), vkey.dtype))
    keys.append(vkey)
    return keys


def encode_key_groups_traced(kinds, opts, parts) -> List[List[jnp.ndarray]]:
    """Per-column key groups (encode_keys_traced flattens these)."""
    return [_encode_one_traced(k, o, p)
            for k, o, p in zip(kinds, opts, parts)]


def encode_keys_traced(kinds, opts, parts) -> List[jnp.ndarray]:
    """Traced equivalent of encode_keys: key stack for lax.sort, most
    significant first.  kinds/opts are static; parts are arrays."""
    return [k for g in encode_key_groups_traced(kinds, opts, parts)
            for k in g]


def group_has_null_key(kind, part) -> bool:
    """Static structure of one key group: whether it leads with a u8
    null-class key (decides decode layout)."""
    (vals, ranks, entry_valid, validity) = part
    if kind == "dict":
        return validity is not None or entry_valid is not None
    return validity is not None


def decode_sorted_group(kind, opt, has_null, group, out_dtype=None,
                        inv_slots=None):
    """Inverse of _encode_one_traced AFTER sorting: recover
    (values-or-codes, validity-or-None) from one column's sorted key
    group.  For dict columns, `inv_slots` maps rank -> dictionary slot
    and codes come back; for the rest `out_dtype` is the physical value
    dtype.  Null rows decode to canonical zero-slot values under a False
    validity bit."""
    (descending, nulls_first) = opt
    validity = None
    if has_null:
        nk = group[0]
        validity = (nk == 1) if nulls_first else (nk == 0)
        group = group[1:]
    if kind == "float":
        nan_k, vkey = group
        nan_flag = (nan_k == (0 if descending else 1))
        if validity is not None:
            nan_flag = jnp.logical_and(nan_flag, validity)
        v = -vkey if descending else vkey
        v = jnp.where(nan_flag, jnp.array(jnp.nan, v.dtype), v)
        return v.astype(out_dtype), validity
    if kind == "dict":
        vkey = group[0]
        if descending:
            vkey = ~vkey
        codes = jnp.take(inv_slots, vkey.astype(jnp.int32), mode="clip")
        return codes.astype(out_dtype), validity
    vkey = group[0]
    if descending:
        vkey = ~vkey
    if out_dtype == jnp.bool_:
        return vkey.astype(jnp.bool_), validity
    if kind == "uint":
        return vkey.astype(out_dtype), validity
    ut, sign = _UNSIGNED_BY_WIDTH[vkey.dtype.itemsize]
    st = {1: jnp.int8, 2: jnp.int16, 4: jnp.int32, 8: jnp.int64}[
        vkey.dtype.itemsize]
    v = jax.lax.bitcast_convert_type(vkey ^ jnp.asarray(sign, ut), st)
    if kind == "day_time":
        v = v ^ jnp.asarray(0x80000000, st)
    return v.astype(out_dtype), validity


def lexsort_order_traced(keys):
    """Stable lexicographic argsort of a key stack (most significant
    first): ONE multi-key lax.sort with a u32 row-index payload.  The
    LSD alternative (one single-key pass per key, composing the
    permutations through row-sized random gathers) moves more bytes."""
    n = keys[0].shape[0]
    iota = jnp.arange(n, dtype=jnp.uint32)
    out = jax.lax.sort(tuple(keys) + (iota,), num_keys=len(keys),
                       is_stable=True)
    return out[-1]


@functools.partial(jax.jit, static_argnames=("kinds", "opts", "limit"))
def _lexsort_stage(kinds, opts, parts, limit=None):
    keys = encode_keys_traced(kinds, opts, parts)
    if limit is not None and len(keys) == 1 \
            and limit <= keys[0].shape[0] // 4:
        # true partial top-k (sort.rs partial_sort:853 role): O(n log k)
        # instead of a full O(n log n) sort.  XLA TopK breaks ties by
        # ascending index, which IS the stable order; inverting the
        # ascending-encoded key makes "largest inverted" = smallest key.
        _, idx = jax.lax.top_k(~keys[0], limit)
        return idx.astype(jnp.uint32)
    idx = lexsort_order_traced(keys)
    return idx if limit is None else idx[:limit]


def lexsort_indices_fused(cols: Sequence[Column],
                          opts: Sequence[SortOptions],
                          limit: Optional[int] = None) -> jnp.ndarray:
    """One-jit sort indices for any mix of key columns."""
    kinds = tuple(key_kind(c) for c in cols)
    parts = tuple(key_parts(c, o) for c, o in zip(cols, opts))
    sopts = tuple((o.descending, o.nulls_first) for o in opts)
    return _lexsort_stage(kinds, sopts, parts, limit)
