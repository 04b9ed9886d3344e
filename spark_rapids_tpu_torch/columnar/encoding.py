"""Encoded columns: dictionary codes and RLE runs kept past the scan (the
analog of ``spark_rapids_tpu/columnar/encoding.py``).

- ``HostDictionaryColumn``: a host column that holds a pyarrow
  ``DictionaryArray`` (a parquet string column read with its dictionary
  pages kept); ``host_decoded`` gives the plain form to host consumers.
- ``Dictionary`` (``:99``): the values of a dictionary, cached once per
  content fingerprint in the process, with one device copy a device, so
  a dictionary crosses the bus once however many batches carry it.
- ``DictionaryColumn`` (``:230``): a device column whose data plane holds
  int32 codes; ``data_type`` stays the logical type.  ``RleColumn``
  (``:254``): run values, run validity and int32 exclusive run ends.
- ``classify_host_column`` (``:486``): the upload's choice per column,
  with the JAX package's four reasons to upload a dictionary plain
  (``valueType``, ``maxDictionarySize``, ``nullsInDictionary``,
  ``duplicateValues``); codes cross the bus in the narrowest integer
  type (``:550``) and are widened to int32 on the card.
- ``materialize``, ``materialize_batch``, ``materialize_rle_batch`` and
  ``align_batches`` (``:382-484``): every decode goes through kernel K16
  (``ops/decode_ops.py``).
- ``DictContains`` and ``plan_code_space`` (``:575-760``): a filter
  conjunct whose only column input is one dictionary column is evaluated
  once over the dictionary's values on the host, by the port's own plain
  evaluation, into a table of keep flags a code with the null verdict in
  front (``table[0]`` for a null row, ``table[1 + code]`` else), cached
  per (fingerprint, conjunct, literal values) and uploaded once; K5 and
  K1 then load ``table[valid ? code + 1 : 0]`` a row.  The table is a
  runtime argument of the kernel, so one compiled stage serves every
  dictionary and literal.  Unlike the JAX rule, which translates only
  the conjuncts of an ``AND``, the port also translates the operands of
  an ``OR`` (q7's ``p_channel_email = 'N' or p_channel_event = 'N'``):
  a row passes a Kleene ``AND`` or ``OR`` exactly when its operands'
  passes say so, so a pass flag per operand is enough.
- ``encoding_stats`` (``:74``), with the JAX package's counter names.

The power-of-two buckets of the JAX module (``bucket_rows``,
``table_bucket``, runs buckets) are a TPU static-shape workaround and
are not carried over."""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, HostColumn
from spark_rapids_tpu_torch.expressions.base import (BoundReference, Col,
                                                     EvalContext, Expression)

#: runs-per-row advantage below which an upload keeps a column plain
_RLE_MIN_RATIO = 8

_STATS_LOCK = threading.Lock()
_STATS = {
    "encoded_columns": 0,        # device columns that arrived encoded
    "rle_columns": 0,
    "encoded_bytes_in": 0,       # H2D bytes of codes, runs, dictionaries
    "encoded_bytes_out": 0,      # D2H bytes of codes
    "decode_avoided_bytes": 0,   # plain bytes the encoded uploads skipped
    "decoded_bytes": 0,          # bytes K16 wrote later
    "dict_fallbacks": 0,         # dictionaries uploaded plain, decodes
}
#: dictionaries uploaded plain, by reason
_FALLBACK_REASONS: Dict[str, int] = {}
#: K16 decodes by column name
_DECODED_COLUMNS: Dict[str, int] = {}


def encoding_stats() -> dict:
    """The counters (the JAX package's names), ``fallback_reasons`` (the
    upload fallbacks by reason) and ``decoded_columns`` (K16's decodes by
    column name)."""
    with _STATS_LOCK:
        out = dict(_STATS)
        out["fallback_reasons"] = dict(_FALLBACK_REASONS)
        out["decoded_columns"] = dict(_DECODED_COLUMNS)
        return out


def _note_decoded(name: str) -> None:
    with _STATS_LOCK:
        _DECODED_COLUMNS[name] = _DECODED_COLUMNS.get(name, 0) + 1


def _bump(**kv) -> None:
    with _STATS_LOCK:
        for k, v in kv.items():
            _STATS[k] += int(v)


@dataclasses.dataclass(frozen=True)
class EncodingSettings:
    """A session's ``spark.rapids.sql.encoding.*`` keys."""
    enabled: bool = True
    late_materialization: bool = True
    max_dictionary_size: int = 1 << 16
    rle_enabled: bool = False

    @staticmethod
    def of(conf) -> "EncodingSettings":
        from spark_rapids_tpu_torch import config as C
        return EncodingSettings(conf.get_bool(C.ENCODING_ENABLED),
                                conf.get_bool(C.ENCODING_LATE_MAT),
                                conf.get_int(C.ENCODING_MAX_DICT_SIZE),
                                conf.get_bool(C.ENCODING_RLE_ENABLED))


# -- host side ---------------------------------------------------------------

def host_decoded(arrow_array):
    """The plain (not dictionary) form of an Arrow array; the array itself
    when it is plain."""
    import pyarrow as pa
    if isinstance(arrow_array, pa.ChunkedArray):
        arrow_array = arrow_array.combine_chunks()
    if pa.types.is_dictionary(arrow_array.type):
        return arrow_array.dictionary_decode()
    return arrow_array


def decimal_words_of_arrow(arr, dt: T.DecimalType) -> np.ndarray:
    """The unscaled values of an Arrow decimal128 array, exactly: its
    16-byte little-endian words read as (lo, hi) int64 pairs; the lo word
    for a decimal64, (hi, lo) for a decimal128; 0 under a null."""
    import pyarrow as pa
    if not pa.types.is_decimal128(arr.type):
        raise TypeError(f"an Arrow {arr.type} array is not decimal128")
    n = len(arr)
    buf = arr.buffers()[1]
    words = np.frombuffer(buf, dtype=np.int64)[2 * arr.offset:
                                               2 * (arr.offset + n)] \
        .reshape(n, 2) if n else np.zeros((0, 2), dtype=np.int64)
    if arr.null_count:
        import pyarrow.compute as pc
        words = np.where(pc.is_valid(arr).to_numpy(
            zero_copy_only=False)[:, None], words, 0)
    if dt.is_decimal128:
        return np.ascontiguousarray(words[:, ::-1])
    return np.ascontiguousarray(words[:, 0])


def host_column_from_arrow(arr, dt: Optional[T.DataType] = None
                           ) -> HostColumn:
    """A plain ``HostColumn`` (numpy planes) of an Arrow array: zeros under
    nulls, a null string of length 0."""
    import pyarrow as pa
    import pyarrow.compute as pc
    arr = host_decoded(arr)
    dt = dt or T.from_arrow(arr.type)
    if isinstance(dt, T.ArrayType):
        raise NotImplementedError(
            f"an {dt} input column is not in the port yet (an array is an "
            "output of collect_list and collect_set only)")
    n = len(arr)
    validity = None
    if arr.null_count:
        validity = pc.is_valid(arr).to_numpy(zero_copy_only=False)
    if isinstance(dt, T.StringType):
        if arr.null_count:
            arr = pc.fill_null(arr, "")
        if pa.types.is_large_string(arr.type):
            odt = np.int64
        else:
            arr = arr.cast(pa.string()) if not pa.types.is_string(
                arr.type) else arr
            odt = np.int32
        bufs = arr.buffers()
        offs = np.frombuffer(bufs[1], dtype=odt)[arr.offset:
                                                 arr.offset + n + 1] \
            if n else np.zeros(1, dtype=odt)
        lo, hi = int(offs[0]), int(offs[-1])
        chars = np.frombuffer(bufs[2], dtype=np.uint8)[lo:hi].copy() \
            if bufs[2] is not None and hi > lo else \
            np.zeros(0, dtype=np.uint8)
        return HostColumn(chars, validity, T.STRING,
                          (offs - odt(lo)).astype(odt))
    if isinstance(dt, T.DecimalType):
        return HostColumn(decimal_words_of_arrow(arr, dt), validity, dt)
    if isinstance(dt, T.DateType):
        arr = arr.cast(pa.int32())
    if isinstance(dt, T.NullType):
        raise NotImplementedError("a column of the null type is not in the "
                                  "port yet")
    fill = False if isinstance(dt, T.BooleanType) else 0
    if arr.null_count:
        arr = pc.fill_null(arr, fill)
    data = arr.to_numpy(zero_copy_only=False).astype(dt.np_dtype,
                                                     copy=False)
    return HostColumn(data, validity, dt)


class HostDictionaryColumn:
    """A host column that holds a pyarrow ``DictionaryArray``: what a
    parquet scan reads from a string column's dictionary pages.  It
    slices as its indices; ``decoded`` is its plain ``HostColumn``."""

    __slots__ = ("arrow", "data_type")

    def __init__(self, arrow, data_type: Optional[T.DataType] = None):
        import pyarrow as pa
        if isinstance(arrow, pa.ChunkedArray):
            arrow = arrow.combine_chunks()
        if not pa.types.is_dictionary(arrow.type):
            raise TypeError(f"a dictionary column needs a DictionaryArray, "
                            f"got {arrow.type}")
        self.arrow = arrow
        self.data_type = data_type or T.from_arrow(arrow.type)

    def __len__(self) -> int:
        return len(self.arrow)

    @property
    def offsets(self):
        return None

    def slice(self, start: int, length: int) -> "HostDictionaryColumn":
        return HostDictionaryColumn(self.arrow.slice(start, length),
                                    self.data_type)

    def decoded(self) -> HostColumn:
        return host_column_from_arrow(self.arrow, self.data_type)

    def to_pylist(self) -> List:
        return self.decoded().to_pylist()


def decoded_host_column(col) -> HostColumn:
    """``col`` as a plain host column."""
    return col.decoded() if isinstance(col, HostDictionaryColumn) else col


# -- dictionaries -------------------------------------------------------------

_DICT_CACHE: "OrderedDict[tuple, Dictionary]" = OrderedDict()
_DICT_CACHE_MAX = 256
#: byte bound on the cached dictionaries' host values (their device copies
#: track them about one to one)
_DICT_CACHE_MAX_BYTES = 64 << 20
_DICT_LOCK = threading.Lock()


class Dictionary:
    """The values of a dictionary-encoded column, content-addressed: two
    row groups or files that write the same dictionary share one
    instance.  The host values stay resident (the lookup tables and the
    download read them); the device copy is made once a device, at first
    use."""

    def __init__(self, values, fingerprint: tuple):
        self.values = values            # a pyarrow Array with no null
        self.fingerprint = fingerprint
        self.size = len(values)
        self.value_type = T.from_arrow(values.type)
        self._host: Optional[HostColumn] = None
        self._dev: Dict[str, DeviceColumn] = {}
        self._tables: Dict[tuple, torch.Tensor] = {}
        self._lock = threading.Lock()

    @staticmethod
    def fingerprint_of(values) -> tuple:
        h = hashlib.sha1()
        for buf in values.buffers():
            if buf is not None:
                h.update(memoryview(buf))
        return (h.hexdigest(), len(values), str(values.type))

    @classmethod
    def of(cls, values) -> "Dictionary":
        """The cached ``Dictionary`` of an Arrow values array (LRU, bounded
        by count and bytes)."""
        fp = cls.fingerprint_of(values)
        with _DICT_LOCK:
            hit = _DICT_CACHE.get(fp)
            if hit is not None:
                _DICT_CACHE.move_to_end(fp)
                return hit
        dic = cls(values, fp)
        with _DICT_LOCK:
            _DICT_CACHE[fp] = dic
            total = sum(d.value_nbytes for d in _DICT_CACHE.values())
            while len(_DICT_CACHE) > 1 and (
                    len(_DICT_CACHE) > _DICT_CACHE_MAX or
                    total > _DICT_CACHE_MAX_BYTES):
                _k, evicted = _DICT_CACHE.popitem(last=False)
                total -= evicted.value_nbytes
        return dic

    @property
    def value_nbytes(self) -> int:
        return sum(b.size for b in self.values.buffers() if b is not None)

    def host_column(self) -> HostColumn:
        with self._lock:
            if self._host is None:
                self._host = host_column_from_arrow(self.values,
                                                    self.value_type)
            return self._host

    def device_values(self, transfers) -> DeviceColumn:
        """The values on ``transfers``' device, uploaded at the first call
        for that device (counted in ``encoded_bytes_in``)."""
        key = str(transfers.device)
        with self._lock:
            hit = self._dev.get(key)
        if hit is not None:
            return hit
        host = self.host_column()
        dev = transfers.upload_column(host)
        with self._lock:
            if key not in self._dev:
                self._dev[key] = dev
                _bump(encoded_bytes_in=_nbytes(dev))
            return self._dev[key]

    def lookup_table(self, key: tuple, build) -> torch.Tensor:
        """The device table of one translated conjunct, built once a key
        (the key names the device)."""
        with self._lock:
            hit = self._tables.get(key)
        if hit is not None:
            return hit
        table = build()
        with self._lock:
            return self._tables.setdefault(key, table)

    def __repr__(self):
        return (f"Dictionary(size={self.size}, {self.value_type}, "
                f"fp={self.fingerprint[0][:8]})")


def _nbytes(col: DeviceColumn) -> int:
    n = col.data.numel() * col.data.element_size() + col.validity.numel()
    if col.offsets is not None:
        n += col.offsets.numel() * col.offsets.element_size()
    return n


def reassemble_host_dictionary(codes_np: np.ndarray, valid_np: np.ndarray,
                               dic: Dictionary, dt: T.DataType
                               ) -> HostDictionaryColumn:
    """The host dictionary column of downloaded codes and validity (null
    rows masked; an empty dictionary gets one null value so the Arrow
    array can be built)."""
    import pyarrow as pa
    codes = codes_np.astype(np.int32, copy=False)
    valid = valid_np.astype(np.bool_, copy=False)
    _bump(encoded_bytes_out=codes.nbytes + valid.nbytes)
    idx = pa.array(np.where(valid, codes, 0), type=pa.int32(),
                   mask=~valid)
    values = dic.values if dic.size else pa.nulls(1, type=dic.values.type)
    return HostDictionaryColumn(pa.DictionaryArray.from_arrays(idx, values),
                                dt)


# -- device columns -----------------------------------------------------------

class DictionaryColumn(DeviceColumn):
    """A device column whose ``data`` plane holds int32 dictionary codes;
    ``data_type`` stays the logical type.  Only the encoding-aware paths
    (K5's and K1's code-space conjuncts, column selection, gathers of
    the codes, the download) read the codes; every other operator sees
    the column decoded by ``materialize`` (``plan/encoding.py`` puts the
    decode in front of it)."""

    __slots__ = ("dictionary",)

    def __init__(self, codes: torch.Tensor, validity: torch.Tensor,
                 data_type: T.DataType, dictionary: Dictionary,
                 all_valid: bool = False):
        if codes.dtype != torch.int32 or codes.dim() != 1:
            raise TypeError("dictionary codes are a 1-D int32 tensor")
        if validity.dtype != torch.bool or \
                tuple(validity.shape) != tuple(codes.shape):
            raise TypeError("validity must be a bool tensor of one flag per "
                            "row")
        self.data = codes
        self.validity = validity
        self.data_type = data_type
        self.all_valid = all_valid
        self.offsets = None
        self.dictionary = dictionary

    def codes_column(self) -> DeviceColumn:
        """The codes as a plain INT column (for gathers and concats)."""
        return DeviceColumn(self.data, self.validity, T.INT, self.all_valid)

    def with_codes(self, col: DeviceColumn) -> "DictionaryColumn":
        """This column's encoding over ``col``'s codes (a gather's or a
        concat's output)."""
        return DictionaryColumn(col.data, col.validity, self.data_type,
                                self.dictionary, col.all_valid)

    def __repr__(self):
        return (f"DictionaryColumn({self.data_type}, rows={self.row_count}, "
                f"{self.dictionary!r})")


class RleColumn(DeviceColumn):
    """A fixed-width column as runs: ``data`` holds the run values,
    ``validity`` the run validity and ``run_ends`` the int32 exclusive
    row end of each run.  Every row-shaped consumer materializes it
    first."""

    __slots__ = ("run_ends", "n_rows")

    def __init__(self, values: torch.Tensor, validity: torch.Tensor,
                 run_ends: torch.Tensor, n_rows: int, data_type: T.DataType):
        if values.dtype != data_type.torch_dtype or values.dim() != 1:
            raise TypeError(f"runs of {data_type} need a 1-D "
                            f"{data_type.torch_dtype} tensor")
        if run_ends.dtype != torch.int32 or \
                tuple(run_ends.shape) != tuple(values.shape) or \
                tuple(validity.shape) != tuple(values.shape):
            raise TypeError("run ends (int32) and validity: one a run")
        self.data = values
        self.validity = validity
        self.data_type = data_type
        self.all_valid = False
        self.offsets = None
        self.run_ends = run_ends
        self.n_rows = int(n_rows)

    @property
    def row_count(self) -> int:
        return self.n_rows

    def __repr__(self):
        return (f"RleColumn({self.data_type}, rows={self.n_rows}, "
                f"runs={self.data.shape[0]})")


def is_encoded(col) -> bool:
    return isinstance(col, (DictionaryColumn, RleColumn))


def batch_has_encoded(batch) -> bool:
    return any(is_encoded(c) for c in batch.columns)


# -- upload classification ----------------------------------------------------

def _narrow_code_dtype(size: int):
    """The narrowest type the codes cross the bus in (int32 on the
    card)."""
    if size <= (1 << 7):
        return np.dtype(np.int8)
    if size <= (1 << 15):
        return np.dtype(np.int16)
    return np.dtype(np.int32)


def _note_fallback(reason: str) -> None:
    with _STATS_LOCK:
        _STATS["dict_fallbacks"] += 1
        _FALLBACK_REASONS[reason] = _FALLBACK_REASONS.get(reason, 0) + 1


def classify_host_column(col, settings: EncodingSettings):
    """The upload's choice for one host column:

    - ``("dict", Dictionary, codes, valid)``: keep it encoded (codes in
      the narrowest integer type, zero under a null);
    - ``("rle", values, valid, ends)``: ship runs (RLE on, a fixed-width
      column of at least 64 rows and at most a run per 8 rows);
    - ``None``: upload it plain (a dictionary column is decoded on the
      host first, ``decoded_host_column``), counting the reason a
      dictionary was refused."""
    import pyarrow.compute as pc
    if isinstance(col, HostDictionaryColumn):
        if not settings.enabled:
            return None
        values = col.arrow.dictionary
        reason = None
        try:
            vt = T.from_arrow(values.type)
        except NotImplementedError:
            vt = None
        if vt is None or isinstance(vt, T.NullType):
            reason = "valueType"
        elif len(values) > settings.max_dictionary_size:
            reason = "maxDictionarySize"
        elif values.null_count:
            reason = "nullsInDictionary"
        elif len(values) and pc.count_distinct(values).as_py() != \
                len(values):
            # repeated values would break equality of codes
            reason = "duplicateValues"
        if reason is not None:
            _note_fallback(reason)
            return None
        dic = Dictionary.of(values)
        arr = col.arrow
        valid = pc.is_valid(arr).to_numpy(zero_copy_only=False)
        codes = pc.fill_null(arr.indices, 0).to_numpy(zero_copy_only=False)
        return ("dict", dic, codes.astype(_narrow_code_dtype(dic.size),
                                          copy=False), valid)
    if settings.enabled and settings.rle_enabled and \
            isinstance(col, HostColumn) and col.offsets is None and \
            col.data_type.np_dtype is not None and len(col) >= 64:
        vals = col.data
        valid = np.ones(len(vals), dtype=bool) if col.validity is None \
            else col.validity
        change = np.empty(len(vals), dtype=bool)
        change[0] = True
        np.not_equal(vals[1:], vals[:-1], out=change[1:])
        change[1:] |= valid[1:] != valid[:-1]
        starts = np.flatnonzero(change)
        if len(starts) * _RLE_MIN_RATIO <= len(vals):
            ends = np.empty(len(starts), dtype=np.int32)
            ends[:-1] = starts[1:]
            ends[-1] = len(vals)
            return ("rle", vals[starts], valid[starts], ends)
    return None


def upload_encoded(col, settings: EncodingSettings, transfers
                   ) -> Optional[DeviceColumn]:
    """The device column of an encoded upload of ``col``, or None when it
    goes up plain: the codes cross in their narrow type and are widened to
    int32 on the card; a dictionary crosses once a device
    (``Dictionary.device_values``)."""
    enc = classify_host_column(col, settings)
    if enc is None:
        return None
    n = len(col)
    if enc[0] == "dict":
        _k, dic, codes, valid = enc
        dev_codes = transfers.to_device(codes).to(torch.int32)
        all_valid = bool(valid.all())
        dev_valid = torch.ones(n, dtype=torch.bool,
                               device=transfers.device) if all_valid \
            else transfers.to_device(valid)
        dic.device_values(transfers)
        sent = codes.nbytes + (0 if all_valid else valid.nbytes)
        per_row = dic.value_nbytes / max(dic.size, 1)
        _bump(encoded_columns=1, encoded_bytes_in=sent,
              decode_avoided_bytes=max(0, int(n * per_row) + 4 * (n + 1) -
                                       sent))
        return DictionaryColumn(dev_codes, dev_valid, col.data_type, dic,
                                all_valid)
    _k, vals, rvalid, ends = enc
    out = RleColumn(transfers.to_device(vals), transfers.to_device(rvalid),
                    transfers.to_device(ends), n, col.data_type)
    sent = vals.nbytes + rvalid.nbytes + ends.nbytes
    _bump(rle_columns=1, encoded_bytes_in=sent,
          decode_avoided_bytes=max(0, n * col.data.itemsize + n - sent))
    return out


# -- decode (K16) --------------------------------------------------------------

def materialize(col: DeviceColumn, transfers) -> DeviceColumn:
    """``col`` decoded through K16 (a plain column as it is); the decoded
    bytes are counted, and each decode forced by an operator counts as a
    fallback, as in the JAX package."""
    from spark_rapids_tpu_torch.ops import decode_ops
    if isinstance(col, DictionaryColumn):
        out = decode_ops.decode_dictionary(
            col.data, None if col.all_valid else col.validity,
            col.dictionary.device_values(transfers), transfers)
    elif isinstance(col, RleColumn):
        out = decode_ops.decode_rle(col.data, col.validity, col.run_ends,
                                    col.n_rows, col.data_type)
    else:
        return col
    _bump(dict_fallbacks=1, decoded_bytes=_nbytes(out))
    return out


def materialize_batch(batch, transfers,
                      ordinals: Optional[Sequence[int]] = None):
    """``batch`` with the chosen (default: every) encoded column decoded;
    the batch itself when nothing decodes."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    want = range(len(batch.columns)) if ordinals is None else ordinals
    want = {i for i in want if is_encoded(batch.columns[i])}
    if not want:
        return batch
    for i in want:
        _note_decoded(batch.names[i])
    cols = [materialize(c, transfers) if i in want else c
            for i, c in enumerate(batch.columns)]
    return ColumnarBatch(cols, batch.row_count, batch.names)


def materialize_rle_batch(batch, transfers):
    """Row work reads dictionary codes as int planes but not runs: the
    batch with its RLE columns decoded."""
    return materialize_batch(batch, transfers, [
        i for i, c in enumerate(batch.columns) if isinstance(c, RleColumn)])


def align_batches(batches: List, transfers) -> List:
    """Batches safe to join column by column: runs decode, and a
    dictionary column keeps its codes only where every batch carries the
    same dictionary there (else it decodes in every batch)."""
    batches = [materialize_rle_batch(b, transfers) for b in batches]
    if not batches:
        return batches
    bad = []
    for ci in range(len(batches[0].columns)):
        cols = [b.columns[ci] for b in batches]
        encs = [c for c in cols if isinstance(c, DictionaryColumn)]
        if encs and (len(encs) != len(cols) or
                     len({c.dictionary.fingerprint for c in encs}) != 1):
            bad.append(ci)
    if not bad:
        return batches
    return [materialize_batch(b, transfers, bad) for b in batches]


def concat_encoded(batches: List, transfers):
    """One batch of ``batches`` (K7c), dictionary columns kept where every
    batch shares the dictionary (their codes are concatenated as int
    planes), the rest decoded first."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.ops.batch_ops import concat_batches
    batches = align_batches(batches, transfers)
    first = batches[0]
    shadows = [ColumnarBatch([c.codes_column() if isinstance(
        c, DictionaryColumn) else c for c in b.columns], b.row_count,
        b.names) for b in batches]
    whole = concat_batches(shadows)
    cols = [p.with_codes(c) if isinstance(p, DictionaryColumn) else c
            for p, c in zip(first.columns, whole.columns)]
    return ColumnarBatch(cols, whole.row_count, whole.names)


# -- code-space predicates ------------------------------------------------------

class DictContains(Expression):
    """A translated conjunct: ``table[valid ? code + 1 : 0] != 0``, where
    ``table`` (runtime table ``slot``, uint8) holds the conjunct's verdict
    on a null row in front of its verdict on each dictionary value.  The
    child is the codes column read as INT.  Never null: the flag is "the
    conjunct is true", which is all a filter keeps."""

    def __init__(self, codes: Expression, slot: int):
        super().__init__([codes])
        self.slot = slot

    @property
    def data_type(self):
        return T.BOOLEAN

    @property
    def nullable(self):
        return False

    def sql(self):
        return f"dict_contains({self.children[0].sql()}, $tab{self.slot})"

    def eval(self, ctx: EvalContext) -> Col:
        c = self.children[0].eval(ctx)
        table = ctx.tables[self.slot]
        idx = torch.where(c.valid, c.data.to(torch.int64) + 1, 0)
        keep = table[idx] != 0
        return Col(keep, torch.ones_like(keep))


def _refs(e: Expression) -> List[int]:
    if isinstance(e, BoundReference):
        return [e.ordinal]
    return [r for c in e.children for r in _refs(c)]


@dataclasses.dataclass
class CodeSpacePlan:
    """How one fused chain reads one batch's encodings: ``kept`` are the
    dictionary columns read as codes (through ``conditions``' lookups or
    passed through), ``decode`` the encoded columns K16 decodes first,
    ``conditions`` the chain's predicates with translated conjuncts, and
    ``slots`` each table's ``(input ordinal, conjunct)``."""
    kept: Tuple[int, ...]
    decode: Tuple[int, ...]
    conditions: List[Expression]
    slots: List[Tuple[int, Expression]]

    @property
    def signature(self) -> tuple:
        return (self.kept, self.decode,
                tuple(c.sql() for c in self.conditions))


def plan_code_space(conditions: Sequence[Expression],
                    value_exprs: Sequence[Expression], batch
                    ) -> Optional[CodeSpacePlan]:
    """The code-space plan of a chain over ``batch`` (the JAX package's
    ``plan_fused_stage``, ``:752``): ``value_exprs`` (computed outputs,
    update inputs) need the values of every column they read; a
    maximal subtree of a condition, reached through ``AND`` and ``OR``
    only, that reads one dictionary column and nothing else becomes a
    ``DictContains`` lookup; any other read of a dictionary column
    decodes it.  None when the batch holds no encoded column."""
    from spark_rapids_tpu_torch.expressions import predicates as P
    dict_in = {i for i, c in enumerate(batch.columns)
               if isinstance(c, DictionaryColumn)}
    rle_in = {i for i, c in enumerate(batch.columns)
              if isinstance(c, RleColumn)}
    if not dict_in and not rle_in:
        return None
    decode = set(rle_in)
    for e in value_exprs:
        decode |= set(_refs(e)) & dict_in
    while True:
        kept = dict_in - decode
        slots: List[Tuple[int, Expression]] = []
        extra: set = set()

        def visit(e: Expression) -> Expression:
            refs = set(_refs(e))
            enc = refs & kept
            if not enc:
                return e
            if len(refs) == 1 and isinstance(e.data_type, T.BooleanType):
                o = enc.pop()
                slots.append((o, e))
                return DictContains(BoundReference(o, T.INT, True,
                                                   f"codes{o}"),
                                    len(slots) - 1)
            if isinstance(e, (P.And, P.Or)):
                return e.with_children([visit(c) for c in e.children])
            extra.update(enc)
            return e

        translated = [visit(c) for c in conditions]
        if not extra:
            return CodeSpacePlan(tuple(sorted(kept)), tuple(sorted(decode)),
                                 translated, slots)
        decode |= extra


def _conjunct_keep(expr: Expression, ordinal: int, values: HostColumn,
                   literal_values) -> np.ndarray:
    """``expr`` over the host values at input ``ordinal``, with the port's
    plain evaluation on the CPU: true where the conjunct is true (false
    and null both drop, as the row filter drops them)."""
    n = len(values)
    offsets = None if values.offsets is None else \
        torch.from_numpy(values.offsets.astype(np.int64))
    valid = torch.ones(n, dtype=torch.bool) if values.validity is None \
        else torch.from_numpy(values.validity.copy())
    cols: List = [None] * (ordinal + 1)
    cols[ordinal] = Col(torch.from_numpy(values.data.copy()), valid,
                        offsets)
    r = expr.eval(EvalContext(cols, n, torch.device("cpu"),
                              literal_values))
    keep = r.data.to(torch.bool) & r.valid
    return keep.expand(n).numpy() if keep.dim() == 0 else keep.numpy()


def lookup_table(dic: Dictionary, expr: Expression, ordinal: int,
                 literal_values, transfers) -> torch.Tensor:
    """The device table of one translated conjunct (``DictContains``):
    uint8 flags, the null verdict (the conjunct over one null value: an
    ``IS NULL`` keeps null rows) then one a value; cached on the
    dictionary per (conjunct, literal values, device) and uploaded
    once."""
    key = (expr.sql(), tuple(repr(v) for v in literal_values or ()),
           str(transfers.device))

    def build():
        host = dic.host_column()
        null = HostColumn(np.zeros(0, dtype=np.uint8), np.zeros(1, bool),
                          T.STRING, np.zeros(2, dtype=np.int32)) \
            if isinstance(dic.value_type, T.StringType) else \
            HostColumn(np.zeros(1, dtype=dic.value_type.np_dtype),
                       np.zeros(1, bool), dic.value_type)
        table = np.zeros(dic.size + 1, dtype=np.uint8)
        table[0] = _conjunct_keep(expr, ordinal, null, literal_values)[0]
        if dic.size:
            table[1:] = _conjunct_keep(expr, ordinal, host, literal_values)
        return transfers.to_device(table)

    return dic.lookup_table(key, build)


def encoded_inputs(plan: CodeSpacePlan, batch, literal_values, transfers):
    """``(batch, tables)`` for a chain planned by ``plan``: the decoded
    columns through K16, the kept dictionary columns as their INT codes;
    one device table a slot."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    tables = [lookup_table(batch.columns[o].dictionary, e, o,
                           literal_values, transfers)
              for o, e in plan.slots]
    cols = []
    for i, c in enumerate(batch.columns):
        if i in plan.decode:
            _note_decoded(batch.names[i])
            c = materialize(c, transfers)
        elif isinstance(c, DictionaryColumn):
            c = c.codes_column()
        cols.append(c)
    return ColumnarBatch(cols, batch.row_count, batch.names), tables
