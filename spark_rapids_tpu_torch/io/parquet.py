"""Parquet scan (the analog of ``spark_rapids_tpu/io/parquet.py``): pyarrow
reads the footers and decodes the pages on the host; the device scan
(``io/multifile.py TorchFileScanExec``) uploads what it reads.

- ``read_file`` (``:228``) reads the columns the plan names, with the
  session's predicate pushed down to pyarrow's dataset filter
  (``_expr_to_arrow_filter``, ``:25``) where it translates, and keeps
  string columns' dictionary pages encoded (``_dictionary_columns``,
  ``:209``) when encoding is on: pyarrow then hands back
  ``DictionaryArray``s, which stay ``HostDictionaryColumn``s up to the
  upload (``columnar/encoding.py``).
- Several files are reconciled into one read schema, with Spark's safe
  widenings (``_widen``, ``:69``); a file whose schema differs is cast to
  it, and loses its dictionaries (the cast works on plain arrays, as in
  the JAX package).
- The legacy datetime rebase (``_rebase_flags``, ``_adapt``: files that
  Spark wrote in the Julian hybrid calendar, or INT96 timestamps) is not
  ported and is refused by name; the port's writers write no such
  file."""

from __future__ import annotations

from typing import List, Optional, Sequence

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow
from spark_rapids_tpu_torch.expressions.base import Expression
from spark_rapids_tpu_torch.io.multifile import (AUTO, MultiFileScanBase,
                                                 TorchFileScanExec)


def _expr_to_arrow_filter(expr: Expression):
    """A predicate as a pyarrow dataset filter, where it translates
    (columns compared with literals under ``AND``/``OR``, ``IS NOT
    NULL``); None otherwise, and the filter runs after the scan."""
    import pyarrow.compute as pc
    from spark_rapids_tpu_torch.expressions import predicates as P
    from spark_rapids_tpu_torch.expressions.base import (AttributeReference,
                                                         BoundReference,
                                                         Literal)

    def leaf(e):
        if isinstance(e, (AttributeReference, BoundReference)):
            return pc.field(e.ref_name)
        if type(e) is Literal and e.value is not None:
            return e.value
        return None

    if isinstance(expr, P.And):
        a, b = (_expr_to_arrow_filter(c) for c in expr.children)
        return None if a is None or b is None else a & b
    if isinstance(expr, P.Or):
        a, b = (_expr_to_arrow_filter(c) for c in expr.children)
        return None if a is None or b is None else a | b
    ops = {P.EqualTo: lambda a, b: a == b, P.LessThan: lambda a, b: a < b,
           P.GreaterThan: lambda a, b: a > b,
           P.LessThanOrEqual: lambda a, b: a <= b,
           P.GreaterThanOrEqual: lambda a, b: a >= b}
    for cls, fn in ops.items():
        if type(expr) is cls:
            a, b = (leaf(c) for c in expr.children)
            if a is not None and b is not None and \
                    any(isinstance(x, pc.Expression) for x in (a, b)):
                return fn(a, b)
    if type(expr) is P.IsNotNull:
        a = leaf(expr.children[0])
        return a.is_valid() if isinstance(a, pc.Expression) else None
    return None


_LEGACY_DATETIME_TAG = b"org.apache.spark.legacyDateTime"
_LEGACY_INT96_TAG = b"org.apache.spark.legacyINT96"


def _widen(a, b):
    """The least common Arrow type of two files' columns (Spark's safe
    widenings: integer upcasts, float to double, integer and float to
    double); None when they do not reconcile."""
    import pyarrow as pa
    if a.equals(b):
        return a
    ints = [pa.int8(), pa.int16(), pa.int32(), pa.int64()]
    if a in ints and b in ints:
        return ints[max(ints.index(a), ints.index(b))]
    floats = [pa.float32(), pa.float64()]
    if a in floats and b in floats:
        return pa.float64()
    if (a in ints and b in floats) or (a in floats and b in ints):
        return pa.float64()
    if pa.types.is_timestamp(a) and pa.types.is_timestamp(b):
        return pa.timestamp("us")
    return None


class CpuParquetScan(MultiFileScanBase):
    """The host side of a parquet scan over ``paths`` (files, directories
    or globs), reading ``columns`` (all when None), with ``predicate``
    pushed down where it translates."""

    format_name = "parquet"
    file_ext = ".parquet"

    def __init__(self, paths: Sequence[str],
                 columns: Optional[List[str]] = None,
                 predicate: Optional[Expression] = None,
                 batch_rows: int = 1 << 20, reader_type: str = AUTO,
                 num_threads: int = 8):
        super().__init__(paths, reader_type=reader_type,
                         batch_rows=batch_rows, num_threads=num_threads)
        self.columns = None if columns is None else list(columns)
        self.predicate = predicate
        self._unified = None

    def unified_schema(self):
        """The read schema over every file's footer: the union of their
        columns, widened (a dictionary type is read as its values)."""
        if self._unified is not None:
            return self._unified
        import pyarrow as pa
        import pyarrow.parquet as pq
        fields: dict = {}
        order: List[str] = []
        for p in self.paths:
            for f in pq.read_schema(p):
                ftype = f.type.value_type \
                    if pa.types.is_dictionary(f.type) else f.type
                if f.name not in fields:
                    fields[f.name] = ftype
                    order.append(f.name)
                    continue
                w = _widen(fields[f.name], ftype)
                if w is None:
                    raise TypeError(
                        f"parquet schema evolution cannot reconcile column "
                        f"{f.name!r}: {fields[f.name]} vs {f.type} ({p})")
                fields[f.name] = w
        self._unified = pa.schema([pa.field(n, fields[n], nullable=True)
                                   for n in order])
        return self._unified

    def infer_schema(self) -> T.StructType:
        unified = self.unified_schema()
        names = unified.names if self.columns is None else self.columns
        missing = [n for n in names if n not in unified.names]
        if missing:
            raise KeyError(f"no column {missing} in {self.paths[0]} "
                           f"({unified.names})")
        return T.StructType([T.StructField(n, T.from_arrow(
            unified.field(n).type)) for n in names])

    def _check_rebase(self, f) -> None:
        md = f.metadata.metadata or {}
        psch = f.metadata.schema
        int96 = [psch.column(i).name for i in range(len(psch))
                 if psch.column(i).physical_type == "INT96"]
        if _LEGACY_DATETIME_TAG in md or _LEGACY_INT96_TAG in md or int96:
            raise NotImplementedError(
                "the legacy datetime rebase of parquet files (Julian hybrid "
                "dates, INT96 timestamps) is not in the port yet")

    def _dictionary_columns(self, f, file_cols, encoding):
        """The string columns whose dictionary pages stay encoded, when
        encoding is on."""
        import pyarrow as pa
        if encoding is None or not encoding.enabled:
            return None
        want = file_cols if file_cols is not None else \
            list(f.schema_arrow.names)
        out = [fld.name for fld in f.schema_arrow
               if fld.name in want and (pa.types.is_string(fld.type) or
                                        pa.types.is_large_string(fld.type))]
        return out or None

    def _adapt(self, tbl):
        """A table of a file whose schema differs, cast to the read
        schema (a column the file lacks is all null)."""
        import pyarrow as pa
        import pyarrow.compute as pc
        unified = self.unified_schema()
        names = unified.names if self.columns is None else self.columns
        cols = {}
        for name in names:
            want = unified.field(name).type
            if name in tbl.column_names:
                c = tbl.column(name).combine_chunks()
                if pa.types.is_dictionary(c.type):
                    c = c.dictionary_decode()
                cols[name] = c if c.type.equals(want) else \
                    pc.cast(c, want, safe=False)
            else:
                cols[name] = pa.nulls(tbl.num_rows, type=want)
        return pa.table(cols)

    def read_file(self, path: str, encoding=None):
        import pyarrow as pa
        import pyarrow.parquet as pq
        f = pq.ParquetFile(path)
        self._check_rebase(f)
        evolved = len(self.paths) > 1 and \
            not f.schema_arrow.equals(self.unified_schema())
        names = self.columns if self.columns is not None else \
            self.unified_schema().names
        file_cols = [c for c in names if c in set(f.schema_arrow.names)]
        flt = None if self.predicate is None else \
            _expr_to_arrow_filter(self.predicate)
        dict_cols = None if evolved else \
            self._dictionary_columns(f, file_cols, encoding)
        if flt is not None and not evolved:
            import pyarrow.dataset as ds
            fmt = ds.ParquetFileFormat(read_options=ds.ParquetReadOptions(
                dictionary_columns=set(dict_cols))) if dict_cols \
                else "parquet"
            scanner = ds.dataset(path, format=fmt).scanner(
                columns=file_cols, filter=flt, batch_size=self.batch_rows)
            for rb in scanner.to_batches():
                if rb.num_rows:
                    yield batch_from_arrow(pa.Table.from_batches([rb]))
            return
        if dict_cols:
            f.close()
            f = pq.ParquetFile(path, read_dictionary=dict_cols)
        for rb in f.iter_batches(batch_size=self.batch_rows,
                                 columns=file_cols):
            if not rb.num_rows:
                continue
            tbl = pa.Table.from_batches([rb])
            if evolved:
                tbl = self._adapt(tbl)
            yield batch_from_arrow(tbl)


class TorchParquetScanExec(TorchFileScanExec):
    """The device parquet scan (``TpuParquetScanExec``): the host scan's
    batches uploaded with the session's encoding settings."""
