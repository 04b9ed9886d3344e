"""ScaleTest: the stress-query suite and its runner (the port of
``spark_rapids_tpu/testing/scaletest.py``, the analog of the plugin's
``ScaleTest.scala``).

    python -m spark_rapids_tpu_torch.testing.scaletest [rows]

runs the 24 queries once each on the card (``TorchSession()``, which
raises without one) over tables of ``rows`` fact rows (100,000 by
default) in 2 partitions, prints the report as JSON and exits 1 if any
query failed.  The tables come from ``testing/datagen.py``, which gives
the JAX generators' values for the same seed, so ``build_tables`` here
and in the JAX package hold the same rows.  The queries are the JAX
suite's, in its order and under its names, written with the port's
expression classes (the port's expressions take no Python operators).

A report entry keeps the JAX fields (``query``, ``iteration``, ``rows``,
``status``, ``seconds``); ``rows`` is the downloaded batch's row count
(a join at 500,000 fact rows gives 2.1e7 rows, and a dict a row would be
the whole run)."""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional, Tuple

from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
from spark_rapids_tpu_torch.ops import string_ops as SO
from spark_rapids_tpu_torch.testing.datagen import (DateGen, DoubleGen,
                                                    IntegerGen, LongGen,
                                                    StringGen, gen_df)


def table_specs(scale_rows: int = 10_000, seed: int = 7):
    """``{name: (generators, rows, seed, partitioned)}`` of the suite's
    tables (the JAX ``build_tables``, ``:23-46``): a fact table and two
    dimensions with skewed keys."""
    return {
        "fact": ([("key", LongGen(nullable=False, min_val=0,
                                  max_val=max(1, scale_rows // 10))),
                  ("key2", IntegerGen(min_val=0, max_val=100)),
                  ("v1", DoubleGen()),
                  ("v2", LongGen(min_val=-1000, max_val=1000)),
                  ("s", StringGen(max_len=12)),
                  ("d", DateGen())], scale_rows, seed, True),
        "dim": ([("key", LongGen(nullable=False, min_val=0,
                                 max_val=max(1, scale_rows // 10))),
                 ("name", StringGen(nullable=False, max_len=8)),
                 ("weight", DoubleGen(no_nans=True))],
                max(10, scale_rows // 10), seed + 1, True),
        "dim2": ([("key2", IntegerGen(nullable=False, min_val=0,
                                      max_val=100)),
                  ("grp", StringGen(nullable=False, max_len=4))],
                 101, seed + 2, False),
    }


def build_tables(session, scale_rows: int = 10_000, seed: int = 7,
                 parts: int = 2) -> Dict[str, object]:
    """The suite's input tables as DataFrames: ``fact`` and ``dim`` in
    ``parts`` partitions, ``dim2`` in one."""
    return {name: gen_df(session, gens, length=n, seed=s,
                         num_partitions=parts if split else 1)
            for name, (gens, n, s, split) in
            table_specs(scale_rows, seed).items()}


def _queries() -> List[Tuple[str, Callable]]:
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.arithmetic import Multiply
    from spark_rapids_tpu_torch.expressions.predicates import (GreaterThan,
                                                               LessThan)
    from spark_rapids_tpu_torch.functions import Window

    def q_agg_sum(t):
        return (t["fact"].group_by("key2")
                .agg(Alias(F.sum(col("v1")), "sv"),
                     Alias(F.count(col("v2")), "c")))

    def q_agg_multi(t):
        return (t["fact"].group_by("key2")
                .agg(Alias(F.min(col("v2")), "mn"),
                     Alias(F.max(col("v2")), "mx"),
                     Alias(F.avg(col("v1")), "av")))

    def q_join_inner(t):
        return t["fact"].join(t["dim"], on="key", how="inner") \
            .select(col("key"), col("name"), col("v1"))

    def q_join_left(t):
        return t["fact"].join(t["dim"], on="key", how="left")

    def q_join_two(t):
        return (t["fact"].join(t["dim"], on="key", how="inner")
                .join(t["dim2"], on="key2", how="inner")
                .group_by("grp").agg(Alias(F.sum(col("weight")), "w")))

    def q_sort_limit(t):
        return t["fact"].order_by("v2", ascending=False).limit(100)

    def q_filter_project(t):
        return (t["fact"].filter(GreaterThan(col("v2"), lit(0)))
                .select(Alias(Multiply(col("v1"), lit(2.0)), "v"),
                        Alias(F.length(col("s")), "sl")))

    def q_distinct(t):
        return t["fact"].select(col("key2")).distinct()

    def q_window_rank(t):
        spec = Window.partition_by("key2").order_by("v2")
        return t["fact"].select(col("key2"), col("v2"),
                                Alias(F.rank().over(spec), "r"))

    def q_union_count(t):
        return t["fact"].union(t["fact"]).group_by("key2").count()

    def q_join_full(t):
        return t["fact"].join(t["dim"], on="key", how="full")

    def q_join_semi(t):
        return t["fact"].join(t["dim"], on="key", how="semi")

    def q_join_anti(t):
        return t["fact"].join(t["dim"], on="key", how="anti")

    def q_window_running_sum(t):
        spec = (Window.partition_by("key2").order_by("v2")
                .rows_between(Window.unboundedPreceding, Window.currentRow))
        return t["fact"].select(col("key2"), col("v2"),
                                Alias(F.sum(col("v1")).over(spec), "rs"))

    def q_window_bounded(t):
        spec = (Window.partition_by("key2").order_by("v2")
                .rows_between(-3, 3))
        return t["fact"].select(col("key2"), col("v2"),
                                Alias(F.avg(col("v1")).over(spec), "ma"))

    def q_window_lag_lead(t):
        spec = Window.partition_by("key2").order_by("v2")
        return t["fact"].select(col("key2"), col("v2"),
                                Alias(F.lag(col("v2"), 1).over(spec), "lg"),
                                Alias(F.lead(col("v2"), 1).over(spec), "ld"))

    def q_rollup(t):
        return (t["fact"].rollup("key2", "s")
                .agg(Alias(F.sum(col("v1")), "sv")))

    def q_count_distinct(t):
        return (t["fact"].group_by("key2")
                .agg(Alias(F.count_distinct(col("v2")), "cd")))

    def q_collect(t):
        return (t["fact"].group_by("key2")
                .agg(Alias(F.collect_set(col("v2")), "cs")))

    def q_string_ops(t):
        return (t["fact"]
                .select(Alias(F.upper(col("s")), "u"),
                        Alias(F.substring(col("s"), 1, 4), "pre"),
                        Alias(F.concat(col("s"), lit("_x")), "c"))
                .group_by("pre").count())

    def q_skew_join(t):
        # every fact row keyed to ONE dim key: worst-case join skew
        skewed = t["fact"].select(Alias(Multiply(col("key"), lit(0)),
                                        "key"), col("v1"))
        return skewed.join(t["dim"], on="key", how="inner") \
            .group_by("name").agg(Alias(F.sum(col("v1")), "sv"))

    def q_intersect(t):
        a = t["fact"].filter(GreaterThan(col("v2"), lit(0))) \
            .select(col("key2"))
        b = t["fact"].filter(LessThan(col("v2"), lit(500))) \
            .select(col("key2"))
        return a.intersect(b)

    def q_range_sort(t):
        return t["fact"].order_by("v1")

    def q_date_agg(t):
        return (t["fact"].group_by("d")
                .agg(Alias(F.count(col("v1")), "c"))
                .order_by("d").limit(50))

    return [("agg_sum", q_agg_sum), ("agg_multi", q_agg_multi),
            ("join_inner", q_join_inner), ("join_left", q_join_left),
            ("join_two_dims", q_join_two), ("sort_limit", q_sort_limit),
            ("filter_project", q_filter_project), ("distinct", q_distinct),
            ("window_rank", q_window_rank), ("union_count", q_union_count),
            ("join_full", q_join_full), ("join_semi", q_join_semi),
            ("join_anti", q_join_anti),
            ("window_running_sum", q_window_running_sum),
            ("window_bounded", q_window_bounded),
            ("window_lag_lead", q_window_lag_lead),
            ("rollup", q_rollup), ("count_distinct", q_count_distinct),
            ("collect_set", q_collect), ("string_ops", q_string_ops),
            ("skew_join", q_skew_join), ("intersect", q_intersect),
            ("range_sort", q_range_sort), ("date_agg", q_date_agg)]


QUERY_NAMES = [name for name, _q in _queries()]


#: the double columns that sum or average ``v1`` (or ``weight``): the
#: engines add in other orders, and ``v1`` (a signed normal at 1e6 with
#: NaN, +-inf and +-0.0) cancels towards zero
SUMS = {"agg_sum": ["sv"], "agg_multi": ["av"], "join_two_dims": ["w"],
        "window_running_sum": ["rs"], "window_bounded": ["ma"],
        "rollup": ["sv"], "skew_join": ["sv"]}
#: a sum or mean of v1 agrees within this share of the sum (mean) of
#: |v1| over the same group or frame
TOLERANCE = 1e-9


def abs_tables(session, scale_rows: int = 10_000, seed: int = 7,
               parts: int = 2) -> Dict[str, object]:
    """``build_tables`` with ``v1`` and ``weight`` as their magnitudes
    (NaN and inf as 0): a query over them gives the sum (or mean) of |v1|
    of each group or frame, the tolerance of ``rows_agree``."""
    import numpy as np
    from spark_rapids_tpu_torch.testing.datagen import gen_batch
    out = {}
    for name, (gens, n, s, split) in table_specs(scale_rows, seed).items():
        hb = gen_batch(gens, n, s)
        for c, cname in zip(hb.columns, hb.names):
            if cname in ("v1", "weight"):
                d = np.abs(c.data)
                d[~np.isfinite(d)] = 0.0
                c.data = d
        out[name] = session.create_dataframe(
            hb, num_partitions=parts if split else 1)
    return out


def _canon(v):
    import math
    if isinstance(v, float):
        return ("nan",) if math.isnan(v) else ("f", v)
    if isinstance(v, list):
        return ("list",) + tuple(sorted(_canon(x) for x in v))
    return ("none",) if v is None else (type(v).__name__, v)


def _row_key(r: dict, skip) -> tuple:
    return tuple(_canon(v) for k, v in r.items() if k not in skip)


def rows_agree(name: str, got: List[dict], ref: List[dict],
               bounds: Optional[List[dict]] = None) -> Optional[str]:
    """None when ``got`` and ``ref`` hold the same rows of query ``name``,
    else the first difference.  Every column but the ``SUMS`` ones is
    compared exactly, as a multiset of rows (a collect_set's values
    sorted); a ``SUMS`` column, after a stable sort on the exact columns
    lines the rows up (window rows keep the order both engines give
    them), within ``TOLERANCE`` of ``bounds`` (the same query's rows over
    ``abs_tables``, in ``got``'s order), a NaN, an inf or a null
    exactly."""
    import math
    if len(got) != len(ref):
        return f"{name}: {len(got)} rows vs {len(ref)}"
    sums = SUMS.get(name, [])
    keys_got = [_row_key(r, sums) for r in got]
    keys_ref = [_row_key(r, sums) for r in ref]
    if sorted(keys_got) != sorted(keys_ref):
        return f"{name}: the exact columns differ"
    if not sums:
        return None
    if bounds is None or [_row_key(r, sums) for r in bounds] != keys_got:
        return f"{name}: the |v1| rows do not line up with the rows"
    order_got = sorted(range(len(got)), key=keys_got.__getitem__)
    order_ref = sorted(range(len(ref)), key=keys_ref.__getitem__)
    for i, j in zip(order_got, order_ref):
        for c in sums:
            a, b = got[i][c], ref[j][c]
            if a is None or b is None:
                ok = a is None and b is None
            elif not (math.isfinite(a) and math.isfinite(b)):
                ok = a == b or (a != a and b != b)
            else:
                ok = abs(a - b) <= TOLERANCE * (bounds[i][c] or 0.0)
            if not ok:
                return f"{name}.{c}: {got[i]} vs {ref[j]} (|v1| " \
                    f"{bounds[i][c]})"
    return None


def run_query(query: Callable, tables) -> Tuple[object, float]:
    """``(host batch, seconds)`` of one query's action: the plan, its run
    on the device and the one download."""
    t0 = time.perf_counter()
    batch = query(tables).collect_batch()
    return batch, time.perf_counter() - t0


def run_scale_test(session, scale_rows: int = 10_000, seed: int = 7,
                   iterations: int = 1,
                   queries: Optional[List[str]] = None,
                   tables: Optional[Dict[str, object]] = None,
                   parts: int = 2) -> List[dict]:
    """Runs the suite (each picked query ``iterations`` times in turn)
    over ``tables`` (``build_tables`` of ``scale_rows``, ``seed`` and
    ``parts`` when not given); returns the per-query reports."""
    if tables is None:
        tables = build_tables(session, scale_rows, seed, parts)
    picked = _queries()
    if queries:
        picked = [(n, q) for n, q in picked if n in queries]
    # string_ops' upper reads a case table built from Python's own
    # str.upper (about a second at first use): set-up, as the tables are,
    # not a part of the query's seconds
    SO.device_case_table(False, session.device, session.transfers)
    report = []
    for name, q in picked:
        for it in range(iterations):
            t0 = time.perf_counter()
            try:
                batch, seconds = run_query(q, tables)
                report.append({"query": name, "iteration": it,
                               "rows": batch.row_count, "status": "OK",
                               "seconds": round(seconds, 4)})
            except Exception as e:   # noqa: BLE001 - reported, not raised
                report.append({"query": name, "iteration": it, "rows": 0,
                               "status": f"FAILED: {e}",
                               "seconds": round(time.perf_counter() - t0,
                                                4)})
    return report


def main(argv=None) -> int:
    """CLI: ``python -m spark_rapids_tpu_torch.testing.scaletest [rows]``
    on the card."""
    import sys
    from spark_rapids_tpu_torch.session import TorchSession
    argv = argv if argv is not None else sys.argv[1:]
    rows = int(argv[0]) if argv else 100_000
    s = TorchSession()
    report = run_scale_test(s, scale_rows=rows)
    print(json.dumps(report, indent=2))
    return 1 if any(r["status"] != "OK" for r in report) else 0


if __name__ == "__main__":
    raise SystemExit(main())
