"""The new expressions of the stage kernels -- In, Substring, <, <=, >=,
date columns, <> and NOT, and string = and <> between two columns or two
substrings -- through K6's and K5's plain versions (exec/fused.py
fused_project_plain and fused_stage_compact_plain) against the JAX
package's eval_exprs_tpu and DataFrame.filter (on JAX-CPU), on the same
seeded inputs; and the Triton source the emitters write for each case
(the kernels run only on the card).

Edge cases: In over strings (empty, non-ASCII, a null option) and over
numbers (a NaN option, a null value); Substring with pos 0, 1, negative
and past the end, len 0, negative and omitted, over empty strings and
bytes >= 0x80 (compared through = and IN, byte for byte); comparisons
with NaN, -0.0 and nulls; dates against date literals and each other;
<> (NOT =: NaN <> NaN and -0.0 <> 0.0 are false) and NOT (NOT null is
null) over numbers, strings and predicates; two string columns, and
substrings of two columns, of different lengths, either one null.
Values are compared in order, exactly.  A substring counts characters
in the port, as Spark and the JAX package's CPU engine do; the JAX
device form counts bytes (ROADMAP queue 3), so an expression that holds
a substring is held against ``eval_exprs_cpu`` on the rows whose strings
are not ASCII, and against ``eval_exprs_tpu`` on the others."""

import datetime
import gc
import importlib

import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar.batch import batch_from_pydict as jax_batch
from spark_rapids_tpu.expressions.evaluator import eval_exprs_tpu
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal, val_eq
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (ColumnarBatch,
                                                   batch_from_pydict)
from spark_rapids_tpu_torch.exec import fused as FU
from spark_rapids_tpu_torch.kernels.fused_stage import (project_source,
                                                        stage_source)


@pytest.fixture(autouse=True, scope="module")
def _collect_outside_reference_locks():
    """The JAX package's ``aux/events.py`` retires a ring sink from a
    weakref finalizer under the plain lock ``RingBufferSink.__init__``
    holds, so a cyclic collection landing there deadlocks the process.
    This module's fixtures and tests run with automatic collection off;
    it collects once they are done."""
    gc.disable()
    yield
    gc.enable()
    gc.collect()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops; a pool of intra-op
    threads in each pytest worker makes them contend for the cores (the
    port's test files took 125 s at -n 6 with torch's default threads and
    61 s on one thread each, on an 8-core machine under load).  This
    module runs on one thread and restores the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SCHEMA = T.StructType([T.StructField("a", T.DOUBLE),
                       T.StructField("b", T.DOUBLE),
                       T.StructField("i", T.INT),
                       T.StructField("k", T.LONG),
                       T.StructField("s", T.STRING),
                       T.StructField("day", T.DATE),
                       T.StructField("day2", T.DATE),
                       T.StructField("t", T.STRING)])

WORDS = ["", "T", "TN", "TNX", "85669", "856691", "é日", "aé", "GA",
         "ÿÿÿ", "abcdefghij"]
D0 = datetime.date(1999, 2, 22)


def data(n, seed):
    rng = np.random.default_rng(seed)
    pool = [np.nan, -0.0, 0.0, 1.5, 2.0, -3.25, np.inf]

    def maybe(values):
        return [None if rng.random() < 0.15 else v for v in values]
    return {
        "a": maybe([float(rng.choice(pool)) for _ in range(n)]),
        "b": maybe([float(rng.choice(pool)) for _ in range(n)]),
        "i": maybe([int(x) for x in rng.integers(-2, 3, n)]),
        "k": rng.integers(-2, 3, n).astype(np.int64),
        "s": maybe([str(rng.choice(WORDS)) for _ in range(n)]),
        "day": maybe([D0 + datetime.timedelta(days=int(x))
                      for x in rng.integers(-3, 40, n)]),
        "day2": maybe([D0 + datetime.timedelta(days=int(x))
                       for x in rng.integers(-3, 3, n)]),
        "t": maybe([str(rng.choice(WORDS)) for _ in range(n)]),
    }


def exprs(pkg, case):
    """Named expressions of ``case`` from ``pkg``'s expression classes."""
    def mod(name):
        return importlib.import_module(f"{pkg}.expressions.{name}")
    P, B, S = mod("predicates"), mod("base"), mod("strings")
    col, lit = B.col, B.lit
    nan = float("nan")

    def sub(pos, length=None):
        return S.Substring(col("s"), pos, length)
    cases = {
        "in": [P.In(col("s"), ["TN", "GA", "é日"]),
               P.In(col("s"), ["", "T"]),
               P.In(col("s"), ["TNX", None]),
               P.In(col("a"), [1.5, nan]),
               P.In(col("a"), [0.0]),
               P.In(col("i"), [1, -2]),
               P.In(col("k"), [0, 2, None]),
               P.In(col("i"), [2.0])],
        "substring": [P.EqualTo(sub(1, 2), lit("TN")),
                      P.In(sub(0, 5), ["85669", "TNX", "é"]),
                      P.In(sub(1, 5), ["85669", "GA"]),
                      P.EqualTo(sub(-2, 2), lit("NX")),
                      P.EqualTo(sub(-1), lit("日")),
                      P.EqualTo(sub(-10, 3), lit("856")),
                      P.EqualTo(sub(3), lit("X")),
                      P.EqualTo(sub(20, 2), lit("")),
                      P.EqualTo(sub(2, 0), lit("")),
                      P.EqualTo(sub(1, -1), lit("")),
                      P.In(sub(2, 2), ["é", "N"]),
                      P.EqualTo(sub(2, 2), lit("ÿ"))],
        "order": [P.LessThan(col("a"), col("b")),
                  P.LessThanOrEqual(col("a"), col("b")),
                  P.GreaterThanOrEqual(col("a"), col("b")),
                  P.LessThanOrEqual(col("a"), lit(0.0)),
                  P.GreaterThanOrEqual(lit(nan), col("b")),
                  P.LessThan(col("i"), col("k")),
                  P.GreaterThanOrEqual(col("k"), lit(0)),
                  P.LessThan(col("i"), lit(1.5))],
        "date": [P.GreaterThanOrEqual(col("day"), lit(D0)),
                 P.LessThanOrEqual(col("day"),
                                   lit(datetime.date(1999, 3, 24))),
                 P.LessThan(col("day"), col("day2")),
                 P.EqualTo(col("day"), lit(D0)),
                 P.In(col("day"), [D0, datetime.date(1999, 3, 1)])],
        "not": [P.NotEqual(col("s"), col("t")),
                P.EqualTo(col("s"), col("t")),
                P.NotEqual(sub(1, 5), S.Substring(col("t"), 1, 5)),
                P.EqualTo(sub(2, 3), S.Substring(col("t"), -3, 3)),
                P.NotEqual(col("s"), lit("TN")),
                P.NotEqual(lit("é日"), col("t")),
                P.NotEqual(col("a"), col("b")),
                P.NotEqual(col("i"), col("k")),
                P.NotEqual(col("day"), col("day2")),
                P.Not(P.LessThan(col("a"), col("b"))),
                P.Not(P.In(col("s"), ["TN", None])),
                P.Not(P.And(P.EqualTo(col("s"), col("t")),
                            P.GreaterThanOrEqual(col("i"), lit(0))))],
    }
    return [B.Alias(e, f"c{j}") for j, e in enumerate(cases[case])]


CASES = ["in", "substring", "order", "date", "not"]


def jax_values(d, case):
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.expressions.base import bind_references
    hb = jax_batch(d, JT.StructType([
        JT.StructField(f.name, getattr(JT, type(f.data_type).__name__)())
        for f in SCHEMA.fields]))
    bound = [bind_references(e, hb.schema)
             for e in exprs("spark_rapids_tpu", case)]
    out = eval_exprs_tpu(bound, hb.to_device()).to_host().to_pydict()
    return [out[f"c{j}"] for j in range(len(bound))]


def jax_cpu_values(d, case):
    """The values of ``case``'s expressions that hold a substring, by
    output name, through the JAX package's CPU engine
    (``eval_exprs_cpu``: a substring by characters)."""
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.expressions.base import bind_references
    from spark_rapids_tpu.expressions.evaluator import eval_exprs_cpu
    hb = jax_batch(d, JT.StructType([
        JT.StructField(f.name, getattr(JT, type(f.data_type).__name__)())
        for f in SCHEMA.fields]))
    picked = [bind_references(e, hb.schema)
              for e in exprs("spark_rapids_tpu", case) if holds_substring(e)]
    out = eval_exprs_cpu(picked, hb).to_pydict() if picked else {}
    return out


def holds_substring(e) -> bool:
    return type(e).__name__ == "Substring" or any(
        holds_substring(c) for c in e.children)


def port_program(case):
    from spark_rapids_tpu_torch.expressions.base import bind_references
    bound = [bind_references(e, SCHEMA)
             for e in exprs("spark_rapids_tpu_torch", case)]
    return FU.StageProgram([("project", bound)], SCHEMA, 0)


@pytest.mark.parametrize("n", [0, 1, 400])
@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_eval_exprs_tpu(n, case):
    d = data(n, seed=n + 11 * len(case))
    session = TorchSession(device="cpu")
    batch = session.transfers.upload_batch(batch_from_pydict(d, SCHEMA))
    program = port_program(case)
    got = [session.transfers.download_batch(
        ColumnarBatch([c], n, ["x"])).columns[0].to_pylist()
        for c in FU.fused_project(program, batch, FU.LiteralArgs([]))]
    ref = jax_values(d, case)
    cpu = jax_cpu_values(d, case)
    ascii_rows = [all(v is None or v.isascii() for v in (d["s"][i],
                                                        d["t"][i]))
                  for i in range(n)]
    for j, e in enumerate(exprs("spark_rapids_tpu", case)):
        if holds_substring(e):
            # the character rule where a string is not ASCII
            ref[j] = [r if ok else c for r, c, ok in
                      zip(ref[j], cpu[f"c{j}"], ascii_rows)]
    assert len(got) == len(ref)
    for j, (r, g) in enumerate(zip(ref, got)):
        assert len(r) == len(g) == n
        bad = [(x, y, d["s"][i], d["a"][i]) for i, (x, y) in
               enumerate(zip(r, g)) if not val_eq(x, y, False)]
        assert not bad, (case, j, bad[:5])


@pytest.mark.parametrize("case", CASES)
def test_k5_and_k6_sources_emit_every_case(case):
    """Each case as a projection (K6) and each one as a filter (K5): the
    Triton source compiles as Python, reads the string column through its
    offsets, and holds IN's options as constants."""
    program = port_program(case)
    nullable = (True,) * len(SCHEMA)
    src = project_source(program.input_types, nullable, program.computed, 0)
    compile(src, "<k6>", "exec")
    for e in program.computed:
        compile(stage_source(program.input_types, nullable, [e], [], 0),
                "<k5>", "exec")
    if case == "substring":
        # "85669" is compared byte by byte: '8' is 56
        assert "in4_off" in src and "== 56)" in src
        assert "tl.where(" in src
    if case == "date":
        # 1999-02-22 is day 10644 since the epoch
        assert "10644" in src
    if case == "not":
        # two views compared byte by byte in a loop over the tile's
        # longest equal length, each read from its own chars buffer
        assert "for vj" in src and "in4 + " in src and "in7 + " in src


def test_computed_string_output_is_refused_by_name():
    """K13 writes a substring of a column and a concat of columns and
    literals; a concat over a substring is still refused, by name."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import Alias, lit
    df = TorchSession(device="cpu").create_dataframe(data(10, 1),
                                                     schema=SCHEMA)
    with pytest.raises(NotImplementedError, match=r"substring\(s, 1, 2\)"):
        df.select(Alias(F.concat(F.substring("s", 1, 2), lit("x")),
                        "z")).collect()


def test_substring_plain_matches_jax_over_ascii():
    """The substring itself (Substring.eval, offsets and chars) against
    the JAX package's device form, over ASCII values."""
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.expressions import strings as JS
    from spark_rapids_tpu.expressions.base import bind_references, col
    from spark_rapids_tpu_torch.expressions import strings as PS
    from spark_rapids_tpu_torch.expressions.base import (EvalContext,
                                                         bind_references
                                                         as pbind)
    from spark_rapids_tpu_torch.expressions.base import col as pcol
    values = ["", "a", "ab", "abcdefghij", None, "TNX", "85669-1234"]
    args = [(0, 3), (1, 1), (1, 5), (-2, 2), (-20, 4), (4, None), (30, 2),
            (2, 0), (1, -3)]
    d = {"s": values}
    hb = jax_batch(d, JT.StructType([JT.StructField("s", JT.STRING)]))
    s = TorchSession(device="cpu")
    batch = s.transfers.upload_batch(batch_from_pydict(
        d, T.StructType([T.StructField("s", T.STRING)])))
    from spark_rapids_tpu_torch.expressions.evaluator import batch_cols
    ctx = EvalContext(batch_cols(batch), batch.row_count, batch.device)
    for pos, length in args:
        e = bind_references(JS.Substring(col("s"), pos, length), hb.schema)
        ref = eval_exprs_tpu([e], hb.to_device()).to_host().to_pydict()
        ref = list(ref.values())[0]
        c = pbind(PS.Substring(pcol("s"), pos, length), batch.schema) \
            .eval(ctx)
        raw = c.data.numpy().tobytes()
        off = c.offsets.tolist()
        got = [raw[off[i]:off[i + 1]].decode() if v else None
               for i, v in enumerate(c.valid.tolist())]
        assert got == ref, (pos, length, got, ref)


def test_filters_match_jax_dataframe_filter():
    """q15's and q12's filters through K5's plain version, in order,
    against the JAX package's DataFrame.filter."""
    from spark_rapids_tpu_torch.testing import tpcds
    d = data(500, seed=3)
    d["s"] = [None if v is None else v + "123" for v in d["s"]]
    jax = TpuSession({"spark.rapids.sql.enabled": "true"}) \
        .create_dataframe(d, num_partitions=1)
    port = TorchSession(device="cpu").create_dataframe(d, schema=SCHEMA)

    def cond(pkg):
        P = importlib.import_module(f"{pkg}.expressions.predicates")
        S = importlib.import_module(f"{pkg}.expressions.strings")
        B = importlib.import_module(f"{pkg}.expressions.base")
        zips = list(tpcds.Q15_ZIPS) + ["TN123", "GA123"]
        lo, hi = tpcds.Q12_DATES
        return [P.Or(P.Or(P.In(S.Substring(B.col("s"), 1, 5), zips),
                          P.In(B.col("s"), ["GA123", "CA"])),
                     P.GreaterThan(B.col("a"), B.lit(1.0))),
                P.And(P.GreaterThanOrEqual(B.col("day"), B.lit(lo)),
                      P.LessThanOrEqual(B.col("day"), B.lit(hi)))]
    for ref_c, got_c in zip(cond("spark_rapids_tpu"),
                            cond("spark_rapids_tpu_torch")):
        ref = jax.filter(ref_c).collect()
        plan = port.filter(got_c)
        assert isinstance(plan.executed_plan(), FU.TorchFusedStageExec)
        got = plan.collect()
        assert 0 < len(got) < 500
        assert rows_equal(ref, got, check_order=True) is None


def test_not_equal_filter_matches_jax_dataframe_filter():
    """q19's filter, ``substr(s, 1, 5) <> substr(t, 1, 5)``, and a NOT
    through K5's plain version, in order, against the JAX package's
    DataFrame.filter."""
    d = data(500, seed=5)
    jax = TpuSession({"spark.rapids.sql.enabled": "true"}) \
        .create_dataframe(d, num_partitions=1)
    port = TorchSession(device="cpu").create_dataframe(d, schema=SCHEMA)

    def cond(pkg):
        P = importlib.import_module(f"{pkg}.expressions.predicates")
        S = importlib.import_module(f"{pkg}.expressions.strings")
        B = importlib.import_module(f"{pkg}.expressions.base")
        return [P.NotEqual(S.Substring(B.col("s"), 1, 5),
                           S.Substring(B.col("t"), 1, 5)),
                P.Not(P.Or(P.EqualTo(B.col("s"), B.col("t")),
                           P.GreaterThan(B.col("a"), B.lit(1.0))))]
    for ref_c, got_c in zip(cond("spark_rapids_tpu"),
                            cond("spark_rapids_tpu_torch")):
        ref = jax.filter(ref_c).collect()
        plan = port.filter(got_c)
        assert isinstance(plan.executed_plan(), FU.TorchFusedStageExec)
        got = plan.collect()
        assert 0 < len(got) < 500
        assert rows_equal(ref, got, check_order=True) is None
