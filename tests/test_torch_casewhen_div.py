"""CASE WHEN, ``div`` and ``%`` on the port (expressions/conditional.py
CaseWhen, expressions/arithmetic.py IntegralDivide and Remainder) through
K6's plain version (exec/fused.py fused_project_plain) against the JAX
package's eval_exprs_tpu (on JAX-CPU), on the same seeded inputs; and the
Triton source their emitters write (the kernels run only on the card).

Edge cases: ``div`` and ``%`` with negative operands, a zero divisor
(null), -1 as the divisor (``INT64_MIN div -1`` wraps to INT64_MIN,
``x % -1`` is 0), int and long operands (``%`` keeps int); CASE WHEN with
numeric values of two types, without ELSE (null), with null predicates
(not taken), and a string CASE whose values are one column and nulls (a
view of the column: its bytes where taken and valid, else null).  Values
are compared in order, exactly."""

import gc
import importlib

import numpy as np
import pytest

from spark_rapids_tpu.columnar.batch import batch_from_pydict as jax_batch
from spark_rapids_tpu.expressions.evaluator import eval_exprs_tpu
from spark_rapids_tpu.testing.rowcompare import val_eq
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


INT64_MIN = -(2 ** 63)
SCHEMA = T.StructType([T.StructField("k", T.LONG),
                       T.StructField("i", T.INT),
                       T.StructField("m", T.LONG),
                       T.StructField("a", T.DOUBLE),
                       T.StructField("s", T.STRING)])


def data(n, seed):
    rng = np.random.default_rng(seed)

    def maybe(values):
        return [None if rng.random() < 0.15 else v for v in values]
    return {
        "k": maybe([int(x) for x in rng.integers(-9, 10, n)]),
        "i": maybe([int(x) for x in rng.integers(-3, 4, n)]),
        "m": [int(rng.choice([INT64_MIN, 2 ** 63 - 1, -7, 7, 0]))
              for _ in range(n)],
        "a": maybe([float(rng.choice([np.nan, -0.0, 0.0, 1.5, -2.0]))
                    for _ in range(n)]),
        "s": maybe([str(rng.choice(["", "TN", "GA", "é日",
                                    "abcdefghij"])) for _ in range(n)]),
    }


def exprs(pkg, case):
    """Named expressions of ``case`` from ``pkg``'s expression classes."""
    def mod(name):
        return importlib.import_module(f"{pkg}.expressions.{name}")
    A, B, C, P = (mod(m) for m in ("arithmetic", "base", "conditional",
                                   "predicates"))
    col, lit = B.col, B.lit
    null_str = B.Literal(None, importlib.import_module(f"{pkg}.types")
                         .STRING)
    cases = {
        "div": [A.IntegralDivide(col("k"), col("i")),
                A.IntegralDivide(col("m"), lit(-1)),
                A.IntegralDivide(col("m"), col("i")),
                A.IntegralDivide(col("i"), lit(0)),
                A.IntegralDivide(lit(-7), col("i")),
                A.IntegralDivide(col("k"), lit(2 ** 40))],
        "remainder": [A.Remainder(col("k"), col("i")),
                      A.Remainder(col("i"), col("i")),
                      A.Remainder(col("m"), lit(-1)),
                      A.Remainder(col("m"), col("k")),
                      A.Remainder(col("k"), lit(0)),
                      A.Remainder(A.IntegralDivide(col("k"), lit(2)),
                                  lit(2))],
        "case numeric": [
            C.CaseWhen([(P.GreaterThan(col("a"), lit(0.0)), col("i")),
                        (P.GreaterThan(col("k"), lit(0)), col("k"))],
                       lit(-1)),
            C.CaseWhen([(P.EqualTo(col("s"), lit("TN")), col("a"))]),
            C.CaseWhen([(P.GreaterThan(col("a"), lit(1.0)), lit(1)),
                        (P.LessThan(col("a"), lit(1.0)), lit(2))], lit(3)),
            C.CaseWhen([(P.EqualTo(A.Remainder(col("k"), lit(2)), lit(0)),
                         A.IntegralDivide(col("k"), lit(2)))],
                       col("m"))],
        "case string": [
            C.CaseWhen([(P.GreaterThan(col("a"), lit(0.0)), col("s"))]),
            C.CaseWhen([(P.EqualTo(col("i"), lit(0)), null_str),
                        (P.GreaterThan(col("k"), lit(0)), col("s"))],
                       col("s")),
            C.CaseWhen([(P.EqualTo(A.Remainder(col("k"), lit(2)), lit(0)),
                         col("s"))], null_str)],
    }
    return [B.Alias(e, f"c{j}") for j, e in enumerate(cases[case])]


CASES = ["div", "remainder", "case numeric", "case string"]


def jax_values(d, case):
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.expressions.base import bind_references
    hb = jax_batch(d, JT.StructType([
        JT.StructField(f.name, getattr(JT, type(f.data_type).__name__)())
        for f in SCHEMA.fields]))
    bound = [bind_references(e, hb.schema)
             for e in exprs("spark_rapids_tpu", case)]
    out = eval_exprs_tpu(bound, hb.to_device()).to_host().to_pydict()
    return [out[f"c{j}"] for j in range(len(bound))], \
        [e.data_type for e in bound]


def port_program(case):
    from spark_rapids_tpu_torch.expressions.base import bind_references
    bound = [bind_references(e, SCHEMA)
             for e in exprs("spark_rapids_tpu_torch", case)]
    return FU.StageProgram([("project", bound)], SCHEMA, 0)


@pytest.mark.parametrize("n", [0, 1, 300])
@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_eval_exprs_tpu(n, case):
    d = data(n, seed=n + 7 * len(case))
    session = TorchSession(device="cpu")
    batch = session.transfers.upload_batch(batch_from_pydict(d, SCHEMA))
    program = port_program(case)
    outs = FU.fused_project(program, batch, FU.LiteralArgs([]))
    got = [session.transfers.download_batch(
        ColumnarBatch([c], n, ["x"])).columns[0].to_pylist() for c in outs]
    ref, ref_types = jax_values(d, case)
    assert [type(o.data_type).__name__ for o in outs] == \
        [type(t).__name__ for t in ref_types]
    for j, (r, g) in enumerate(zip(ref, got)):
        assert len(r) == len(g) == n
        bad = [(x, y, i) for i, (x, y) in enumerate(zip(r, g))
               if not val_eq(x, y, False)]
        assert not bad, (case, j, bad[:5])
    if n == 300 and case in ("div", "remainder"):
        # the -1 divisor over INT64_MIN and a zero divisor both occur
        assert INT64_MIN in d["m"] and None in got[3]


def test_string_case_is_a_view_of_its_column():
    """The string CASE shares its column's chars and offsets; K6 writes
    only its validity plane."""
    session = TorchSession(device="cpu")
    batch = session.transfers.upload_batch(batch_from_pydict(data(50, 3),
                                                             SCHEMA))
    outs = FU.fused_project(port_program("case string"), batch,
                            FU.LiteralArgs([]))
    s = batch.columns[4]
    for o in outs:
        assert o.data is s.data and o.offsets is s.offsets
        assert not bool((o.validity & ~s.validity).any())
    src = project_source(SCHEMA.types, (True,) * 5,
                         port_program("case string").computed, 0)
    compile(src, "<k6>", "exec")
    assert "out0_valid" in src and "out0 +" not in src


@pytest.mark.parametrize("case", CASES)
def test_k5_and_k6_sources_emit_every_case(case):
    """Each case as a projection (K6) compiles as Python; the numeric ones
    as K5's computed outputs too; ``div`` and ``%`` guard the -1 and 0
    divisors before Triton's truncating ``//`` and ``%``."""
    program = port_program(case)
    nullable = (True,) * len(SCHEMA)
    src = project_source(program.input_types, nullable, program.computed, 0)
    compile(src, "<k6>", "exec")
    if case != "case string":
        compile(stage_source(program.input_types, nullable, [],
                             program.computed, 0), "<k5>", "exec")
    if case in ("div", "remainder"):
        assert "== -1" in src and "== 0" in src
        assert (" // " if case == "div" else " % ") in src
    if case == "case numeric":
        assert "tl.where(" in src


def test_outside_the_port_is_refused_by_name():
    from spark_rapids_tpu_torch.expressions import arithmetic as A
    from spark_rapids_tpu_torch.expressions import conditional as C
    from spark_rapids_tpu_torch.expressions import predicates as P
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    df = TorchSession(device="cpu").create_dataframe(data(10, 1),
                                                     schema=SCHEMA)
    with pytest.raises(NotImplementedError, match="div of DoubleType"):
        df.select(Alias(A.IntegralDivide(col("a"), lit(2)), "z")).collect()
    with pytest.raises(NotImplementedError, match="computed string"):
        df.select(Alias(C.CaseWhen([(P.GreaterThan(col("k"), lit(0)),
                                     lit("x"))], col("s")), "z")).collect()
    # a string CASE is K6's alone: a filtering stage refuses it by name
    with pytest.raises(NotImplementedError, match="CASE WHEN"):
        df.filter(P.GreaterThan(col("k"), lit(0))).select(Alias(
            C.CaseWhen([(P.GreaterThan(col("k"), lit(1)), col("s"))]),
            "z")).collect()


def test_grouping_bits_match_jax_sql():
    """``F.grouping(k)`` in ``rollup(...).agg(...)`` (the grouping id's
    bit through ``div`` and ``%``, alone and summed) against the JAX
    package's SQL ``grouping()`` over ``ROLLUP``, without regard to order;
    a grouping() beside a column outside it is refused by name."""
    from spark_rapids_tpu.session import TpuSession
    from spark_rapids_tpu.testing.rowcompare import rows_equal
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.arithmetic import Add
    from spark_rapids_tpu_torch.expressions.base import col
    rng = np.random.default_rng(21)
    d = {"a": [None if rng.random() < 0.1 else str(x)
               for x in rng.choice(["x", "y", "z"], 80)],
         "b": [int(x) for x in rng.integers(0, 3, 80)],
         "v": [float(x) for x in rng.standard_normal(80)]}
    js = TpuSession({"spark.rapids.sql.enabled": "false"})
    js.create_or_replace_temp_view("t", js.create_dataframe(
        d, num_partitions=1))
    ref = js.sql("select a, b, sum(v) as s, grouping(a) as ga, "
                 "grouping(b) as gb, grouping(a) + grouping(b) as lvl "
                 "from t group by rollup(a, b)").collect()
    got = TorchSession(device="cpu").create_dataframe(d).rollup("a", "b") \
        .agg(F.sum("v").alias("s"), F.grouping("a").alias("ga"),
             F.grouping("b").alias("gb"),
             Add(F.grouping("a"), F.grouping("b")).alias("lvl")).collect()
    assert len(got) == len(ref) > 0
    assert rows_equal(ref, got, check_order=False, approx_float=True) \
        is None, (ref, got)
    df = TorchSession(device="cpu").create_dataframe(d)
    with pytest.raises(NotImplementedError, match="only grouping"):
        df.rollup("a", "b").agg(Add(F.grouping("a"), col("b")).alias("x"))
