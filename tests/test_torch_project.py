"""The computing projection's module (exec/fused.py StageProgram and
fused_project, K6, with kernels/fused_stage.py project_source, and
exec/basic.py TorchFusedProjectExec) against the JAX package's
expressions/evaluator.py eval_exprs_tpu (on JAX-CPU), on the same seeded
inputs.

The expressions are the new ones of the slice -- Divide (null for a zero
divisor, NaN through), If with a null branch (an average's finish), Cast
to double, Kleene And and Or, and string = against a literal (empty,
non-ASCII, longer than the value) -- over columns with nulls, NaN and
-0.0.  A projection keeps its rows in order, so values are compared in
order, exactly: the plain version repeats the same IEEE operations."""

import gc
import importlib

import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar.batch import batch_from_pydict as jax_batch
from spark_rapids_tpu.expressions.evaluator import eval_exprs_tpu
from spark_rapids_tpu.testing.rowcompare import val_eq
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (ColumnarBatch,
                                                   batch_from_pydict)
from spark_rapids_tpu_torch.exec import fused as FU
from spark_rapids_tpu_torch.exec.basic import TorchFusedProjectExec
from spark_rapids_tpu_torch.kernels.fused_stage import project_source


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


SCHEMA = T.StructType([T.StructField("a", T.DOUBLE),
                       T.StructField("b", T.DOUBLE),
                       T.StructField("i", T.INT),
                       T.StructField("k", T.LONG),
                       T.StructField("s", T.STRING),
                       T.StructField("t", T.STRING)])


def data(n, seed):
    rng = np.random.default_rng(seed)
    pool = [np.nan, -0.0, 0.0, 1.5, 2.0, -3.25, np.inf]
    words = ["", "N", "TN", "TNX", "é日", "Y", "College"]
    return {
        "a": [None if rng.random() < 0.15 else float(rng.choice(pool))
              for _ in range(n)],
        "b": [None if rng.random() < 0.15 else float(rng.choice(pool))
              for _ in range(n)],
        "i": [None if rng.random() < 0.15 else int(x)
              for x in rng.integers(-2, 3, n)],
        "k": rng.integers(-2, 3, n).astype(np.int64),
        "s": [None if rng.random() < 0.15 else str(rng.choice(words))
              for _ in range(n)],
        "t": [None if rng.random() < 0.15 else str(rng.choice(words[:3]))
              for _ in range(n)],
    }


def exprs(pkg, case):
    """One list of named expressions of ``case``, built from ``pkg``'s
    expression classes."""
    def mod(name):
        return importlib.import_module(f"{pkg}.expressions.{name}")
    A, P, B = mod("arithmetic"), mod("predicates"), mod("base")
    C, CA = mod("conditional"), mod("cast")
    TT = importlib.import_module(f"{pkg}.types")
    col, lit, Alias = B.col, B.lit, B.Alias
    cases = {
        "divide": [A.Divide(col("a"), col("b")),
                   A.Divide(col("i"), col("k")),
                   A.Divide(col("k"), lit(0))],
        "avg finish": [C.If(P.GreaterThan(col("k"), B.Literal(0, TT.LONG)),
                            A.Divide(CA.Cast(col("a"), TT.DOUBLE),
                                     CA.Cast(col("k"), TT.DOUBLE)),
                            B.Literal(None, TT.DOUBLE)),
                       A.Multiply(col("a"), lit(1.2))],
        "cast": [CA.Cast(col("i"), TT.DOUBLE), CA.Cast(col("k"), TT.DOUBLE),
                 CA.Cast(col("i"), TT.LONG)],
        "string =": [P.EqualTo(col("s"), lit("TN")),
                     P.EqualTo(col("s"), lit("")),
                     P.EqualTo(col("s"), lit("é日")),
                     P.EqualTo(lit("College"), col("s")),
                     P.EqualTo(col("t"), lit("TNXXXXXXXX"))],
        "kleene": [P.Or(P.EqualTo(col("s"), lit("N")),
                        P.EqualTo(col("t"), lit("N"))),
                   P.And(P.EqualTo(col("s"), lit("N")),
                         P.EqualTo(col("t"), lit("N"))),
                   P.Or(P.GreaterThan(col("a"), lit(0.0)),
                        P.EqualTo(col("i"), lit(1))),
                   P.And(P.GreaterThan(col("a"), lit(0.0)),
                         P.GreaterThan(col("i"), lit(0)))],
    }
    return [Alias(e, f"c{j}") for j, e in enumerate(cases[case])]


CASES = ["divide", "avg finish", "cast", "string =", "kleene"]


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


def port_program(case):
    from spark_rapids_tpu_torch.expressions.base import bind_references
    bound = [bind_references(e, SCHEMA)
             for e in exprs("spark_rapids_tpu_torch", case)]
    return FU.StageProgram([("project", bound)], SCHEMA, 0)


def same(ref, got, what):
    assert len(ref) == len(got), what
    for r, g in zip(ref, got):
        assert len(r) == len(g), what
        for x, y in zip(r, g):
            assert val_eq(x, y, False), (what, r, g)


@pytest.mark.parametrize("n", [0, 1, 300])
@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_eval_exprs_tpu(n, case):
    d = data(n, seed=n + 7 * len(case))
    session = TorchSession(device="cpu")
    batch = session.transfers.upload_batch(batch_from_pydict(d, SCHEMA))
    program = port_program(case)
    outs = FU.fused_project_plain(program, batch, FU.LiteralArgs([]))
    got = [session.transfers.download_batch(
        ColumnarBatch([c], n, ["x"])).columns[0].to_pylist()
        for c in outs]
    same(jax_values(d, case), got, case)
    # the wrapper takes the plain version for a CPU batch
    again = FU.fused_project(program, batch, FU.LiteralArgs([]))
    for a, b in zip(outs, again):   # bit for bit: NaN is not == NaN
        assert a.data.contiguous().view(torch.uint8).equal(
            b.data.contiguous().view(torch.uint8)) if n else True
        assert a.validity.equal(b.validity)


@pytest.mark.parametrize("case", CASES)
def test_select_plans_k6_and_matches_jax(case):
    d = data(200, seed=3)
    df = TorchSession(device="cpu").create_dataframe(d, schema=SCHEMA) \
        .select(*exprs("spark_rapids_tpu_torch", case), "s")
    plan = df.executed_plan()
    assert isinstance(plan, TorchFusedProjectExec), plan.tree_string()
    got = df.collect_batch().to_pydict()
    ref = jax_values(d, case)
    same(ref, [got[f"c{j}"] for j in range(len(ref))], case)
    assert got["s"] == d["s"]   # a bare column passes through


def test_planner_picks_k5_select_or_k6():
    from spark_rapids_tpu_torch.exec.basic import TorchSelectExec
    from spark_rapids_tpu_torch.expressions import arithmetic as A
    from spark_rapids_tpu_torch.expressions import predicates as P
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    df = TorchSession(device="cpu").create_dataframe(data(10, 1),
                                                     schema=SCHEMA)
    picked = df.select(Alias(col("k"), "kk"), col("s")).executed_plan()
    assert isinstance(picked, TorchSelectExec)
    computed = df.select(Alias(A.Divide(col("a"), col("b")), "q"),
                         col("k")).select(col("q")).executed_plan()
    assert isinstance(computed, TorchFusedProjectExec)
    assert computed.program.bare == [None]
    filtered = df.filter(P.EqualTo(col("s"), lit("TN"))) \
        .select(Alias(A.Divide(col("a"), col("b")), "q")).executed_plan()
    assert isinstance(filtered, FU.TorchFusedStageExec)


@pytest.mark.parametrize("case", CASES)
def test_k6_source_emits_every_case(case):
    """The Triton source of each case (the kernel runs only on the card):
    a string is read through its offsets and compared byte by byte with
    the literal's bytes, which are constants of the kernel."""
    program = port_program(case)
    nullable = (True,) * len(SCHEMA)
    src = project_source(program.input_types, nullable, program.computed, 0)
    compile(src, "<k6>", "exec")
    assert "def stage_project(" in src
    if case == "string =":
        assert "in4_off" in src and "== 84)" in src   # 'T'
        # "é日" is five UTF-8 bytes
        assert "- t" in src and "== 5" in src
