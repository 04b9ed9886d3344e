"""The compacting stage's module (exec/fused.py TorchFusedStageExec and
fused_stage_compact, K5, with kernels/fused_stage.py) against the JAX
package's filter and project (TpuFusedStageExec, exec/fused.py, on
JAX-CPU), on the same seeded inputs.

A filter keeps the surviving rows in input order, so rows are compared in
order with rowcompare.rows_equal, exactly: the computed outputs repeat
the same IEEE operations."""

import gc

import numpy as np
import pytest
import torch

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec import stage_compiler
from spark_rapids_tpu_torch.exec.basic import TorchSelectExec
from spark_rapids_tpu_torch.exec.fused import TorchFusedStageExec
from spark_rapids_tpu_torch.kernels.fused_stage import stage_source


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


SCHEMA = T.StructType([T.StructField("i", T.INT), T.StructField("k", T.LONG),
                       T.StructField("v", T.DOUBLE),
                       T.StructField("s", T.STRING)])


@pytest.fixture(scope="module")
def jax_session():
    return TpuSession({"spark.rapids.sql.enabled": "true"})


def data(n, seed):
    rng = np.random.default_rng(seed)
    pool = [np.nan, -0.0, 0.0, 1.5, 2.0, -3.25]
    return {
        "i": [None if rng.random() < 0.1 else int(x)
              for x in rng.integers(-3, 4, n)],
        "k": rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64),
        "v": [None if rng.random() < 0.1 else float(rng.choice(pool))
              for _ in range(n)],
        "s": [None if rng.random() < 0.1 else "w" * int(x)
              for x in rng.integers(0, 4, n)],
    }


def recipe(df, pkg, case):
    import importlib
    A = importlib.import_module(f"{pkg}.expressions.arithmetic")
    P = importlib.import_module(f"{pkg}.expressions.predicates")
    B = importlib.import_module(f"{pkg}.expressions.base")
    col, lit, Alias = B.col, B.lit, B.Alias
    conds = {"int =": P.EqualTo(col("i"), lit(2)),
             "int >": P.GreaterThan(col("i"), lit(0)),
             "all": P.GreaterThan(col("i"), lit(-100)),
             "none": P.EqualTo(col("i"), lit(100)),
             "double =": P.EqualTo(col("v"), lit(0.0)),
             "NaN = NaN": P.EqualTo(col("v"), col("v")),
             "two": P.GreaterThan(col("i"), lit(-2))}
    out = df.filter(conds[case])
    if case == "two":
        out = out.filter(P.EqualTo(col("k"), col("k")))
    return out.select(Alias(A.Add(col("k"), lit(1)), "k1"),
                      Alias(A.Multiply(col("v"), lit(2.0)), "v2"),
                      col("s"), Alias(col("i"), "renamed"))


@pytest.mark.parametrize("n", [0, 1, 300])
@pytest.mark.parametrize("case", ["int =", "int >", "all", "none",
                                  "double =", "NaN = NaN", "two"])
def test_filter_project_matches_jax(jax_session, n, case):
    d = data(n, seed=n + len(case))
    ref = recipe(jax_session.create_dataframe(d), "spark_rapids_tpu",
                 case).collect()
    df = recipe(TorchSession(device="cpu").create_dataframe(d,
                                                            schema=SCHEMA),
                "spark_rapids_tpu_torch", case)
    assert isinstance(df.executed_plan(), TorchFusedStageExec)
    got = df.collect()
    assert rows_equal(ref, got, check_order=True, approx_float=False) \
        is None, (case, ref, got)


def test_bare_columns_are_a_selection_and_literals_share_a_kernel():
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import EqualTo
    s = TorchSession(device="cpu")
    df = s.create_dataframe(data(20, seed=2), schema=SCHEMA)
    sel = df.select(Alias(col("s"), "t"), col("i"))
    assert isinstance(sel.executed_plan(), TorchSelectExec)
    before = s.transfers.stats()
    assert sel.collect() == [{"t": r["s"], "i": r["i"]}
                             for r in df.collect()]
    # a selection moves no row: only the download syncs
    assert s.transfers.stats()["syncs"] - before["syncs"] == 2
    df.filter(EqualTo(col("i"), lit(1))).collect()
    built = stage_compiler.stats()["builds"]
    rows = df.filter(EqualTo(col("i"), lit(3))).collect()
    assert stage_compiler.stats()["builds"] == built
    assert all(r["i"] == 3 for r in rows)


def test_emitted_source_reads_only_the_columns_it_uses():
    from spark_rapids_tpu_torch.expressions.base import BoundReference
    from spark_rapids_tpu_torch.expressions.predicates import EqualTo
    from spark_rapids_tpu_torch.plan.stages import PromotedLiteral
    cond = EqualTo(BoundReference(0, T.INT), PromotedLiteral(11, T.INT, 0))
    src = stage_source(SCHEMA.types, [False, True, True, True], [cond], [],
                       1)
    assert "def stage_count(in0, lits, counts, n_rows" in src
    assert "def stage_write(in0, lits, offsets, out_idx, n_rows" in src
    assert "in3" not in src and "tl.cumsum" in src


def test_computed_string_outputs_are_refused():
    """A string literal output is K13's (a concat of one literal); a
    substring of a concat is still refused."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import Literal
    s = TorchSession(device="cpu")
    df = s.create_dataframe(data(5, seed=1), schema=SCHEMA)
    assert [r["x"] for r in df.select(
        Literal("x", T.STRING).alias("x")).collect()] == ["x"] * 5
    with pytest.raises(NotImplementedError, match="StringType"):
        df.select(F.substring(F.concat(Literal("x", T.STRING),
                                       Literal("y", T.STRING)), 1, 1)
                  ).collect()
