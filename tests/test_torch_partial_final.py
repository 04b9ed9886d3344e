"""The port's PARTIAL and FINAL group-by (spark_rapids_tpu_torch/exec/
aggregate.py TorchKeyedAggregateExec over K9's plain version, its merge
kinds included) against the JAX package, on the same seeded numpy planes:

- PARTIAL buffers equal JAX ``CpuHashAggregateExec(PARTIAL)``'s as
  multisets of rows: sum (its sum and count), count, count(*), avg (a
  double sum and a count) and the variance family (count, mean, m2);
  keys and counts exactly, sums within 1e-12 and mean and m2 within 1e-9
  relative (the engines add in other orders);
- FINAL over a hash exchange equals COMPLETE over one partition, and the
  JAX package's rows over the same partitions (``ignore_order``), for
  keyed, rollup and global aggregates and count(DISTINCT) behind its
  raw-row exchange; the variance family against the JAX CPU engine at
  one partition, since over several it merges a partial of no present
  value wrongly (ROADMAP queue 3; pinned below against the JAX device
  path, which merges it right);
- the plans: PARTIAL, a hash exchange on the buffer keys, FINAL; a
  count(DISTINCT) COMPLETE behind an exchange of the raw rows."""

import gc

import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import batch_from_pydict as j_batch
from spark_rapids_tpu.exec.aggregate import PARTIAL as J_PARTIAL
from spark_rapids_tpu.exec.aggregate import CpuHashAggregateExec
from spark_rapids_tpu.exec.basic import CpuInMemoryScanExec
from spark_rapids_tpu.expressions import aggregates as JA
from spark_rapids_tpu.expressions import base as JB
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import batch_from_pydict
from spark_rapids_tpu_torch.exec import aggregate as A
from spark_rapids_tpu_torch.exec.basic import TorchInMemoryScanExec
from spark_rapids_tpu_torch.expressions import aggregates as PA
from spark_rapids_tpu_torch.expressions.base import BoundReference, Literal
from spark_rapids_tpu_torch.plan import base as L
from spark_rapids_tpu_torch.plan.base import ExecContext


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


COLUMNS = [("k", JT.INT, T.INT), ("s", JT.STRING, T.STRING),
           ("a", JT.INT, T.INT), ("v", JT.DOUBLE, T.DOUBLE)]


def values(seed: int, n: int = 600):
    rng = np.random.default_rng(seed)

    def nulls(vs, p=0.1):
        return [None if rng.random() < p else v for v in vs]

    return {"k": nulls([int(v) for v in rng.integers(0, 9, n)], 0.05),
            "s": nulls([str(rng.choice(["x", "yy", "", "zzz"]))
                        for _ in range(n)], 0.05),
            "a": nulls([int(v) for v in rng.integers(-50, 50, n)]),
            "v": nulls([float(v) for v in rng.normal(1000.0, 3.0, n)])}


#: (JAX class, port class, input column)
AGGS = [(JA.Sum, PA.Sum, 2), (JA.Sum, PA.Sum, 3), (JA.Count, PA.Count, 3),
        (JA.Count, PA.Count, None), (JA.Average, PA.Average, 2),
        (JA.StddevSamp, PA.StddevSamp, 3), (JA.VariancePop, PA.VariancePop,
                                            2)]


def jax_aggs():
    out = []
    for j, (jc, _pc, o) in enumerate(AGGS):
        arg = JB.Literal(1, JT.INT) if o is None else \
            JB.BoundReference(o, COLUMNS[o][1])
        out.append(JA.AggregateExpression(jc(arg), f"a{j}"))
    return out


def port_aggs():
    out = []
    for j, (_jc, pc, o) in enumerate(AGGS):
        arg = Literal(1, T.INT) if o is None else \
            BoundReference(o, COLUMNS[o][2], True, COLUMNS[o][0])
        out.append(PA.AggregateExpression(pc(arg), f"a{j}"))
    return out


def sort_key(row):
    return tuple((v is None, v if v is not None else 0) for v in row[:2])


def close(a, b, rel):
    if a is None or b is None:
        return a is b
    if isinstance(a, float):
        return abs(a - b) <= rel * max(abs(a), abs(b), 1e-300) or a == b
    return a == b


def test_partial_buffers_equal_jax_as_multisets():
    vals = values(1)
    jschema = JT.StructType([JT.StructField(n, jt, True)
                             for n, jt, _pt in COLUMNS])
    jb = j_batch(vals, jschema)
    jexec = CpuHashAggregateExec(
        [JB.BoundReference(0, JT.INT), JB.BoundReference(1, JT.STRING)],
        jax_aggs(), J_PARTIAL, CpuInMemoryScanExec([[jb]], jschema))
    ref = []
    for b in jexec.execute_partition(0):
        d = b.to_pydict()
        ref += list(zip(*d.values()))
    pschema = T.StructType([T.StructField(n, pt, True)
                            for n, _jt, pt in COLUMNS])
    s = TorchSession(device="cpu")
    layout = A._AggLayout([BoundReference(0, T.INT, True, "k"),
                           BoundReference(1, T.STRING, True, "s")],
                          port_aggs())
    scan = TorchInMemoryScanExec(L.Scan([[batch_from_pydict(vals, pschema)]],
                                        pschema))
    pexec = A.TorchKeyedAggregateExec(layout, scan, A.PARTIAL)
    assert pexec.schema.names[2:] == list(jexec.schema.names)[2:]
    out = pexec.execute(ExecContext(s.device, s.transfers))
    got = list(zip(*s.transfers.download_batch(out[0][0])
                   .to_pydict().values()))
    assert len(got) == len(ref)
    names = pexec.schema.names
    for g, r in zip(sorted(got, key=sort_key), sorted(ref, key=sort_key)):
        for name, x, y in zip(names, g, r):
            rel = 1e-9 if name.endswith(("#mean", "#m2")) else 1e-12
            assert close(x, y, rel), (name, g, r)


def frames(n_parts: int, seed: int):
    vals = values(seed)
    pschema = T.StructType([T.StructField(n, pt, True)
                            for n, _jt, pt in COLUMNS])
    jschema = JT.StructType([JT.StructField(n, jt, True)
                             for n, jt, _pt in COLUMNS])
    port = TorchSession(device="cpu").create_dataframe(
        vals, num_partitions=n_parts, schema=pschema)
    jax = TpuSession({"spark.rapids.sql.enabled": "false"}) \
        .create_dataframe(vals, num_partitions=n_parts, schema=jschema)
    return port, jax


def queries(f, df):
    return {
        "keyed": df.group_by("k", "s").agg(
            f.sum("a").alias("sa"), f.sum("v").alias("sv"),
            f.count("v").alias("cv"), f.avg("a").alias("aa"),
            f.stddev_samp("v").alias("sd"), f.var_pop("a").alias("vp")),
        "rollup": df.rollup("k", "s").agg(f.sum("a").alias("sa"),
                                          f.avg("v").alias("av")),
        "global": df.agg(f.sum("a").alias("sa"), f.avg("v").alias("av"),
                         f.count("v").alias("cv")),
        "distinct_keyed": df.group_by("k").agg(
            f.count_distinct("s").alias("ds"), f.sum("a").alias("sa")),
        "distinct_global": df.agg(f.count_distinct("a").alias("da")),
        "distinct_rows": df.select("k", "s").distinct(),
    }


@pytest.mark.parametrize("name", ["keyed", "rollup", "global",
                                  "distinct_keyed", "distinct_global",
                                  "distinct_rows"])
@pytest.mark.parametrize("n_parts", [2, 3])
def test_final_over_partitions_equals_complete_and_jax(name, n_parts):
    port, jax = frames(n_parts, 7)
    one, jax1 = frames(1, 7)
    got = queries(F, port)[name].collect()
    complete = queries(F, one)[name].collect()
    # the JAX CPU engine's variance merge over partitions is at fault
    ref = queries(JF, jax1 if name == "keyed" else jax)[name].collect()
    assert rows_equal(complete, got, check_order=False,
                      approx_float=True) is None
    assert rows_equal(ref, got, check_order=False,
                      approx_float=True) is None


def test_plans_partial_exchange_final():
    port, _jax = frames(3, 2)
    text = queries(F, port)["keyed"].explain()
    assert "TorchKeyedAggregate[partial" in text
    assert "TorchExchange[HashPartitioning(k, s, 3)]" in text
    assert "TorchKeyedAggregate[final" in text
    text = queries(F, port)["distinct_keyed"].explain()
    assert "partial" not in text and "TorchKeyedAggregate[complete" in text
    assert "TorchExchange[HashPartitioning(k, 3)]" in text
    text = queries(F, port)["distinct_global"].explain()
    assert "TorchExchange[SinglePartition]" in text


def test_chan_merge_kinds_match_a_one_pass_reference():
    """K9's Chan merge (plain version) of (n, mean, m2) partials equals
    the moments of the rows the partials were made from."""
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.ops import agg_ops as G
    rng = np.random.default_rng(3)
    x = rng.normal(1e6, 2.0, 4000)
    part = rng.integers(0, 4, 4000)
    grp = rng.integers(0, 5, 4000)
    rows = []
    for g in range(5):
        for p in range(4):
            xs = x[(grp == g) & (part == p)]
            m = xs.mean() if len(xs) else 0.0
            rows.append((g, float(len(xs)), m, float(((xs - m) ** 2).sum()),
                         len(xs) > 0))
    ones = torch.ones(len(rows), dtype=torch.bool)

    def col(j, dt):
        vals = torch.tensor([r[j] for r in rows],
                            dtype=torch.float64 if dt == T.DOUBLE
                            else torch.int64)
        return DeviceColumn(vals, ones, dt)
    g, n, mean, m2 = col(0, T.LONG), col(1, T.DOUBLE), col(2, T.DOUBLE), \
        col(3, T.DOUBLE)
    mean = DeviceColumn(mean.data, torch.tensor([r[4] for r in rows]),
                        T.DOUBLE)
    s = TorchSession(device="cpu")
    _rep, res = G.keyed_aggregate(
        [g], [n, mean, m2], [G.KEYED_SUM_F64, G.KEYED_CHAN_MEAN,
                             G.KEYED_CHAN_M2], s.transfers,
        aux=[None, (n, mean), (n, mean)])
    for k in range(5):
        xs = x[grp == k]
        assert res[0][0][k] == len(xs)
        assert abs(float(res[1][0][k]) - xs.mean()) <= 1e-9 * xs.mean()
        m2_ref = ((xs - xs.mean()) ** 2).sum()
        assert abs(float(res[2][0][k]) - m2_ref) <= 1e-9 * m2_ref


def test_variance_merge_of_an_empty_partial_matches_the_jax_device_path():
    """The smallest input of the reference fault: group 1's rows in the
    first of two partitions are one null, so its partial there has no
    present value.  The JAX CPU engine merges it to a stddev and a var_pop
    of 0.0; its device path (on JAX-CPU), its own one-partition run and
    the port give 0.7071... and 0.25."""
    d = {"k": [1, 2, 1, 1], "v": [None, 5.0, 1.0, 2.0]}
    sch = JT.StructType([JT.StructField("k", JT.INT, True),
                         JT.StructField("v", JT.DOUBLE, True)])
    psch = T.StructType([T.StructField("k", T.INT, True),
                         T.StructField("v", T.DOUBLE, True)])

    def run(f, df):
        return sorted((r["k"], r["sd"], r["vp"]) for r in df.group_by(
            "k").agg(f.stddev_samp("v").alias("sd"),
                     f.var_pop("v").alias("vp")).collect())
    got = run(F, TorchSession(device="cpu").create_dataframe(
        d, num_partitions=2, schema=psch))
    device = run(JF, TpuSession({}).create_dataframe(
        d, num_partitions=2, schema=sch))
    engine = run(JF, TpuSession({"spark.rapids.sql.enabled": "false"})
                 .create_dataframe(d, num_partitions=2, schema=sch))
    for rows in (got, device):
        assert rows[0] == (1, pytest.approx(0.5 ** 0.5, rel=1e-12), 0.25)
        assert rows[1] == (2, None, 0.0)
    assert engine[0] == (1, 0.0, 0.0)
