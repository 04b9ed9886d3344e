"""Kernel 1's module (spark_rapids_tpu_torch/exec/fused.py) against the JAX
function it replaces, TpuFusedAggExec._fused_update (exec/fused.py), on the
same seeded numpy inputs: the bench chain -- filter(w > t), project k+1,
v*2.0 and murmur3(k, w) -- and its update pass into six buffers.

On the CPU the wrapper runs the plain version; kernel 2 folds its partial
rows.  Long sums and counts are exact; the double sum agrees within
1e-12 * sum|v2| (another summation order)."""

import ast
import gc

import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar.batch import HostColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import HostColumn as JColumn
from spark_rapids_tpu.exec.fused import TpuFusedAggExec
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import batch_from_numpy
from spark_rapids_tpu_torch.exec import fused as FU
from spark_rapids_tpu_torch.expressions.base import Alias, Expression


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


F64_RTOL = 1e-12
INT64_MAX = 2 ** 63 - 1
SCHEMA = T.StructType([T.StructField("k", T.LONG),
                       T.StructField("v", T.DOUBLE),
                       T.StructField("w", T.INT)])


def recipe(df, threshold, pkg):
    """bench.py's _query, against either package's modules."""
    import importlib
    F = importlib.import_module(f"{pkg}.functions")
    A = importlib.import_module(f"{pkg}.expressions.arithmetic")
    H = importlib.import_module(f"{pkg}.expressions.hashing")
    P = importlib.import_module(f"{pkg}.expressions.predicates")
    B = importlib.import_module(f"{pkg}.expressions.base")
    return (df
            .filter(P.GreaterThan(B.col("w"), B.lit(threshold)))
            .select(B.Alias(A.Add(B.col("k"), B.lit(1)), "k1"),
                    B.Alias(A.Multiply(B.col("v"), B.lit(2.0)), "v2"),
                    B.Alias(H.Murmur3Hash(B.col("k"), B.col("w")), "h"))
            .agg(F.sum("k1").alias("sk"), F.sum("v2").alias("sv"),
                 F.sum("h").alias("sh")))


def columns(n, seed, specials=True):
    """(data, validity) planes: nulls everywhere, k at INT64_MAX in part,
    NaN, +-inf and -0.0 in v."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1 << 40, n).astype(np.int64)
    k[rng.random(n) < 0.3] = INT64_MAX
    v = rng.standard_normal(n) * 1e3
    if specials:
        for x in (np.nan, np.inf, -np.inf, -0.0):
            v[rng.random(n) < 0.002] = x
    w = rng.integers(-1000, 1000, n).astype(np.int32)
    return [(k, rng.random(n) > 0.1), (v, rng.random(n) > 0.1),
            (w, rng.random(n) > 0.1)]


@pytest.fixture(scope="module")
def jax_session():
    return TpuSession({"spark.rapids.sql.enabled": "true"})


def _find(node, cls):
    if isinstance(node, cls):
        return node
    for c in node.children:
        found = _find(c, cls)
        if found is not None:
            return found
    return None


def jax_buffers(session, cols, threshold):
    hb = JBatch([JColumn.from_numpy(d, v) for d, v in cols], len(cols[0][0]),
                ["k", "v", "w"])
    fx = _find(recipe(session.create_dataframe(hb), threshold,
                      "spark_rapids_tpu")._executed_plan(), TpuFusedAggExec)
    out = fx._fused_update(hb.to_device()).to_host().to_pydict()
    return [out[name][0] for name in out]


def port_buffers(cols, threshold):
    s = TorchSession(device="cpu")
    hb = batch_from_numpy(cols, SCHEMA)
    fx = _find(recipe(s.create_dataframe(hb), threshold,
                      "spark_rapids_tpu_torch").executed_plan(),
               FU.TorchFusedAggExec)
    lits = FU.LiteralArgs.upload(fx.promoted, s.transfers)
    row = fx.update_batch(s.transfers.upload_batch(hb), lits)
    return s.transfers.download_batch(row).to_rows()[0]


@pytest.mark.parametrize("n,threshold,specials", [
    (1, 0, False), (1000, 0, True), (4099, 0, False), (4099, 250, True),
    (4099, 1000, True)])   # w > 1000 keeps no row
def test_fused_update_matches_jax(jax_session, n, threshold, specials):
    cols = columns(n, seed=n + threshold, specials=specials)
    ref = jax_buffers(jax_session, cols, threshold)
    got = port_buffers(cols, threshold)
    assert list(got) == ["sk#sum", "sk#cnt", "sv#sum", "sv#cnt", "sh#sum",
                         "sh#cnt"]
    got = list(got.values())
    for j in (0, 1, 3, 4, 5):
        assert got[j] == ref[j], (j, got[j], ref[j])
    if ref[2] is None or np.isnan(ref[2]) or np.isinf(ref[2]):
        assert got[2] == ref[2] or (np.isnan(ref[2]) and np.isnan(got[2]))
    else:
        (k, kv), (v, vv), (w, wv) = cols
        sel = wv & (w > threshold) & vv
        assert abs(got[2] - ref[2]) <= F64_RTOL * np.abs(v[sel] * 2).sum()


def test_kernel_source_is_one_parameterized_kernel():
    s = TorchSession(device="cpu")
    hb = batch_from_numpy(columns(10, 1), SCHEMA)
    fx = _find(recipe(s.create_dataframe(hb), 12345,
                      "spark_rapids_tpu_torch").executed_plan(),
               FU.TorchFusedAggExec)
    src = fx.program.compiled.source
    tree = ast.parse(src)
    kernels = [f for f in tree.body if isinstance(f, ast.FunctionDef)
               and f.name == "fused_agg_update"]
    assert len(kernels) == 1
    assert [a.arg for a in kernels[0].args.args][6] == "lits"
    assert "12345" not in src and "do_not_specialize" in src
    # the uint32 murmur constants are bit patterns of signed int32
    assert str(0xCC9E2D51 - (1 << 32)) in src


def test_columns_without_nulls_get_a_kernel_without_validity_planes():
    s = TorchSession(device="cpu")
    k, v, w = columns(10, 5)
    hb = batch_from_numpy([(k[0], None), v, (w[0], None)], SCHEMA)
    fx = _find(recipe(s.create_dataframe(hb), 0,
                      "spark_rapids_tpu_torch").executed_plan(),
               FU.TorchFusedAggExec)
    batch = s.transfers.upload_batch(hb)
    assert [c.all_valid for c in batch.columns] == [True, False, True]
    assert bool(batch.columns[0].validity.all())
    src = fx.program.kernel_for((False, True, False)).source
    kernel = [f for f in ast.parse(src).body
              if isinstance(f, ast.FunctionDef)
              and f.name == "fused_agg_update"][0]
    assert [a.arg for a in kernel.args.args][:4] == \
        ["in0", "in1", "in1_valid", "in2"]
    assert "in0_valid" not in src and "in2_valid" not in src
    assert fx.program.kernel_for((False, True, False)) is not \
        fx.program.compiled


def test_wrapper_takes_plain_path_for_cpu_tensors():
    s = TorchSession(device="cpu")
    hb = batch_from_numpy(columns(100, 2), SCHEMA)
    fx = _find(recipe(s.create_dataframe(hb), 0,
                      "spark_rapids_tpu_torch").executed_plan(),
               FU.TorchFusedAggExec)
    lits = FU.LiteralArgs.upload(fx.promoted, s.transfers)
    batch = s.transfers.upload_batch(hb)
    before = FU.LAUNCHES
    words, valid = FU.fused_agg_update(fx.program, batch, lits)
    assert FU.LAUNCHES == before
    plain = FU.fused_agg_update_plain(fx.program, batch, lits)
    assert torch.equal(words, plain[0]) and torch.equal(valid, plain[1])
    assert words.shape == (1, 6)


class Negate(Expression):
    """An expression with no Triton emitter."""

    def __init__(self, child):
        super().__init__([child])

    @property
    def data_type(self):
        return self.children[0].data_type

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return type(c)(-c.data, c.valid)


def test_expression_without_emitter_is_refused_at_planning():
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import col
    s = TorchSession(device="cpu")
    df = s.create_dataframe(batch_from_numpy(columns(10, 3), SCHEMA))
    q = df.select(Alias(Negate(col("k")), "nk")).agg(F.sum("nk"))
    with pytest.raises(NotImplementedError, match="Negate"):
        q.collect()


@pytest.mark.cuda
def test_kernel1_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("kernel 1 is a Triton kernel and runs only on a card")
    from spark_rapids_tpu_torch.ops.agg_ops import global_reduce_plain
    s = TorchSession(device="cuda")
    hb = batch_from_numpy(columns(10000, 4, specials=False), SCHEMA)
    fx = _find(recipe(s.create_dataframe(hb), 0,
                      "spark_rapids_tpu_torch").executed_plan(),
               FU.TorchFusedAggExec)
    lits = FU.LiteralArgs.upload(fx.promoted, s.transfers)
    batch = s.transfers.upload_batch(hb)
    before = FU.LAUNCHES
    kernel = FU.fused_agg_update(fx.program, batch, lits)
    assert FU.LAUNCHES == before + 1
    got = global_reduce_plain(*kernel, fx.program.fold_kinds)
    ref = global_reduce_plain(*FU.fused_agg_update_plain(fx.program, batch,
                                                         lits),
                              fx.program.fold_kinds)
    assert torch.equal(got[1], ref[1])
    for j in (0, 1, 3, 4, 5):
        assert got[0][j].item() == ref[0][j].item()
