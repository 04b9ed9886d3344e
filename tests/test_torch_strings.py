"""String columns of the port (types.py, columnar/column.py, batch.py,
transfer.py) and the gather kernel's module (ops/batch_ops.py, K7) against
the JAX package.

A JAX host string column (Arrow) must turn into the same offsets, chars
and validity as the port's; a gather through the same map must give the
same rows as the JAX package's gather_batch (ops/batch_ops.py:45) run on
JAX-CPU.  Everything here is exact."""

import gc

import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import HostColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import HostColumn as JColumn
from spark_rapids_tpu.ops.batch_ops import gather_batch as jax_gather
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (HostColumnarBatch,
                                                   batch_from_pydict)
from spark_rapids_tpu_torch.columnar.column import HostColumn
from spark_rapids_tpu_torch.ops import batch_ops as BO


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


def strings(rng, n, null_frac=0.15):
    """ASCII and non-ASCII words of 0..9 characters, some None."""
    alphabet = list("abcxyz") + ["é", "ß", "日"]
    out = []
    for _ in range(n):
        if rng.random() < null_frac:
            out.append(None)
        else:
            k = int(rng.integers(0, 10))
            out.append("".join(rng.choice(alphabet, k)))
    return out


@pytest.mark.parametrize("n", [0, 1, 37])
def test_jax_host_string_column_has_the_same_planes(n):
    values = strings(np.random.default_rng(n), n)
    arrow = JColumn.from_pylist(values, JT.STRING).arrow
    validity, offsets, chars = arrow.buffers()
    mine = HostColumn.from_strings(values)
    assert mine.offsets.dtype == np.int32
    ref_off = np.frombuffer(offsets, dtype=np.int32)[:n + 1] if n else \
        np.zeros(1, np.int32)
    np.testing.assert_array_equal(mine.offsets, ref_off)
    total = int(ref_off[-1])
    ref_chars = np.frombuffer(chars, dtype=np.uint8)[:total] \
        if chars is not None else np.zeros(0, np.uint8)
    np.testing.assert_array_equal(mine.data, ref_chars)
    ref_valid = np.array([v is not None for v in values], bool)
    got_valid = np.ones(n, bool) if mine.validity is None else mine.validity
    np.testing.assert_array_equal(got_valid, ref_valid)
    assert mine.to_pylist() == values == JColumn.from_pylist(
        values, JT.STRING).to_pylist()


def test_numpy_object_arrays_become_string_columns():
    d = {"s": np.array(["a", None, "", "bb"], dtype=object),
         "k": np.arange(4, dtype=np.int64)}
    hb = batch_from_pydict(d)
    assert hb.schema.types == [T.STRING, T.LONG]
    assert hb.to_pydict()["s"] == ["a", None, "", "bb"]
    assert hb.slice(1, 3).to_pydict()["s"] == [None, "", "bb"]


def test_string_columns_round_trip_through_the_gateway():
    s = TorchSession(device="cpu")
    values = strings(np.random.default_rng(3), 50)
    hb = batch_from_pydict({"s": values,
                            "v": np.arange(50, dtype=np.float64)})
    before = s.transfers.stats()
    dev = s.transfers.upload_batch(hb)
    assert dev.columns[0].is_string and dev.columns[0].row_count == 50
    back = s.transfers.download_batch(dev)
    after = s.transfers.stats()
    assert back.to_pydict() == hb.to_pydict()
    # chars, offsets, validity up; data, validity, offsets down; one sync
    assert after["h2d_copies"] - before["h2d_copies"] == 4
    assert after["d2h_copies"] - before["d2h_copies"] == 5
    assert after["syncs"] - before["syncs"] == 1
    front = s.transfers.download_batch(dev.front(7))
    assert front.to_pydict()["s"] == values[:7]


def _jax_batch(values, ints):
    n = len(values)
    return JBatch([JColumn.from_pylist(values, JT.STRING),
                   JColumn.from_numpy(ints, None)], n, ["s", "k"])


@pytest.mark.parametrize("n_src,n_out", [(1, 0), (1, 1), (40, 200),
                                         (300, 77)])
@pytest.mark.parametrize("unique", [False, True])
def test_gather_matches_jax(n_src, n_out, unique):
    rng = np.random.default_rng(n_src * 7 + n_out)
    values = strings(rng, n_src)
    ints = rng.integers(-100, 100, n_src).astype(np.int64)
    if unique:
        n_out = min(n_out, n_src)
        idx = rng.permutation(n_src)[:n_out].astype(np.int64)
    else:
        idx = rng.integers(0, n_src, n_out).astype(np.int64)
    jb = _jax_batch(values, ints).to_device()
    import jax.numpy as jnp
    ref = jax_gather(jb, jnp.asarray(idx, dtype=jnp.int32), n_out)
    ref = ref.to_host().to_pydict() if n_out else {"s": [], "k": []}
    s = TorchSession(device="cpu")
    dev = s.transfers.upload_batch(HostColumnarBatch(
        [HostColumn.from_strings(values), HostColumn(ints, None, T.LONG)],
        n_src, ["s", "k"]))
    syncs = s.transfers.stats()["syncs"]
    got = BO.gather_batch(dev, torch.from_numpy(idx), s.transfers, unique)
    # a gather that may repeat rows reads its chars total: one sync
    assert s.transfers.stats()["syncs"] - syncs == (0 if unique else 1)
    assert s.transfers.download_batch(got).to_pydict() == ref


def test_int64_offsets_gather_like_int32_offsets():
    rng = np.random.default_rng(5)
    values = strings(rng, 60)
    c32 = HostColumn.from_strings(values)
    c64 = HostColumn(c32.data, c32.validity, T.STRING,
                     c32.offsets.astype(np.int64))
    s = TorchSession(device="cpu")
    idx = torch.from_numpy(rng.integers(0, 60, 90).astype(np.int64))
    outs = []
    for c in (c32, c64):
        dev = s.transfers.upload_column(c)
        outs.append(BO.gather_columns([dev], idx, s.transfers)[0])
    assert torch.equal(outs[0].offsets, outs[1].offsets)
    assert torch.equal(outs[0].data, outs[1].data)
    assert [values[i] for i in idx.tolist()] == HostColumn(
        outs[0].data.numpy(), outs[0].validity.numpy(), T.STRING,
        outs[0].offsets.numpy()).to_pylist()


def test_gather_refuses_other_devices_and_maps():
    s = TorchSession(device="cpu")
    dev = s.transfers.upload_column(HostColumn.from_strings(["a", "b"]))
    with pytest.raises(TypeError, match="int64"):
        BO.gather_columns([dev], torch.zeros(1, dtype=torch.int32),
                          s.transfers)
    meta = torch.zeros(1, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="different devices"):
        BO.gather_columns([dev], meta, s.transfers)



def test_substring_negative_pos_past_the_start_clamps_first():
    """A reference fault pinned (ROADMAP queue 3): Spark's substringSQL
    takes the end as ``start + len`` before it clamps ``start`` to 0, so
    ``substring('abc', -5, 3)`` is ``'a'`` and ``substring('ab', -5, 3)``
    is ``''``; both forms of the JAX package clamp first and give
    ``'abc'`` and ``'ab'``, and the port, which matches the reference,
    does the same on its CPU path (``Substring.eval``, and the byte view
    a filter compares)."""
    from spark_rapids_tpu import functions as JF
    from spark_rapids_tpu.session import TpuSession
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import (BoundReference,
                                                         Col, EvalContext,
                                                         lit)
    from spark_rapids_tpu_torch.expressions.predicates import EqualTo
    from spark_rapids_tpu_torch.expressions.strings import Substring
    values = ["abc", "ab", None, ""]
    schema = JT.StructType([JT.StructField("s", JT.STRING)])
    ref = {}
    for enabled in ("true", "false"):
        s = TpuSession({"spark.rapids.sql.enabled": enabled})
        ref[enabled] = [r["x"] for r in s.create_dataframe(
            {"s": values}, schema).select(
                JF.substring("s", -5, 3).alias("x")).collect()]
    c = HostColumn.from_strings(values)
    ctx = EvalContext([Col(torch.from_numpy(c.data),
                           torch.tensor([v is not None for v in values]),
                           torch.from_numpy(c.offsets))], 4,
                      torch.device("cpu"))
    got = Substring(BoundReference(0, T.STRING), -5, 3).eval(ctx)
    got = HostColumn(got.data.numpy(), got.valid.numpy(), T.STRING,
                     got.offsets.numpy()).to_pylist()
    assert got == ref["true"] == ref["false"] == ["abc", "ab", None, ""]
    df = TorchSession(device="cpu").create_dataframe({"s": values})
    kept = df.filter(EqualTo(F.substring("s", -5, 3), lit("abc"))).collect()
    assert kept == [{"s": "abc"}]
