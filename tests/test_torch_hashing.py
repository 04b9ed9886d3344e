"""The port's murmur3 (spark_rapids_tpu_torch/expressions/hashing.py) against
the JAX package's Murmur3Hash / murmur3_col run through jnp on JAX-CPU:
bit-exact for int and long columns, nulls, the extremes of both types and a
chained pair."""

import gc
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.expressions import base as JB
from spark_rapids_tpu.expressions import hashing as JH
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions import base as PB
from spark_rapids_tpu_torch.expressions import hashing as PH


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


INT_EXTREMES = [-(2 ** 31), 2 ** 31 - 1, -1, 0, 1, 42]
LONG_EXTREMES = [-(2 ** 63), 2 ** 63 - 1, -1, 0, 1, 2 ** 32, -(2 ** 32)]

_JT = {"int": JT.INT, "long": JT.LONG}
_PT = {"int": T.INT, "long": T.LONG}
_NP = {"int": np.int32, "long": np.int64}


def _column(rng, kind, n, nulls):
    info = np.iinfo(_NP[kind])
    data = rng.integers(info.min, info.max, n, dtype=_NP[kind],
                        endpoint=True)
    extremes = INT_EXTREMES if kind == "int" else LONG_EXTREMES
    data[:len(extremes)] = extremes
    valid = rng.random(n) > 0.25 if nulls else np.ones(n, dtype=bool)
    return data, valid


def _jax_hash(columns, kinds):
    n = len(columns[0][0])
    tcols = [JB.TCol(jnp.asarray(d), jnp.asarray(v), _JT[k])
             for (d, v), k in zip(columns, kinds)]
    refs = [JB.BoundReference(i, _JT[k]) for i, k in enumerate(kinds)]
    ctx = JB.EvalContext(tcols, "tpu", n)
    out = JH.Murmur3Hash(*refs).eval_tpu(ctx)
    return np.asarray(out.data)


def _port_hash(columns, kinds):
    n = len(columns[0][0])
    cols = [PB.Col(torch.from_numpy(d), torch.from_numpy(v))
            for d, v in columns]
    refs = [PB.BoundReference(i, _PT[k]) for i, k in enumerate(kinds)]
    ctx = PB.EvalContext(cols, n, torch.device("cpu"))
    out = PH.Murmur3Hash(*refs).eval(ctx)
    assert out.data.dtype == torch.int32 and bool(out.valid.all())
    return out.data.numpy()


@pytest.mark.parametrize("kinds", [("int",), ("long",), ("long", "int"),
                                   ("int", "long", "int")])
@pytest.mark.parametrize("nulls", [False, True])
def test_murmur3_matches_jax(kinds, nulls):
    rng = np.random.default_rng(len(kinds) * 10 + nulls)
    columns = [_column(rng, k, 257, nulls) for k in kinds]
    np.testing.assert_array_equal(_port_hash(columns, kinds),
                                  _jax_hash(columns, kinds))


def test_murmur3_all_null_row_keeps_seed():
    # every field null: the hash is the seed (42) itself
    columns = [(np.array([7], np.int64), np.array([False])),
               (np.array([9], np.int32), np.array([False]))]
    assert _port_hash(columns, ("long", "int")).tolist() == [42]
    assert _jax_hash(columns, ("long", "int")).tolist() == [42]


@pytest.mark.parametrize("kind", ["int", "long"])
def test_murmur3_col_running_seed_matches_jax(kind):
    """murmur3_col with a per-row running seed, as a chain passes it on."""
    rng = np.random.default_rng(3)
    data, valid = _column(rng, kind, 100, True)
    seeds = rng.integers(0, 2 ** 32, 100, dtype=np.uint32)
    jctx = JB.EvalContext([], "tpu", 100)
    ref = JH.murmur3_col(JB.TCol(jnp.asarray(data), jnp.asarray(valid),
                                 _JT[kind]), _JT[kind],
                         jnp.asarray(seeds), jctx, jnp)
    got = PH.murmur3_col(PB.Col(torch.from_numpy(data),
                                torch.from_numpy(valid)), _PT[kind],
                         torch.from_numpy(seeds.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref).astype(np.int64))


def test_murmur3_refuses_double():
    """Kernel 1 still refuses murmur3 of a double by name; the plain form
    hashes it since the hash exchanges came in (K11h), -0.0 as 0.0, equal
    to the JAX package's murmur3_col."""
    from spark_rapids_tpu_torch.expressions.base import BoundReference
    from spark_rapids_tpu_torch.kernels import fused_agg as K
    data = np.array([0.0, -0.0, np.nan, 1.5], dtype=np.float64)
    valid = np.ones(4, dtype=bool)
    col = PB.Col(torch.from_numpy(data), torch.from_numpy(valid))
    got = PH.murmur3_col(col, T.DOUBLE, torch.zeros(4, dtype=torch.int64))
    ref = JH.murmur3_col(JB.TCol(jnp.asarray(data), jnp.asarray(valid),
                                 JT.DOUBLE), JT.DOUBLE,
                         jnp.zeros(4, dtype=jnp.uint32),
                         JB.EvalContext([], "tpu", 4), jnp)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref).astype(np.int64))
    assert got[0] == got[1]
    with pytest.raises(NotImplementedError, match="DoubleType"):
        K.kernel_source([T.DOUBLE], (True,), [],
                        [PH.Murmur3Hash(BoundReference(0, T.DOUBLE))],
                        [(0, "sum", True, T.LONG)], 0)
