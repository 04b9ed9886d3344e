"""Kernel 2's module (spark_rapids_tpu_torch/ops/agg_ops.py) against the JAX
function it replaces, ops/agg_ops.py global_agg_trace, run through jnp on
JAX-CPU with the same numpy inputs.

Long sums (wrapping) and counts are exact; double sums agree within
1e-12 * sum|x| because the two sum in different orders; min and max are
exact with NaN greatest; an empty or all-null input gives NULL."""

import gc
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.ops.agg_ops import global_agg_trace
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.ops import agg_ops as G


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


F64_RTOL = 1e-12
_TYPES = {"long": (T.LONG, JT.LONG, np.int64),
          "int": (T.INT, JT.INT, np.int32),
          "double": (T.DOUBLE, JT.DOUBLE, np.float64)}


def _data(rng, kind, n, variant):
    if kind == "double":
        x = rng.standard_normal(n) * 1e3
        if variant == "nan":
            x[rng.random(n) < 0.2] = np.nan
        if variant == "specials":
            x[rng.random(n) < 0.1] = -0.0
            x[rng.random(n) < 0.05] = np.inf
        return x
    info = np.iinfo(_TYPES[kind][2])
    if variant == "wrap":
        return np.full(n, info.max - 3, dtype=_TYPES[kind][2])
    return rng.integers(info.min // 4, info.max // 4, n,
                        dtype=_TYPES[kind][2])


def _run_both(columns, specs):
    """columns: [(kind, data, valid)]; specs: [(ordinal, kind, cvo)]."""
    n = len(columns[0][1])
    # the JAX package reduces padded planes under an in-row mask; one
    # padding row (present, but outside the mask) keeps n = 0 reducible
    jcols = [types.SimpleNamespace(
        data=jnp.asarray(np.append(d, d[:1] if n else np.zeros(1, d.dtype))),
        validity=jnp.asarray(np.append(v, True)), lengths=None)
        for _k, d, v in columns]
    jspecs = [(o, k, cv, _TYPES[columns[o][0]][1]) for o, k, cv in specs]
    ref = global_agg_trace(jcols, jnp.arange(n + 1) < n, jspecs, jnp)
    ref = [(np.asarray(d)[0], bool(np.asarray(v)[0])) for d, v, _ln in ref]
    pcols = [DeviceColumn(torch.from_numpy(d.copy()), torch.from_numpy(v),
                          _TYPES[k][0]) for k, d, v in columns]
    pspecs = []
    for o, k, cv in specs:
        dt = _TYPES[columns[o][0]][0]
        out_dt = T.LONG if k == "count" or (k == "sum" and dt.is_integral) \
            else dt
        pspecs.append((o, k, cv, out_dt))
    got = G.global_aggregate(ColumnarBatch(pcols, n, ["c"] * len(pcols)),
                             pspecs)
    got = [(c.data.numpy()[0], bool(c.validity.numpy()[0]))
           for c in got.columns]
    return ref, got


def _assert_match(ref, got, columns, specs):
    for (rv, rok), (gv, gok), (o, kind, cv) in zip(ref, got, specs):
        assert rok == gok, (kind, rok, gok)
        if not rok:
            continue
        ckind, d, v = columns[o]
        if ckind == "double" and kind == "sum":
            if np.isnan(rv) or np.isinf(rv):
                assert (np.isnan(rv) and np.isnan(gv)) or rv == gv
            else:
                bound = F64_RTOL * np.abs(d[v]).sum()
                assert abs(gv - rv) <= bound, (gv, rv, bound)
        elif ckind == "double":
            assert (np.isnan(rv) and np.isnan(gv)) or rv == gv, (kind, rv, gv)
        else:
            assert int(gv) == int(rv), (kind, gv, rv)


@pytest.mark.parametrize("n", [0, 1, 7, 4099])
@pytest.mark.parametrize("variant", ["plain", "nan", "specials", "wrap",
                                     "all_null"])
def test_global_aggregate_matches_jax(n, variant):
    rng = np.random.default_rng(n * 7 + len(variant))
    columns = []
    for kind in ("long", "double", "int"):
        valid = np.zeros(n, bool) if variant == "all_null" \
            else rng.random(n) > 0.2
        columns.append((kind, _data(rng, kind, n, variant), valid))
    specs = [(0, "sum", True), (0, "count", True), (0, "count", False),
             (0, "min", True), (0, "max", True),
             (1, "sum", True), (1, "count", True), (1, "min", True),
             (1, "max", True),
             (2, "sum", True), (2, "min", True), (2, "max", True)]
    ref, got = _run_both(columns, specs)
    _assert_match(ref, got, columns, specs)


def test_nan_is_greatest():
    x = np.array([1.0, np.nan, -2.0])
    columns = [("double", x, np.ones(3, bool))]
    ref, got = _run_both(columns, [(0, "min", True), (0, "max", True)])
    assert got[0][0] == -2.0 and np.isnan(got[1][0])
    assert ref[0][0] == -2.0 and np.isnan(ref[1][0])
    only_nan = [("double", np.array([np.nan, np.nan]), np.ones(2, bool))]
    _ref, got = _run_both(only_nan, [(0, "min", True)])
    assert np.isnan(got[0][0]) and got[0][1]


def test_reduce_plain_matches_words_api():
    """The word-table API: double columns ride as their bits."""
    vals = torch.tensor([[5, 0], [-3, 0]], dtype=torch.int64)
    vals[:, 1] = torch.tensor([1.5, 2.25], dtype=torch.float64).view(
        torch.int64)
    valid = torch.ones(2, 2, dtype=torch.bool)
    words, ok = G.global_reduce(vals, valid, [G.SUM_I64, G.SUM_F64])
    assert words[0].item() == 2
    assert words[1:2].view(torch.float64).item() == 3.75
    assert ok.tolist() == [True, True]


def test_unsupported_kind_raises():
    # first and last are kernel 2 kinds; mean is not
    with pytest.raises(NotImplementedError, match="mean"):
        G.reduce_kind("mean", T.DOUBLE)
    with pytest.raises(NotImplementedError, match="min"):
        G.reduce_kind("min", T.STRING)
    with pytest.raises(ValueError, match="kinds"):
        G.global_reduce(torch.zeros(1, 2, dtype=torch.int64),
                        torch.ones(1, 2, dtype=torch.bool), [G.SUM_I64])


@pytest.mark.cuda
def test_kernel2_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("kernel 2 is CUDA C++ and runs only on an NVIDIA card")
    rng = np.random.default_rng(5)
    kinds = [G.SUM_I64, G.SUM_F64, G.COUNT, G.MIN_I64, G.MAX_I64,
             G.MIN_F64, G.MAX_F64]
    n = 4097
    cols = []
    for kind in kinds:
        if kind in (G.SUM_F64, G.MIN_F64, G.MAX_F64):
            x = rng.standard_normal(n)
            x[rng.random(n) < 0.05] = np.nan
            cols.append(x.view(np.int64))
        else:
            cols.append(rng.integers(-(2 ** 62), 2 ** 62, n))
    values = torch.from_numpy(np.stack(cols, 1)).cuda()
    valid = torch.from_numpy(rng.random((n, len(kinds))) > 0.2).cuda()
    before = G.LAUNCHES
    words, ok = G.global_reduce(values, valid, kinds)
    assert G.LAUNCHES == before + 1
    ref_words, ref_ok = G.global_reduce_plain(values, valid, kinds)
    assert torch.equal(ok, ref_ok)
    for j, kind in enumerate(kinds):
        if kind == G.SUM_F64:
            a = words[j:j + 1].view(torch.float64).item()
            b = ref_words[j:j + 1].view(torch.float64).item()
            assert np.isnan(a) == np.isnan(b)
        else:
            assert words[j].item() == ref_words[j].item()
