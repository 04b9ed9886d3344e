"""min, max, first and last on the port (K9's new kinds in a group-by and
its FINAL merge, K1's update forms and K3's fold and merge, K7 for a
string first/last) against the JAX package, on the same seeded numpy
planes: int, date, long and double inputs with nulls, NaN, +-inf, -0.0
and 0.0, an all-null group and an all-NaN group, and strings for first
and last.

- Kernel level, the plain versions (what the CPU runs, and what the card
  holds each kernel against): K9's kinds against ``_segment_reduce`` and,
  for strings, ``_lengths_reduce`` over the same groups; K3's kinds against
  ``_global_reduce``; K1's update forms (then K3's fold and K7) against
  ``_global_reduce`` over the rows the filter keeps.  Min and max equal
  bit for bit (-0.0 below 0.0 in either row order, as the JAX device path
  gives them; NaN greater than every value), first and last exactly, and
  each keeps its input's type.
- DataFrame level: ``group_by(...).agg(min, max, first, last,
  first(ignore_nulls=True), ...)`` and the global form against the JAX
  device path (``TpuSession({})``) at 1, 2 and 3 partitions.
- A global ``first`` over a partition that keeps no row is null, as both
  JAX engines give it (ROADMAP queue 3: Spark gives the next partition's
  value); a string ``min``/``max`` is refused by name, as on the JAX
  device path."""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import batch_from_pydict as j_batch
from spark_rapids_tpu.ops.agg_ops import (_global_reduce, _lengths_reduce,
                                          _segment_reduce)
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (batch_from_numpy,
                                                   batch_from_pydict)
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec.fused import (LiteralArgs,
                                               TorchFusedAggExec,
                                               fused_agg_update_plain)
from spark_rapids_tpu_torch.expressions.base import col, lit
from spark_rapids_tpu_torch.expressions.predicates import GreaterThan
from spark_rapids_tpu_torch.ops import agg_ops as G
from spark_rapids_tpu_torch.ops.batch_ops import gather_columns


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
    threads in each pytest worker makes them contend for the cores.  This
    module runs on one thread and restores the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 600
#: the group of every null value, and the group of every NaN (doubles)
ALL_NULL, ALL_NAN = 10, 11
#: the groups of doubles that are all zeros, and the zero each starts with
ZEROS = {3: 0.0, 4: -0.0}
KINDS = ("min", "max", "first", "last", "first_valid", "last_valid")
TYPES = {"int": (T.INT, np.int32), "date": (T.DATE, np.int32),
         "long": (T.LONG, np.int64), "double": (T.DOUBLE, np.float64)}
STEMS = ["", "a", "ab", "abcdefgh", "zz", "日本", "é"]


def planes(seed: int = 5, n: int = N):
    """Group ids (12 groups, two of them special), a value plane of each
    type and a validity plane (about 15% null; none in ``ALL_NULL``)."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 12, n).astype(np.int32)
    valid = (rng.random(n) > 0.15) & (g != ALL_NULL)
    v = rng.normal(0.0, 100.0, n)
    for value in (np.nan, np.inf, -np.inf, 0.0, -0.0):
        v[rng.random(n) < 0.05] = value
    v[g == ALL_NAN] = np.nan
    # groups of zeros alone, 0.0 first in one and -0.0 first in the other
    for group, first in ZEROS.items():
        rows = np.flatnonzero(g == group)
        v[rows] = np.where(np.arange(len(rows)) % 2 == 0, first, -first)
        valid[rows[:2]] = True
    x64 = rng.integers(-10 ** 12, 10 ** 12, n)
    x64[rng.random(n) < 0.05] = np.iinfo(np.int64).min
    x64[rng.random(n) < 0.05] = np.iinfo(np.int64).max
    x32 = rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
    days = rng.integers(-20000, 30000, n).astype(np.int32)
    strings = [STEMS[i] for i in rng.integers(0, len(STEMS), n)]
    return {"g": g, "valid": valid,
            "values": {"int": x32, "date": days, "long": x64, "double": v},
            "strings": strings}


def port_column(x: np.ndarray, valid: np.ndarray, dt) -> DeviceColumn:
    return DeviceColumn(torch.from_numpy(x.copy()),
                        torch.from_numpy(valid.copy()), dt)


def bits(x: np.ndarray) -> np.ndarray:
    """Integers as they are; doubles as their bit patterns."""
    x = np.asarray(x)
    return x.view(np.int64) if x.dtype == np.float64 else x.astype(np.int64)


def same(port_data, port_valid, ref_data, ref_valid, what: str) -> None:
    """Validity equal; where valid, values equal bit for bit."""
    pv, rv = np.asarray(port_valid), np.asarray(ref_valid)
    assert np.array_equal(pv, rv), what
    assert np.array_equal(bits(np.asarray(port_data))[pv],
                          bits(np.asarray(ref_data))[rv]), what


@pytest.fixture(scope="module")
def data():
    return planes()


@pytest.fixture(scope="module")
def groups(data):
    keys = [port_column(data["g"], np.ones(N, bool), T.INT)]
    gid, _rep = G.group_rows_plain(keys, None)
    return keys, gid


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", list(TYPES))
def test_k9_plain_matches_segment_reduce(data, groups, name, kind):
    dt, np_type = TYPES[name]
    x, valid = data["values"][name].astype(np_type), data["valid"]
    keys, gid = groups
    c = port_column(x, valid, dt)
    rep, [(got, ok)] = G.keyed_aggregate_plain(keys, [c], [G.KEYED_KINDS[kind]],
                                               None)
    assert got.dtype == c.data.dtype, "the result keeps the input's type"
    n_groups = rep.shape[0]
    ref, ref_ok = _segment_reduce(kind, jnp.asarray(x), jnp.asarray(valid),
                                  jnp.asarray(gid.numpy()),
                                  jnp.ones(N, dtype=bool), n_groups, jnp)
    same(got.numpy(), ok.numpy(), ref, ref_ok, f"K9 {kind} of {name}")
    if name == "double" and kind in ("min", "max"):
        for group in ZEROS:
            at = int(gid[int(np.flatnonzero(data["g"] == group)[0])])
            assert got[at].item() == 0.0
            assert np.signbit(got[at].item()) == (kind == "min")


def jax_strings(strings, valid):
    hb = j_batch({"s": [s if ok else None for s, ok in zip(strings, valid)]},
                 JT.StructType([JT.StructField("s", JT.STRING, True)]))
    return hb.to_device().columns[0]


def decode(data, lens, ok):
    data, lens = np.asarray(data), np.asarray(lens)
    return [bytes(data[i, :lens[i]]).decode("utf-8") if ok[i] else None
            for i in range(len(ok))]


@pytest.mark.parametrize("kind", KINDS[2:])
def test_k9_plain_string_rows_match_lengths_reduce(data, groups, kind):
    keys, gid = groups
    strings, valid = data["strings"], data["valid"]
    c = port_strings(strings, valid)
    rep, [(rows, ok)] = G.keyed_aggregate_plain(keys, [c],
                                                [G.KEYED_KINDS[kind]], None)
    got = gather_columns([c], rows, None, unique=True, nullable=True)[0]
    n_groups = rep.shape[0]
    jc = jax_strings(strings, valid)
    bucket = jc.data.shape[0]
    seg = np.zeros(bucket, np.int64)
    seg[:N] = gid.numpy()
    inrow = jnp.arange(bucket) < N
    d, v, lens = _lengths_reduce(kind, jc, jc.validity, jnp.asarray(seg),
                                 inrow, n_groups, jnp)
    ref = decode(d, lens, np.asarray(v))
    got_s = [None if not ok_ else s for s, ok_ in
             zip(column_strings(got), got.validity.tolist())]
    assert got_s == ref
    assert torch.equal(ok, got.validity)


def port_strings(strings, valid) -> DeviceColumn:
    s = TorchSession(device="cpu")
    hb = batch_from_pydict(
        {"s": [x if ok else None for x, ok in zip(strings, valid)]},
        T.StructType([T.StructField("s", T.STRING, True)]))
    return s.transfers.upload_batch(hb).columns[0]


def column_strings(c: DeviceColumn):
    off = c.offsets.tolist()
    raw = c.data.numpy().tobytes()
    return [raw[off[i]:off[i + 1]].decode("utf-8") for i in range(c.row_count)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", list(TYPES))
def test_k3_plain_matches_global_reduce(data, name, kind):
    dt, np_type = TYPES[name]
    x, valid = data["values"][name].astype(np_type), data["valid"]
    special = (ALL_NULL, ALL_NAN, *ZEROS) if name == "double" \
        else (ALL_NULL,)
    for rows in [slice(0, N)] + [np.flatnonzero(data["g"] == group)
                                 for group in special]:
        xs, vs = x[rows], valid[rows]
        c = port_column(xs, vs, dt)
        words, ok, kinds = G.pack_columns([c], [(0, kind, True, dt)])
        got, got_ok = G.global_reduce_plain(words, ok, kinds)
        ref, ref_ok = _global_reduce(kind, jnp.asarray(xs), jnp.asarray(vs),
                                     jnp.ones(len(xs), dtype=bool), jnp)
        w = got[:1]
        value = w.view(torch.float64) if dt.is_floating else w
        same(value.numpy(), got_ok.numpy(), np.asarray(ref).reshape(1),
             np.asarray(ref_ok).reshape(1), f"K3 {kind} of {name}")


def fused_exec(df):
    found = []

    def visit(node):
        if isinstance(node, TorchFusedAggExec):
            found.append(node)
        for c in node.children:
            visit(c)
    visit(df.executed_plan())
    assert len(found) == 1
    return found[0]


def test_k1_plain_update_forms_match_global_reduce(data):
    """K1's plain update over the rows ``w > 0`` keeps (min and max of
    each type, every row-order kind of each type and of a string), then
    K3's fold and K7's gather, against ``_global_reduce`` over the same
    selection."""
    s = TorchSession(device="cpu")
    valid = data["valid"]
    w = np.random.default_rng(9).integers(-3, 3, N).astype(np.int32)
    frame = {name: data["values"][name].astype(np_type)
             for name, (_dt, np_type) in TYPES.items()}
    schema = T.StructType([T.StructField("w", T.INT, True)] +
                          [T.StructField(n, TYPES[n][0], True)
                           for n in TYPES] +
                          [T.StructField("s", T.STRING, True)])
    df = s.create_dataframe(batch_from_numpy(
        [(w, None)] + [(frame[n], valid) for n in TYPES] +
        [(data["strings"], valid)], schema))
    aggs = []
    for name in list(TYPES) + ["s"]:
        for kind in KINDS:
            if name == "s" and kind in ("min", "max"):
                continue
            base = kind.split("_")[0]
            fn = {"min": F.min, "max": F.max, "first": F.first,
                  "last": F.last}[base]
            e = fn(name) if base in ("min", "max") else \
                fn(name, kind.endswith("_valid"))
            aggs.append((name, kind, e.alias(f"{kind}_{name}")))
    q = df.filter(GreaterThan(col("w"), lit(0))).agg(*[a for *_x, a in aggs])
    fx = fused_exec(q)
    batch = s.transfers.upload_batch(df._plan.partitions[0][0])
    lits = LiteralArgs.upload(fx.promoted, s.transfers)
    words, ok = fused_agg_update_plain(fx.program, batch, lits)
    row, row_ok = G.global_reduce_plain(words, ok, fx.program.fold_kinds)
    got = fx.program.buffer_row(row, row_ok, batch,
                                fx.scalar.buffer_names, s.transfers)
    sel = jnp.asarray(w > 0)
    jstrings = jax_strings(data["strings"], valid)
    for j, (name, kind, _e) in enumerate(aggs):
        c = got.columns[j]
        if name == "s":
            bucket = jstrings.data.shape[0]
            inrow = np.zeros(bucket, bool)
            inrow[:N] = w > 0
            d, v, lens = _lengths_reduce(
                kind, jstrings, jstrings.validity,
                jnp.zeros(bucket, dtype=jnp.int64), jnp.asarray(inrow), 1,
                jnp)
            want = decode(d, lens, np.asarray(v))[0]
            have = column_strings(c)[0] if bool(c.validity[0]) else None
            assert have == want, (kind, have, want)
            continue
        x = frame[name]
        ref, ref_ok = _global_reduce(kind, jnp.asarray(x), jnp.asarray(valid),
                                     sel, jnp)
        same(c.data.numpy(), c.validity.numpy(), np.asarray(ref).reshape(1),
             np.asarray(ref_ok).reshape(1), f"K1 {kind} of {name}")
        assert c.data.dtype == torch.from_numpy(x[:1]).dtype


# -- DataFrame level ----------------------------------------------------------

def frame_values(seed: int = 21, n: int = 300):
    rng = np.random.default_rng(seed)

    def nulls(vs, p=0.12):
        return [None if rng.random() < p else v for v in vs]
    v = rng.normal(0.0, 50.0, n)
    for value in (np.nan, np.inf, -np.inf, -0.0, 0.0):
        v[rng.random(n) < 0.04] = value
    k = [int(x) for x in rng.integers(0, 7, n)]
    vv = nulls([float(x) for x in v])
    # key 6: every value null; key 5: every value NaN
    vv = [None if kk == 6 else (float("nan") if kk == 5 else x)
          for kk, x in zip(k, vv)]
    return {"k": nulls(k, 0.05),
            "i": nulls([int(x) for x in rng.integers(-10 ** 6, 10 ** 6, n)]),
            "l": nulls([int(x) for x in rng.integers(-2 ** 62, 2 ** 62, n)]),
            "v": vv,
            "s": nulls([str(rng.choice(STEMS)) for _ in range(n)])}


FRAME_COLUMNS = [("k", JT.INT, T.INT), ("i", JT.INT, T.INT),
                 ("l", JT.LONG, T.LONG), ("v", JT.DOUBLE, T.DOUBLE),
                 ("s", JT.STRING, T.STRING)]


def frames(n_parts: int):
    vals = frame_values()
    jschema = JT.StructType([JT.StructField(n, jt, True)
                             for n, jt, _pt in FRAME_COLUMNS])
    pschema = T.StructType([T.StructField(n, pt, True)
                            for n, _jt, pt in FRAME_COLUMNS])
    port = TorchSession(device="cpu").create_dataframe(
        vals, num_partitions=n_parts, schema=pschema)
    jax = TpuSession({}).create_dataframe(vals, num_partitions=n_parts,
                                          schema=jschema)
    return port, jax


def folds(f):
    return [f.min("i").alias("mn_i"), f.max("i").alias("mx_i"),
            f.min("l").alias("mn_l"), f.max("l").alias("mx_l"),
            f.min("v").alias("mn_v"), f.max("v").alias("mx_v"),
            f.first("v").alias("f_v"), f.last("v").alias("l_v"),
            f.first("v", True).alias("fv_v"), f.last("l", True).alias("lv_l"),
            f.first("s").alias("f_s"), f.last("s", True).alias("lv_s"),
            f.first("i").alias("f_i"), f.last("i", True).alias("lv_i")]


@pytest.mark.parametrize("n_parts", [1, 2, 3])
def test_group_by_matches_the_jax_device_path(n_parts):
    port, jax = frames(n_parts)
    got = port.group_by("k").agg(*folds(F)).collect()
    ref = jax.group_by("k").agg(*folds(JF)).collect()
    assert len(got) == 8
    assert rows_equal(ref, got, approx_float=False) is None, (ref, got)


@pytest.mark.parametrize("n_parts", [1, 2, 3])
def test_global_matches_the_jax_device_path(n_parts):
    port, jax = frames(n_parts)
    got = port.filter(GreaterThan(col("i"), lit(-500000))) \
        .agg(*folds(F)).collect()
    ref = jax.filter(JF.col("i") > -500000).agg(*folds(JF)).collect()
    assert rows_equal(ref, got, check_order=True, approx_float=False) \
        is None, (ref, got)


def test_global_first_over_an_empty_partition_is_null():
    """The reference fault (ROADMAP queue 3), pinned: the first of two
    partitions keeps no row of ``w > 1``, its buffer is null, and the
    merge takes the first buffer row.  Both JAX engines and the port give
    None (Spark, whose ``First`` keeps a value-set flag, gives 4); at one
    partition all give 4."""
    d = {"k": [1, 2, 3, 4, 5, 6], "w": [0, 0, 0, 5, 5, 5]}
    jsch = JT.StructType([JT.StructField("k", JT.LONG, True),
                          JT.StructField("w", JT.INT, True)])
    psch = T.StructType([T.StructField("k", T.LONG, True),
                         T.StructField("w", T.INT, True)])
    for parts, want in ((2, None), (1, 4)):
        got = TorchSession(device="cpu").create_dataframe(
            d, num_partitions=parts, schema=psch) \
            .filter(GreaterThan(col("w"), lit(1))).agg(F.first("k")) \
            .collect()
        for conf in ({}, {"spark.rapids.sql.enabled": "false"}):
            ref = TpuSession(conf).create_dataframe(
                d, num_partitions=parts, schema=jsch) \
                .filter(JF.col("w") > 1).agg(JF.first("k")).collect()
            assert [list(r.values()) for r in ref] == [[want]]
        assert [list(r.values()) for r in got] == [[want]]


def test_string_min_and_max_are_refused_by_name():
    port, _jax = frames(1)
    for fn in (F.min, F.max):
        with pytest.raises(NotImplementedError,
                           match="min/max over strings not on device yet"):
            port.group_by("k").agg(fn("s")).collect()
        with pytest.raises(NotImplementedError,
                           match="min/max over strings not on device yet"):
            port.agg(fn("s")).collect()
