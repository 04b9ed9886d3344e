"""The port's encoded columns (spark_rapids_tpu_torch/columnar/encoding.py,
K16 in ops/decode_ops.py) against the JAX package's
(spark_rapids_tpu/columnar/encoding.py) on JAX-CPU, on the same seeded
numpy inputs:

- K16's plain version against ``decode_dictionary`` (every fixed type and
  strings; null codes, null values, an empty dictionary) and
  ``decode_rle`` (null runs, rows past the last run): validity, data
  (zero under a null, doubles bit for bit) and string bytes exactly
  equal;
- ``classify_host_column``'s choice for each case (kept encoded with the
  same narrow codes, RLE with the same runs, plain) and the reason of each
  fallback (``valueType``, ``maxDictionarySize``, ``nullsInDictionary``,
  ``duplicateValues``) equal the JAX one's;
- the lookup table of a translated conjunct and its null verdict equal
  ``_build_lookup_table``'s for ``=``, ``IN``, ``LIKE``, a range and
  ``IS NULL``;
- the code-space plan translates the operands of an ``OR`` and a
  conjunct over two dictionary columns decodes them."""

import datetime
import gc

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import encoding as JENC
from spark_rapids_tpu.columnar.column import HostColumn as JHostColumn
from spark_rapids_tpu.expressions import base as JB
from spark_rapids_tpu.expressions import predicates as JP
from spark_rapids_tpu.expressions import strings as JS
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import encoding as ENC
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.transfer import TransferGateway
from spark_rapids_tpu_torch.expressions import base as B
from spark_rapids_tpu_torch.expressions import predicates as P
from spark_rapids_tpu_torch.expressions import strings as S
from spark_rapids_tpu_torch.ops import decode_ops as D


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
    """The plain versions run many small tensor ops; this module runs on
    one intra-op thread and restores the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TR = TransferGateway(torch.device("cpu"))
WORDS = ["", "a", "é", "abcdefg", "abcdefgh", "日本語", "ÿÿÿÿÿÿÿx",
         "a" * 40]


def values_of(kind: str, size: int, rng, nulls: bool):
    """A dictionary's values: ``size`` of ``kind``, 10% null with
    ``nulls``."""
    mask = rng.random(size) < 0.1 if nulls else None
    if kind == "string":
        data = [WORDS[i % len(WORDS)] + str(i) for i in range(size)]
        return pa.array(data, type=pa.string(), mask=mask)
    if kind == "bool":
        return pa.array(rng.random(size) < 0.5, mask=mask)
    if kind == "double":
        return pa.array(rng.normal(0, 1e3, size), mask=mask)
    if kind == "date":
        return pa.array(rng.integers(-1000, 20000, size).astype(np.int32),
                        mask=mask).cast(pa.date32())
    dt = np.int32 if kind == "int" else np.int64
    return pa.array(rng.integers(-10 ** 6, 10 ** 6, size).astype(dt),
                    mask=mask)


def jax_decode(values, codes, valid):
    """``decode_dictionary`` on JAX-CPU: (validity, data, lengths)."""
    import jax.numpy as jnp
    dic = JENC.Dictionary(values, JENC.Dictionary._fingerprint_of(values))
    data, v, lens = JENC.decode_dictionary(
        jnp.asarray(codes), jnp.asarray(valid), JENC._dict_planes(dic), jnp)
    return np.asarray(v), np.asarray(data), \
        None if lens is None else np.asarray(lens)


def port_values(values):
    return TR.upload_column(ENC.host_column_from_arrow(values))


def same_decode(values, codes, valid):
    jv, jdata, jlens = jax_decode(values, codes, valid)
    got = D.decode_dictionary_plain(torch.from_numpy(codes),
                                    torch.from_numpy(valid),
                                    port_values(values), TR)
    n = len(codes)
    np.testing.assert_array_equal(got.validity.numpy(), jv[:n])
    if got.is_string:
        raw = got.data.numpy().tobytes()
        offs = got.offsets.numpy()
        port = [raw[offs[i]:offs[i + 1]] for i in range(n)]
        ref = [jdata[i, :jlens[i]].tobytes() for i in range(n)]
        assert port == ref
        assert all(len(b) == 0 for b, ok in zip(port, jv) if not ok)
        return
    data = got.data.numpy()
    ref = jdata[:n]
    if data.dtype == np.float64:
        data, ref = data.view(np.int64), ref.view(np.int64)
    np.testing.assert_array_equal(data, ref.astype(data.dtype))
    assert not data[~jv[:n]].any()


@pytest.mark.parametrize("kind", ["string", "int", "long", "double", "bool",
                                  "date"])
@pytest.mark.parametrize("size", [0, 1, 7, 300])
def test_dictionary_decode_matches_jax(kind, size):
    """Null codes (10%), null values (10%), codes over every value."""
    rng = np.random.default_rng(size * 7 + len(kind))
    n = 1000
    for nulls in (False, True):
        values = values_of(kind, size, rng, nulls)
        codes = rng.integers(0, max(size, 1), n).astype(np.int32)
        for valid in (np.ones(n, bool), rng.random(n) >= 0.1,
                      np.zeros(n, bool)):
            same_decode(values, codes, valid)


@pytest.mark.parametrize("kind", ["int", "long", "double", "bool"])
def test_rle_decode_matches_jax(kind):
    """Runs of 1 to 60 rows, 10% of them null; rows past the last run are
    null (the JAX upload pads one invalid run to int32 max)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(len(kind))
    lens = rng.integers(1, 61, 40)
    ends = np.cumsum(lens).astype(np.int32)
    vals = values_of(kind, len(ends), rng, False)
    vnp = vals.to_numpy(zero_copy_only=False)
    rvalid = rng.random(len(ends)) >= 0.1
    # the runs cover the first ends[-1] rows; the 9 rows after are null
    n = int(ends[-1]) + 9
    data, v = JENC.decode_rle(
        jnp.asarray(np.append(vnp, vnp[:1])),
        jnp.asarray(np.append(rvalid, False)),
        jnp.asarray(np.append(ends, np.int32(2 ** 31 - 1))), n, jnp)
    dt = T.from_arrow(vals.type)
    got = D.decode_rle_plain(torch.from_numpy(vnp.astype(dt.np_dtype)),
                             torch.from_numpy(rvalid),
                             torch.from_numpy(ends), n, dt)
    np.testing.assert_array_equal(got.validity.numpy(), np.asarray(v))
    np.testing.assert_array_equal(got.data.numpy(),
                                  np.asarray(data).astype(dt.np_dtype))


def _dict_array(indices, values):
    return pa.DictionaryArray.from_arrays(pa.array(indices, type=pa.int32()),
                                          values)


CLASSIFY_CASES = {
    "kept": (_dict_array([0, 1, None, 2, 1], pa.array(["a", "bb", "é"])),
             None),
    "kept, 300 values (int16 codes)": (
        _dict_array(list(range(300)), pa.array([f"v{i}" for i in
                                               range(300)])), None),
    "maxDictionarySize": (_dict_array([0, 2, 1], pa.array(["a", "b", "c"])),
                          "maxDictionarySize"),
    "nullsInDictionary": (_dict_array([0, 1], pa.array(["a", None])),
                          "nullsInDictionary"),
    "duplicateValues": (_dict_array([0, 1, 2], pa.array(["a", "b", "a"])),
                        "duplicateValues"),
    "valueType": (_dict_array([0, 0], pa.nulls(1)), "valueType"),
}


@pytest.mark.parametrize("case", list(CLASSIFY_CASES))
def test_classify_matches_jax(case, monkeypatch):
    """The upload's choice and a fallback's reason equal the JAX
    package's; ``maxDictionarySize`` is 2 in its case."""
    import spark_rapids_tpu.aux.events as EV
    arr, reason = CLASSIFY_CASES[case]
    limit = 2 if case == "maxDictionarySize" else 1 << 16
    monkeypatch.setattr(JENC, "MAX_DICTIONARY_SIZE", limit)
    seen = []
    monkeypatch.setattr(EV, "emit", lambda kind, **kw: seen.append(
        kw.get("detail")))
    jdt = JT.STRING if pa.types.is_string(arr.dictionary.type) else None
    ref = JENC.classify_host_column(JHostColumn(arr, jdt))
    before = ENC.encoding_stats()["fallback_reasons"]
    got = ENC.classify_host_column(
        ENC.HostDictionaryColumn(arr),
        ENC.EncodingSettings(max_dictionary_size=limit))
    after = ENC.encoding_stats()["fallback_reasons"]
    assert (got is None) == (ref is None)
    if reason is None:
        assert got[0] == ref[0] == "dict"
        assert got[2].dtype == ref[2].dtype
        np.testing.assert_array_equal(got[2], ref[2])
        np.testing.assert_array_equal(got[3], ref[3])
        assert got[1].size == ref[1].size
    else:
        assert seen == [reason]
        assert after.get(reason, 0) == before.get(reason, 0) + 1


def test_classify_rle_and_disabled_match_jax(monkeypatch):
    """RLE on: a long column of runs of 10 ships the same runs; encoding
    off: a dictionary column goes up plain on both sides."""
    monkeypatch.setattr(JENC, "RLE_ENABLED", True)
    x = np.repeat(np.arange(64, dtype=np.int64), 10)
    ref = JENC.classify_host_column(JHostColumn(pa.array(x)))
    got = ENC.classify_host_column(
        ENC.host_column_from_arrow(pa.array(x)),
        ENC.EncodingSettings(rle_enabled=True))
    assert got[0] == ref[0] == "rle"
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(g, r)
    monkeypatch.setattr(JENC, "ENCODING_ENABLED", False)
    arr = CLASSIFY_CASES["kept"][0]
    assert JENC.classify_host_column(JHostColumn(arr, JT.STRING)) is None
    assert ENC.classify_host_column(
        ENC.HostDictionaryColumn(arr), ENC.EncodingSettings(enabled=False)
    ) is None


def _tables(values, jexpr, expr):
    jd = JENC.Dictionary(values, JENC.Dictionary._fingerprint_of(values))
    jtable, jnull = JENC._build_lookup_table(jd, jexpr, 0, 1)
    table = ENC.lookup_table(ENC.Dictionary.of(values), expr, 0, None,
                             TR).numpy()
    return (np.asarray(jtable)[:len(values)], bool(jnull)), \
        (table[1:].astype(bool), bool(table[0]))


STRINGS = pa.array(["ab", "a", "b", "abc", "axb", "é", "", "aab"])


def _lookup_cases():
    js, s = JB.BoundReference(0, JT.STRING), B.BoundReference(0, T.STRING)
    ji, i = JB.BoundReference(0, JT.INT), B.BoundReference(0, T.INT)
    return {
        "=": (STRINGS, JP.EqualTo(js, JB.Literal("b")),
              P.EqualTo(s, B.Literal("b"))),
        "IN": (STRINGS, JP.In(js, ["a", "axb", "zz"]),
               P.In(s, ["a", "axb", "zz"])),
        "LIKE": (STRINGS, JS.Like(js, JB.Literal("a%b")),
                 S.Like(s, "a%b")),
        "LIKE _": (STRINGS, JS.Like(js, JB.Literal("a_b")),
                   S.Like(s, "a_b")),
        "range": (pa.array(np.arange(-5, 15, dtype=np.int32)),
                  JP.And(JP.GreaterThanOrEqual(ji, JB.Literal(3)),
                         JP.LessThan(ji, JB.Literal(9))),
                  P.And(P.GreaterThanOrEqual(i, B.Literal(3)),
                        P.LessThan(i, B.Literal(9)))),
        "IS NULL": (STRINGS, JP.IsNull(js), P.IsNull(s)),
        "IS NULL OR =": (STRINGS, JP.Or(JP.IsNull(js),
                                        JP.EqualTo(js, JB.Literal("a"))),
                         P.Or(P.IsNull(s), P.EqualTo(s, B.Literal("a")))),
    }


@pytest.mark.parametrize("case", list(_lookup_cases()))
def test_lookup_table_matches_jax(case):
    """The table over the dictionary's values and the null verdict (true
    for IS NULL: a null row passes)."""
    values, jexpr, expr = _lookup_cases()[case]
    (jt, jn), (t, n) = _tables(values, jexpr, expr)
    np.testing.assert_array_equal(t, jt)
    assert n == jn
    assert jt.any() or jn   # a case that keeps nothing proves little


def test_code_space_plan_translates_or_and_decodes_two_columns():
    """``a = 'x' OR b = 'y'`` (q7's promotion filter) becomes two lookups;
    ``a = b`` reads two dictionary columns and decodes both; a computed
    output over a dictionary column decodes it."""
    values = pa.array(["x", "y"])
    dic = ENC.Dictionary.of(values)

    def dcol(codes):
        return ENC.DictionaryColumn(torch.tensor(codes, dtype=torch.int32),
                                    torch.ones(len(codes), dtype=torch.bool),
                                    T.STRING, dic, True)
    batch = ColumnarBatch([dcol([0, 1]), dcol([1, 1])], 2, ["a", "b"])
    a, b = B.BoundReference(0, T.STRING), B.BoundReference(1, T.STRING)
    plan = ENC.plan_code_space([P.Or(P.EqualTo(a, B.Literal("x")),
                                     P.EqualTo(b, B.Literal("y")))], [],
                               batch)
    assert plan.kept == (0, 1) and plan.decode == ()
    assert len(plan.slots) == 2
    assert isinstance(plan.conditions[0].children[0], ENC.DictContains)
    plan = ENC.plan_code_space([P.EqualTo(a, b)], [], batch)
    assert plan.decode == (0, 1) and not plan.slots
    plan = ENC.plan_code_space([P.EqualTo(a, B.Literal("x"))],
                               [S.Substring(b, 1, 1)], batch)
    assert plan.kept == (0,) and plan.decode == (1,)
    cooked, tables = ENC.encoded_inputs(plan, batch, None, TR)
    assert cooked.columns[1].is_string and len(tables) == 1
    assert not ENC.is_encoded(cooked.columns[0])


def test_dictionary_crosses_once_and_codes_are_narrow():
    """Two uploads of one dictionary: its values cross once; codes cross
    as int8 and are int32 on the device; the download reassembles the
    host dictionary array from the codes."""
    from spark_rapids_tpu_torch.columnar.batch import HostColumnarBatch
    values = pa.array([f"w{i}" for i in range(5)] +
                      [datetime.date.today().isoformat()])
    arr = _dict_array([0, 5, None, 3], values)
    tr = TransferGateway(torch.device("cpu"))
    hb = HostColumnarBatch([ENC.HostDictionaryColumn(arr)], 4, ["s"])
    settings = ENC.EncodingSettings()
    first = tr.upload_batch(hb, settings)
    copies = tr.stats()["h2d_copies"]
    second = tr.upload_batch(hb, settings)
    # codes and validity only, the second time
    assert tr.stats()["h2d_copies"] - copies == 2
    assert tr.stats()["h2d_bytes"] > 0
    c = second.columns[0]
    assert isinstance(c, ENC.DictionaryColumn) and c.data.dtype == \
        torch.int32
    assert first.columns[0].dictionary is c.dictionary
    down = tr.download_batch(second)
    assert isinstance(down.columns[0], ENC.HostDictionaryColumn)
    assert down.to_pydict() == {"s": ["w0", values[5].as_py(), None,
                                      "w3"]}
