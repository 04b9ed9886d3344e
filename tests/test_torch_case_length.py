"""length, upper, lower and substring by characters (K13's plain
versions, ops/string_ops.py) against the JAX package's ``eval_cpu``
(spark_rapids_tpu/expressions/strings.py: Length :42, Upper/Lower :68,
Substring :157), the JAX CPU engine's rule and Spark's.

- The inputs mix ASCII, 'é', 'ß' (upper gives "SS"), 'İ' (lower gives
  two code points), 'ǅ' (title case), 'ﬀ', CJK, 4-byte emoji, sigma in
  word-final and inner positions and after case-ignorable marks
  (Final_Sigma), nulls and empty strings; equality is exact, byte for
  byte.
- The JAX device forms differ (they map ASCII only and cut bytes:
  ROADMAP queue 3); the port keeps the CPU engine's rule.
- The smallest input of the old fault, ``substring("句読点テスト", 1,
  4)``, gives '句読点テ' as a written column (K13) and as a view compared
  in a filter (K5), as the JAX CPU engine gives it.
- Bytes that are not UTF-8 still give one answer: a continuation byte
  with no lead belongs to no character; a case map copies them.
- The K13 forms reach the planner: a projection's outputs and a
  filtering stage's survivors (``rows``), one sync each, none for the
  length."""

import gc

import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.config import TpuConf
from spark_rapids_tpu.expressions import base as JB
from spark_rapids_tpu.expressions import strings as JS
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, HostColumn
from spark_rapids_tpu_torch.exec import fused as FU
from spark_rapids_tpu_torch.expressions import base as B
from spark_rapids_tpu_torch.expressions import strings as S
from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
from spark_rapids_tpu_torch.expressions.predicates import (EqualTo,
                                                           GreaterThan)
from spark_rapids_tpu_torch.ops import string_ops as SO


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


STEMS = ["", "a", "Hello World", "句読点テスト", "émoji🎉", " spaced  ",
         "ß", "straße", "İstanbul", "ǅǆǄ", "ﬀ", "ΟΔΟΣ", "ΣΑΣ ΣΑΣ.",
         "aΣ", "Σ", "a'Σ", "aΣb", "xͅΣ", "ʰΣ", "aΣ̀", "aΣ̀b", "1Σ",
         "ΑΣ ", "ŉ", "ΐ", "日本語x", "é" * 20, "ÿé", "AbC-éÉ"]


def words(rng, n, null_frac=0.1):
    return [None if rng.random() < null_frac else
            STEMS[int(rng.integers(0, len(STEMS)))] for _ in range(n)]


def port_eval(expr, values):
    c = HostColumn.from_strings(values)
    ctx = B.EvalContext([B.Col(torch.from_numpy(c.data),
                               torch.tensor([v is not None for v in values]),
                               torch.from_numpy(c.offsets))],
                        len(values), torch.device("cpu"))
    out = expr.eval(ctx)
    if out.offsets is None:
        return [int(x) if ok else None
                for x, ok in zip(out.data.tolist(), out.valid.tolist())]
    raw, offs = out.data.numpy().tobytes(), out.offsets.tolist()
    return [raw[offs[i]:offs[i + 1]].decode("utf-8") if ok else None
            for i, ok in enumerate(out.valid.tolist())]


def cpu_eval(jexpr, values):
    ctx = JB.EvalContext([JB.TCol(np.array(values, dtype=object),
                                  np.array([v is not None for v in values]),
                                  JT.STRING)], "cpu", len(values))
    tc = jexpr.eval_cpu(ctx)
    return [None if not ok else (int(v) if jexpr.data_type == JT.INT
                                 else v)
            for v, ok in zip(tc.data, tc.valid)]


FUNCTIONS = {"length": (JS.Length, S.Length), "upper": (JS.Upper, S.Upper),
             "lower": (JS.Lower, S.Lower)}


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_length_upper_lower_match_eval_cpu(name):
    rng = np.random.default_rng(len(name))
    values = words(rng, 400) + STEMS
    jcls, pcls = FUNCTIONS[name]
    assert port_eval(pcls(B.BoundReference(0, T.STRING)), values) == \
        cpu_eval(jcls(JB.BoundReference(0, JT.STRING)), values)


def test_special_cases_by_name():
    got = port_eval(S.Upper(B.BoundReference(0, T.STRING)),
                    ["ß", "émoji🎉", "ﬀ"])
    assert got == ["SS", "ÉMOJI🎉", "FF"]
    got = port_eval(S.Lower(B.BoundReference(0, T.STRING)),
                    ["İ", "ΟΔΟΣ", "ΣΑΣ ΣΑΣ.", "Σ", "aΣb", "aΣ̀"])
    assert got == ["i̇", "οδος", "σας σας.", "σ", "aσb", "aς̀"]


SUBSTRINGS = [(1, 4), (1, 5), (2, 3), (0, 4), (3, None), (-1, None),
              (-3, 2), (-50, 3), (41, None), (8, 8), (1, 0), (2, -2),
              (1, 100), (-8, None)]


@pytest.mark.parametrize("pos,length", SUBSTRINGS)
def test_substring_by_characters_matches_eval_cpu(pos, length):
    rng = np.random.default_rng(abs(pos * 17 + (length or 0)))
    values = words(rng, 300) + STEMS
    assert port_eval(S.Substring(B.BoundReference(0, T.STRING), pos,
                                 length), values) == \
        cpu_eval(JS.Substring(JB.BoundReference(0, JT.STRING), pos,
                              length), values)


def test_the_fault_input_gives_the_cpu_engines_characters():
    """``substring("句読点テスト", 1, 4)``: the JAX CPU engine's
    '句読点テ', in K13's written form and in the K5 view."""
    js = TpuSession(TpuConf({"spark.rapids.sql.enabled": "false"}))
    ref = js.create_dataframe({"s": ["句読点テスト"]}).select(
        JF.substring(JB.col("s"), 1, 4).alias("p")).collect()
    assert ref == [{"p": "句読点テ"}]
    s = TorchSession(device="cpu")
    df = s.create_dataframe({"s": ["句読点テスト"]})
    assert df.select(F.substring(col("s"), 1, 4).alias("p")).collect() == \
        ref
    hit = df.filter(EqualTo(F.substring(col("s"), 1, 4),
                            lit("句読点テ"))).collect()
    assert hit == [{"s": "句読点テスト"}]


def test_bytes_outside_utf8_give_one_answer():
    """A stray continuation byte belongs to no character; an incomplete
    sequence's bytes are copied by a case map, as ``csrc/strings.cu``
    does."""
    raw = [b"\x80\x80ab", b"a\xe6\x97", b"\xff\xc3\xa9x", b"\xce\xa3\x80"]
    offsets = np.cumsum([0] + [len(r) for r in raw]).astype(np.int64)
    chars = torch.from_numpy(np.frombuffer(b"".join(raw), dtype=np.uint8)
                             .copy())
    offs = torch.from_numpy(offsets)
    valid = torch.ones(len(raw), dtype=torch.bool)
    count, _ok = SO.length_plain(chars, offs, valid)
    assert count.tolist() == [2, 2, 3, 1]
    first, ln = SO.substring_range(chars, offs[:-1], offs[1:], 1, 1)
    got = [bytes(chars[f:f + n].tolist())
           for f, n in zip(first.tolist(), ln.tolist())]
    assert got == [b"a", b"a", b"\xff", b"\xce\xa3\x80"]
    up, up_off = SO.case_map_plain(chars, offs, lower=False)
    out = up.numpy().tobytes()
    assert [out[up_off[i]:up_off[i + 1]] for i in range(len(raw))] == \
        [b"\x80\x80AB", b"A\xe6\x97", b"\xff\xc3\x89X", b"\xce\xa3\x80"]


def test_k13_forms_reach_projections_and_stages():
    s = TorchSession(device="cpu")
    values = ["ß", None, "aΣ", "Hello", "句読点テスト", ""]
    df = s.create_dataframe({"s": values, "k": list(range(6))},
                            num_partitions=2)
    prog = FU.StageProgram([("project", [
        Alias(S.Upper(B.BoundReference(0, T.STRING)), "u"),
        Alias(S.Length(B.BoundReference(0, T.STRING)), "n")])],
        df.schema, 0)
    assert [f.op for f in prog.strings] == [SO.UPPER, SO.LENGTH]
    assert prog.computed == []
    got = df.filter(GreaterThan(col("k"), lit(0))).select(
        Alias(F.upper(col("s")), "u"), Alias(F.lower(col("s")), "l"),
        Alias(F.length(col("s")), "n"), col("k")).collect()
    assert got == [{"u": None, "l": None, "n": None, "k": 1},
                   {"u": "AΣ", "l": "aς", "n": 2, "k": 2},
                   {"u": "HELLO", "l": "hello", "n": 5, "k": 3},
                   {"u": "句読点テスト", "l": "句読点テスト", "n": 6,
                    "k": 4},
                   {"u": "", "l": "", "n": 0, "k": 5}]


def test_wrappers_follow_rows_and_count_their_syncs():
    s = TorchSession(device="cpu")
    rng = np.random.default_rng(3)
    values = words(rng, 200)
    column = s.transfers.upload_column(HostColumn.from_strings(values))
    rows = torch.from_numpy(rng.integers(0, 200, 90).astype(np.int64))
    before = s.transfers.stats()["syncs"]
    n = SO.string_length(column, 90, rows)
    assert s.transfers.stats()["syncs"] == before
    assert isinstance(n, DeviceColumn) and n.data_type == T.INT
    assert [v if ok else None for v, ok in zip(n.data.tolist(),
                                               n.validity.tolist())] == \
        [None if values[r] is None else len(values[r])
         for r in rows.tolist()]
    low = SO.string_column(SO.LOWER, [column], 90, torch.device("cpu"),
                           s.transfers, rows=rows)
    assert s.transfers.stats()["syncs"] == before + 1
    raw, offs = low.data.numpy().tobytes(), low.offsets.tolist()
    assert [raw[offs[i]:offs[i + 1]].decode() if ok else None
            for i, ok in enumerate(low.validity.tolist())] == \
        [None if values[r] is None else values[r].lower()
         for r in rows.tolist()]
    assert SO.LAUNCHES == SO.CASE_LAUNCHES == SO.LENGTH_LAUNCHES == 0
    with pytest.raises(ValueError, match="one string column"):
        SO.string_column(SO.UPPER, [column, column], 200,
                         torch.device("cpu"), s.transfers)
