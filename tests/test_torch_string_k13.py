"""K13, the port's computed strings (ops/string_ops.py, the plain version
on the CPU), against the JAX package's device forms run on JAX-CPU:
``Substring.eval_tpu`` (spark_rapids_tpu/expressions/strings.py:179) and
``Concat.eval_tpu`` (:115), and against their ``eval_cpu``.

- The inputs are datagen-style strings of 0, 1, 7, 8, 15 and 40 bytes,
  with nulls, empty strings and bytes at or above 0x80.  The port's
  substring counts characters, as Spark and ``eval_cpu`` do; the JAX
  device form counts bytes (ROADMAP queue 3), so a substring is held
  against ``eval_cpu`` on every stem and against ``eval_tpu`` on the
  ASCII stems, where the two rules agree.
- Substring: positive, zero, negative and past-the-end ``pos``, with and
  without ``len`` (also 0 and negative ``len``).  Concat: literals on
  both sides of a column, two columns, a literal alone.
- Equality is exact: each valid row's bytes, and the validity (a null
  row is length 0 in the port; the JAX planes keep bytes under it).
- The kernel's wrapper on CPU tensors takes its plain path, reads the
  chars total through the gateway (one sync), writes int64 offsets, and
  with ``rows`` reads input row ``rows[i]`` for output row ``i``.
- A computed string reaches the port's planner as a K13 output of a
  projection or a filtering stage, a group key and a sort key."""

import gc

import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import HostColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import HostColumn as JColumn
from spark_rapids_tpu.expressions import base as JB
from spark_rapids_tpu.expressions import strings as JS
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import HostColumn
from spark_rapids_tpu_torch.exec import fused as FU
from spark_rapids_tpu_torch.expressions import base as B
from spark_rapids_tpu_torch.expressions import strings as S
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
    threads in each pytest worker makes them contend for the cores (q5 at
    sf 1 took 5.4 s at 8 threads and 0.46 s at 1 on an 8-core machine
    under load).  This module runs on one thread and restores the count
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STEMS = ["", "a", "abcdefg", "abcdefgh", "abcdefghijklmno", "x" * 40,
         "ÿé", "日本語x", "é" * 20]
ASCII_STEMS = STEMS[:6] + ["24128", "AAAAAAAA0001BAAA"]


def words(rng, n, stems, null_frac=0.1):
    return [None if rng.random() < null_frac else
            stems[int(rng.integers(0, len(stems)))] for _ in range(n)]


def jax_context(columns):
    """A JAX device EvalContext over string columns (padded planes)."""
    n = len(columns[0])
    hb = JBatch([JColumn.from_pylist(v, JT.STRING) for v in columns], n,
                [f"s{j}" for j in range(len(columns))]).to_device()
    tcols = [JB.TCol(c.data, c.validity, JT.STRING, lengths=c.lengths)
             for c in hb.columns]
    return JB.EvalContext(tcols, "tpu", hb.bucket)


def jax_rows(tc, n):
    """``(bytes or None)`` per row of a JAX device string TCol."""
    data, lens = np.asarray(tc.data), np.asarray(tc.lengths)
    valid = np.asarray(tc.valid)
    return [bytes(data[i, :lens[i]]) if valid[i] else None
            for i in range(n)]


def port_rows(chars, offsets, valid):
    chars, offsets = chars.numpy().tobytes(), offsets.tolist()
    out = []
    for i, ok in enumerate(valid.tolist()):
        if not ok:
            assert offsets[i + 1] == offsets[i]   # a null row is length 0
            out.append(None)
        else:
            out.append(chars[offsets[i]:offsets[i + 1]])
    return out


def port_eval(expr, columns):
    n = len(columns[0])
    cols = []
    for v in columns:
        c = HostColumn.from_strings(v)
        cols.append(B.Col(torch.from_numpy(c.data),
                          torch.tensor([x is not None for x in v],
                                       dtype=torch.bool),
                          torch.from_numpy(c.offsets)))
    out = expr.eval(B.EvalContext(cols, n, torch.device("cpu")))
    assert out.offsets.dtype == torch.int64
    return port_rows(out.data, out.offsets, out.valid)


SUBSTRINGS = [(1, 5), (1, 2), (2, 3), (0, 4), (3, None), (-1, None),
              (-3, 2), (-50, 3), (41, None), (8, 8), (1, 0), (2, -2),
              (1, 100), (-8, None)]


def cpu_rows(jexpr, columns):
    """``(bytes or None)`` per row of a JAX ``eval_cpu`` string result."""
    n = len(columns[0])
    cctx = JB.EvalContext([JB.TCol(np.array(v, dtype=object),
                                   np.array([x is not None for x in v]),
                                   JT.STRING) for v in columns], "cpu", n)
    tc = jexpr.eval_cpu(cctx)
    return [None if not ok else v.encode("utf-8")
            for v, ok in zip(tc.data, tc.valid)]


@pytest.mark.parametrize("pos,length", SUBSTRINGS)
def test_substring_matches_eval_tpu_byte_for_byte(pos, length):
    """By characters against ``eval_cpu`` on every stem (the stems at or
    above 0x80 among them), and byte for byte against ``eval_tpu`` on
    the ASCII rows, where the byte rule and the character rule agree."""
    rng = np.random.default_rng(abs(pos * 31 + (length or 0)))
    values = words(rng, 300, STEMS)
    jexpr = JS.Substring(JB.BoundReference(0, JT.STRING), pos, length)
    got = port_eval(S.Substring(B.BoundReference(0, T.STRING), pos, length),
                    [values])
    assert got == cpu_rows(jexpr, [values])
    ref = jax_rows(jexpr.eval_tpu(jax_context([values])), len(values))
    ascii_rows = [i for i, v in enumerate(values)
                  if v is None or v.isascii()]
    assert len(ascii_rows) > 100
    assert [got[i] for i in ascii_rows] == [ref[i] for i in ascii_rows]


CONCATS = {
    "lit col lit": lambda: ([B.lit("store"), 0, B.lit("#")],
                            [JB.Literal("store"), 0, JB.Literal("#")]),
    "col col": lambda: ([0, 1], [0, 1]),
    "col lit col": lambda: ([1, B.lit("é-"), 0], [1, JB.Literal("é-"), 0]),
    "lit": lambda: ([B.lit("web channel")], [JB.Literal("web channel")]),
    "empty lit col": lambda: ([B.lit(""), 1], [JB.Literal(""), 1]),
}


@pytest.mark.parametrize("case", list(CONCATS))
def test_concat_matches_eval_tpu_byte_for_byte(case):
    rng = np.random.default_rng(len(case))
    columns = [words(rng, 300, STEMS), words(rng, 300, STEMS, 0.2)]
    mine, theirs = CONCATS[case]()

    def port(x):
        return B.BoundReference(x, T.STRING) if isinstance(x, int) else x

    def jax(x):
        return JB.BoundReference(x, JT.STRING) if isinstance(x, int) else x
    ref = jax_rows(JS.Concat(*map(jax, theirs)).eval_tpu(
        jax_context(columns)), 300)
    got = port_eval(S.Concat(*map(port, mine)), columns)
    assert got == ref


@pytest.mark.parametrize("form", ["substring", "concat"])
def test_ascii_forms_match_eval_cpu(form):
    rng = np.random.default_rng(7)
    columns = [words(rng, 200, ASCII_STEMS), words(rng, 200, ASCII_STEMS)]
    cctx = JB.EvalContext([JB.TCol(np.array(v, dtype=object),
                                   np.array([x is not None for x in v]),
                                   JT.STRING) for v in columns], "cpu", 200)
    a, b = (JB.BoundReference(j, JT.STRING) for j in (0, 1))
    pa, pb = (B.BoundReference(j, T.STRING) for j in (0, 1))
    for jexpr, pexpr in (
            [(JS.Substring(a, p, n), S.Substring(pa, p, n))
             for p, n in SUBSTRINGS] if form == "substring" else
            [(JS.Concat(JB.Literal("x"), a, b),
              S.Concat(B.lit("x"), pa, pb))]):
        tc = jexpr.eval_cpu(cctx)
        ref = [None if not ok else v.encode("utf-8")
               for v, ok in zip(tc.data, tc.valid)]
        assert port_eval(pexpr, columns) == ref, jexpr


def test_a_null_literal_makes_every_row_null():
    got = port_eval(S.Concat(B.BoundReference(0, T.STRING),
                             B.lit(None, T.STRING)), [["a", None, ""]])
    assert got == [None, None, None]


def device_column(values):
    s = TorchSession(device="cpu")
    return s, s.transfers.upload_column(HostColumn.from_strings(values))


@pytest.mark.parametrize("op", ["substring", "concat"])
def test_wrapper_reads_the_total_once_and_follows_rows(op):
    rng = np.random.default_rng(11)
    values = words(rng, 500, STEMS)
    s, col = device_column(values)
    rows = torch.from_numpy(rng.integers(0, 500, 300).astype(np.int64))
    args = ((SO.SUBSTRING, [col]), {"pos": -3, "length": 2}) \
        if op == "substring" else ((SO.CONCAT, [b"<", col, b">"]), {})
    before = s.transfers.stats()["syncs"]
    got = SO.string_column(*args[0], 300, torch.device("cpu"), s.transfers,
                           rows=rows, **args[1])
    assert s.transfers.stats()["syncs"] - before == 1
    assert got.offsets.dtype == torch.int64 and got.row_count == 300
    whole = SO.string_column(*args[0], 500, torch.device("cpu"),
                             s.transfers, **args[1])
    full = port_rows(whole.data, whole.offsets, whole.validity)
    assert port_rows(got.data, got.offsets, got.validity) == \
        [full[i] for i in rows.tolist()]
    assert SO.LAUNCHES == 0   # the plain path launches nothing


def test_wrapper_refuses_what_k13_cannot_write():
    s, col = device_column(["a"])
    with pytest.raises(ValueError, match="one string column"):
        SO.string_column(SO.SUBSTRING, [col, col], 1, torch.device("cpu"),
                         s.transfers)
    with pytest.raises(NotImplementedError, match="1 to 8 parts"):
        SO.string_column(SO.CONCAT, [col] * 9, 1, torch.device("cpu"),
                         s.transfers)
    with pytest.raises(TypeError, match="bytes or None"):
        SO.string_column(SO.CONCAT, ["a"], 1, torch.device("cpu"),
                         s.transfers)


def test_k13_forms_leave_the_triton_outputs_and_refuse_the_rest():
    schema = T.StructType([T.StructField("s", T.STRING),
                           T.StructField("k", T.LONG)])
    s, k = B.BoundReference(0, T.STRING), B.BoundReference(1, T.LONG)
    prog = FU.StageProgram([("project", [
        B.Alias(S.Substring(s, 1, 2), "a"),
        B.Alias(S.Concat(B.lit("x"), s), "b"),
        B.Alias(B.lit("lit"), "c"), k])], schema, 0)
    assert prog.computed == [] and prog.computes
    assert [f.op if f else None for f in prog.strings] == \
        [SO.SUBSTRING, SO.CONCAT, SO.CONCAT, None]
    nested = S.Concat(S.Substring(s, 1, 2), B.lit("x"))
    assert S.k13_form(nested) is None
    with pytest.raises(NotImplementedError, match="no kernel form"):
        FU.StageProgram([("project", [B.Alias(nested, "n")])], schema, 0)


def test_computed_strings_reach_stages_keys_and_sorts():
    sess = TorchSession(device="cpu")
    from spark_rapids_tpu_torch.expressions.predicates import GreaterThan
    df = sess.create_dataframe({"s": ["abc", None, "", "abd", "xyz"],
                                "k": [1, 2, 3, 4, 5]})
    out = df.filter(GreaterThan(B.col("k"), B.lit(1))).select(
        F.concat(B.lit("<"), "s").alias("c"),
        F.substring("s", 2, 1).alias("m"), "k", "s").collect()
    assert out == [{"c": None, "m": None, "k": 2, "s": None},
                   {"c": "<", "m": "", "k": 3, "s": ""},
                   {"c": "<abd", "m": "b", "k": 4, "s": "abd"},
                   {"c": "<xyz", "m": "y", "k": 5, "s": "xyz"}]
    grouped = df.group_by(F.substring("s", 1, 2).alias("p")).agg(
        F.sum("k").alias("t")).order_by("p").collect()
    assert grouped == [{"p": None, "t": 2}, {"p": "", "t": 3},
                       {"p": "ab", "t": 5}, {"p": "xy", "t": 5}]
    ordered = df.order_by(F.desc(F.concat("s", B.lit("!")))).collect()
    assert [r["k"] for r in ordered] == [5, 4, 1, 3, 2]
