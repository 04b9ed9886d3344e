"""String sort keys (ops/sort_ops.py, K8's string words, and exec/sort.py)
against the JAX package's sort (ops/sort_ops.py sort_permutation with
_string_words and _order_words, on JAX-CPU), on the same seeded inputs.

The strings share prefixes, are 0, 7, 8, 14, 15 and 40 bytes long (the
word edges: 7 bytes a word), hold bytes >= 0x80 and nulls, and come
first in a key list followed by an int key.  Both sorts are stable, so
the permutations must be equal; the words themselves equal the JAX
package's bit for bit."""

import gc

import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar.batch import batch_from_pydict as jax_batch
from spark_rapids_tpu.ops import sort_ops as JS
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import batch_from_pydict
from spark_rapids_tpu_torch.ops import sort_ops as S


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


SCHEMA = T.StructType([T.StructField("s", T.STRING),
                       T.StructField("i", T.INT)])
STEMS = ["", "a", "ab", "ab\0", "abc", "abcdefg", "abcdefgh",
         "abcdefghijklmn", "abcdefghijklmno", "x" * 40, "x" * 39 + "y",
         "é", "日本", "\x7f", "zz", "AAAAAAAA00000006", "AAAAAAAA00000065"]


def data(n, seed, null_frac=0.1):
    rng = np.random.default_rng(seed)
    return {
        "s": [None if rng.random() < null_frac else str(rng.choice(STEMS))
              for _ in range(n)],
        "i": rng.integers(-3, 4, n).astype(np.int32),
    }


def port_perm(d, orders):
    s = TorchSession(device="cpu")
    cols = s.transfers.upload_batch(batch_from_pydict(d, SCHEMA)).columns
    before = s.transfers.stats()["syncs"]
    perm = S.sort_permutation(cols, orders, s.transfers)
    # each string key's longest length is read once
    strings = sum(cols[o.ordinal].is_string for o in orders)
    assert s.transfers.stats()["syncs"] - before == strings
    return perm.tolist()


def jax_perm(d, orders):
    from spark_rapids_tpu import types as JT
    hb = jax_batch(d, JT.StructType([JT.StructField("s", JT.StringType()),
                                     JT.StructField("i", JT.IntegerType())]))
    jorders = [JS.SortOrder(o.ordinal, o.ascending, o.nulls_first)
               for o in orders]
    perm = np.asarray(JS.sort_permutation(hb.to_device(), jorders))
    return perm[:len(d["s"])].tolist()


ORDERS = {
    "asc": [S.SortOrder(0, True, True)],
    "asc nulls last": [S.SortOrder(0, True, False)],
    "desc": [S.SortOrder(0, False, False)],
    "desc nulls first": [S.SortOrder(0, False, True)],
    "string then int": [S.SortOrder(0, True, True), S.SortOrder(1, False,
                                                                False)],
    "int then string": [S.SortOrder(1, True, True), S.SortOrder(0, False,
                                                                True)],
}


@pytest.mark.parametrize("n", [0, 1, 300])
@pytest.mark.parametrize("case", list(ORDERS))
def test_permutation_matches_jax(n, case):
    d = data(n, seed=n + len(case))
    orders = ORDERS[case]
    assert port_perm(d, orders) == jax_perm(d, orders)


def test_words_are_the_jax_words_bit_for_bit():
    d = data(200, seed=5, null_frac=0.0)
    s = TorchSession(device="cpu")
    col = s.transfers.upload_batch(batch_from_pydict(d, SCHEMA)).columns[0]
    longest = int(S.string_longest_plain(col))
    assert longest == 40
    n_words = S.string_word_count(longest)
    got = S.string_words_plain(col, n_words).numpy().view(np.uint64)
    raw = [x.encode() for x in d["s"]]
    chars = np.zeros((len(raw), longest), np.uint8)
    for r, b in enumerate(raw):
        chars[r, :len(b)] = np.frombuffer(b, np.uint8)
    lens = np.array([len(b) for b in raw], np.int32)
    ref = JS._string_words_np(chars, lens)
    assert len(ref) == n_words == 6
    for w, r in zip(got, ref):
        assert np.array_equal(w, r)


def test_order_by_a_string_key_matches_jax():
    from spark_rapids_tpu import functions as JF
    d = data(300, seed=9)
    ref = TpuSession({"spark.rapids.sql.enabled": "true"}) \
        .create_dataframe(d).order_by(JF.desc("s"), "i").collect()
    got = TorchSession(device="cpu").create_dataframe(d, schema=SCHEMA) \
        .order_by(F.desc("s"), "i").collect()
    assert rows_equal(ref, got, check_order=True, approx_float=False) \
        is None


def test_a_string_key_needs_the_gateway():
    s = TorchSession(device="cpu")
    cols = s.transfers.upload_batch(batch_from_pydict(data(5, 1),
                                                      SCHEMA)).columns
    with pytest.raises(ValueError, match="gateway"):
        S.sort_permutation(cols, [S.SortOrder(0)])
    assert S.sort_permutation(cols, [S.SortOrder(1)]).shape == (5,)
    assert torch.equal(S.sort_permutation(cols, [S.SortOrder(0)],
                                          s.transfers),
                       S.sort_permutation_plain(cols, [S.SortOrder(0)],
                                                s.transfers))
