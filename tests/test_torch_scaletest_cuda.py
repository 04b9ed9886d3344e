"""This slice's kernels on the card against their plain PyTorch versions:
K15 (collect_list and collect_set, ``csrc/collect.cu``), K13's length
pass and case maps and its substring by characters (``csrc/strings.cu``)
and the substring view in K6 and K5 (``kernels/fused_agg.py``), on
``testing/text_cases.py`` inputs; and the port's ScaleTest on the card
against its CPU run (``scaletest.rows_agree``).

Every test needs a CUDA card and skips without one; this file imports
nothing of JAX:

    python -m pytest tests/test_torch_scaletest_cuda.py --noconftest -q

Exact, bit for bit, but the double sums ScaleTest compares within 1e-9
of the sum of |v1| over the same group or frame."""

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec import fused as FU
from spark_rapids_tpu_torch.ops import agg_ops as G
from spark_rapids_tpu_torch.ops import string_ops as SO
from spark_rapids_tpu_torch.testing import scaletest as ST
from spark_rapids_tpu_torch.testing import text_cases as TC

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return TorchSession(device="cuda")


def same(got, ref):
    """Two columns plane by plane, doubles by their bits, a string's
    chars and an array's elements up to the last offset."""
    assert torch.equal(got.validity.cpu(), ref.validity.cpu())
    if got.offsets is None:
        a, b = got.data.cpu(), ref.data.cpu()
    else:
        assert torch.equal(got.offsets.long().cpu(), ref.offsets.long().cpu())
        end = int(ref.offsets[-1])
        a, b = got.data[:end].cpu(), ref.data[:end].cpu()
    if a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1, 1000, (1 << 17) + 3])
def test_k13_forms_match_their_plain_versions(card, n):
    rng = np.random.default_rng(n)
    tr, dev = card.transfers, card.device
    a = tr.upload_column(TC.string_column(rng, n))
    rows = torch.from_numpy(rng.integers(0, n, max(1, n // 3))).to(dev)
    before = (SO.LENGTH_LAUNCHES, SO.CASE_LAUNCHES, SO.SUBSTRING_LAUNCHES)
    for r in (None, rows):
        m = n if r is None else r.shape[0]
        same(SO.string_length(a, m, r), SO.string_length_plain(a, m, r))
        for op, kw in [(SO.UPPER, {}), (SO.LOWER, {})] + [
                (SO.SUBSTRING, {"pos": p, "length": ln})
                for p, ln in TC.SUBSTRINGS]:
            same(SO.string_column(op, [a], m, dev, tr, rows=r, **kw),
                 SO.string_column_plain(op, [a], m, dev, tr, rows=r, **kw))
    assert SO.LENGTH_LAUNCHES - before[0] == 2
    assert SO.CASE_LAUNCHES - before[1] == 4
    assert SO.SUBSTRING_LAUNCHES - before[2] == 2 * len(TC.SUBSTRINGS)


@pytest.mark.parametrize("n", [1000, (1 << 17) + 3])
def test_substring_views_match_written_substrings(card, n):
    rng = np.random.default_rng(n + 1)
    tr, dev = card.transfers, card.device
    a = tr.upload_column(TC.string_column(rng, n))
    written = [SO.string_column(SO.SUBSTRING, [a], n, dev, tr, pos=p,
                                length=ln) for p, ln in TC.SUBSTRINGS]
    schema = T.StructType([T.StructField("s", T.STRING)] + [
        T.StructField(f"w{j}", T.STRING) for j in range(len(written))])
    batch = ColumnarBatch([a] + written, n, schema.names)
    lits = FU.LiteralArgs([])
    k6 = TC.view_program(schema, TC.SUBSTRINGS, False)
    got = FU.fused_project(k6, batch, lits)
    for g, r in zip(got, FU.fused_project_plain(k6, batch, lits)):
        same(g, r)
    present = int(a.validity.sum())
    for c in got[:-1]:
        assert bool((c.data | ~c.validity).all())
        assert int(c.validity.sum()) == present
    k5 = TC.view_program(schema, TC.SUBSTRINGS, True)
    idx, outs = FU.fused_stage_compact(k5, batch, lits, tr)
    ref_idx, ref_outs = FU.fused_stage_compact_plain(k5, batch, lits, tr)
    assert torch.equal(idx.cpu(), ref_idx.cpu()) and idx.shape[0] == present
    for g, r in zip(outs, ref_outs):
        same(g, r)


@pytest.mark.parametrize("kind", list(TC.COLLECT_TYPES))
@pytest.mark.parametrize("groups", [1, 4096])
def test_collect_matches_its_plain_version(card, kind, groups):
    n = (1 << 17) + 3
    rng = np.random.default_rng(groups + len(kind))
    tr, dev = card.transfers, card.device
    v = tr.upload_column(TC.collect_values(rng, kind, n))
    gid = None if groups == 1 else \
        torch.from_numpy(rng.integers(0, groups, n)).to(dev)
    for distinct in (False, True):
        got = G.collect(v, gid, groups, distinct, tr)
        assert got.data_type == T.ArrayType(v.data_type, False)
        same(got, G.collect_plain(v, gid, groups, distinct, tr))
    empty = tr.upload_column(TC.collect_values(rng, kind, 0))
    out = G.collect(empty, None, 1, True, tr)
    assert out.offsets.tolist() == [0, 0] and bool(out.validity.all())


def test_scaletest_on_the_card_equals_the_cpu_run(card):
    rows = 20_000
    cpu = TorchSession(device="cpu")
    got_t, abs_t = ST.build_tables(card, rows), ST.abs_tables(card, rows)
    ref_t = ST.build_tables(cpu, rows)
    G.COLLECT_SET_LAUNCHES = SO.LENGTH_LAUNCHES = SO.CASE_LAUNCHES = 0
    for name, q in ST._queries():
        bounds = q(abs_t).collect() if name in ST.SUMS else None
        assert ST.rows_agree(name, q(got_t).collect(), q(ref_t).collect(),
                             bounds) is None
    assert G.COLLECT_SET_LAUNCHES and SO.LENGTH_LAUNCHES and \
        SO.CASE_LAUNCHES
    report = ST.run_scale_test(card, rows, iterations=1)
    assert [r["status"] for r in report] == ["OK"] * len(ST.QUERY_NAMES)
