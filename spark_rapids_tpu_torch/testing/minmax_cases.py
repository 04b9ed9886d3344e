"""Seeded inputs of the min, max, first and last kinds (K9's fold and
merge, K1's update forms, K3's fold): the card tests
(``tests/test_torch_cuda.py``) and ``chip_smoke.py`` phase 2m hold each
kernel against its plain version on them.

A batch holds a group key ``g`` (``GROUPS`` groups), a key ``one`` that
puts every row in one group, and the values: ``i`` (int), ``d`` (date),
``l`` (long, with INT64_MIN and INT64_MAX), ``v`` (double, with NaN,
+-inf, -0.0 and 0.0) and ``s`` (string), each about 10% null.  Group
``ZERO_GROUPS`` hold only zeros in ``v`` (0.0 first in one, -0.0 first in
the other), ``NAN_GROUP`` only NaN and ``NULL_GROUP`` only nulls."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (HostColumnarBatch,
                                                   batch_from_numpy)
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.ops import agg_ops as G

GROUPS = 4096
ZERO_GROUPS = {0: 0.0, 1: -0.0}
NAN_GROUP, NULL_GROUP = 2, 3
STEMS = ["", "a", "ab", "abcdefgh", "zz", "日本", "é", "a longer string "
         "of forty bytes, or so"]
SCHEMA = T.StructType([T.StructField("g", T.INT, True),
                       T.StructField("one", T.INT, True),
                       T.StructField("i", T.INT, True),
                       T.StructField("d", T.DATE, True),
                       T.StructField("l", T.LONG, True),
                       T.StructField("v", T.DOUBLE, True),
                       T.StructField("s", T.STRING, True)])
#: the fixed-width value columns (ordinals in ``SCHEMA``) and the string
FIXED = (2, 3, 4, 5)
STRING = 6


def host_batch(seed: int, n: int, groups: int = GROUPS
               ) -> HostColumnarBatch:
    rng = np.random.default_rng(seed)
    g = rng.integers(0, groups, n).astype(np.int32)
    valid = (rng.random(n) > 0.1) & (g != NULL_GROUP)
    v = rng.normal(0.0, 1e3, n)
    for value in (np.nan, np.inf, -np.inf, 0.0, -0.0):
        v[rng.random(n) < 0.02] = value
    v[g == NAN_GROUP] = np.nan
    for group, first in ZERO_GROUPS.items():
        rows = np.flatnonzero(g == group)
        v[rows] = np.where(np.arange(len(rows)) % 2 == 0, first, -first)
    i = rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
    d = rng.integers(-20000, 30000, n).astype(np.int32)
    lo = rng.integers(-2 ** 62, 2 ** 62, n)
    lo[rng.random(n) < 0.01] = np.iinfo(np.int64).min
    lo[rng.random(n) < 0.01] = np.iinfo(np.int64).max
    s = [STEMS[k] for k in rng.integers(0, len(STEMS), n)]
    return batch_from_numpy([(g, None), (np.zeros(n, np.int32), None),
                             (i, valid), (d, valid), (lo, valid), (v, valid),
                             (s, valid)], SCHEMA)


def keyed_slots(columns) -> Tuple[List[DeviceColumn], List[int]]:
    """K9's inputs and kinds over a batch's columns: each fixed-width
    value with min, max and the four row-order kinds, the string with the
    four row-order kinds (28 slots)."""
    inputs, kinds = [], []
    for o in FIXED:
        for kind in (G.KEYED_MIN, G.KEYED_MAX) + G.KEYED_PICK:
            inputs.append(columns[o])
            kinds.append(kind)
    for kind in G.KEYED_PICK:
        inputs.append(columns[STRING])
        kinds.append(kind)
    return inputs, kinds


def merged_halves(columns, inputs, kinds, transfers
                  ) -> Tuple[List[DeviceColumn], List[DeviceColumn],
                             List[int]]:
    """K9's partials of a batch's two halves by ``g`` over the
    fixed-width slots of ``keyed_slots``, laid end to end as the buffer
    rows an exchange delivers to a FINAL aggregate: its keys, buffer
    columns and merge kinds."""
    fixed = [(c, k) for c, k in zip(inputs, kinds) if not c.is_string]
    merge_kinds = [k for _c, k in fixed]
    g = columns[0]
    n = g.row_count
    parts = []
    for lo, hi in ((0, n // 2), (n // 2, n)):
        rep, res = G.keyed_aggregate(
            [DeviceColumn(g.data[lo:hi], g.validity[lo:hi], g.data_type)],
            [DeviceColumn(c.data[lo:hi], c.validity[lo:hi], c.data_type)
             for c, _k in fixed], merge_kinds, transfers)
        parts.append((g.data[lo:hi][rep], res))
    key = torch.cat([p[0] for p in parts])
    keys = [DeviceColumn(key, torch.ones(key.shape[0], dtype=torch.bool,
                                         device=key.device), g.data_type)]
    merged = [DeviceColumn(torch.cat([p[1][j][0] for p in parts]),
                           torch.cat([p[1][j][1] for p in parts]),
                           fixed[j][0].data_type) for j in range(len(fixed))]
    return keys, merged, merge_kinds


def global_specs():
    """K3 specs ``(ordinal, kind, count_valid_only, dtype)`` over a batch:
    min and max of each fixed-width column, the four row-order kinds of
    each column, the string's by its rows."""
    specs = []
    for o in FIXED + (STRING,):
        dt = SCHEMA.types[o]
        kinds = ("first", "last", "first_valid", "last_valid") + \
            (() if o == STRING else ("min", "max"))
        specs += [(o, kind, True, dt) for kind in kinds]
    return specs


def words(t: torch.Tensor) -> torch.Tensor:
    """A plane as int64 words (doubles by their bits), for an exact
    comparison that holds NaN and the sign of zero."""
    if t.dtype == torch.float64:
        return t.contiguous().view(torch.int64)
    return t.to(torch.int64)


def same_keyed(got, ref, what: str) -> None:
    """K9's output against its plain version's: the groups, and each
    slot's values (doubles by their bits) and validity, exactly."""
    if not torch.equal(got[0], ref[0]):
        raise AssertionError(f"{what}: groups")
    for j, ((gv, gok), (rv, rok)) in enumerate(zip(got[1], ref[1])):
        if gv.dtype != rv.dtype:
            raise AssertionError(f"{what}, slot {j}: {gv.dtype} vs "
                                 f"{rv.dtype}")
        if not torch.equal(gok, rok):
            raise AssertionError(f"{what}, slot {j}: validity")
        if not torch.equal(words(gv), words(rv)):
            raise AssertionError(f"{what}, slot {j}: values")
