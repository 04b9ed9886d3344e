#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (spark_rapids_tpu_torch).

    python3 chip_smoke.py [--rows N] [--parts N] [--reps N] [--sf SF]

Needs one CUDA card; it exits non-zero, printing no result, without one.
It builds every kernel from the sources in the checkout, into the
git-ignored build/ directory: kernel 1 and K5 (Triton, emitted by
kernels/fused_agg.py and kernels/fused_stage.py) and kernel 2, K7, K8, K9
and K10 (csrc/*.cu, one nvcc each, all started together).  It holds each
kernel against its plain PyTorch version on the card, then drives two
paths through ``TorchSession()``, each with the launch counters set to 0
just before it and read just after:

- bench.py's recipe -- filter(w > t), project k+1, v*2.0 and
  murmur3(k, w), sum all three, collect -- on 128M rows in 4 partitions,
  checked against the CPU run and numpy;
- TPC-DS q3 at sf 1000 (store_sales 30M rows, item 2M, date_dim 1461) at
  one partition, checked against a numpy q3 and the CPU run, timed, with a
  torch.profiler breakdown by kernel.

Every check that fails ends the run with a non-zero exit.  The last two
lines of standard output are a JSON object describing each kernel and the
JSON result line.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

INT64_MAX = 2 ** 63 - 1
#: the CUDA sources of the kernels (kernel 2, K7, K8, K9, K10)
CUDA_SOURCES = ("global_reduce.cu", "gather.cu", "sort.cu", "keyed_agg.cu",
                "hash_join.cu")
#: q3's kernels: name, route, source, the JAX program each replaces
Q3_KERNELS = {
    "K5": ("fused_stage", "triton",
           "spark_rapids_tpu_torch/kernels/fused_stage.py",
           "spark_rapids_tpu/exec/fused.py:202"),
    "K7": ("gather", "cuda", "spark_rapids_tpu_torch/csrc/gather.cu",
           "spark_rapids_tpu/ops/join_ops.py:335"),
    "K8": ("sort", "cuda", "spark_rapids_tpu_torch/csrc/sort.cu",
           "spark_rapids_tpu/ops/sort_ops.py:237"),
    "K9": ("keyed_agg", "cuda", "spark_rapids_tpu_torch/csrc/keyed_agg.cu",
           "spark_rapids_tpu/ops/agg_ops.py:390"),
    "K10": ("hash_join", "cuda", "spark_rapids_tpu_torch/csrc/hash_join.cu",
            "spark_rapids_tpu/ops/join_ops.py:125"),
}
#: each q3 kernel's launch counter: module and attribute
Q3_COUNTERS = {"K5": ("exec.fused", "STAGE_LAUNCHES"),
               "K7": ("ops.batch_ops", "LAUNCHES"),
               "K8": ("ops.sort_ops", "LAUNCHES"),
               "K9": ("ops.agg_ops", "KEYED_LAUNCHES"),
               "K10": ("ops.join_ops", "LAUNCHES")}
#: data bytes of one table row (k int64, v double, w int32), as bench.py
ROW_BYTES = 8 + 8 + 4
F64_SUM_RTOL = 1e-10
#: timed q3 queries after the main path's run
Q3_REPS = 10


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def build_data(n_rows: int):
    """A copy of bench.py's _build_data (seed 7)."""
    rng = np.random.default_rng(7)
    return {
        "k": rng.integers(0, 1 << 20, n_rows).astype(np.int64),
        "v": rng.standard_normal(n_rows),
        "w": rng.integers(-1000, 1000, n_rows).astype(np.int32),
    }


def query(df, threshold=0):
    """bench.py's _query against the port's modules."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions import arithmetic as A
    from spark_rapids_tpu_torch.expressions import hashing as H
    from spark_rapids_tpu_torch.expressions import predicates as P
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    return (df
            .filter(P.GreaterThan(col("w"), lit(threshold)))
            .select(Alias(A.Add(col("k"), lit(1)), "k1"),
                    Alias(A.Multiply(col("v"), lit(2.0)), "v2"),
                    Alias(H.Murmur3Hash(col("k"), col("w")), "h"))
            .agg(F.sum("k1").alias("sk"),
                 F.sum("v2").alias("sv"),
                 F.sum("h").alias("sh")))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def memory_rate(name: str) -> float:
    """Device memory bytes/s of the card by its name (NVIDIA data sheets)."""
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    if "H200" in name:
        return 4.8e12
    return 3.35e12


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def fused_exec_of(df):
    from spark_rapids_tpu_torch.exec.fused import TorchFusedAggExec
    found = []

    def visit(node):
        if isinstance(node, TorchFusedAggExec):
            found.append(node)
        for c in node.children:
            visit(c)
    visit(df.executed_plan())
    check(len(found) == 1, "the plan has one fused aggregate")
    return found[0]


def kernel1_read_bytes(batch) -> int:
    """Bytes kernel 1 must read from ``batch``: each data plane, and the
    validity plane of each column that may hold nulls."""
    return batch.row_count * sum(
        c.data.element_size() + (0 if c.all_valid else 1)
        for c in batch.columns)


def compare_rows(kernel, plain, types, abs_sum: float, what: str) -> float:
    """Holds a buffer row from a kernel against the plain version's: int64
    words and validity exact, double sums within F64_SUM_RTOL * abs_sum."""
    import torch
    kw, kv = (t.cpu() for t in kernel)
    pw, pv = (t.cpu() for t in plain)
    check(bool((kv == pv).all()), f"{what}: validity {kv} vs {pv}")
    err = 0.0
    for j, dt in enumerate(types):
        if not bool(pv[j]):
            continue
        if dt.is_floating:
            a = float(kw[j:j + 1].view(torch.float64)[0])
            b = float(pw[j:j + 1].view(torch.float64)[0])
            if math.isnan(b) or math.isinf(b):
                check(a == b or (math.isnan(a) and math.isnan(b)),
                      f"{what}: buffer {j} {a!r} vs {b!r}")
                continue
            err = max(err, abs(a - b))
            check(abs(a - b) <= F64_SUM_RTOL * abs_sum,
                  f"{what}: buffer {j} {a!r} vs {b!r} (sum|x| {abs_sum})")
        else:
            check(int(kw[j]) == int(pw[j]),
                  f"{what}: buffer {j} {int(kw[j])} vs {int(pw[j])}")
    return err


def kernel1_cases(rng, n: int, special: bool, nulls: bool):
    """Rows with k near INT64_MAX in part, nulls in every column when
    ``nulls``, and NaN, +-inf and -0.0 in v when ``special``."""
    k = rng.integers(0, 1 << 40, n).astype(np.int64)
    near = rng.random(n) < 0.3
    k[near] = INT64_MAX - rng.integers(0, 3, int(near.sum()))
    v = rng.standard_normal(n) * 1e3
    if special:
        for value in (np.nan, np.inf, -np.inf, -0.0):
            v[rng.random(n) < 0.01] = value
    w = rng.integers(-1000, 1000, n).astype(np.int32)
    valid = [rng.random(n) > 0.1 if nulls else None for _ in range(3)]
    return [(k, valid[0]), (v, valid[1]), (w, valid[2])]


def check_kernel1(session, program, sizes):
    import torch
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import batch_from_numpy
    from spark_rapids_tpu_torch.exec import fused as FU
    from spark_rapids_tpu_torch.exec.fused import (LiteralArgs,
                                                   fused_agg_update,
                                                   fused_agg_update_plain)
    from spark_rapids_tpu_torch.kernels.fused_agg import literal_word
    from spark_rapids_tpu_torch.ops.agg_ops import global_reduce_plain
    schema = T.StructType([T.StructField("k", T.LONG),
                           T.StructField("v", T.DOUBLE),
                           T.StructField("w", T.INT)])
    rng = np.random.default_rng(11)
    max_err = 0.0
    for n in sizes:
        for special, nulls in ((False, True), (True, True), (True, False)):
            hb = batch_from_numpy(kernel1_cases(rng, n, special, nulls),
                                  schema)
            batch = session.transfers.upload_batch(hb)
            for threshold in (0, 1000):   # 1000 keeps no row
                values, types = [threshold, 2.0], [T.INT, T.DOUBLE]
                lits = LiteralArgs(values, session.transfers.to_device(
                    np.array([literal_word(x, t)
                              for x, t in zip(values, types)], np.int64)))
                kw, kv = fused_agg_update(program, batch, lits)
                torch.cuda.synchronize()
                check(kw.shape[0] == max(1, FU.grid_size(n, batch.device)),
                      "one partial row per program")
                kernel = global_reduce_plain(kw, kv, program.fold_kinds)
                plain = global_reduce_plain(
                    *fused_agg_update_plain(program, batch, lits),
                    program.fold_kinds)
                vd = batch.columns[1].data
                sel = (batch.columns[2].data > threshold) & \
                    batch.columns[2].validity & batch.columns[1].validity
                finite = torch.isfinite(vd)
                abs_sum = float(torch.where(sel & finite, (vd * 2.0).abs(),
                                            0.0).sum())
                max_err = max(max_err, compare_rows(
                    kernel, plain, program.buffer_types, abs_sum,
                    f"kernel 1, {n} rows, special={special}, "
                    f"nulls={nulls}, t={threshold}"))
    return max_err


def check_kernel2(device, sizes):
    import torch
    from spark_rapids_tpu_torch.ops import agg_ops as G
    kinds = [G.SUM_I64, G.SUM_F64, G.COUNT, G.MIN_I64, G.MAX_I64,
             G.MIN_F64, G.MAX_F64]
    types_ = [None, "f", None, None, None, "f", "f"]
    rng = np.random.default_rng(12)
    max_err = 0.0
    for n in sizes:
        for variant in ("plain", "nan", "none_valid"):
            cols, valids = [], []
            for t in types_:
                if t == "f":
                    x = rng.standard_normal(n) * 1e3
                    if variant == "nan":
                        x[rng.random(n) < 0.05] = np.nan
                    cols.append(x.view(np.int64))
                else:
                    cols.append(rng.integers(-(2 ** 63), 2 ** 63 - 1, n,
                                             dtype=np.int64))
                valids.append(np.zeros(n, bool) if variant == "none_valid"
                              else rng.random(n) > 0.2)
            values = torch.from_numpy(np.stack(cols, 1).copy()).to(device)
            valid = torch.from_numpy(np.stack(valids, 1).copy()).to(device)
            out = G.global_reduce(values, valid, kinds)
            torch.cuda.synchronize()
            ref = G.global_reduce_plain(values, valid, kinds)
            f = values[:, 1].view(torch.float64)
            abs_sum = float(torch.where(valid[:, 1] & torch.isfinite(f),
                                        f.abs(), 0.0).sum())
            kw, kv = (t.cpu() for t in out)
            pw, pv = (t.cpu() for t in ref)
            what = f"kernel 2, {n} rows, {variant}"
            check(bool((kv == pv).all()), f"{what}: validity")
            for j, t in enumerate(types_):
                if not bool(pv[j]):
                    continue
                if t == "f":
                    a = float(kw[j:j + 1].view(torch.float64)[0])
                    b = float(pw[j:j + 1].view(torch.float64)[0])
                    if math.isnan(b):
                        check(math.isnan(a), f"{what}: column {j} NaN")
                    elif kinds[j] == G.SUM_F64:
                        max_err = max(max_err, abs(a - b))
                        check(abs(a - b) <= F64_SUM_RTOL * abs_sum,
                              f"{what}: column {j} {a!r} vs {b!r}")
                    else:
                        check(a == b, f"{what}: column {j} {a!r} vs {b!r}")
                else:
                    check(int(kw[j]) == int(pw[j]),
                          f"{what}: column {j} {int(kw[j])} vs {int(pw[j])}")
    return max_err


# -- slice 2: the kernels of TPC-DS q3 ---------------------------------------

def host_strings(rng, n: int, null_frac: float = 0.1, width: int = 12):
    """Strings of 0..width ASCII letters (empty ones included), None for a
    null."""
    lens = rng.integers(0, width + 1, n)
    letters = rng.integers(97, 123, int(lens.sum())).astype(np.uint8)
    raw = letters.tobytes().decode("ascii")
    out, at = [], 0
    nulls = rng.random(n) < null_frac
    for i, k in enumerate(lens.tolist()):
        out.append(None if nulls[i] else raw[at:at + k])
        at += k
    return out


def mixed_batch(session, rng, n: int, off64: bool = False):
    """A device batch of int (nulls), long, double (NaN, -0.0, nulls) and
    string (empty and null rows) columns."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import (HostColumnarBatch,
                                                       batch_from_numpy)
    from spark_rapids_tpu_torch.columnar.column import HostColumn
    v = rng.standard_normal(n) * 1e3
    v[rng.random(n) < 0.05] = np.nan
    v[rng.random(n) < 0.05] = -0.0
    schema = T.StructType([T.StructField("i", T.INT),
                           T.StructField("k", T.LONG),
                           T.StructField("v", T.DOUBLE),
                           T.StructField("s", T.STRING)])
    hb = batch_from_numpy([
        (rng.integers(-50, 50, n).astype(np.int32), rng.random(n) > 0.1),
        (rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64), None),
        (v, rng.random(n) > 0.1),
        (np.array(host_strings(rng, n), dtype=object), None)], schema)
    if off64:
        s = hb.columns[3]
        hb = HostColumnarBatch(hb.columns[:3] + [HostColumn(
            s.data, s.validity, T.STRING, s.offsets.astype(np.int64))],
            n, hb.names)
    return session.transfers.upload_batch(hb)


def max_diff(got, ref) -> float:
    """max |got - ref| over two tensors of one shape (0.0 when empty);
    doubles over the rows where both are finite."""
    import torch
    if got.numel() == 0:
        return 0.0
    if got.dtype.is_floating_point:
        both = torch.isfinite(got) & torch.isfinite(ref)
        return float(torch.where(both, (got - ref).abs(), 0.0).max())
    return float((got.long() - ref.long()).abs().max())


def same_indices(got, ref, what: str) -> float:
    """Equal int64 index tensors; returns the measured max |d|."""
    import torch
    g, r = got.cpu(), ref.cpu()
    check(g.shape == r.shape, f"{what}: {tuple(g.shape)} vs {tuple(r.shape)}")
    check(bool(torch.equal(g, r)), what)
    return max_diff(g, r)


def same_columns(got, ref, what: str) -> float:
    """Columns equal plane by plane (doubles bit for bit; a string's chars
    up to its last offset); returns the measured max |d| over the data,
    offsets and validity planes."""
    import torch
    check(len(got) == len(ref), f"{what}: column count")
    err = 0.0
    for j, (g, r) in enumerate(zip(got, ref)):
        w = f"{what}, column {j}"
        check(g.row_count == r.row_count, f"{w}: {g.row_count} rows vs "
              f"{r.row_count}")
        gv, rv = g.validity.cpu(), r.validity.cpu()
        check(bool(torch.equal(gv, rv)), f"{w}: validity")
        err = max(err, max_diff(gv, rv))
        if g.is_string:
            go, ro = g.offsets.cpu().long(), r.offsets.cpu().long()
            check(bool(torch.equal(go, ro)), f"{w}: offsets")
            end = int(ro[-1])
            gc, rc = g.data.cpu()[:end], r.data.cpu()[:end]
            check(bool(torch.equal(gc, rc)), f"{w}: chars")
            err = max(err, max_diff(go, ro), max_diff(gc, rc))
        else:
            gd, rd = g.data.cpu(), r.data.cpu()
            bits = (gd.view(torch.int64), rd.view(torch.int64)) \
                if gd.dtype == torch.float64 else (gd, rd)
            check(bool(torch.equal(*bits)), f"{w}: data")
            err = max(err, max_diff(gd, rd))
    return err


def check_gather(session, rng) -> float:
    """K7 against its plain version: 0, 1 and 2**20 + 3 output rows, maps
    with repeats and permutations, int32 and int64 string offsets."""
    import torch
    from spark_rapids_tpu_torch.ops import batch_ops as BO
    tr = session.transfers
    err = 0.0
    for n_src, n_out, off64 in ((5, 0, False), (5, 1, True),
                                ((1 << 20) + 3, (1 << 20) + 3, False),
                                (4099, 1000, True)):
        batch = mixed_batch(session, rng, n_src, off64)
        for unique in (False, True):
            idx = rng.permutation(n_src)[:n_out] if unique else \
                rng.integers(0, n_src, n_out)
            idx = torch.from_numpy(idx.astype(np.int64)).to(session.device)
            got = BO.gather_columns(batch.columns, idx, tr, unique)
            torch.cuda.synchronize()
            ref = BO.gather_columns_plain(batch.columns, idx, tr, unique)
            err = max(err, same_columns(
                got, ref, f"K7, {n_src} -> {n_out} rows, unique={unique}, "
                          f"off64={off64}"))
    return err


def check_stage(session, rng) -> float:
    """K5 against its plain version: all-true, all-false and random
    filters, a computed output and a string column passed through."""
    import torch
    from spark_rapids_tpu_torch import DataFrame
    from spark_rapids_tpu_torch.exec import fused as FU
    from spark_rapids_tpu_torch.expressions import arithmetic as A
    from spark_rapids_tpu_torch.expressions import predicates as P
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.ops import batch_ops as BO
    from spark_rapids_tpu_torch.plan import base as L
    tr = session.transfers
    conds = {"all true": P.GreaterThan(col("i"), lit(-1000)),
             "all false": P.EqualTo(col("i"), lit(5000)),
             "random": P.GreaterThan(col("i"), lit(0)),
             "double =": P.EqualTo(col("v"), col("v"))}
    err = 0.0
    for n in (1, 1000, (1 << 20) + 3):
        batch = mixed_batch(session, rng, n)
        # a frame over the batch's schema, only to plan the stage
        df = DataFrame(L.Scan([[]], batch.schema), session)
        for name, cond in conds.items():
            stage = (df.filter(cond)
                     .select(Alias(A.Add(col("k"), lit(1)), "k1"),
                             Alias(A.Multiply(col("v"), lit(2.0)), "v2"),
                             col("s"))
                     .executed_plan())
            check(isinstance(stage, FU.TorchFusedStageExec),
                  f"K5 plan: {stage.tree_string()}")
            lits = FU.LiteralArgs.upload(stage.promoted, tr)
            idx, comp = FU.fused_stage_compact(stage.program, batch, lits,
                                               tr)
            torch.cuda.synchronize()
            ridx, rcomp = FU.fused_stage_compact_plain(stage.program, batch,
                                                       lits, tr)
            what = f"K5, {n} rows, {name}"
            err = max(err, same_indices(idx, ridx, f"{what}: survivors"),
                      same_columns(comp, rcomp, what))
            same_columns(
                BO.gather_columns([batch.columns[3]], idx, tr, True),
                BO.gather_columns_plain([batch.columns[3]], ridx, tr, True),
                f"{what}: the string column")
    return err


def check_join(session, rng) -> float:
    """K10 against its plain version: duplicate build keys, null keys on
    both sides, int and long keys, empty sides."""
    import torch
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.ops import join_ops as J
    tr = session.transfers
    dev = session.device

    def key(n, hi, null_frac, dtype):
        data = torch.from_numpy(rng.integers(0, hi, n).astype(dtype)).to(dev)
        valid = torch.from_numpy(rng.random(n) >= null_frac).to(dev)
        dt = T.INT if dtype == np.int32 else T.LONG
        return DeviceColumn(data, valid, dt, all_valid=null_frac == 0)

    err = 0.0
    for nb, npr, hi, nf, bt, pt in (
            (1000, 100_000, 300, 0.1, np.int64, np.int64),
            (7, 50, 5, 0.2, np.int32, np.int64),
            (120, (1 << 20) + 3, 1461, 0.0, np.int64, np.int64),
            (0, 10, 5, 0.0, np.int64, np.int32),
            (10, 0, 5, 0.0, np.int64, np.int64)):
        b, p = key(nb, hi, nf, bt), key(npr, hi, nf, pt)
        got = J.join_pairs(b, p, tr)
        torch.cuda.synchronize()
        ref = J.join_pairs_plain(b, p, tr)
        for g, r, side in zip(got, ref, ("probe", "build")):
            err = max(err, same_indices(g, r,
                                        f"K10, {nb} x {npr}: {side} rows"))
    return err


def check_keyed(session, rng) -> float:
    """K9 against its plain version: int, long and string keys with nulls,
    double and long sums and counts.  Groups, counts and long sums exact;
    double sums within 1e-10 of the group's sum |v|."""
    import torch
    from spark_rapids_tpu_torch.ops import agg_ops as G
    tr = session.transfers
    err = 0.0
    kinds = [G.KEYED_SUM_F64, G.KEYED_SUM_I64, G.KEYED_COUNT,
             G.KEYED_COUNT_ALL]
    for n in (1, 1000, 100_000):
        b = mixed_batch(session, rng, n)
        i, k, v, s = b.columns
        # few distinct keys, so groups hold many rows
        k.data.remainder_(7)
        for keys in ([i, k, s], [s], [i]):
            inputs = [v, k, v, None]
            rep, res = G.keyed_aggregate(keys, inputs, kinds, tr)
            torch.cuda.synchronize()
            ref = G.keyed_aggregate_plain(keys, inputs, kinds, tr)
            err = max(err, same_keyed(keys, inputs, kinds, (rep, res), ref,
                                      tr, f"K9, {n} rows, {len(keys)} keys"))
    return err


def same_keyed(keys, inputs, kinds, got, ref, tr, what: str) -> float:
    """K9's output against the plain version's: groups, counts and long
    sums exact; a double sum within 1e-10 of its group's sum |v|.  Returns
    the measured max |d|."""
    import torch
    from spark_rapids_tpu_torch.ops import agg_ops as G
    (rep, res), (rrep, rres) = got, ref
    err = same_indices(rep, rrep, f"{what}: groups")
    gid, _ = G.group_rows_plain(keys, tr)
    for j, ((gd, gv), (rd, rv)) in enumerate(zip(res, rres)):
        check(bool(torch.equal(gv.cpu(), rv.cpu())),
              f"{what}, aggregate {j}: validity")
        if kinds[j] != G.KEYED_SUM_F64:
            err = max(err, same_indices(gd, rd,
                                        f"{what}, aggregate {j}: values"))
            continue
        v = inputs[j]
        absum = torch.zeros(rep.shape[0], dtype=torch.float64,
                            device=v.device).index_add_(
            0, gid, torch.where(v.validity & torch.isfinite(v.data),
                                v.data.abs(), 0.0))
        nan = torch.isnan(rd)
        check(bool(torch.equal(torch.isnan(gd), nan)),
              f"{what}, aggregate {j}: NaN sums")
        d = torch.where(nan | ~rv, 0.0, (gd - rd).abs())
        check(bool((d <= F64_SUM_RTOL * absum).all()),
              f"{what}, aggregate {j}: double sums")
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def check_sort(session, rng) -> float:
    """K8 against its plain version: NaN, -0.0, +-inf, nulls, descending
    keys and ties (the permutations must be equal: both are stable)."""
    import torch
    from spark_rapids_tpu_torch.ops import sort_ops as S
    err = 0.0
    for n in (1, 1000, 100_003):
        b = mixed_batch(session, rng, n)
        b.columns[2].data[::97] = float("inf")
        b.columns[2].data[1::89] = float("-inf")
        for orders in ([S.SortOrder(2, False, False), S.SortOrder(0),
                        S.SortOrder(1)],
                       [S.SortOrder(0)],
                       [S.SortOrder(2, True, True)],
                       [S.SortOrder(0, False, True),
                        S.SortOrder(2, False, False)]):
            got = S.sort_permutation(b.columns, orders)
            torch.cuda.synchronize()
            ref = S.sort_permutation_plain(b.columns, orders)
            err = max(err, same_indices(
                got, ref, f"K8, {n} rows, {orders}: permutation"))
    return err


def rows_match(expected, actual, what: str) -> None:
    """In order; doubles within 1e-6 relative (the comparator the JAX
    package's TPC-DS oracle uses, rowcompare.val_eq), the rest exact."""
    check(len(expected) == len(actual),
          f"{what}: {len(expected)} rows vs {len(actual)}")
    for i, (e, a) in enumerate(zip(expected, actual)):
        check(e.keys() == a.keys(), f"{what}: row {i} columns")
        for key in e:
            x, y = e[key], a[key]
            if isinstance(x, float) and isinstance(y, float):
                ok = x == y or abs(x - y) <= max(1e-9, 1e-6 * max(abs(x),
                                                                  abs(y)))
            else:
                ok = x == y
            check(ok, f"{what}: row {i} {key} {x!r} vs {y!r}")


def q3_counter(kernel: str):
    """(module, attribute) of a q3 kernel's launch counter."""
    import importlib
    mod, attr = Q3_COUNTERS[kernel]
    return importlib.import_module(f"spark_rapids_tpu_torch.{mod}"), attr


class Recorder:
    """Records the calls of the slice-2 kernels' wrappers that launched
    their kernel during one run, so each kernel can be checked and timed
    on the inputs the main path gave it; with ``mark``, each call runs in
    a profiler range named ``srt.<kernel>``, which sums the device time of
    the kernels the call launched."""

    def __init__(self, mark: bool = False):
        self.mark = mark
        from spark_rapids_tpu_torch.exec import fused, joins
        from spark_rapids_tpu_torch.ops import agg_ops, batch_ops, sort_ops
        self.calls = []
        self._patches = [
            (fused, "fused_stage_compact", "K5"),
            (batch_ops, "gather_columns", "K7"),
            (joins, "gather_columns", "K7"),
            (sort_ops, "sort_permutation", "K8"),
            (agg_ops, "keyed_aggregate", "K9"),
            (joins, "join_pairs", "K10")]
        self._saved = []

    def __enter__(self):
        for mod, name, kernel in self._patches:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))

            def wrapped(*a, _fn=fn, _k=kernel, **kw):
                counter = q3_counter(_k)
                before = getattr(*counter)
                if self.mark:
                    import torch
                    with torch.profiler.record_function(f"srt.{_k}"):
                        out = _fn(*a, **kw)
                else:
                    out = _fn(*a, **kw)
                if getattr(*counter) != before:
                    self.calls.append((_k, a, kw))
                return out
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def column_bytes(c, rows=None) -> int:
    """Bytes of a column's planes (of ``rows`` rows of a fixed-width one)."""
    n = c.row_count if rows is None else rows
    if c.is_string:
        return c.offsets.element_size() * (n + 1) + int(c.offsets[-1]) + \
            (0 if c.all_valid else n)
    return n * (c.data.element_size() + (0 if c.all_valid else 1))


def same_output(name: str, args, kw, got, ref, tr, what: str) -> float:
    """A q3 kernel's output on one recorded call against its plain
    version's, by phase 2b's comparators; returns the measured max |d|."""
    if name == "K5":
        return max(same_indices(got[0], ref[0], f"{what}: survivors"),
                   same_columns(got[1], ref[1], what))
    if name == "K7":
        return same_columns(got, ref, what)
    if name == "K8":
        return same_indices(got, ref, f"{what}: permutation")
    if name == "K9":
        return same_keyed(*args[:3], got, ref, tr, what)
    return max(same_indices(g, r, f"{what}: {side} rows")
               for g, r, side in zip(got, ref, ("probe", "build")))


def time_q3_kernels(session, calls, rate: float, reps: int):
    """Per query: each kernel's device ms, plain ms, bound ms and library
    ms, summed over its recorded launches, and the max |d| of its output
    on each of them against its plain version's."""
    import torch
    from spark_rapids_tpu_torch.exec import fused as FU
    from spark_rapids_tpu_torch.ops import agg_ops as G
    from spark_rapids_tpu_torch.ops import batch_ops as BO
    from spark_rapids_tpu_torch.ops import join_ops as J
    from spark_rapids_tpu_torch.ops import sort_ops as S
    tr = session.transfers
    plain = {"K5": FU.fused_stage_compact_plain,
             "K7": BO.gather_columns_plain, "K8": S.sort_permutation_plain,
             "K9": G.keyed_aggregate_plain, "K10": J.join_pairs_plain}
    kernel = {"K5": FU.fused_stage_compact, "K7": BO.gather_columns,
              "K8": S.sort_permutation, "K9": G.keyed_aggregate,
              "K10": J.join_pairs}
    out = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "library_ms": 0.0,
               "shapes": [], "max_abs_err": 0.0} for k in plain}
    out["K9"]["library_ms"] = out["K10"]["library_ms"] = None
    for i, (name, args, kw) in enumerate(calls):
        o = out[name]
        got = kernel[name](*args, **kw)
        torch.cuda.synchronize()
        o["max_abs_err"] = max(o["max_abs_err"], same_output(
            name, args, kw, got, plain[name](*args, **kw), tr,
            f"q3 main path, {name} call {i}"))
        ms = time_ms(lambda: kernel[name](*args, **kw), reps)
        o["ms"] += ms
        o["plain_ms"] += time_ms(lambda: plain[name](*args, **kw), 2, 1)
        if name == "K5":
            program, batch, lits, _tr = args
            idx = got[0]
            used = [batch.columns[i] for i in program.used]
            o["bytes"] += sum(column_bytes(c) for c in used) + \
                8 * idx.shape[0]
            o["shapes"].append(f"{batch.row_count}->{idx.shape[0]}: "
                               f"{ms:.4f} ms")
            # library: the predicate's mask by torch, torch.nonzero, and
            # index_select of the stage's fixed-width planes (the gather
            # of those planes is K7's work on the kernel side)
            cond = program.conditions[0]
            c = batch.columns[cond.children[0].ordinal]
            value = lits.values[0] if lits.values else cond.children[1].value
            kept = [batch.columns[b] for b in program.bare if b is not None]
            planes = [k.data for k in kept if not k.is_string] + \
                [k.validity for k in kept]

            def compact(c=c, value=value, planes=planes):
                rows = torch.nonzero(c.data == value).flatten()
                return [torch.index_select(p, 0, rows) for p in planes]
            o["library_ms"] += time_ms(compact, reps)
        elif name == "K7":
            cols, idx = args[0], args[1]
            n = idx.shape[0]
            o["bytes"] += 8 * n + sum(column_bytes(g) * 2 for g in got)
            o["shapes"].append(f"{len(cols)}x{n}: {ms:.4f} ms")
            planes = [p for c in cols if not c.is_string for p in (c.data,)]
            planes += [c.validity for c in cols]
            o["library_ms"] += time_ms(
                lambda: [torch.index_select(p, 0, idx) for p in planes],
                reps)
        elif name == "K8":
            cols, orders = args
            n = cols[0].row_count
            o["bytes"] += sum(column_bytes(cols[x.ordinal]) for x in orders) \
                + 8 * n
            o["shapes"].append(f"{n} rows, {len(orders)} keys: {ms:.4f} ms")
            word = S.order_words_plain(cols[orders[1].ordinal],
                                       orders[1])[-1]
            o["library_ms"] += time_ms(
                lambda: torch.argsort(word, stable=True), reps)
        elif name == "K9":
            keys, inputs = args[0], args[1]
            rep, res = got
            g = rep.shape[0]
            o["bytes"] += sum(column_bytes(c) for c in keys) + \
                sum(column_bytes(c) for c in inputs if c is not None) + \
                g * (8 + sum(9 for _ in res))
            o["shapes"].append(f"{keys[0].row_count}->{g} groups: "
                               f"{ms:.4f} ms")
        else:
            b, p = args[0], args[1]
            pr = got[0]
            o["bytes"] += column_bytes(b) + column_bytes(p) + \
                16 * pr.shape[0]
            o["shapes"].append(f"{b.row_count} x {p.row_count} -> "
                               f"{pr.shape[0]}: {ms:.4f} ms")
    for o in out.values():
        o["bound_ms"] = o["bytes"] / rate * 1e3
    return out


def device_us_by_range(events, prefix: str = "srt."):
    """Device microseconds of the kernels and copies that ran inside each
    profiler range named ``<prefix><kernel>`` on the card's timeline: a
    range's own span also holds the card's idle gaps, its kernels do not."""
    from torch.autograd import DeviceType
    spans, work = [], []
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        t = (e.time_range.start, e.time_range.end)
        (spans if e.name.startswith(prefix) else work).append((t, e.name))
    out = {}
    for (s0, s1), name in spans:
        key = name[len(prefix):]
        out[key] = out.get(key, 0.0) + sum(
            w1 - w0 for (w0, w1), _n in work if s0 <= w0 and w1 <= s1)
    return out


def profile_q3(frames, reps: int = 3):
    """Device time by kernel over ``reps`` q3 queries (torch.profiler, which
    traces the card through CUPTI), the share of the window in which the
    card ran nothing, and each slice-2 kernel's device ms per query (what
    its wrapper calls ran on the card), or None where the profiler saw no
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from spark_rapids_tpu_torch.testing import tpcds
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            Recorder(mark=True):
        t0 = time.perf_counter()
        for _ in range(reps):
            tpcds.q3(*frames)[0].collect()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith("srt.")]

    def dev_us(e):
        return next((getattr(e, n) for n in ("self_device_time_total",
                                             "self_cuda_time_total")
                     if hasattr(e, n)), 0)
    busy = sum(dev_us(e) for e in kernels)
    if not kernels or not busy:
        print("q3 profile: the profiler recorded no device time (not "
              "measured)")
        return {k: None for k in Q3_KERNELS}
    print(f"q3 profile over {reps} queries: device busy {busy / reps:.1f} "
          f"us per query of {wall_us / reps:.1f} us wall (profiler on); "
          f"idle share {1 - busy / wall_us:.4f}; {len(kernels)} kernels")
    for e in sorted(kernels, key=lambda e: -dev_us(e))[:14]:
        print(f"  {dev_us(e) / reps:9.1f} us/query  {e.count // reps:4d} x  "
              f"{e.key[:90]}")
    by_range = device_us_by_range(prof.events())
    device_ms = {k: by_range[k] / reps / 1e3 if by_range.get(k) else None
                 for k in Q3_KERNELS}
    print(f"q3 device ms per query by kernel (work inside each wrapper's "
          f"profiler range): {device_ms}; outside them "
          f"{(busy - sum(by_range.values())) / reps / 1e3:.4f} ms")
    return device_ms


def run_q3(session, sf: float, rate: float):
    """Phase 5: TPC-DS q3 at ``sf`` through TorchSession(); checks it
    against numpy and the CPU run, and times its kernels."""
    import torch
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch.exec.stage_compiler import stats as kstats
    from spark_rapids_tpu_torch.testing import tpcds
    t0 = time.perf_counter()
    tables = tpcds.q3_tables(tpcds.generate_tables(sf))
    gen_s = time.perf_counter() - t0
    names = ("date_dim", "store_sales", "item")
    rows = {t: len(next(iter(tables[t].values()))) for t in names}
    dfs = [session.create_dataframe(tables[t]) for t in names]
    t0 = time.perf_counter()
    first = tpcds.q3(*dfs)[0].collect()
    first_s = time.perf_counter() - t0
    device_bytes = sum(column_bytes(c) for df in dfs for part in
                       df._plan.device_cache[str(session.device)]
                       for b in part for c in b.columns)
    print(f"q3: sf {sf}, rows {rows}, generated in {gen_s:.1f} s; "
          f"{device_bytes} B of device columns; first action (upload, "
          f"builds, query) {first_s:.3f} s")

    counters = [(*q3_counter(k), k) for k in Q3_KERNELS]
    for mod, attr, _k in counters:
        setattr(mod, attr, 0)
    tr0, ks0 = session.transfers.stats(), kstats()
    t0 = time.perf_counter()
    result = tpcds.q3(*dfs)[0].collect()
    main_s = time.perf_counter() - t0
    launches = {k: getattr(mod, attr) for mod, attr, k in counters}
    tr1, ks1 = session.transfers.stats(), kstats()
    syncs = tr1["syncs"] - tr0["syncs"]
    builds = ks1["builds"] - ks0["builds"]
    print(f"q3 main path: {main_s * 1e3:.3f} ms, {len(result)} rows, "
          f"launches {launches}, transfers "
          f"{({k: tr1[k] - tr0[k] for k in tr1})}, builds {builds}")
    for k, n in launches.items():
        check(n > 0, f"q3 launched {k}: {launches}")
    check(builds == 0, "a repeated q3 builds nothing")
    check(result == first, "a repeated q3 gives the same rows")
    check(len(result) >= 10, f"q3 gives at least 10 rows: {len(result)}")

    times = []
    for _ in range(Q3_REPS):
        t0 = time.perf_counter()
        tpcds.q3(*dfs)[0].collect()
        times.append(time.perf_counter() - t0)
    best, median = min(times), float(np.median(times))

    rows_match(tpcds.q3_numpy(tables), result, "q3 vs numpy")
    cpu = TorchSession(device="cpu")
    t0 = time.perf_counter()
    cpu_rows = tpcds.q3(*[cpu.create_dataframe(tables[t])
                          for t in names])[0].collect()
    cpu_s = time.perf_counter() - t0
    rows_match(cpu_rows, result, "q3 vs the CPU run")
    print(f"q3 matches numpy and the CPU run ({cpu_s:.1f} s); first rows "
          f"{result[:2]}")

    device_ms = profile_q3(dfs)
    with Recorder() as rec:
        tpcds.q3(*dfs)[0].collect()
    recorded = {k: sum(c[0] == k for c in rec.calls) for k in Q3_KERNELS}
    check(recorded == launches, f"every launch of the main path was "
          f"recorded: {recorded} vs {launches}")
    timed = time_q3_kernels(session, rec.calls, rate, 10)
    print(f"q3 kernels vs plain on the main path's {len(rec.calls)} calls: "
          f"pass, max |d| "
          f"{({k: o['max_abs_err'] for k, o in timed.items()})}")
    ss_rows = rows["store_sales"]
    print(f"q3 best of {Q3_REPS}: {best * 1e3:.3f} ms, median "
          f"{median * 1e3:.3f} ms, {ss_rows / best:.6e} store_sales "
          f"rows/s; {syncs} syncs per query; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    for k, o in timed.items():
        o["device_ms"] = device_ms[k]
        print(f"  {k}: {o['ms']:.4f} ms per query over {launches[k]} "
              f"launches (per launch: {'; '.join(o['shapes'])}), plain "
              f"{o['plain_ms']:.4f} ms, bound {o['bound_ms']:.6f} ms "
              f"({o['bytes']} B), library {o['library_ms']}")
    kernel_ms = sum(o["ms"] for o in timed.values())
    print(f"q3 breakdown: kernels {kernel_ms:.4f} ms (each timed alone, "
          f"syncs inside), rest {best * 1e3 - kernel_ms:.4f} ms of "
          f"{best * 1e3:.4f} ms")
    return launches, timed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=128_000_000)
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sf", type=float, default=1000.0,
                    help="TPC-DS scale of the q3 phase (store_sales "
                    "30,000 rows per sf)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import spark_rapids_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    from importlib.metadata import version
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch.exec import fused as FU
    from spark_rapids_tpu_torch.exec.stage_compiler import stats as kstats
    from spark_rapids_tpu_torch.kernels import build as B
    from spark_rapids_tpu_torch.ops import agg_ops as G

    started = time.perf_counter()

    def phase(what: str) -> None:
        print(f"[{time.perf_counter() - started:7.1f} s] {what}")

    # -- phase 1: the card, the versions, the kernel builds -----------------
    card = card_line()
    print(card)
    name = torch.cuda.get_device_name(0)
    rate = memory_rate(name)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, triton "
          f"{version('triton')}, {name}, memory rate {rate / 1e12} TB/s "
          "(data sheet)")
    nvcc_s = {}

    def build_cuda(source):
        t0 = time.perf_counter()
        B.build_shared_library(source)
        nvcc_s[source] = time.perf_counter() - t0
    # one nvcc per source, all at once
    builds = [threading.Thread(target=build_cuda, args=(src,))
              for src in CUDA_SOURCES]
    for t in builds:
        t.start()
    session = TorchSession()
    check(session.device.type == "cuda", "TorchSession() runs on cuda")
    tiny = session.create_dataframe(build_data(4099), num_partitions=1)
    fx = fused_exec_of(query(tiny))
    program = fx.program
    lits = FU.LiteralArgs.upload(fx.promoted, session.transfers)
    t0 = time.perf_counter()
    tb = session.transfers.upload_batch(tiny._plan.partitions[0][0])
    FU.fused_agg_update(program, tb, lits)
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    for t in builds:
        t.join()
    for src in CUDA_SOURCES:
        check(src in nvcc_s, f"{src} built")
    G.load_library()
    print(f"build: kernel 1 (Triton, first launch) {triton_s:.2f} s; nvcc "
          f"sm_90a " + ", ".join(f"{k} {v:.2f} s" for k, v in
                                 nvcc_s.items()))
    for log in sorted((B.REPO_ROOT / "build" / "cuda").glob("*.log")):
        text = log.read_text()
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spill = sum(int(x) for x in re.findall(r"(\d+) bytes spill", text))
        print(f"nvcc {log.stem}: {len(regs)} kernels, at most "
              f"{max(regs, default=0)} registers, {spill} bytes spilled")
    phase("built")

    # -- phase 2: each kernel against its plain version on the card ---------
    sizes = [1, 1000, 4097, (1 << 20) + 3]
    err1 = check_kernel1(session, program, sizes)
    err2 = check_kernel2(session.device, [0] + sizes[:3] + [31250])
    print(f"kernel 1 vs plain: pass, max |d sum_v| {err1!r}; "
          f"kernel 2 vs plain: pass, max |d sum| {err2!r}")

    # -- phase 2b: the q3 kernels against their plain versions --------------
    rng = np.random.default_rng(13)
    t0 = time.perf_counter()
    errs = {"K5": check_stage(session, rng), "K7": check_gather(session, rng),
            "K8": check_sort(session, rng), "K9": check_keyed(session, rng),
            "K10": check_join(session, rng)}
    print(f"K5, K7, K8, K9, K10 vs plain: pass ({time.perf_counter() - t0:.1f}"
          f" s), max |d| {errs}")

    phase("kernels checked")

    # -- phase 3: the bench recipe at full size -----------------------------
    data = build_data(args.rows)
    df = session.create_dataframe(data, num_partitions=args.parts)
    t0 = time.perf_counter()
    first = query(df).collect()
    print(f"first action (upload + query): "
          f"{time.perf_counter() - t0:.3f} s")

    FU.LAUNCHES = 0
    G.LAUNCHES = 0
    tr0, ks0 = session.transfers.stats(), kstats()
    t0 = time.perf_counter()
    result = query(df).collect()
    main_s = time.perf_counter() - t0
    launches = {"fused_agg_update": FU.LAUNCHES,
                "global_reduce": G.LAUNCHES}
    tr1, ks1 = session.transfers.stats(), kstats()
    print(f"main path: {main_s * 1e3:.3f} ms, launches {launches}, "
          f"transfers {({k: tr1[k] - tr0[k] for k in tr1})}")
    check(launches["fused_agg_update"] == args.parts,
          f"kernel 1 launched once per partition: {launches}")
    check(launches["global_reduce"] == args.parts + 1,
          f"kernel 2 launched per partition plus the merge: {launches}")
    check(tr1["syncs"] - tr0["syncs"] == 1, "one blocking sync per query")
    check(ks1["builds"] == ks0["builds"], "a repeated query builds nothing")
    check(result == first, "a repeated query gives the same row")
    other = query(df, threshold=5).collect()
    check(kstats()["builds"] == ks0["builds"],
          "another threshold builds nothing")
    check(other[0]["sk"] != result[0]["sk"], "threshold 5 is a new query")

    best = float("inf")
    for _ in range(args.reps):
        t0 = time.perf_counter()
        query(df).collect()
        best = min(best, time.perf_counter() - t0)

    cpu = TorchSession(device="cpu")
    ref = query(cpu.create_dataframe(data, num_partitions=args.parts)
                ).collect()
    r, c = result[0], ref[0]
    check(r["sk"] == c["sk"] and r["sh"] == c["sh"],
          f"sk, sh match the CPU run: {r} vs {c}")
    check(abs(r["sv"] - c["sv"]) < 1e-6 * abs(c["sv"]),
          f"sv matches the CPU run: {r} vs {c}")
    sel = data["w"] > 0
    np_sk = int(np.sum(data["k"][sel] + 1))
    np_sv = float(np.sum(data["v"][sel] * 2.0))
    check(r["sk"] == np_sk, f"sk matches numpy: {r['sk']} vs {np_sk}")
    check(abs(r["sv"] - np_sv) < 1e-6 * abs(np_sv),
          f"sv matches numpy: {r['sv']} vs {np_sv}")
    print(f"result {result[0]} matches the CPU run and numpy")

    phase("bench recipe run and checked")

    # -- per-kernel times at the main path's shapes -------------------------
    part0 = df._plan.device_cache[str(session.device)][0][0]
    n0 = part0.row_count
    lits = FU.LiteralArgs.upload(fx.promoted, session.transfers)
    k1_ms = time_ms(lambda: FU.fused_agg_update(program, part0, lits), 20)
    k1_plain_ms = time_ms(
        lambda: FU.fused_agg_update_plain(program, part0, lits), 3, 1)
    words, valid = FU.fused_agg_update(program, part0, lits)
    # kernel 1 against its plain version at the main path's shape
    w0, v0 = part0.columns[2].data, part0.columns[1].data
    err1 = max(err1, compare_rows(
        G.global_reduce_plain(words, valid, program.fold_kinds),
        G.global_reduce_plain(*FU.fused_agg_update_plain(program, part0,
                                                         lits),
                              program.fold_kinds),
        program.buffer_types,
        float(torch.where(w0 > 0, (v0 * 2.0).abs(), 0.0).sum()),
        f"kernel 1 on partition 0 ({n0} rows)"))
    print(f"kernel 1 vs plain on partition 0: pass, max |d sum_v| {err1!r}")
    k2_ms = time_ms(lambda: G.global_reduce(words, valid,
                                            program.fold_kinds), 50)
    k2_plain_ms = time_ms(lambda: G.global_reduce_plain(
        words, valid, program.fold_kinds), 10)
    # the library yardstick: a masked torch.sum per kind of column
    ints = [j for j, k in enumerate(program.fold_kinds) if k != G.SUM_F64]
    dbls = [j for j, k in enumerate(program.fold_kinds) if k == G.SUM_F64]
    wi, vi = words[:, ints].contiguous(), valid[:, ints].contiguous()
    wf = words[:, dbls].contiguous().view(torch.float64)
    vf = valid[:, dbls].contiguous()
    k2_lib_ms = time_ms(lambda: (torch.where(vi, wi, 0).sum(0),
                                 torch.where(vf, wf, 0.0).sum(0)), 50)
    nb = len(program.update_specs)
    kernel_ms = args.parts * k1_ms + (args.parts + 1) * k2_ms
    print(f"breakdown per query: kernels {kernel_ms:.4f} ms "
          f"({args.parts} x kernel 1 + {args.parts + 1} x kernel 2, each "
          f"timed alone), rest {best * 1e3 - kernel_ms:.4f} ms of "
          f"{best * 1e3:.4f} ms (host planning, launches, glue, transfers "
          f"and the sync); kernel share {kernel_ms / (best * 1e3):.4f}")
    k1_bytes = kernel1_read_bytes(part0) + words.shape[0] * nb * 9
    query_read = sum(kernel1_read_bytes(b) for part in
                     df._plan.device_cache[str(session.device)]
                     for b in part)
    k2_bytes = words.numel() * 9 + nb * 9
    rows_s = args.rows / best
    print(f"query best of {args.reps}: {best * 1e3:.3f} ms, "
          f"{rows_s:.6e} rows/s, {args.rows * ROW_BYTES / best:.6e} B/s "
          f"(data planes), kernel-1 bound per query "
          f"{query_read / rate * 1e3:.4f} ms ({query_read} B); "
          f"kernel 1 {k1_ms:.4f} ms/partition of {n0} rows (bound "
          f"{k1_bytes / rate * 1e3:.4f} ms, "
          f"{k1_bytes / rate * 1e3 / k1_ms:.4f} of it), kernel 2 "
          f"{k2_ms:.4f} ms/fold of {words.shape[0]} partial rows; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; "
          f"card {card}")
    kernels = [
        {"name": "fused_agg_update", "route": "triton",
         "source": "spark_rapids_tpu_torch/kernels/fused_agg.py",
         "replaces": "spark_rapids_tpu/exec/fused.py:337",
         "launches": launches["fused_agg_update"], "max_abs_err": err1,
         "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bytes / rate * 1e3, "bound_by": "bytes",
         "library_ms": None, "per": "launch", "passed": True},
        {"name": "global_reduce", "route": "cuda",
         "source": "spark_rapids_tpu_torch/csrc/global_reduce.cu",
         "replaces": "spark_rapids_tpu/ops/agg_ops.py:223",
         "launches": launches["global_reduce"], "max_abs_err": err2,
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bytes / rate * 1e3, "bound_by": "bytes",
         "library_ms": k2_lib_ms, "per": "launch", "passed": True},
    ]
    del df, data, part0, words, valid

    phase("bench recipe's kernels timed")

    # -- phase 4: TPC-DS q3 at full size -------------------------------------
    q3_launches, timed = run_q3(session, args.sf, rate)
    phase("q3 run, checked and timed")
    for k, (name_, route, source, replaces) in Q3_KERNELS.items():
        o = timed[k]
        kernels.append({
            "name": name_, "route": route, "source": source,
            "replaces": replaces, "launches": q3_launches[k],
            "max_abs_err": max(errs[k], o["max_abs_err"]), "ms": o["ms"],
            "plain_ms": o["plain_ms"], "bound_ms": o["bound_ms"],
            "bound_by": "bytes", "library_ms": o["library_ms"],
            "device_ms": o["device_ms"], "per": "query", "passed": True})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
