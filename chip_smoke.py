#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (spark_rapids_tpu_torch).

    python3 chip_smoke.py [--rows N] [--parts N] [--reps N]

Needs one CUDA card; it exits non-zero, printing no result, without one.
It builds every kernel of the main path from the sources in the checkout
(kernel 1: the Triton kernel emitted by kernels/fused_agg.py; kernel 2:
csrc/global_reduce.cu through nvcc, into the git-ignored build/ directory),
holds each kernel against its plain PyTorch version on the card, and then
drives bench.py's recipe -- filter(w > t), project k+1, v*2.0 and
murmur3(k, w), sum all three, collect -- on 128M rows in 4 partitions
through ``TorchSession()``.  Every check that fails ends the run with a
non-zero exit.  The last two lines of standard output are a JSON object
describing each kernel and the JSON result line.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np

INT64_MAX = 2 ** 63 - 1
#: data bytes of one table row (k int64, v double, w int32), as bench.py
ROW_BYTES = 8 + 8 + 4
F64_SUM_RTOL = 1e-10


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=128_000_000)
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
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

    # -- phase 1: the card, the versions, the kernel builds -----------------
    card = card_line()
    print(card)
    name = torch.cuda.get_device_name(0)
    rate = memory_rate(name)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, triton "
          f"{version('triton')}, {name}, memory rate {rate / 1e12} TB/s "
          "(data sheet)")
    nvcc_s = {}

    def build_cuda():
        t0 = time.perf_counter()
        G.load_library()
        nvcc_s["s"] = time.perf_counter() - t0
    nvcc = threading.Thread(target=build_cuda)
    nvcc.start()
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
    nvcc.join()
    check("s" in nvcc_s, "kernel 2 built")
    log = sorted((B.REPO_ROOT / "build" / "cuda").glob("*.log"))
    print(f"build: kernel 1 (Triton, first launch) {triton_s:.2f} s; "
          f"kernel 2 (nvcc sm_90a) {nvcc_s['s']:.2f} s")
    if log:
        print("nvcc: " + " | ".join(
            ln.strip() for ln in log[-1].read_text().splitlines()
            if "registers" in ln or "spill" in ln))

    # -- phase 2: each kernel against its plain version on the card ---------
    sizes = [1, 1000, 4097, (1 << 20) + 3]
    err1 = check_kernel1(session, program, sizes)
    err2 = check_kernel2(session.device, [0] + sizes[:3] + [31250])
    print(f"kernel 1 vs plain: pass, max |d sum_v| {err1!r}; "
          f"kernel 2 vs plain: pass, max |d sum| {err2!r}")

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
         "library_ms": None, "passed": True},
        {"name": "global_reduce", "route": "cuda",
         "source": "spark_rapids_tpu_torch/csrc/global_reduce.cu",
         "replaces": "spark_rapids_tpu/ops/agg_ops.py:223",
         "launches": launches["global_reduce"], "max_abs_err": err2,
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bytes / rate * 1e3, "bound_by": "bytes",
         "library_ms": k2_lib_ms, "passed": True},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
