"""Times kernel 1 (exec/fused.py) on the card over its launch constants.

    python3 -m spark_rapids_tpu_torch.tools.sweep_fused [--rows N] [--reps N]

It builds one partition of ``--rows`` rows (default 32M: one partition of
bench.py's recipe at 128M rows in 4) with bench.py's columns and value
ranges (seed 7) and plans the recipe's chain at threshold 0.  The
columns hold no null, so the main path's kernel reads no validity plane;
the same planes not marked all valid drive the kernel that reads them.
For each tile size, warp count and number of program instances per SM it
holds both kernels' folded rows against the plain version's (long sums
and counts exact, the double sum within 1e-10 * sum|v2|) and times them
in turns by CUDA events.  "programs per SM" 0 means one program per
tile, with no grid stride.  It prints the card's name and power limit,
one line per setting, and last a JSON list of the settings and their
times.  It needs a CUDA card."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec import fused as FU
from spark_rapids_tpu_torch.expressions import arithmetic as A
from spark_rapids_tpu_torch.expressions import hashing as H
from spark_rapids_tpu_torch.expressions import predicates as P
from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
from spark_rapids_tpu_torch.ops.agg_ops import global_reduce_plain

TILES = (512, 1024, 2048, 4096)
WARPS = (4, 8, 16)
PROGRAMS_PER_SM = (0, 1, 2, 4, 8)


def _fused_exec(node):
    if isinstance(node, FU.TorchFusedAggExec):
        return node
    for c in node.children:
        found = _fused_exec(c)
        if found is not None:
            return found
    return None


def _time_ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _check(program, batch, lits, ref_words, ref_valid, tol, setting):
    """Holds kernel 1's folded row against the plain version's."""
    words, valid = (t.cpu() for t in global_reduce_plain(
        *FU.fused_agg_update(program, batch, lits), program.fold_kinds))
    if not torch.equal(valid, ref_valid):
        raise RuntimeError(f"validity differs at {setting}")
    for j, dt in enumerate(program.buffer_types):
        a, b = words[j:j + 1], ref_words[j:j + 1]
        if dt.is_floating:
            ok = abs(float(a.view(torch.float64) -
                           b.view(torch.float64))) <= tol
        else:
            ok = int(a) == int(b)
        if not ok:
            raise RuntimeError(f"buffer {j} differs at {setting}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=32_000_000)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_fused: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    rng = np.random.default_rng(7)
    n = args.rows
    data = {"k": rng.integers(0, 1 << 20, n).astype(np.int64),
            "v": rng.standard_normal(n),
            "w": rng.integers(-1000, 1000, n).astype(np.int32)}
    session = TorchSession()
    df = session.create_dataframe(data)
    fx = _fused_exec(df.filter(P.GreaterThan(col("w"), lit(0)))
                     .select(Alias(A.Add(col("k"), lit(1)), "k1"),
                             Alias(A.Multiply(col("v"), lit(2.0)), "v2"),
                             Alias(H.Murmur3Hash(col("k"), col("w")), "h"))
                     .agg(F.sum("k1"), F.sum("v2"), F.sum("h"))
                     .executed_plan())
    program = fx.program
    batch = session.transfers.upload_batch(df._plan.partitions[0][0])
    lits = FU.LiteralArgs.upload(fx.promoted, session.transfers)
    ref_words, ref_valid = global_reduce_plain(
        *FU.fused_agg_update_plain(program, batch, lits), program.fold_kinds)
    ref_words, ref_valid = ref_words.cpu(), ref_valid.cpu()
    v, w = batch.columns[1].data, batch.columns[2].data
    tol = 1e-10 * float(torch.where(w > 0, (v * 2.0).abs(), 0.0).sum())
    # the same planes, not marked all valid: the kernel reads validity
    nullable = ColumnarBatch([DeviceColumn(c.data, c.validity, c.data_type)
                              for c in batch.columns], batch.row_count,
                             batch.names)
    rows = []
    for tile in TILES:
        for warps in WARPS:
            for per_sm in PROGRAMS_PER_SM:
                FU.BLOCK_ROWS, FU.NUM_WARPS = tile, warps
                FU.PROGRAMS_PER_SM = per_sm or 1 << 40
                for b in (batch, nullable):
                    _check(program, b, lits, ref_words, ref_valid, tol,
                           (tile, warps, per_sm))
                row = {"tile": tile, "warps": warps,
                       "programs_per_sm": per_sm,
                       "grid": FU.grid_size(n, batch.device),
                       "read_ms": 0.0, "skipped_ms": 0.0}
                for key, b in (("read_ms", nullable), ("skipped_ms", batch),
                               ("skipped_ms", batch), ("read_ms", nullable)):
                    row[key] += _time_ms(
                        lambda: FU.fused_agg_update(program, b, lits),
                        args.reps) / 2
                rows.append(row)
                print(f"tile {tile:5d} warps {warps:2d} programs/SM {per_sm} "
                      f"grid {row['grid']:6d}: {row['skipped_ms']:.4f} ms "
                      f"skipping validity, {row['read_ms']:.4f} ms reading "
                      "it", flush=True)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
