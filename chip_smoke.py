#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (spark_rapids_tpu_torch).

    python3 chip_smoke.py [--rows N] [--parts N] [--reps N] [--sf SF]

Needs one CUDA card; it exits non-zero, printing no result, without one.
It builds every kernel from the sources in the checkout, into the
git-ignored build/ directory: kernel 1, K5 and K6 (Triton, emitted by
kernels/fused_agg.py and kernels/fused_stage.py) and kernel 2, K7, K7c,
K8, K9, K10 (with its full outer mode K10f and its null-safe mode K10n),
K10x, K14 (with its ranking pass K14r and its frame kinds K14s, K14b and
K14o), K15d, K11h, K11r and K7s, K13 (computed strings), K16 (the
decode of dictionary and RLE columns), K14c (the running window's
carry between chunks) and the decimal avg finish (csrc/decimal.cu)
(csrc/*.cu, one nvcc each, all started together).
It holds each kernel against its plain PyTorch version on the card
(phase 2h: the exchange's kernels and K9's merge kinds; phase 2i: the
window frames and the full outer join; phase 2j: K13 and K10's
null-safe mode; phase 2k: K16 and K5's code-space mode; phase 2l: K14c
chunk by chunk, and the chunked bounded window path against one batch;
phase 2m: K9's min, max, first, last, first_valid and last_valid kinds
(group-by and merge), K1's update forms of them and K3's, on 2^20+3 rows
with nulls, NaN, +-0.0 and one group of every row; phase 2n: K12, the
decimal arithmetic, inside K6, K5 and K1, K9's and K3's decimal sum
kinds, the decimal avg finish, K8's decimal words and K7, K7c and K7s on
decimal128 rows, on 2^20+3 rows, bit for bit), then drives sixteen
paths through ``TorchSession()``, each query with the launch counters set
to 0 just before it and read just after:

- bench.py's recipe -- filter(w > t), project k+1, v*2.0 and
  murmur3(k, w), sum all three, collect -- on 128M rows in 4 partitions,
  checked against the CPU run and numpy;
- phase 3b: the recipe's global form over the same table --
  filter(w > t), then min(v), max(v), min(k), max(w), first(k), last(v),
  first(v, ignore_nulls) and last(w, ignore_nulls) -- K1's update forms,
  K3's fold and merge, K7's gather of the first/last rows, held against
  numpy in partition order (no CPU run);
- phase 3d: the recipe's decimal form over the same table with ``d`` =
  ``v`` rounded to cents as DECIMAL(7,2) -- filter(w > t), then k + 1,
  d * 2, d - w, d * w, (d * w) * d and murmur3(k, w), and their sums --
  K12 inside K1 with its 128-bit sums, K3's 128-bit fold and merge, held
  against exact integers (no CPU run);
- TPC-DS q3, q1 and q7 at sf 1000 (store_sales 30M rows, store_returns
  3M, customer and item 2M, date_dim 1461) at one partition, over tables
  generated once, each checked against a numpy version of the query and
  the CPU run, timed, with a torch.profiler breakdown by kernel, and every
  kernel call of its main path held against the kernel's plain version;
- TPC-DS q15, q12 and q20 (catalog_sales 15M rows, web_sales 8M,
  customer_address 1M) over the same tables, checked and timed alike;
- TPC-DS q13, q19 and q16 (store_sales 30M rows through five joins into
  kernel 1; a <> of two substrings; semi and anti joins and
  count(DISTINCT) over catalog_sales 15M rows) over the same tables,
  checked and timed alike;
- TPC-DS q17 as written and with its ``sr_item_sk = cs_item_sk``
  conjunct dropped (joins on three and two key columns, stddev_samp),
  q10 (a semi join, existence markers over distinct customers, an 8-key
  group-by and sort) and q18 (ROLLUP: an Expand of five grouping sets
  concatenated by K7c) over the same tables, checked and timed alike;
- TPC-DS q6 (an eager scalar subquery, a left outer join on the string
  key i_category), q28 (six global aggregates with count(DISTINCT),
  cross-joined: K10x) and q36 (rank() over a rollup's parents: K14r, a
  CASE WHEN string view in K6, a sort by expressions) over the same
  tables, checked and timed alike;
- phase 9b: TPC-DS q51 (running sums and maxima: K14s; the full outer
  join: K10f; CASE over an int and a date) and q51w (q51's store half
  with a 7-day moving average, lag, lead and ntile: K14b, K14o) over the
  same tables, checked and timed alike;
- phase 9f: q51 again over the same tables under a 128 MiB device pool
  (``spark.rapids.tpu.memory.pool.size``; the memory runtime shut down
  and shaped anew, then back to the default pool): every window takes
  the chunked running path over the external sort, K14c carrying each
  chunk, the catalog spills to the host; at 4 partitions the FINAL
  group-bys re-partition on the host; held against phase 9b's rows and
  numpy, with the out-of-core counters, K14c's main-path calls held
  against its plain version, best and median of 3 at one partition;
  every other query checks that those counters read 0;
- phase 9c: TPC-DS q8 (an INTERSECT: a null-safe semi join, K10n; the
  zips' substrings written by K13 as the INTERSECT's columns and both
  join keys; a 128-zip IN in K5) over the same tables, checked and timed
  alike;
- phase 9d: TPC-DS q5 (UNION ALLs, ``'store' || s_store_id`` and the
  channel names written by K13, a rollup) at sf 10 (``OWN_SF``: its web
  join grows with sf squared), checked against numpy at sf 10 and the
  CPU run at sf 1, timed alike;
- phase 9e: TPC-DS q3, q7 and q19 from parquet files of the same tables
  (the columns they read, written under build/ with pyarrow's default
  row groups, deleted after; the scan cache on): string columns reach
  the card as dictionary codes, q7's five string filters run in K5's
  code-space mode and never decode, q3's and q19's string payloads
  decode through K16; each held against its in-memory run and numpy,
  with the host read and the upload timed apart and the encoding
  counters printed, then timed and profiled alike;
- phase 9g: TPC-DS q35 as written (no row: date_dim ends in 2001) and
  q35v (``d_year = 2001``: a 6-key group-by folding count(*), min, max
  and avg of three int columns, K9's min and max kinds) over the same
  tables, checked and timed alike;
- phase 9h: TPC-DS q3, q19 and q7 over the same tables with every money
  column they read as DECIMAL(7,2) cents (``tpcds.decimal_money``):
  decimal64 sums in K9, K8's decimal sort words, q7's decimal averages
  through the avg finish, each held against numpy in int64 cents and the
  CPU run, with Spark's result types, timed alike;
- phase 10: q3, q1, q7, q12, q16, q17 without its item conjunct, q18,
  q51, q8, q35v, q3d and q7d over the same tables cut into ``--parts``
  partitions (the
  JAX package's register_tables rule): every group-by, join, sort and
  window behind a hash or range exchange (K11h, K11r, K7s), PARTIAL/FINAL
  group-bys through K9's merge kinds, each query's rows held against its
  one-partition run and numpy, timed and profiled alike.

The CPU run of each query of phases 4 to 9 is held against a card run
over tables at a tenth of the scale (sf 100; q5's at sf 1), and phase
3's against a card run over the first tenth of its rows, to keep the
script inside its time.  Each phase prints its seconds.

Every check that fails ends the run with a non-zero exit.  The last two
lines of standard output are a JSON object describing each kernel on
each path and the JSON result line.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import decimal
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
#: the CUDA sources of the kernels (kernel 2, K7, K8, K9, K10, K14 and
#: its ranking pass K14r, K15d, K7c, K10x, K11h, K11r and K7s, K13 and
#: K16)
CUDA_SOURCES = ("global_reduce.cu", "gather.cu", "sort.cu", "keyed_agg.cu",
                "hash_join.cu", "window.cu", "distinct.cu", "concat.cu",
                "cross_join.cu", "partition.cu", "strings.cu", "decode.cu",
                "window_carry.cu", "decimal.cu", "collect.cu")
#: the TPC-DS kernels: name, route, source, the JAX program each replaces
TPCDS_KERNELS = {
    "K1": ("fused_agg_update", "triton",
           "spark_rapids_tpu_torch/kernels/fused_agg.py",
           "spark_rapids_tpu/exec/fused.py:337"),
    "K3": ("global_reduce", "cuda",
           "spark_rapids_tpu_torch/csrc/global_reduce.cu",
           "spark_rapids_tpu/ops/agg_ops.py:223"),
    "K5": ("fused_stage", "triton",
           "spark_rapids_tpu_torch/kernels/fused_stage.py",
           "spark_rapids_tpu/exec/fused.py:202"),
    "K6": ("fused_project", "triton",
           "spark_rapids_tpu_torch/kernels/fused_stage.py",
           "spark_rapids_tpu/expressions/evaluator.py:160"),
    "K7": ("gather", "cuda", "spark_rapids_tpu_torch/csrc/gather.cu",
           "spark_rapids_tpu/ops/join_ops.py:335"),
    "K7c": ("concat", "cuda", "spark_rapids_tpu_torch/csrc/concat.cu",
            "spark_rapids_tpu/ops/batch_ops.py:274"),
    "K8": ("sort", "cuda", "spark_rapids_tpu_torch/csrc/sort.cu",
           "spark_rapids_tpu/ops/sort_ops.py:237"),
    "K9": ("keyed_agg", "cuda", "spark_rapids_tpu_torch/csrc/keyed_agg.cu",
           "spark_rapids_tpu/ops/agg_ops.py:390"),
    "K10": ("hash_join", "cuda", "spark_rapids_tpu_torch/csrc/hash_join.cu",
            "spark_rapids_tpu/ops/join_ops.py:125"),
    "K14": ("window", "cuda", "spark_rapids_tpu_torch/csrc/window.cu",
            "spark_rapids_tpu/ops/window_ops.py:79"),
    "K14r": ("window_rank", "cuda", "spark_rapids_tpu_torch/csrc/window.cu",
             "spark_rapids_tpu/ops/window_ops.py:177"),
    "K10x": ("cross_pairs", "cuda",
             "spark_rapids_tpu_torch/csrc/cross_join.cu",
             "spark_rapids_tpu/ops/join_ops.py:251"),
    "K15d": ("count_distinct", "cuda",
             "spark_rapids_tpu_torch/csrc/distinct.cu",
             "spark_rapids_tpu/ops/agg_ops.py:550"),
    "K11h": ("hash_partition", "cuda",
             "spark_rapids_tpu_torch/csrc/partition.cu",
             "spark_rapids_tpu/plan/partitioning.py:77"),
    "K11r": ("range_partition", "cuda",
             "spark_rapids_tpu_torch/csrc/partition.cu",
             "spark_rapids_tpu/plan/partitioning.py:186"),
    "K7s": ("split", "cuda", "spark_rapids_tpu_torch/csrc/partition.cu",
            "spark_rapids_tpu/ops/batch_ops.py:71"),
    "K14s": ("window_running", "cuda",
             "spark_rapids_tpu_torch/csrc/window.cu",
             "spark_rapids_tpu/ops/window_ops.py:210"),
    "K14b": ("window_bounded", "cuda",
             "spark_rapids_tpu_torch/csrc/window.cu",
             "spark_rapids_tpu/ops/window_ops.py:305"),
    "K14o": ("window_offset", "cuda",
             "spark_rapids_tpu_torch/csrc/window.cu",
             "spark_rapids_tpu/ops/window_ops.py:197"),
    "K10f": ("full_outer_join", "cuda",
             "spark_rapids_tpu_torch/csrc/hash_join.cu",
             "spark_rapids_tpu/ops/join_ops.py:275"),
    "K10n": ("null_safe_join", "cuda",
             "spark_rapids_tpu_torch/csrc/hash_join.cu",
             "spark_rapids_tpu/ops/join_ops.py:191"),
    "K13": ("string_column", "cuda",
            "spark_rapids_tpu_torch/csrc/strings.cu",
            "spark_rapids_tpu/expressions/strings.py:179"),
    "K16": ("decode_dictionary", "cuda",
            "spark_rapids_tpu_torch/csrc/decode.cu",
            "spark_rapids_tpu/columnar/encoding.py:402"),
    "K16r": ("decode_rle", "cuda", "spark_rapids_tpu_torch/csrc/decode.cu",
             "spark_rapids_tpu/columnar/encoding.py:416"),
    "K5d": ("fused_stage_codes", "triton",
            "spark_rapids_tpu_torch/kernels/fused_stage.py",
            "spark_rapids_tpu/columnar/encoding.py:575"),
    "K14c": ("running_fixup", "cuda",
             "spark_rapids_tpu_torch/csrc/window_carry.cu",
             "spark_rapids_tpu/exec/window.py:637"),
    "K12avg": ("decimal_avg", "cuda",
               "spark_rapids_tpu_torch/csrc/decimal.cu",
               "spark_rapids_tpu/expressions/aggregates.py:182"),
    "K15": ("collect_list", "cuda", "spark_rapids_tpu_torch/csrc/collect.cu",
            "spark_rapids_tpu/ops/agg_ops.py:550"),
    "K15s": ("collect_set", "cuda", "spark_rapids_tpu_torch/csrc/collect.cu",
             "spark_rapids_tpu/ops/agg_ops.py:550"),
    "K13l": ("string_length", "cuda",
             "spark_rapids_tpu_torch/csrc/strings.cu",
             "spark_rapids_tpu/expressions/strings.py:49"),
}
#: each TPC-DS kernel's launch counter: module and attribute
COUNTERS = {"K1": ("exec.fused", "LAUNCHES"),
            "K3": ("ops.agg_ops", "LAUNCHES"),
            "K5": ("exec.fused", "STAGE_LAUNCHES"),
            "K6": ("exec.fused", "PROJECT_LAUNCHES"),
            "K7": ("ops.batch_ops", "LAUNCHES"),
            "K7c": ("ops.batch_ops", "CONCAT_LAUNCHES"),
            "K8": ("ops.sort_ops", "LAUNCHES"),
            "K9": ("ops.agg_ops", "KEYED_LAUNCHES"),
            "K10": ("ops.join_ops", "LAUNCHES"),
            "K14": ("ops.window_ops", "LAUNCHES"),
            "K14r": ("ops.window_ops", "RANK_LAUNCHES"),
            "K10x": ("ops.join_ops", "CROSS_LAUNCHES"),
            "K15d": ("ops.agg_ops", "DISTINCT_LAUNCHES"),
            "K11h": ("ops.partition_ops", "HASH_LAUNCHES"),
            "K11r": ("ops.partition_ops", "RANGE_LAUNCHES"),
            "K7s": ("ops.partition_ops", "SPLIT_LAUNCHES"),
            "K14s": ("ops.window_ops", "FRAME_LAUNCHES"),
            "K14b": ("ops.window_ops", "BOUNDED_LAUNCHES"),
            "K14o": ("ops.window_ops", "OFFSET_LAUNCHES"),
            "K10f": ("ops.join_ops", "FULL_LAUNCHES"),
            "K10n": ("ops.join_ops", "NULL_SAFE_LAUNCHES"),
            "K13": ("ops.string_ops", "LAUNCHES"),
            "K16": ("ops.decode_ops", "DICT_LAUNCHES"),
            "K16r": ("ops.decode_ops", "RLE_LAUNCHES"),
            "K5d": ("exec.fused", "CODE_SPACE_LAUNCHES"),
            "K14c": ("ops.window_ops", "FIXUP_LAUNCHES"),
            "K12avg": ("ops.decimal_ops", "AVG_LAUNCHES"),
            "K15": ("ops.agg_ops", "COLLECT_LAUNCHES"),
            "K15s": ("ops.agg_ops", "COLLECT_SET_LAUNCHES"),
            "K13l": ("ops.string_ops", "LENGTH_LAUNCHES")}
#: the decimal forms' launches, each a part of a kernel's count: K1, K5
#: and K6 running K12, K9 with a decimal sum slot, K3 with a decimal128
#: sum, K8 with a decimal key
DECIMAL_COUNTERS = {"K12": ("exec.fused", "DECIMAL_LAUNCHES"),
                    "K12s": ("exec.fused", "DECIMAL_STAGE_LAUNCHES"),
                    "K12p": ("exec.fused", "DECIMAL_PROJECT_LAUNCHES"),
                    "K9d": ("ops.agg_ops", "KEYED_DECIMAL_LAUNCHES"),
                    "K3d": ("ops.agg_ops", "DECIMAL_LAUNCHES"),
                    "K8d": ("ops.sort_ops", "DECIMAL_LAUNCHES")}
#: K9's launches with a min, max, first or last slot, a part of its count
MIN_MAX_COUNTER = ("ops.agg_ops", "KEYED_MIN_MAX_LAUNCHES")
#: the out-of-core paths' counters, which read 0 on every default-pool
#: query (module, attribute)
OOC_COUNTERS = (("exec.sort", "EXTERNAL_SORT_EVENTS"),
                ("exec.window", "RUNNING_WINDOW_EVENTS"),
                ("exec.window", "BOUNDED_WINDOW_EVENTS"),
                ("exec.aggregate", "REPARTITION_EVENTS"),
                ("ops.window_ops", "FIXUP_LAUNCHES"))
#: K14o's three wrappers, recorded apart: ntile and the lag/lead default
K14O_PARTS = {"K14on": "K14o", "K14of": "K14o"}
#: the kernels each query's main path launches
QUERY_KERNELS = {"q3": ("K5", "K7", "K8", "K9", "K10"),
                 "q1": ("K5", "K6", "K7", "K8", "K9", "K10"),
                 "q7": ("K5", "K6", "K7", "K8", "K9", "K10"),
                 "q15": ("K5", "K7", "K8", "K9", "K10"),
                 "q12": ("K5", "K6", "K7", "K8", "K9", "K10", "K14"),
                 "q20": ("K5", "K6", "K7", "K8", "K9", "K10", "K14"),
                 "q13": ("K1", "K3", "K5", "K7", "K10"),
                 "q19": ("K5", "K7", "K8", "K9", "K10"),
                 "q16": ("K1", "K3", "K5", "K7", "K9", "K10", "K15d"),
                 # as written q17 may keep no row: no group to finish or sort
                 "q17": ("K5", "K7", "K9", "K10"),
                 "q17v": ("K5", "K6", "K7", "K8", "K9", "K10"),
                 "q10": ("K5", "K6", "K7", "K8", "K9", "K10"),
                 "q18": ("K5", "K6", "K7", "K7c", "K8", "K9", "K10"),
                 "q6": ("K5", "K6", "K7", "K8", "K9", "K10"),
                 "q28": ("K1", "K3", "K5", "K7", "K10x", "K15d"),
                 "q36": ("K5", "K6", "K7", "K7c", "K8", "K9", "K10",
                         "K14r"),
                 "q51": ("K5", "K6", "K7", "K8", "K9", "K10", "K10f",
                         "K14s"),
                 "q51w": ("K5", "K7", "K8", "K9", "K10", "K14b", "K14o"),
                 "q8": ("K5", "K7", "K8", "K9", "K10", "K10n", "K13"),
                 "q5": ("K6", "K7", "K7c", "K7s", "K8", "K9", "K10",
                        "K11h", "K11r", "K13"),
                 # as written no date passes: no group to finish or sort
                 "q35": ("K5", "K7", "K10"),
                 "q35v": ("K5", "K6", "K7", "K8", "K9", "K10"),
                 # phase 9h: q3, q19 and q7 over DECIMAL(7,2) money
                 "q3d": ("K5", "K7", "K8", "K9", "K10"),
                 "q19d": ("K5", "K7", "K8", "K9", "K10"),
                 "q7d": ("K5", "K6", "K7", "K8", "K9", "K10", "K12avg")}
#: the JAX programs the decimal forms replace: K12 (``tpu_binary_eval``,
#: with ``compare`` and ``decimal_to_double``), the decimal sums of
#: ``_segment_reduce`` (K9) and ``_global_reduce`` (K1, K3), K8's decimal
#: words (``sortable_words``)
DECIMAL_REPLACES = {
    "K12": "spark_rapids_tpu/expressions/decimal_math.py:530",
    "K12 also": ["spark_rapids_tpu/expressions/decimal_math.py:653",
                 "spark_rapids_tpu/expressions/decimal_math.py:612"],
    "K9d": "spark_rapids_tpu/ops/agg_ops.py:62",
    "K3d": "spark_rapids_tpu/ops/agg_ops.py:166",
    "K8d": "spark_rapids_tpu/ops/sort_ops.py:101"}
#: phase 9h's queries, and the decimal forms each must launch
DECIMAL_QUERIES = {"q3d": ("K9d", "K8d"), "q19d": ("K9d", "K8d"),
                   "q7d": ("K9d",)}
#: phase 9e: the queries run from parquet, and the kernels each launches
#: (q7's filters on five dictionary columns run in code space, K5d, and
#: decode none; q3's and q19's string payloads decode through K16 ahead
#: of their joins; at sf 1000 the batches of a table's row groups also
#: meet in K7c)
PARQUET_QUERIES = ("q3", "q7", "q19")
PARQUET_KERNELS = {"q3": ("K5", "K7", "K8", "K9", "K10", "K16"),
                   "q7": ("K5", "K5d", "K6", "K7", "K8", "K9", "K10"),
                   "q19": ("K5", "K7", "K8", "K9", "K10", "K16")}
#: q7's filtered dictionary columns, which must never decode
Q7_CODE_SPACE_COLUMNS = ("cd_gender", "cd_marital_status",
                         "cd_education_status", "p_channel_email",
                         "p_channel_event")
#: phase 10: the queries run over tables at 4 partitions, and the kernels
#: each launches beside its one-partition ones (q16 sorts its one-row
#: global aggregate: no range exchange)
PARTS_QUERIES = ("q3", "q1", "q7", "q12", "q16", "q17v", "q18", "q51",
                 "q8", "q35v", "q3d", "q7d")
PARTS_KERNELS = {"q16": ("K7c", "K11h", "K7s")}
PARTS_DEFAULT_KERNELS = ("K7c", "K11h", "K11r", "K7s")
#: the histogram the exchange's one read brings to the host (exec/
#: exchange.py:658) beside the partition ids
HISTOGRAM_REPLACES = ["spark_rapids_tpu/exec/exchange.py:658"]
#: the JAX programs K9's merge kinds, with K7c and K6, replace
#: (fused.agg_merge_final, K3b, and the merge specs with the Chan merge)
MERGE_REPLACES = ["spark_rapids_tpu/exec/fused.py:468",
                  "spark_rapids_tpu/ops/agg_ops.py:466"]
#: the JAX programs K10's and K7's left outer mode replaces (on q1)
OUTER_REPLACES = ["spark_rapids_tpu/ops/join_ops.py:275",
                  "spark_rapids_tpu/ops/join_ops.py:313",
                  "spark_rapids_tpu/ops/join_ops.py:418"]
#: the JAX programs K10's semi and anti modes replace (on q16), and the
#: segmented aggregation K15d's scalar slots replace beside it
SEMI_ANTI_REPLACES = ["spark_rapids_tpu/ops/join_ops.py:275",
                      "spark_rapids_tpu/ops/join_ops.py:313"]
DISTINCT_REPLACES = ["spark_rapids_tpu/ops/agg_ops.py:646",
                     "spark_rapids_tpu/ops/agg_ops.py:340"]
#: the JAX function K10's several key columns replace (q17), and K9's m2
#: kind (q17's stddev_samp)
MULTIKEY_REPLACES = ["spark_rapids_tpu/ops/join_ops.py:96"]
#: the JAX function K10's string keys replace (q6: _hash_rows over the
#: string words whose widths the sides agree on), and the boundaries and
#: first positions K14r replaces beside the ranking kinds (q36)
STRING_KEY_REPLACES = ["spark_rapids_tpu/ops/join_ops.py:71"]
RANK_REPLACES = ["spark_rapids_tpu/ops/window_ops.py:122"]
#: the JAX programs K13 replaces beside Substring's device form (Concat's,
#: q5) and K10's null-safe mode beside the pair verification (the
#: null-safe keys of INTERSECT, ``session.py:495``)
CONCAT_REPLACES = ["spark_rapids_tpu/expressions/strings.py:115"]
NULL_SAFE_REPLACES = ["spark_rapids_tpu/ops/join_ops.py:234",
                      "spark_rapids_tpu/session.py:495"]
#: the JAX programs beside each frame kind: the min/max half of the agg
#: kind (K14s, K14b), ntile beside the offset kind (K14o), and the
#: unmatched positions and the maps' concatenation beside the build
#: side's matched flags (K10f)
FRAME_REPLACES = ["spark_rapids_tpu/ops/window_ops.py:279"]
NTILE_REPLACES = ["spark_rapids_tpu/ops/window_ops.py:187"]
FULL_REPLACES = ["spark_rapids_tpu/ops/join_ops.py:313",
                 "spark_rapids_tpu/ops/join_ops.py:418"]
M2_REPLACES = ["spark_rapids_tpu/ops/agg_ops.py:490"]
#: the JAX reductions K9's min and max kinds replace beside the keyed
#: program (``_segment_reduce``'s min/max and first/last), and those of
#: K1's update forms and K3's kinds (``_global_reduce``)
MIN_MAX_REPLACES = ["spark_rapids_tpu/ops/agg_ops.py:82",
                    "spark_rapids_tpu/ops/agg_ops.py:110"]
GLOBAL_MIN_MAX_REPLACES = ["spark_rapids_tpu/ops/agg_ops.py:180",
                           "spark_rapids_tpu/ops/agg_ops.py:199"]
#: the tables of TPC-DS q35 (and q35v), in its recipe's order
Q35_TABLES = ("customer", "customer_address", "customer_demographics",
              "store_sales", "web_sales", "catalog_sales", "date_dim")
#: phase 2m: rows of the min/max/first/last checks
SLICE13_ROWS = (1 << 20) + 3
#: data bytes of one table row (k int64, v double, w int32), as bench.py
ROW_BYTES = 8 + 8 + 4
F64_SUM_RTOL = 1e-10
#: K9's m2 against its plain version: the two sum in other orders (the
#: plain one with atomics), so their means differ by a few units in the
#: last place (bounded here by M2_MEAN_RTOL of the group's largest |x|)
#: and m2 by about n times that difference squared, and its squares'
#: sum by a few units in the last place; M2_RTOL of m2 covers the rest
M2_RTOL = 1e-9
M2_MEAN_RTOL = 1e-12
#: timed queries of each older TPC-DS query after its main path's run
#: (fewer each time a phase came in, to keep the run inside its time)
TPCDS_REPS = 3
#: the newest queries, timed NEW_REPS times (q5: 2 when one run takes
#: over 2 s)
NEW_QUERIES = ("q8", "q5")
NEW_REPS = 5
#: timed queries of each phase-10 query
PARTS_REPS = 3


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
    """Equal int64 index tensors (compared where they lie); returns the
    measured max |d|."""
    import torch
    check(got.shape == ref.shape,
          f"{what}: {tuple(got.shape)} vs {tuple(ref.shape)}")
    check(bool(torch.equal(got, ref)), what)
    return max_diff(got, ref)


def same_columns(got, ref, what: str) -> float:
    """Columns equal plane by plane (doubles bit for bit; a string's chars
    and an array's elements up to its last offset), compared where they
    lie; returns the measured max |d| over the data, offsets and validity
    planes."""
    import torch
    check(len(got) == len(ref), f"{what}: column count")
    err = 0.0
    for j, (g, r) in enumerate(zip(got, ref)):
        w = f"{what}, column {j}"
        check(g.row_count == r.row_count, f"{w}: {g.row_count} rows vs "
              f"{r.row_count}")
        gv, rv = g.validity, r.validity
        check(bool(torch.equal(gv, rv)), f"{w}: validity")
        err = max(err, max_diff(gv, rv))
        if g.offsets is not None:
            # a string's chars, or an array's elements (doubles by bits),
            # up to the last offset
            go, ro = g.offsets.long(), r.offsets.long()
            check(bool(torch.equal(go, ro)), f"{w}: offsets")
            end = int(ro[-1])
            gc, rc = g.data[:end], r.data[:end]
            bits = (gc.view(torch.int64), rc.view(torch.int64)) \
                if gc.dtype == torch.float64 else (gc, rc)
            check(bool(torch.equal(*bits)), f"{w}: chars or elements")
            err = max(err, max_diff(go, ro), max_diff(gc, rc))
        else:
            gd, rd = g.data, r.data
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
    from spark_rapids_tpu_torch.testing import minmax_cases as MC
    (rep, res), (rrep, rres) = got, ref
    err = same_indices(rep, rrep, f"{what}: groups")
    gid, _ = G.group_rows_plain(keys, tr)
    for j, ((gd, gv), (rd, rv)) in enumerate(zip(res, rres)):
        check(bool(torch.equal(gv.cpu(), rv.cpu())),
              f"{what}, aggregate {j}: validity")
        if kinds[j] in G.KEYED_KEEPS_TYPE:
            # min, max, first and last: exact, doubles by their bits; the
            # max |d| by value (doubles over the finite ones)
            check(gd.dtype == rd.dtype, f"{what}, aggregate {j}: type")
            same_indices(MC.words(gd), MC.words(rd),
                         f"{what}, aggregate {j}: values")
            err = max(err, max_diff(gd, rd))
            continue
        if kinds[j] == G.KEYED_M2:
            err = max(err, same_m2(inputs[j], gid, rep.shape[0], gd, rd,
                                   f"{what}, aggregate {j}"))
            continue
        if kinds[j] != G.KEYED_SUM_F64:
            err = max(err, same_indices(gd, rd,
                                        f"{what}, aggregate {j}: values"))
            continue
        v = inputs[j]
        x = v.data.to(torch.float64)   # an average's sum takes ints too
        absum = torch.zeros(rep.shape[0], dtype=torch.float64,
                            device=v.device).index_add_(
            0, gid, torch.where(v.validity & torch.isfinite(x), x.abs(),
                                0.0))
        nan = torch.isnan(rd)
        check(bool(torch.equal(torch.isnan(gd), nan)),
              f"{what}, aggregate {j}: NaN sums")
        inf = torch.isinf(rd) & rv
        check(bool(torch.equal(torch.where(inf, gd, 0.0),
                               torch.where(inf, rd, 0.0))),
              f"{what}, aggregate {j}: infinite sums")
        d = torch.where(nan | inf | ~rv, 0.0, (gd - rd).abs())
        check(bool((d <= F64_SUM_RTOL * absum).all()),
              f"{what}, aggregate {j}: double sums")
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def same_m2(v, gid, n_groups, got, ref, what: str) -> float:
    """K9's m2 of input ``v`` against the plain version's: within
    M2_RTOL of the plain m2, plus the group's count times (M2_MEAN_RTOL
    times its largest |x|) squared; NaN where the plain one is NaN (a
    group holding a NaN or an infinity)."""
    import torch
    x = v.data.to(torch.float64)
    ok = v.validity & torch.isfinite(x)
    n = torch.zeros(n_groups, dtype=torch.float64, device=x.device) \
        .index_add_(0, gid, ok.to(torch.float64))
    big = torch.zeros(n_groups, dtype=torch.float64, device=x.device) \
        .scatter_reduce_(0, gid, torch.where(ok, x.abs(), 0.0), "amax")
    bad = ~torch.isfinite(ref)
    check(bool(torch.equal(~torch.isfinite(got), bad)),
          f"{what}: m2 finite where the plain one is")
    d = torch.where(bad, 0.0, (got - ref).abs())
    tol = M2_RTOL * ref.abs() + n * (M2_MEAN_RTOL * big) ** 2
    check(bool((d <= torch.where(bad, 0.0, tol)).all()), f"{what}: m2")
    return float(d.max()) if d.numel() else 0.0


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


# -- slice 3: the new forms of K5 to K10 --------------------------------------

#: strings of phase 2c: prefixes of one another, 0, 7, 8, 14, 15 and 40
#: bytes (string sort words hold 7 bytes), bytes >= 0x80, the literals
STEMS = ["", "a", "ab", "ab\0", "abc", "abcdefg", "abcdefgh",
         "abcdefghijklmn", "abcdefghijklmno", "x" * 40, "x" * 39 + "y",
         "é", "日本", "ÿ", "N", "TN", "TNX", "College", "AAAAAAAA00000006"]


def string_column(rng, n: int, stems, null_frac: float):
    """A host string column of ``n`` values drawn from ``stems``, built
    in numpy (a null row has length 0)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import HostColumn
    raw = [x.encode("utf-8") for x in stems]
    pool_lens = np.array([len(b) for b in raw], np.int64)
    pool_starts = np.concatenate([[0], np.cumsum(pool_lens)[:-1]])
    pool = np.frombuffer(b"".join(raw), np.uint8)
    pick = rng.integers(0, len(raw), n)
    valid = rng.random(n) >= null_frac
    lens = np.where(valid, pool_lens[pick], 0)
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    at = np.repeat(pool_starts[pick] - offsets[:-1], lens) + \
        np.arange(int(offsets[-1]))
    return HostColumn(pool[at].copy(), None if valid.all() else valid,
                      T.STRING, offsets)


def slice3_batch(session, rng, n: int):
    """A device batch of doubles with NaN, -0.0, 0.0 and nulls (a, b), a
    nullable int (i), a long with zeros (k) and two nullable strings (s
    from STEMS, t from "N", "TN" and "")."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import HostColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import HostColumn
    pool = np.array([np.nan, -0.0, 0.0, 1.5, -2.25, np.inf, 3.0])
    cols = [HostColumn(pool[rng.integers(0, len(pool), n)],
                       rng.random(n) > 0.1, T.DOUBLE) for _ in range(2)]
    cols.append(HostColumn(rng.integers(-2, 3, n).astype(np.int32),
                           rng.random(n) > 0.1, T.INT))
    cols.append(HostColumn(rng.integers(-2, 3, n).astype(np.int64), None,
                           T.LONG))
    cols.append(string_column(rng, n, STEMS, 0.1))
    cols.append(string_column(rng, n, ["N", "TN", ""], 0.2))
    hb = HostColumnarBatch(cols, n, ["a", "b", "i", "k", "s", "t"])
    return session.transfers.upload_batch(hb)


SLICE3_SIZES = (0, 1, 1000, (1 << 20) + 3)


def check_slice3(session, rng):
    """Phase 2c: K6, K5's string = and Or, K8's string keys, K10's left
    outer mode and K7's -1 rows against their plain versions on the card,
    at 0, 1, 1000 and 2**20 + 3 rows.  Returns the max |d| of each."""
    import torch
    from spark_rapids_tpu_torch import DataFrame
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.exec import fused as FU
    from spark_rapids_tpu_torch.expressions import arithmetic as A
    from spark_rapids_tpu_torch.expressions import predicates as P
    from spark_rapids_tpu_torch.expressions.base import (Alias, Literal,
                                                         bind_references,
                                                         col, lit)
    from spark_rapids_tpu_torch.expressions.cast import Cast
    from spark_rapids_tpu_torch.expressions.conditional import If
    from spark_rapids_tpu_torch.ops import batch_ops as BO
    from spark_rapids_tpu_torch.ops import join_ops as J
    from spark_rapids_tpu_torch.ops import sort_ops as S
    from spark_rapids_tpu_torch.plan import base as L
    tr, dev = session.transfers, session.device
    err = {k: 0.0 for k in ("K5", "K6", "K7", "K8", "K10")}
    exprs = [A.Divide(col("a"), col("b")), A.Divide(col("i"), col("k")),
             If(P.GreaterThan(col("k"), Literal(0, T.LONG)),
                A.Divide(Cast(col("a"), T.DOUBLE), Cast(col("k"), T.DOUBLE)),
                Literal(None, T.DOUBLE)),
             P.Or(P.EqualTo(col("s"), lit("N")),
                  P.EqualTo(col("t"), lit("N"))),
             P.And(P.EqualTo(col("t"), lit("")),
                   P.GreaterThan(col("a"), lit(0.0))),
             P.EqualTo(col("s"), lit("日本")),
             P.EqualTo(col("t"), lit("TNXXXXXXXXXXXXXXX"))]
    string_orders = ([S.SortOrder(4, True, True)],
                     [S.SortOrder(4, False, False)],
                     [S.SortOrder(4, True, False), S.SortOrder(2, False,
                                                               True)],
                     [S.SortOrder(4, False, True), S.SortOrder(0)])
    for n in SLICE3_SIZES:
        batch = slice3_batch(session, rng, n)
        schema = batch.schema
        bound = [bind_references(Alias(e, f"c{j}"), schema)
                 for j, e in enumerate(exprs)]
        program = FU.StageProgram([("project", bound)], schema, 0)
        lits = FU.LiteralArgs([])
        got = FU.fused_project(program, batch, lits)
        torch.cuda.synchronize()
        err["K6"] = max(err["K6"], same_columns(
            got, FU.fused_project_plain(program, batch, lits),
            f"K6, {n} rows"))
        # K5's string = and Or, chained as q7's filters are
        df = DataFrame(L.Scan([[]], schema), session)
        stage = (df.filter(P.Or(P.EqualTo(col("s"), lit("TN")),
                                P.EqualTo(col("t"), lit("N"))))
                 .filter(P.EqualTo(col("t"), lit("N")))
                 .select(Alias(A.Divide(col("a"), col("k")), "q"), col("s"))
                 .executed_plan())
        check(isinstance(stage, FU.TorchFusedStageExec),
              f"K5 plan: {stage.tree_string()}")
        slits = FU.LiteralArgs.upload(stage.promoted, tr)
        idx, comp = FU.fused_stage_compact(stage.program, batch, slits, tr)
        torch.cuda.synchronize()
        ridx, rcomp = FU.fused_stage_compact_plain(stage.program, batch,
                                                   slits, tr)
        err["K5"] = max(err["K5"], same_indices(idx, ridx,
                                                f"K5, {n} rows: survivors"),
                        same_columns(comp, rcomp, f"K5, {n} rows"))
        for orders in string_orders:
            perm = S.sort_permutation(batch.columns, orders, tr)
            torch.cuda.synchronize()
            err["K8"] = max(err["K8"], same_indices(
                perm, S.sort_permutation_plain(batch.columns, orders, tr),
                f"K8, {n} rows, {orders}"))
        # K7 with -1 rows, from this batch and from an empty one
        for src in (batch, slice3_batch(session, rng, 0)):
            m = src.row_count
            gidx = torch.from_numpy(rng.integers(-1, max(m, 1), n + 3)
                                    if m else np.full(n + 3, -1)).to(dev)
            got = BO.gather_columns(src.columns, gidx, tr, nullable=True)
            torch.cuda.synchronize()
            err["K7"] = max(err["K7"], same_columns(
                got, BO.gather_columns_plain(src.columns, gidx, tr,
                                             nullable=True),
                f"K7 with -1 rows, {m} -> {n + 3} rows"))

    def key(m, lo, hi, null_frac):
        data = torch.from_numpy(rng.integers(lo, hi, m).astype(np.int64))
        valid = torch.from_numpy(rng.random(m) >= null_frac)
        return DeviceColumn(data.to(dev), valid.to(dev), T.LONG,
                            all_valid=null_frac == 0)
    for n in SLICE3_SIZES:
        for case, build in (("no match", key(300, 10_000, 10_300, 0.0)),
                            ("null probe keys", key(300, 0, 500, 0.1)),
                            ("duplicate build keys", key(3000, 0, 50, 0.0)),
                            ("empty build side", key(0, 0, 5, 0.0))):
            probe = key(n, 0, 500, 0.3 if case == "null probe keys" else 0)
            got = J.join_pairs(build, probe, tr, outer=True)
            torch.cuda.synchronize()
            ref = J.join_pairs_plain(build, probe, tr, outer=True)
            for g, r, side in zip(got, ref, ("probe", "build")):
                err["K10"] = max(err["K10"], same_indices(
                    g, r, f"K10 outer, {case}, {n} probe rows: {side}"))
    return err


# -- slice 4: K14, the new emitters of K5 and K6, K9's double keys ------------

#: NaNs of several payloads: quiet, with a payload, negative, signalling
NAN_BITS = np.array([0x7ff8000000000000, 0x7ff8000000000001,
                     0xfff8000000000000, 0x7ff0000000000001], np.uint64)
#: q15's zips and states in part, and strings with bytes >= 0x80
Z_STEMS = ["85669", "856691234", "GA", "CA", "", "é", "日本語", "ÿÿ", "8",
           "80348-12"]


def slice4_batch(session, rng, n: int):
    """A device batch of partition keys and values for phase 2d: g (int,
    values 0..5 and nulls), c (one constant int), u (a long unique per
    row), p (double: 0.0, -0.0, NaNs of four payloads, 1.5, nulls), d
    (date, nulls), s (strings from STEMS), z (strings from Z_STEMS), t
    (from "N", "TN", ""); values v (double: nulls, NaN, +-inf; the
    partition g = 1 holds +inf and -inf, g = 3 no present value) and w
    (longs near 2**62, whose sums wrap)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import HostColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import HostColumn
    g = rng.integers(0, 6, n).astype(np.int32)
    pool = np.concatenate([[0.0, -0.0, 1.5], NAN_BITS.view(np.float64)])
    p = pool[rng.integers(0, len(pool), n)]
    v = rng.standard_normal(n) * 1e3
    v[rng.random(n) < 0.02] = np.nan
    v_valid = rng.random(n) > 0.1
    ones = np.flatnonzero(g == 1)
    v[ones[:1]] = np.inf
    v[ones[1:2]] = -np.inf
    v_valid[ones[:2]] = True
    v_valid[g == 3] = False
    cols = [HostColumn(g, rng.random(n) > 0.1, T.INT),
            HostColumn(np.zeros(n, np.int32), None, T.INT),
            HostColumn(rng.permutation(n).astype(np.int64), None, T.LONG),
            HostColumn(p, rng.random(n) > 0.1, T.DOUBLE),
            HostColumn(rng.integers(10640, 10700, n).astype(np.int32),
                       rng.random(n) > 0.1, T.DATE),
            string_column(rng, n, STEMS, 0.1),
            string_column(rng, n, Z_STEMS, 0.1),
            string_column(rng, n, ["N", "TN", ""], 0.0),
            HostColumn(v, v_valid, T.DOUBLE),
            HostColumn(rng.integers(1 << 62, (1 << 63) - 1, n), None,
                       T.LONG)]
    hb = HostColumnarBatch(cols, n, ["g", "c", "u", "p", "d", "s", "z", "t",
                                     "v", "w"])
    return session.transfers.upload_batch(hb)


def same_window(got, ref, absum, what: str) -> float:
    """K14's outputs against the plain version's: validity, counts and
    long sums exact; a double sum or mean within 1e-10 of its partition's
    sum |v| (over the count, for a mean), NaN and infinities exact."""
    import torch
    err = 0.0
    for j, (g, r) in enumerate(zip(got, ref)):
        w = f"{what}, function {j}"
        check(bool(torch.equal(g.validity.cpu(), r.validity.cpu())),
              f"{w}: validity")
        gd, rd = g.data.cpu(), r.data.cpu()
        if not gd.dtype.is_floating_point:
            check(bool(torch.equal(gd, rd)), f"{w}: values")
            err = max(err, max_diff(gd, rd))
            continue
        ok = r.validity.cpu()
        finite = torch.isfinite(rd)
        check(bool(torch.equal(torch.isnan(gd) & ok, torch.isnan(rd) & ok)),
              f"{w}: NaN")
        inf = ok & torch.isinf(rd)
        check(bool(torch.equal(torch.where(inf, gd, 0.0),
                               torch.where(inf, rd, 0.0))),
              f"{w}: infinities")
        limit = F64_SUM_RTOL * absum[j].cpu()
        d = torch.where(ok & finite, (gd - rd).abs(), 0.0)
        worst = float(d.max()) if d.numel() else 0.0
        check(bool((d <= limit).all()), f"{w}: sums ({worst})")
        err = max(err, worst)
    return err


def check_window(session, rng):
    """Phase 2d, K14: no key, one partition, every row its own partition,
    null, string, double and date keys, two keys; sum, long sum (wrapping),
    counts and avg, at 0, 1, 1000 and 2**20 + 3 rows.  Returns the max
    |d|, and K14's ms on one partition of 2**20 + 3 rows with its bound."""
    import torch
    from spark_rapids_tpu_torch.ops import batch_ops as BO
    from spark_rapids_tpu_torch.ops import sort_ops as S
    from spark_rapids_tpu_torch.ops import window_ops as W
    tr, dev = session.transfers, session.device
    kinds = [W.WIN_SUM_F64, W.WIN_SUM_I64, W.WIN_COUNT, W.WIN_COUNT_ALL,
             W.WIN_MEAN]
    err, timed = 0.0, None
    for n in SLICE3_SIZES:
        b = slice4_batch(session, rng, n)
        col = dict(zip(b.names, b.columns))
        for names in ([], ["c"], ["u"], ["g"], ["s"], ["p"], ["d"],
                      ["z", "g"]):
            keys = [col[k] for k in names]
            what = f"K14, {n} rows, keys {names}"
            if keys and n:
                perm = S.sort_permutation(
                    keys, [S.SortOrder(i) for i in range(len(keys))], tr)
                moved = BO.gather_columns(keys + [col["v"], col["w"]], perm,
                                          tr, unique=True)
            else:
                moved = keys + [col["v"], col["w"]]
            k, (v, w) = moved[:len(keys)], moved[len(keys):]
            args = (k, [v, w, v, None, v], kinds, n, dev)
            got = W.window_reduce(*args)
            torch.cuda.synchronize()
            err = max(err, same_window_call(
                args, got, W.window_reduce_plain(*args), what))
            if names == ["c"] and n == SLICE3_SIZES[-1]:
                one = [v]
                ms = time_ms(lambda: W.window_reduce(
                    k, one, [W.WIN_SUM_F64], n, dev), 20)
                # the key and the value read, the output written, once
                nbytes = column_bytes(k[0]) + column_bytes(v) + 9 * n
                timed = (ms, nbytes / memory_rate(
                    torch.cuda.get_device_name(0)) * 1e3, nbytes)
    return err, timed


def check_slice4(session, rng):
    """Phase 2d: K14 (check_window); K6 and K5 with IN, substring views,
    <, <=, >= and dates; K9 with double keys and five mixed keys, against
    their plain versions at 0, 1, 1000 and 2**20 + 3 rows.  Returns the
    max |d| of each, and K14's one-partition time."""
    import datetime
    import torch
    from spark_rapids_tpu_torch import DataFrame
    from spark_rapids_tpu_torch.exec import fused as FU
    from spark_rapids_tpu_torch.expressions import predicates as P
    from spark_rapids_tpu_torch.expressions.base import (Alias, Literal,
                                                         bind_references,
                                                         col, lit)
    from spark_rapids_tpu_torch.expressions.strings import Substring
    from spark_rapids_tpu_torch.ops import agg_ops as G
    from spark_rapids_tpu_torch.plan import base as L
    tr = session.transfers
    err = {"K14": 0.0, "K5": 0.0, "K6": 0.0, "K9": 0.0}
    err["K14"], k14_timed = check_window(session, rng)
    nan = float("nan")
    d0, d1 = datetime.date(1999, 2, 22), datetime.date(1999, 3, 24)

    def sub(pos, length=None):
        return Substring(col("z"), pos, length)
    exprs = [P.In(col("s"), ["TN", "", "é", "日本", None]),
             P.In(col("z"), ["GA", "CA", "WA"]),
             P.In(col("v"), [1.5, nan]),
             P.In(col("p"), [0.0, nan, None]),
             P.In(col("g"), [1, 4]),
             P.In(col("d"), [d0, d1]),
             P.In(sub(1, 5), ["85669", "80348", "ÿÿ"]),
             P.EqualTo(sub(0, 2), lit("85")),
             P.EqualTo(sub(-3), lit("本語")),
             P.EqualTo(sub(-20, 2), lit("85")),
             P.EqualTo(sub(30, 2), lit("")),
             P.EqualTo(sub(2, 0), lit("")),
             P.EqualTo(sub(2, -4), lit("")),
             P.In(sub(2, 2), ["56", "A", "\xbf"]),
             P.LessThan(col("v"), col("p")),
             P.LessThanOrEqual(col("v"), Literal(nan)),
             P.GreaterThanOrEqual(col("p"), col("v")),
             P.LessThan(col("g"), lit(3)),
             P.GreaterThanOrEqual(col("d"), lit(d0)),
             P.LessThanOrEqual(col("d"), lit(d1))]
    for n in SLICE3_SIZES:
        batch = slice4_batch(session, rng, n)
        schema = batch.schema
        bound = [bind_references(Alias(e, f"c{j}"), schema)
                 for j, e in enumerate(exprs)]
        program = FU.StageProgram([("project", bound)], schema, 0)
        lits = FU.LiteralArgs([])
        got = FU.fused_project(program, batch, lits)
        torch.cuda.synchronize()
        err["K6"] = max(err["K6"], same_columns(
            got, FU.fused_project_plain(program, batch, lits),
            f"K6 (slice 4), {n} rows"))
        # q15's and q12's filters, chained
        df = DataFrame(L.Scan([[]], schema), session)
        stage = (df.filter(P.Or(P.Or(P.In(sub(1, 5), ["85669", "80348"]),
                                     P.In(col("z"), ["GA", "CA"])),
                                P.GreaterThan(col("v"), lit(500.0))))
                 .filter(P.And(P.GreaterThanOrEqual(col("d"), lit(d0)),
                               P.LessThanOrEqual(col("d"), lit(d1))))
                 .select(col("z"), col("v"), col("d"))
                 .executed_plan())
        check(isinstance(stage, FU.TorchFusedStageExec),
              f"K5 plan: {stage.tree_string()}")
        slits = FU.LiteralArgs.upload(stage.promoted, tr)
        idx, comp = FU.fused_stage_compact(stage.program, batch, slits, tr)
        torch.cuda.synchronize()
        ridx, rcomp = FU.fused_stage_compact_plain(stage.program, batch,
                                                   slits, tr)
        err["K5"] = max(err["K5"], same_indices(
            idx, ridx, f"K5 (slice 4), {n} rows: survivors"),
            same_columns(comp, rcomp, f"K5 (slice 4), {n} rows"))
        cols = dict(zip(batch.names, batch.columns))
        kinds = [G.KEYED_SUM_F64, G.KEYED_SUM_I64, G.KEYED_COUNT,
                 G.KEYED_COUNT_ALL]
        inputs = [cols["v"], cols["w"], cols["v"], None]
        for names in (["p"], ["s", "t", "z", "t", "p"]):
            keys = [cols[k] for k in names]
            got = G.keyed_aggregate(keys, inputs, kinds, tr)
            torch.cuda.synchronize()
            ref = G.keyed_aggregate_plain(keys, inputs, kinds, tr)
            err["K9"] = max(err["K9"], same_keyed(
                keys, inputs, kinds, got, ref, tr,
                f"K9 (slice 4), {n} rows, keys {names}"))
    return err, k14_timed


# -- slice 5: K10's semi and anti modes, K15d, <> and NOT, K1 over strings ---

def check_slice5(session, rng, rate: float):
    """Phase 2e: K10's semi and anti modes, K15d keyed and global, the <>,
    NOT and view-to-view emitters in K6 and K5, and kernel 1 over string
    columns, against their plain versions at 0, 1, 1000 and 2**20 + 3
    rows; then K15d keyed over 5M groups of 3 rows (q16's subquery shape)
    and global over one group of 2**20 + 3 rows, timed.  Returns the max
    |d| of each kernel and the K15d timings."""
    import datetime
    import torch
    from spark_rapids_tpu_torch import DataFrame
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.exec import fused as FU
    from spark_rapids_tpu_torch.expressions import predicates as P
    from spark_rapids_tpu_torch.expressions.base import (Alias,
                                                         bind_references,
                                                         col, lit)
    from spark_rapids_tpu_torch.expressions.strings import Substring
    from spark_rapids_tpu_torch.ops import agg_ops as G
    from spark_rapids_tpu_torch.ops import join_ops as J
    from spark_rapids_tpu_torch.plan import base as L
    tr, dev = session.transfers, session.device
    err = {k: 0.0 for k in ("K1", "K5", "K6", "K10", "K15d")}

    def key(m, lo, hi, null_frac):
        data = torch.from_numpy(rng.integers(lo, hi, m).astype(np.int64))
        valid = torch.from_numpy(rng.random(m) >= null_frac)
        return DeviceColumn(data.to(dev), valid.to(dev), T.LONG,
                            all_valid=null_frac == 0)
    exprs = [P.NotEqual(col("s"), col("z")),
             P.EqualTo(col("s"), col("t")),
             P.NotEqual(Substring(col("z"), 1, 5), Substring(col("s"), 1, 5)),
             P.EqualTo(Substring(col("z"), 2, 3), Substring(col("s"), -3, 3)),
             P.NotEqual(col("z"), lit("GA")),
             P.NotEqual(col("p"), col("v")),
             P.NotEqual(col("g"), col("u")),
             P.NotEqual(col("d"), lit(datetime.date(1999, 2, 28))),
             P.Not(P.LessThan(col("v"), col("p"))),
             P.Not(P.In(col("z"), ["GA", None])),
             P.Not(P.And(P.EqualTo(col("s"), col("t")),
                         P.GreaterThan(col("g"), lit(2))))]
    for n in SLICE3_SIZES:
        batch = slice4_batch(session, rng, n)
        schema = batch.schema
        bound = [bind_references(Alias(e, f"c{j}"), schema)
                 for j, e in enumerate(exprs)]
        program = FU.StageProgram([("project", bound)], schema, 0)
        lits = FU.LiteralArgs([])
        got = FU.fused_project(program, batch, lits)
        torch.cuda.synchronize()
        err["K6"] = max(err["K6"], same_columns(
            got, FU.fused_project_plain(program, batch, lits),
            f"K6 (slice 5), {n} rows"))
        df = DataFrame(L.Scan([[]], schema), session)
        # q19's filter, then a NOT
        stage = (df.filter(P.NotEqual(Substring(col("z"), 1, 5),
                                      Substring(col("s"), 1, 5)))
                 .filter(P.Not(P.EqualTo(col("t"), lit("N"))))
                 .select(col("z"), col("v"))
                 .executed_plan())
        check(isinstance(stage, FU.TorchFusedStageExec),
              f"K5 plan: {stage.tree_string()}")
        slits = FU.LiteralArgs.upload(stage.promoted, tr)
        idx, comp = FU.fused_stage_compact(stage.program, batch, slits, tr)
        torch.cuda.synchronize()
        ridx, rcomp = FU.fused_stage_compact_plain(stage.program, batch,
                                                   slits, tr)
        err["K5"] = max(err["K5"], same_indices(
            idx, ridx, f"K5 (slice 5), {n} rows: survivors"),
            same_columns(comp, rcomp, f"K5 (slice 5), {n} rows"))
        # kernel 1 over string columns: q13's filter shape, averages
        agg = (df.filter(P.And(
            P.Or(P.And(P.EqualTo(col("t"), lit("TN")),
                       P.GreaterThanOrEqual(col("v"), lit(-500.0))),
                 P.And(P.EqualTo(col("s"), lit("College")),
                       P.LessThanOrEqual(col("v"), lit(500.0)))),
            P.Or(P.In(col("z"), ["GA", "CA", "85669"]),
                 P.NotEqual(col("s"), col("z")))))
            .agg(F.avg("g").alias("a1"), F.avg("v").alias("a2"),
                 F.sum("v").alias("s1"), F.count("*").alias("c1"))
            .executed_plan())
        check(isinstance(agg, FU.TorchFusedAggExec) and
              agg.program.conditions, f"K1 plan: {agg.tree_string()}")
        klits = FU.LiteralArgs.upload(agg.promoted, tr)
        args = (agg.program, batch, klits)
        got = FU.fused_agg_update(*args)
        torch.cuda.synchronize()
        err["K1"] = max(err["K1"], same_kernel1(
            args, got, FU.fused_agg_update_plain(*args),
            f"K1 over strings, {n} rows"))
        # K15d, keyed over K9's groups of g and global, every value type
        cols = dict(zip(batch.names, batch.columns))
        rep, _res, gid = G.keyed_aggregate([cols["g"]], [], [], tr,
                                           row_groups=True)
        for name in ("g", "u", "p", "d", "s", "z"):
            c = cols[name]
            err["K15d"] = max(err["K15d"], same_indices(
                G.count_distinct(c), G.count_distinct_plain(c),
                f"K15d global, {n} rows, {name}"))
            if rep.shape[0]:
                err["K15d"] = max(err["K15d"], same_indices(
                    G.count_distinct(c, gid, rep.shape[0]),
                    G.count_distinct_plain(c, gid, rep.shape[0]),
                    f"K15d keyed, {n} rows, {name}"))
        # K10 semi and anti: no match, null keys, duplicates, no build row
        for case, build in (("no match", key(300, 10_000, 10_300, 0.0)),
                            ("null keys", key(300, 0, 500, 0.1)),
                            ("duplicate build keys", key(3000, 0, 50, 0.0)),
                            ("empty build side", key(0, 0, 5, 0.0))):
            probe = key(n, 0, 500, 0.3 if case == "null keys" else 0)
            for mode in ("semi", "anti"):
                got = J.join_pairs(build, probe, tr, mode=mode)
                torch.cuda.synchronize()
                ref = J.join_pairs_plain(build, probe, tr, mode=mode)
                check(got[1] is None and ref[1] is None,
                      f"K10 {mode}: no build rows")
                err["K10"] = max(err["K10"], same_indices(
                    got[0], ref[0], f"K10 {mode}, {case}, {n} rows"))
    # q16's subquery shape: 5M orders of 3 rows, warehouses 1..5; and one
    # group of 2**20 + 3 rows
    m = 15_000_000
    gid = torch.arange(m, device=dev) // 3
    wh = DeviceColumn(torch.from_numpy(rng.integers(1, 6, m)).to(dev),
                      torch.ones(m, dtype=torch.bool, device=dev), T.LONG,
                      True)
    groups = m // 3
    got = G.count_distinct(wh, gid, groups)
    torch.cuda.synchronize()
    err["K15d"] = max(err["K15d"], same_indices(
        got, G.count_distinct_plain(wh, gid, groups),
        f"K15d keyed, {m} rows, {groups} groups"))
    keyed_ms = time_ms(lambda: G.count_distinct(wh, gid, groups), 10)
    keyed_bytes = column_bytes(wh) + 8 * m + 8 * groups
    big = slice4_batch(session, rng, SLICE3_SIZES[-1]).columns[2]
    got = G.count_distinct(big)
    torch.cuda.synchronize()
    err["K15d"] = max(err["K15d"], same_indices(
        got, G.count_distinct_plain(big), "K15d global, one group of "
        f"{big.row_count} rows"))
    global_ms = time_ms(lambda: G.count_distinct(big), 10)
    timed = {"keyed": (keyed_ms, time_ms(lambda: G.count_distinct_plain(
        wh, gid, groups), 2, 1), keyed_bytes / rate * 1e3, None),
        "global": (global_ms, time_ms(lambda: G.count_distinct_plain(big),
                                      2, 1),
                   (column_bytes(big) + 8) / rate * 1e3,
                   time_ms(lambda: torch.unique(big.data).numel(), 10))}
    return err, timed


def check_slice6(session, rng, rate: float):
    """Phase 2f: K7c (strings, 0-row inputs, a front slice), K9's m2 kind
    (int and double inputs), K10 on two and three key columns in all four
    modes (nulls in one key column, duplicates, an empty build side), and
    the Subtract, Sqrt and null-literal emitters in K6 and K5, against
    their plain versions at 0, 1, 1000 and 2**20 + 3 rows; then K7c over
    five slices of 2**20 + 3 rows and K9's m2 over one group of 2**20 + 3
    rows near 1e9, timed.  Returns the max |d| of each kernel and the
    timings."""
    import torch
    from spark_rapids_tpu_torch import DataFrame
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.exec import fused as FU
    from spark_rapids_tpu_torch.expressions import predicates as P
    from spark_rapids_tpu_torch.expressions.arithmetic import (Divide,
                                                               Subtract)
    from spark_rapids_tpu_torch.expressions.base import (Alias, Literal,
                                                         bind_references,
                                                         col, lit)
    from spark_rapids_tpu_torch.expressions.cast import Cast
    from spark_rapids_tpu_torch.expressions.conditional import If
    from spark_rapids_tpu_torch.expressions.mathexprs import Sqrt
    from spark_rapids_tpu_torch.ops import agg_ops as G
    from spark_rapids_tpu_torch.ops import batch_ops as BO
    from spark_rapids_tpu_torch.ops import join_ops as J
    from spark_rapids_tpu_torch.plan import base as L
    tr, dev = session.transfers, session.device
    err = {k: 0.0 for k in ("K5", "K6", "K7c", "K9", "K10")}
    u_dbl = Cast(col("u"), T.DOUBLE)
    exprs = [Subtract(col("g"), col("u")), Subtract(col("v"), lit(1.5)),
             Subtract(col("w"), col("u")), Sqrt(col("v")), Sqrt(col("p")),
             Sqrt(Subtract(col("g"), lit(3))),
             # stddev_samp's finish over a count and an m2
             If(P.GreaterThan(u_dbl, lit(1.0)),
                Sqrt(Divide(col("v"), Subtract(u_dbl, lit(1.0)))),
                Literal(None, T.DOUBLE))]

    def keys(m, n_keys, null_col, hi):
        out = []
        for c in range(n_keys):
            dt = T.INT if c == 1 else T.LONG
            data = torch.from_numpy(rng.integers(0, hi, m).astype(
                dt.np_dtype)).to(dev)
            nulls = 0.2 if c == null_col else 0.0
            out.append(DeviceColumn(data, torch.from_numpy(
                rng.random(m) >= nulls).to(dev), dt, nulls == 0.0))
        return out
    for n in SLICE3_SIZES:
        batch = slice4_batch(session, rng, n)
        schema = batch.schema
        program = FU.StageProgram(
            [("project", [bind_references(Alias(e, f"c{j}"), schema)
                          for j, e in enumerate(exprs)])], schema, 0)
        lits = FU.LiteralArgs([])
        got = FU.fused_project(program, batch, lits)
        torch.cuda.synchronize()
        err["K6"] = max(err["K6"], same_columns(
            got, FU.fused_project_plain(program, batch, lits),
            f"K6 (slice 6), {n} rows"))
        df = DataFrame(L.Scan([[]], schema), session)
        stage = (df.filter(P.GreaterThan(Sqrt(Subtract(col("v"), col("p"))),
                                         lit(2.0)))
                 .select(col("s"), Alias(Subtract(col("u"), col("g")), "d"))
                 .executed_plan())
        check(isinstance(stage, FU.TorchFusedStageExec),
              f"K5 plan: {stage.tree_string()}")
        slits = FU.LiteralArgs.upload(stage.promoted, tr)
        idx, comp = FU.fused_stage_compact(stage.program, batch, slits, tr)
        torch.cuda.synchronize()
        ridx, rcomp = FU.fused_stage_compact_plain(stage.program, batch,
                                                   slits, tr)
        err["K5"] = max(err["K5"], same_indices(
            idx, ridx, f"K5 (slice 6), {n} rows: survivors"),
            same_columns(comp, rcomp, f"K5 (slice 6), {n} rows"))
        # K7c: this batch, a third of it, an empty one and a front slice
        # whose chars plane runs past its last offset
        parts = [batch, batch.front(n // 3), batch.front(0),
                 slice4_batch(session, rng, n).front(max(0, n - 1))]
        got = BO.concat_batches(parts)
        torch.cuda.synchronize()
        ref = BO.concat_batches_plain(parts)
        check(got.row_count == ref.row_count, f"K7c, {n} rows: row count")
        err["K7c"] = max(err["K7c"], same_columns(
            got.columns, ref.columns, f"K7c, {n} rows"))
        # K9's m2 (double and int inputs) beside a count, over g and z
        cols = dict(zip(batch.names, batch.columns))
        for key_cols in ([cols["g"]], [cols["g"], cols["z"]]):
            args = (key_cols, [cols["v"], cols["g"], cols["v"]],
                    [G.KEYED_M2, G.KEYED_M2, G.KEYED_COUNT], tr)
            got = G.keyed_aggregate(*args)
            torch.cuda.synchronize()
            err["K9"] = max(err["K9"], same_keyed(
                *args[:3], got, G.keyed_aggregate_plain(*args), tr,
                f"K9 m2, {n} rows, {len(key_cols)} keys"))
        # K10 on two and three key columns, all four modes
        for n_keys in (2, 3):
            probe = keys(n, n_keys, 0, 6)
            for case, build in (("duplicates", keys(3000, n_keys, 1, 6)),
                                ("no match", keys(50, n_keys, -1, 6)),
                                ("empty build side", keys(0, n_keys, 1, 6))):
                if case == "no match":
                    for c in build:
                        c.data.add_(100)
                for kw in ({}, {"outer": True}, {"mode": "semi"},
                           {"mode": "anti"}):
                    got = J.join_pairs(build, probe, tr, **kw)
                    torch.cuda.synchronize()
                    ref = J.join_pairs_plain(build, probe, tr, **kw)
                    what = f"K10 {n_keys} keys {kw}, {case}, {n} rows"
                    check((got[1] is None) == (ref[1] is None),
                          f"{what}: build rows")
                    err["K10"] = max(err["K10"], *[
                        same_indices(g, r, f"{what}: {side} rows")
                        for g, r, side in zip(got, ref, ("probe", "build"))
                        if r is not None])
    # K7c over five slices of 2**20 + 3 rows (an Expand's five grouping
    # sets): every column, then the fixed-width ones alone, whose planes
    # torch.cat joins as the library yardstick
    big = slice4_batch(session, rng, SLICE3_SIZES[-1])
    fixed = big.select([j for j, c in enumerate(big.columns)
                        if not c.is_string],
                       [nm for nm, c in zip(big.names, big.columns)
                        if not c.is_string])
    timed = {}
    for what, b in (("all columns", big), ("fixed-width columns", fixed)):
        parts = [b] * 5
        got = BO.concat_batches(parts)
        torch.cuda.synchronize()
        err["K7c"] = max(err["K7c"], same_columns(
            got.columns, BO.concat_batches_plain(parts).columns,
            f"K7c, five slices of {b.row_count} rows, {what}"))
        nbytes = 2 * sum(column_bytes(c) for c in b.columns) * 5
        planes = [p for c in b.columns for p in (c.data, c.validity)]
        library = None if what == "all columns" else time_ms(
            lambda: [torch.cat([p] * 5) for p in planes], 10)
        timed[what] = (time_ms(lambda: BO.concat_batches(parts), 10),
                       time_ms(lambda: BO.concat_batches_plain(parts), 2, 1),
                       nbytes / rate * 1e3, library)
    # K9's m2 over one group of 2**20 + 3 rows near 1e9
    m = SLICE3_SIZES[-1]
    key = DeviceColumn(torch.zeros(m, dtype=torch.int64, device=dev),
                       torch.ones(m, dtype=torch.bool, device=dev), T.LONG,
                       True)
    near = DeviceColumn(torch.from_numpy(1e9 + rng.standard_normal(m)).to(
        dev), torch.ones(m, dtype=torch.bool, device=dev), T.DOUBLE, True)
    args = ([key], [near], [G.KEYED_M2], tr)
    got = G.keyed_aggregate(*args)
    torch.cuda.synchronize()
    err["K9"] = max(err["K9"], same_keyed(
        *args[:3], got, G.keyed_aggregate_plain(*args), tr,
        f"K9 m2, one group of {m} rows near 1e9"))
    x = near.data
    exact = float(((x - x.mean()) ** 2).sum())
    check(abs(float(got[1][0][0][0]) - exact) <= 1e-6 * exact,
          f"K9 m2 near 1e9 within 1e-6 of the two-pass m2: "
          f"{float(got[1][0][0][0])} vs {exact}")
    timed["m2"] = (time_ms(lambda: G.keyed_aggregate(*args), 5),
                   time_ms(lambda: G.keyed_aggregate_plain(*args), 2, 1),
                   (16 * m + 17) / rate * 1e3, None)
    return err, timed


def string_keys(rng, n: int, base, null_frac: float):
    """A host string column of ``n`` keys, each a prefix (0 to 40 bytes)
    of one of the byte rows of ``base``: prefixes of one another, the
    empty string among them, and nulls."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import HostColumn
    fam = rng.integers(0, base.shape[0], n)
    valid = rng.random(n) >= null_frac
    lens = np.where(valid, rng.integers(0, base.shape[1] + 1, n), 0)
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    row = np.repeat(fam, lens)
    pos = np.arange(int(offsets[-1])) - np.repeat(offsets[:-1], lens)
    return HostColumn(base[row, pos].astype(np.uint8), None if valid.all()
                      else valid, T.STRING, offsets)


def check_slice7(session, rng, rate: float):
    """Phase 2g: K14's ranking pass (partition and order keys of every
    kind, ascending and descending, nulls first and last), the div, % and
    CASE WHEN emitters in K6 (a string CASE as a view's validity) and K5,
    at 0, 1, 1000 and 2**20 + 3 rows; K10x over 3,001 x 1,024 rows and an
    empty side; K10 on string keys, alone and beside an int key, in all
    four modes, 1M probe rows against 64k and 16 build rows (prefixes of
    one another, 0 to 40 bytes, nulls); and K14r over one partition of
    2**20 + 3 rows of peers of 7, each against its plain version.  K14r,
    K10x and the string-key joins are timed.  Returns the max |d| of each
    kernel and the timings."""
    import torch
    from spark_rapids_tpu_torch import DataFrame
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import HostColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn, \
        HostColumn
    from spark_rapids_tpu_torch.exec import fused as FU
    from spark_rapids_tpu_torch.expressions import predicates as P
    from spark_rapids_tpu_torch.expressions.arithmetic import (
        IntegralDivide, Remainder, Subtract)
    from spark_rapids_tpu_torch.expressions.base import (Alias, Literal,
                                                         bind_references,
                                                         col, lit)
    from spark_rapids_tpu_torch.expressions.conditional import CaseWhen
    from spark_rapids_tpu_torch.ops import batch_ops as BO
    from spark_rapids_tpu_torch.ops import join_ops as J
    from spark_rapids_tpu_torch.ops import sort_ops as S
    from spark_rapids_tpu_torch.ops import window_ops as W
    from spark_rapids_tpu_torch.plan import base as L
    tr, dev = session.transfers, session.device
    err = {k: 0.0 for k in ("K5", "K6", "K10", "K10x", "K14r")}
    exprs = [IntegralDivide(col("u"), col("g")),
             Remainder(col("g"), Subtract(col("g"), lit(2))),
             IntegralDivide(col("w"), lit(-1)),
             Remainder(col("w"), col("u")),
             IntegralDivide(Literal(-(2 ** 63), T.LONG), lit(-1)),
             CaseWhen([(P.GreaterThan(col("v"), lit(0.0)), col("g")),
                       (P.EqualTo(col("t"), lit("TN")), col("u"))],
                      lit(-1)),
             CaseWhen([(P.GreaterThan(col("p"), lit(0.0)), col("s"))]),
             CaseWhen([(P.EqualTo(Remainder(col("g"), lit(2)), lit(0)),
                        Literal(None, T.STRING))], col("z"))]
    orderings = ((["g"], ["p"], [(True, True)]),
                 (["s", "g"], ["u"], [(False, False)]),
                 ([], ["z", "v"], [(True, False), (False, True)]),
                 (["d"], ["s"], [(False, True)]))
    for n in SLICE3_SIZES:
        batch = slice4_batch(session, rng, n)
        schema = batch.schema
        program = FU.StageProgram(
            [("project", [bind_references(Alias(e, f"c{j}"), schema)
                          for j, e in enumerate(exprs)])], schema, 0)
        lits = FU.LiteralArgs([])
        got = FU.fused_project(program, batch, lits)
        torch.cuda.synchronize()
        err["K6"] = max(err["K6"], same_columns(
            got, FU.fused_project_plain(program, batch, lits),
            f"K6 (slice 7), {n} rows"))
        df = DataFrame(L.Scan([[]], schema), session)
        stage = (df.filter(P.GreaterThan(CaseWhen(
            [(P.GreaterThan(col("v"), lit(0.0)),
              IntegralDivide(col("u"), lit(3)))],
            Remainder(col("w"), lit(7))), lit(0)))
            .select(col("s"), Alias(Remainder(col("u"), lit(5)), "r"))
            .executed_plan())
        check(isinstance(stage, FU.TorchFusedStageExec),
              f"K5 plan: {stage.tree_string()}")
        slits = FU.LiteralArgs.upload(stage.promoted, tr)
        idx, comp = FU.fused_stage_compact(stage.program, batch, slits, tr)
        torch.cuda.synchronize()
        ridx, rcomp = FU.fused_stage_compact_plain(stage.program, batch,
                                                   slits, tr)
        err["K5"] = max(err["K5"], same_indices(
            idx, ridx, f"K5 (slice 7), {n} rows: survivors"),
            same_columns(comp, rcomp, f"K5 (slice 7), {n} rows"))
        cols = dict(zip(batch.names, batch.columns))
        for keys, order, dirs in orderings:
            every = [cols[k] for k in keys + order]
            perm = S.sort_permutation(
                every, [S.SortOrder(i) for i in range(len(keys))] +
                [S.SortOrder(len(keys) + j, *d) for j, d in enumerate(dirs)],
                tr) if n else torch.empty(0, dtype=torch.int64, device=dev)
            moved = BO.gather_columns(every, perm, tr, unique=True)
            args = (moved[:len(keys)], moved[len(keys):], list(W.RANKING), n,
                    dev)
            got = W.window_rank(*args)
            torch.cuda.synchronize()
            err["K14r"] = max(err["K14r"], same_output(
                "K14r", args, {}, got, W.window_rank_plain(*args), tr,
                f"K14r, {n} rows, {keys} by {order}"))
    # K14r over one partition of 2**20 + 3 rows, peers of 7 rows
    m = SLICE3_SIZES[-1]
    ones = torch.ones(m, dtype=torch.bool, device=dev)
    one = DeviceColumn(torch.zeros(m, dtype=torch.int64, device=dev), ones,
                       T.LONG, True)
    peers = DeviceColumn(torch.arange(m, device=dev) // 7, ones, T.LONG,
                         True)
    rank_args = ([one], [peers], list(W.RANKING), m, dev)
    got = W.window_rank(*rank_args)
    torch.cuda.synchronize()
    err["K14r"] = max(err["K14r"], same_output(
        "K14r", rank_args, {}, got, W.window_rank_plain(*rank_args), tr,
        f"K14r, one partition of {m} rows"))
    timed = {"rank": (time_ms(lambda: W.window_rank(*rank_args), 20),
                      time_ms(lambda: W.window_rank_plain(*rank_args), 2,
                              1), (16 * m + 12 * m) / rate * 1e3, None)}
    # K10x: 3,001 x 1,024 pairs, and an empty side
    for sizes in ((3001, 1024), (0, 1024), (3001, 0), (1, 1)):
        got = J.cross_pairs(*sizes, dev)
        torch.cuda.synchronize()
        err["K10x"] = max(err["K10x"], *[
            same_indices(g, r, f"K10x {sizes}: {side} rows")
            for g, r, side in zip(got, J.cross_pairs_plain(*sizes, dev),
                                  ("probe", "build"))])
    timed["cross"] = (
        time_ms(lambda: J.cross_pairs(3001, 1024, dev), 20),
        time_ms(lambda: J.cross_pairs_plain(3001, 1024, dev), 2, 1),
        16 * 3001 * 1024 / rate * 1e3,
        time_ms(lambda: torch.cartesian_prod(
            torch.arange(3001, device=dev), torch.arange(1024, device=dev)),
            20))
    # K10 on string keys: 1M probe rows, 64k and 16 build rows
    base = rng.integers(97, 100, (4096, 40))

    def side(rows):
        hb = HostColumnarBatch(
            [string_keys(rng, rows, base, 0.05),
             HostColumn(rng.integers(0, 3, rows).astype(np.int32), None,
                        T.INT)], rows, ["k", "a"])
        return tr.upload_batch(hb).columns

    def distinct_side(rows):
        """``rows`` build rows of distinct strings from the same
        families (no key repeats, so no probe row meets duplicates)."""
        c = string_keys(rng, 4 * rows, base, 0.0)
        off = c.offsets.tolist()
        raw = c.data.tobytes()
        keys = sorted({raw[off[i]:off[i + 1]] for i in range(4 * rows)})
        keys = [keys[i].decode() for i in rng.permutation(len(keys))[:rows]]
        hb = HostColumnarBatch(
            [HostColumn.from_strings(keys),
             HostColumn(rng.integers(0, 3, len(keys)).astype(np.int32), None,
                        T.INT)], len(keys), ["k", "a"])
        return tr.upload_batch(hb).columns
    probe = side(1_000_000)
    for rows, build in (("65536", side(65_536)),
                        ("65536 distinct", distinct_side(65_536)),
                        ("16", side(16))):
        for keys in ((build[0], probe[0]), (build, probe)):
            for kw in ({}, {"outer": True}, {"mode": "semi"},
                       {"mode": "anti"}):
                args = (*keys, tr)
                got = J.join_pairs(*args, **kw)
                torch.cuda.synchronize()
                err["K10"] = max(err["K10"], same_output(
                    "K10", args, kw, got, J.join_pairs_plain(*args, **kw),
                    tr, f"K10 string keys {rows} x 1000000, "
                    f"{len(J.key_list(keys[0]))} keys, {kw}"))
        # a key repeated m times on the build side costs each probe row
        # that meets it m**2 moves in the write pass (its matches are put
        # in build-row order by insertion): the first build side repeats
        # its short keys, the second holds each key once
        pairs = J.join_pairs(build[0], probe[0], tr)[0].shape[0]
        print(f"K10 string keys, {build[0].row_count} build rows ({rows}) "
              f"x 1000000 probe rows: {pairs} pairs")
        timed[f"string {rows}"] = (
            time_ms(lambda: J.join_pairs(build[0], probe[0], tr), 10),
            time_ms(lambda: J.join_pairs_plain(build[0], probe[0], tr), 2,
                    1),
            (column_bytes(build[0]) + column_bytes(probe[0]) + 16 * pairs)
            / rate * 1e3, None)
    return err, timed


#: rows of phase 2h's hash and range checks
SLICE8_ROWS = 1_000_000


def slice8_keys(session, rng, n: int):
    """Phase 2h's key columns of every type K11h hashes, ``n`` rows: int,
    date, long, double (NaN, -0.0, infinities), bool, float32 (raw planes)
    and strings (empty to 40 bytes, bytes of 0x80 and above), each with
    nulls."""
    import torch
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.ops.partition_ops import HashColumn
    dev = session.device

    def valid():
        return torch.from_numpy(rng.random(n) > 0.1).to(dev)
    d = rng.choice(np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5,
                             -2.25]), n)
    d[::3] = rng.standard_normal(len(d[::3]))
    base = rng.integers(0, 256, (64, 40)).astype(np.uint8)
    s = session.transfers.upload_column(string_keys(rng, n, base, 0.1))
    return [
        DeviceColumn(torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n)
                                      .astype(np.int32)).to(dev), valid(),
                     T.INT),
        DeviceColumn(torch.from_numpy(rng.integers(-30000, 30000, n)
                                      .astype(np.int32)).to(dev), valid(),
                     T.DATE),
        DeviceColumn(torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62, n))
                     .to(dev), valid(), T.LONG),
        DeviceColumn(torch.from_numpy(d).to(dev), valid(), T.DOUBLE),
        DeviceColumn(torch.from_numpy(rng.random(n) < 0.5).to(dev), valid(),
                     T.BOOLEAN),
        HashColumn(torch.from_numpy(d.astype(np.float32)).to(dev), valid(),
                   None),
        s]


def check_slice8(session, rng, rate: float):
    """Phase 2h: K11h (1M rows, one to three keys of each type, n = 1, 2,
    3, 7, 200, 1024), K11r (the same rows against 3 and 199 bounds,
    ascending and descending, nulls first and last), K7s (a mixed batch at
    n = 4 and 200, at 0, 1, 1000 and 2**20 + 3 rows) and K9's merge kinds
    (four partials of 1M groups; one group of 2**20 + 3 partial rows)
    against their plain versions: ids, histograms and offsets equal, the
    merged doubles within M2_RTOL.  Then each timed at one shape.  Returns
    the max |d| of each and the timings."""
    import torch
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.ops import agg_ops as G
    from spark_rapids_tpu_torch.ops import batch_ops as BO
    from spark_rapids_tpu_torch.ops import partition_ops as PO
    from spark_rapids_tpu_torch.ops.sort_ops import (SortOrder,
                                                     order_words_plain,
                                                     sort_permutation)
    tr, dev = session.transfers, session.device
    err = {k: 0.0 for k in ("K11h", "K11r", "K7s", "K9")}
    timed = {}
    n = SLICE8_ROWS
    keys = slice8_keys(session, rng, n)
    strings = [keys[-1]]
    combos = [[j] for j in range(len(keys))] + [[0, 6], [3, 2, 6],
                                                [4, 1, 5]]
    for combo in combos:
        ks = [keys[j] for j in combo]
        for parts in (1, 2, 3, 7, 200, 1024):
            for wide in (False, True):
                as_long = [wide] * len(ks)
                got = PO.hash_partition(ks, parts, strings, as_long)
                torch.cuda.synchronize()
                ref = PO.hash_partition_plain(ks, parts, strings, as_long)
                what = f"K11h, keys {combo}, n = {parts}"
                err["K11h"] = max(err["K11h"],
                                  same_indices(got[0], ref[0], what),
                                  same_indices(got[1], ref[1],
                                               f"{what}: histogram"))
    # K11r: bounds picked from a sorted sample of the same rows
    for combo in ([2], [3], [6], [0, 3], [6, 2]):
        ks = [keys[j] for j in combo]
        for asc, nf in ((True, True), (True, False), (False, True),
                        (False, False)):
            orders = [(asc, nf)] * len(ks)
            for nb in (3, 199):
                pick = torch.from_numpy(rng.choice(n, 8 * nb)).to(dev)
                sample = BO.gather_columns(ks, pick, tr)
                perm = sort_permutation(
                    sample, [SortOrder(j, asc, nf) for j in range(len(ks))],
                    tr)
                at = perm[torch.arange(1, nb + 1, device=dev) * 8 - 1]
                bounds = BO.gather_columns(sample, at, tr, unique=True)
                got = PO.range_partition(ks, bounds, orders, nb + 1,
                                         strings)
                torch.cuda.synchronize()
                ref = PO.range_partition_plain(ks, bounds, orders, nb + 1,
                                               strings)
                what = f"K11r, keys {combo}, {nb} bounds, asc {asc}, " \
                    f"nulls first {nf}"
                err["K11r"] = max(err["K11r"],
                                  same_indices(got[0], ref[0], what),
                                  same_indices(got[1], ref[1],
                                               f"{what}: histogram"))
    # K7s on a mixed batch, at 4 and 200 partitions
    for rows in SLICE3_SIZES:
        b = mixed_batch(session, rng, rows)
        bs = [c for c in b.columns if c.is_string]
        for parts in (4, 200):
            pids, counts = PO.hash_partition([b.columns[1]], parts, bs)
            host = tr.read_counts(counts)
            chars = [host[(1 + j) * parts:(2 + j) * parts]
                     for j in range(len(bs))]
            got = PO.split_columns(b.columns, pids, host[:parts], chars, tr)
            torch.cuda.synchronize()
            ref = PO.split_columns_plain(b.columns, pids, host[:parts],
                                         chars, tr)
            for p, (g, r) in enumerate(zip(got, ref)):
                err["K7s"] = max(err["K7s"], same_columns(
                    g, r, f"K7s, {rows} rows, {parts} partitions, "
                          f"partition {p}"))
    # K9's merge kinds: four partials of 1M groups, one group of 2**20 + 3
    for rows, groups in ((4 * SLICE8_ROWS, SLICE8_ROWS),
                         (SLICE3_SIZES[-1], 1)):
        g = torch.from_numpy(rng.permutation(np.arange(rows) % groups)).to(
            dev)
        cnt = torch.from_numpy(rng.integers(0, 40, rows).astype(
            np.float64)).to(dev)
        ones = torch.ones(rows, dtype=torch.bool, device=dev)
        mean = DeviceColumn(torch.from_numpy(rng.normal(1e3, 5.0, rows)).to(
            dev), cnt > 0, T.DOUBLE)
        n_col = DeviceColumn(cnt, ones, T.DOUBLE, True)
        m2 = DeviceColumn(torch.from_numpy(rng.random(rows) * 50.0).to(dev),
                          ones, T.DOUBLE, True)
        total = DeviceColumn(torch.from_numpy(rng.normal(0, 1e6, rows)).to(
            dev), torch.from_numpy(rng.random(rows) > 0.1).to(dev),
            T.DOUBLE)
        counts_ = DeviceColumn(cnt.long(), ones, T.LONG, True)
        args = ([DeviceColumn(g, ones, T.LONG, True)],
                [total, counts_, n_col, mean, m2],
                [G.KEYED_SUM_F64, G.KEYED_SUM_I64, G.KEYED_SUM_F64,
                 G.KEYED_CHAN_MEAN, G.KEYED_CHAN_M2], tr)
        kw = {"aux": [None, None, None, (n_col, mean), (n_col, mean)]}
        got = G.keyed_aggregate(*args, **kw)
        torch.cuda.synchronize()
        ref = G.keyed_aggregate_plain(*args, **kw)
        what = f"K9 merge kinds, {rows} partial rows in {groups} groups"
        err["K9"] = max(err["K9"], same_indices(got[0], ref[0], what))
        for j, ((gv, gok), (rv, rok)) in enumerate(zip(got[1], ref[1])):
            check(bool(torch.equal(gok, rok)), f"{what}: validity {j}")
            if gv.dtype == torch.int64:
                err["K9"] = max(err["K9"], same_indices(gv, rv, what))
                continue
            scale = rv.abs().max().item() if rv.numel() else 0.0
            d = max_diff(gv, rv)
            check(d <= M2_RTOL * max(scale, 1.0),
                  f"{what}: kind {args[2][j]} max |d| {d} vs scale {scale}")
            err["K9"] = max(err["K9"], d)
        if groups > 1:
            timed["merge"] = (
                time_ms(lambda: G.keyed_aggregate(*args, **kw), 5),
                time_ms(lambda: G.keyed_aggregate_plain(*args, **kw), 2, 1),
                (8 * rows + 41 * rows + groups * (8 + 5 * 9)) / rate * 1e3,
                None)
    # timings: K11h on one long key, K11r on one long key (one word: the
    # library is torch.searchsorted), K7s on a fixed-width batch (the
    # library is a stable argsort and index_select of every plane)
    long_key = DeviceColumn(keys[2].data, torch.ones(n, dtype=torch.bool,
                                                     device=dev), T.LONG,
                            True)
    timed["K11h"] = (time_ms(lambda: PO.hash_partition([long_key], 200), 20),
                     time_ms(lambda: PO.hash_partition_plain([long_key], 200),
                             3, 1),
                     (8 * n + 4 * n + 8 * 200) / rate * 1e3, None)
    pick = torch.from_numpy(rng.choice(n, 199, replace=False)).to(dev)
    bnd = BO.gather_columns([long_key], pick, tr)
    bnd = BO.gather_columns(bnd, sort_permutation(bnd, [SortOrder(0)], tr),
                            tr, unique=True)
    o = [(True, True)]
    row_word = order_words_plain(long_key, SortOrder(0))[-1]
    bound_word = order_words_plain(bnd[0], SortOrder(0))[-1]
    timed["K11r"] = (
        time_ms(lambda: PO.range_partition([long_key], bnd, o, 200), 20),
        time_ms(lambda: PO.range_partition_plain([long_key], bnd, o, 200),
                3, 1),
        (8 * n + 8 * 199 + 4 * n + 8 * 200) / rate * 1e3,
        time_ms(lambda: torch.searchsorted(bound_word, row_word), 20))
    fixed = [c for c in mixed_batch(session, rng, n).columns
             if not c.is_string]
    pids, counts = PO.hash_partition([fixed[1]], 4)
    host = tr.read_counts(counts)
    planes = [p for c in fixed for p in (c.data, c.validity)]

    def library():
        perm = torch.argsort(pids, stable=True)
        return [torch.index_select(p, 0, perm) for p in planes]
    timed["K7s"] = (
        time_ms(lambda: PO.split_columns(fixed, pids, host, [], tr), 20),
        time_ms(lambda: PO.split_columns_plain(fixed, pids, host, [], tr),
                3, 1),
        (4 * n + 2 * sum(column_bytes(c) for c in fixed)) / rate * 1e3,
        time_ms(library, 20))
    return err, timed


def frame_inputs(session, rng, n: int, big: int):
    """Phase 2i's sorted batch: a partition key (runs of 1 to 9 rows, one
    of ``big`` rows in the middle), an order key with ties, and values:
    doubles with NaN, +-inf, -0.0 and nulls, longs, ints and dates with
    nulls."""
    import torch
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    dev = session.device
    sizes = []
    while sum(sizes) < n - big:
        sizes.append(int(rng.integers(1, 10)))
    sizes.insert(len(sizes) // 2, big)
    g = np.repeat(np.arange(len(sizes)), sizes)[:n]
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    valid = torch.from_numpy(rng.random(n) > 0.15).to(dev)
    d = rng.standard_normal(n) * 100
    u = rng.random(n)
    d = np.where(u < 0.01, np.nan, d)
    d = np.where((u > 0.01) & (u < 0.015), np.inf, d)
    d = np.where((u > 0.015) & (u < 0.02), -np.inf, d)
    d = np.where((u > 0.02) & (u < 0.03), -0.0, d)
    ints = rng.integers(-1000, 1000, n)
    key = DeviceColumn(torch.from_numpy(g).to(dev), ones, T.LONG, True)
    order = DeviceColumn(torch.from_numpy(np.concatenate(
        [np.sort(rng.integers(0, 4, k)) for k in sizes])[:n].astype(
            np.int64)).to(dev), ones, T.LONG, True)
    values = {
        "double": DeviceColumn(torch.from_numpy(d).to(dev), valid,
                               T.DOUBLE),
        "long": DeviceColumn(torch.from_numpy(ints * 3_000_000_000).to(dev),
                             valid, T.LONG),
        "int": DeviceColumn(torch.from_numpy(ints.astype(np.int32)).to(dev),
                            valid, T.INT),
        "date": DeviceColumn(torch.from_numpy((ints + 11000).astype(
            np.int32)).to(dev), valid, T.DATE)}
    return key, order, values


def check_slice9(session, rng, rate: float):
    """Phase 2i: K14s and K14b (every kind over every frame form: running
    to the row, to i + k, to the last peer, the whole partition, from the
    row or i + k to the end, bounded ROWS frames) and K14o (lag/lead
    source rows, ntile, the default of each fixed-width type) on sorted
    batches of 0, 1, 1000 and 2**20 + 3 rows, whose middle partition
    spans more than three tiles (and at the largest size most rows), and
    K10f (int, string and two keys with nulls on both sides; empty sides;
    1M probe rows against 64k build rows, a third of the keys matching)
    against their plain versions.  Then each timed at one shape: K14s over
    one partition of 2**20 + 3 rows, a running sum (library: torch.cumsum)
    and a running max (torch.cummax); K14b a 7-row moving average and K14o
    lag over the same rows; K10f 1M x 64k.  Returns the max |d| of each
    and the timings."""
    import torch
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import batch_from_pydict
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.ops import batch_ops as BO
    from spark_rapids_tpu_torch.ops import join_ops as J
    from spark_rapids_tpu_torch.ops import window_ops as W
    tr, dev = session.transfers, session.device
    err = {k: 0.0 for k in ("K14s", "K14b", "K14o", "K10f")}
    timed = {}
    unbounded = [("rows", None, 0), ("rows", None, 2), ("rows", None, -2),
                 ("range", None, 0), ("rows", None, None), ("rows", 0, None),
                 ("rows", 3, None), ("rows", -1, None)]
    bounded = [("rows", -1, 1), ("rows", -2, 0), ("rows", 0, 2),
               ("rows", -3, -1), ("rows", 1, 3), ("rows", -40, 5)]
    kinds = [(W.WIN_SUM_F64, "double"), (W.WIN_SUM_I64, "long"),
             (W.WIN_COUNT, "double"), (W.WIN_COUNT_ALL, None),
             (W.WIN_MEAN, "double")] + \
        [(k, t) for k in (W.WIN_MIN, W.WIN_MAX)
         for t in ("double", "long", "int", "date")]
    for n in SLICE3_SIZES:
        big = min(n, 3 * 1024 + 517) if n < (1 << 20) else n - 4000
        key, order, values = frame_inputs(session, rng, n, big)
        for fk, lo, hi in unbounded + bounded:
            funcs, inputs = [], []
            for kind, t in kinds:
                f = W.FrameAgg(kind, fk, lo, hi)
                if kind in (W.WIN_MIN, W.WIN_MAX) and not (
                        f.bounded or (lo is None and hi in (None, 0)) or
                        (lo == 0 and hi is None)):
                    continue   # refused, as the JAX program refuses it
                funcs.append(f)
                inputs.append(None if t is None else values[t])
            name = "K14b" if funcs[0].bounded else "K14s"
            args = ([key], funcs, inputs, n, dev) if name == "K14b" else \
                ([key], [order], funcs, inputs, n, dev)
            fn = W.window_bounded if name == "K14b" else W.window_running
            plain = W.window_bounded_plain if name == "K14b" else \
                W.window_running_plain
            got = fn(*args)
            torch.cuda.synchronize()
            err[name] = max(err[name], same_frame_call(
                name, args, got, plain(*args),
                f"{name}, {n} rows, frame {fk} {lo} {hi}"))
        offsets = [-1, -2, 1, 3, 0, -big, big - 1]
        for g, r in zip(W.window_offset([key], offsets, n, dev),
                        W.window_offset_plain([key], offsets, n, dev)):
            err["K14o"] = max(err["K14o"], same_indices(
                g, r, f"K14o, {n} rows: source rows"))
        for g, r in zip(W.window_ntile([key], [1, 3, 7, big + 5], n, dev),
                        W.window_ntile_plain([key], [1, 3, 7, big + 5], n,
                                             dev)):
            err["K14o"] = max(err["K14o"], same_indices(
                g.data, r.data, f"K14o, {n} rows: ntile"))
        m, = W.window_offset([key], [-2], n, dev)
        for t, default in (("double", -99.5), ("long", -(2 ** 40)),
                           ("int", -7), ("date", 11111)):
            col, = BO.gather_columns([values[t]], m, tr, nullable=True)
            err["K14o"] = max(err["K14o"], same_columns(
                [W.window_fill(col, m, default)],
                [W.window_fill_plain(col, m, default)],
                f"K14o, {n} rows: a {t} default"))

    # K10f: int, string and two keys with nulls on both sides
    def side(rows, card):
        d = {"k": [None if rng.random() < 0.1 else int(x)
                   for x in rng.integers(0, card, rows)],
             "s": [None if rng.random() < 0.1 else f"k{x}"
                   for x in rng.integers(0, card, rows)],
             "a": [int(x) for x in rng.integers(0, 3, rows)]}
        return tr.upload_batch(batch_from_pydict(d, T.StructType([
            T.StructField("k", T.LONG), T.StructField("s", T.STRING),
            T.StructField("a", T.INT)])))
    probe, build = side(100_000, 40_000), side(30_000, 60_000)
    for b, p in ((build, probe), (side(0, 5), probe), (build, side(0, 5)),
                 (side(1, 5), side(1, 5))):
        for keys in ((b.columns[0], p.columns[0]),
                     (b.columns[1], p.columns[1]),
                     ([b.columns[0], b.columns[2]],
                      [p.columns[0], p.columns[2]])):
            got = J.join_pairs(*keys, tr, mode="full")
            torch.cuda.synchronize()
            err["K10f"] = max(err["K10f"], same_output(
                "K10f", keys, {"mode": "full"}, got,
                J.join_pairs_plain(*keys, tr, mode="full"), tr,
                f"K10f, {b.row_count} x {p.row_count}"))
    # timings
    n = SLICE3_SIZES[-1]
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    one = DeviceColumn(torch.zeros(n, dtype=torch.int64, device=dev), ones,
                       T.LONG, True)
    x = DeviceColumn(torch.from_numpy(rng.normal(size=n)).to(dev), ones,
                     T.DOUBLE, True)
    for what, kind, library in (
            ("running sum", W.WIN_SUM_F64,
             lambda: torch.cumsum(x.data, 0)),
            ("running max", W.WIN_MAX,
             lambda: torch.cummax(x.data, 0))):
        f = [W.FrameAgg(kind, "rows", None, 0)]
        got = W.window_running([one], [], f, [x], n, dev)
        torch.cuda.synchronize()
        err["K14s"] = max(err["K14s"], same_frame_call(
            "K14s", ([one], [], f, [x], n, dev), got,
            W.window_running_plain([one], [], f, [x], n, dev),
            f"K14s, {what} over one partition of {n} rows"))
        timed[f"K14s {what}"] = (
            time_ms(lambda: W.window_running([one], [], f, [x], n, dev), 10),
            time_ms(lambda: W.window_running_plain([one], [], f, [x], n,
                                                   dev), 2, 1),
            (8 * n + 8 * n + 9 * n) / rate * 1e3, time_ms(library, 10))
    f = [W.FrameAgg(W.WIN_MEAN, "rows", -6, 0)]
    timed["K14b moving average"] = (
        time_ms(lambda: W.window_bounded([one], f, [x], n, dev), 10),
        time_ms(lambda: W.window_bounded_plain([one], f, [x], n, dev), 2, 1),
        (8 * n + 8 * n + 9 * n) / rate * 1e3, None)
    timed["K14o lag"] = (
        time_ms(lambda: W.window_offset([one], [-1], n, dev), 10),
        time_ms(lambda: W.window_offset_plain([one], [-1], n, dev), 2, 1),
        (8 * n + 8 * n) / rate * 1e3, None)
    # K10f: 1M probe rows against 64k build rows, a third of them matching
    pk = torch.from_numpy(rng.integers(0, 3 * 65536, SLICE8_ROWS)).to(dev)
    bk = torch.from_numpy(rng.permutation(65536) * 3).to(dev)
    pcol = DeviceColumn(pk, torch.ones(SLICE8_ROWS, dtype=torch.bool,
                                       device=dev), T.LONG, True)
    bcol = DeviceColumn(bk, torch.ones(65536, dtype=torch.bool, device=dev),
                        T.LONG, True)
    got = J.join_pairs(bcol, pcol, tr, mode="full")
    err["K10f"] = max(err["K10f"], same_output(
        "K10f", (bcol, pcol), {"mode": "full"}, got,
        J.join_pairs_plain(bcol, pcol, tr, mode="full"), tr,
        "K10f, 65536 x 1000000"))
    timed["K10f"] = (
        time_ms(lambda: J.join_pairs(bcol, pcol, tr, mode="full"), 10),
        time_ms(lambda: J.join_pairs_plain(bcol, pcol, tr, mode="full"), 2,
                1),
        (8 * 65536 + 8 * SLICE8_ROWS + 16 * got[0].shape[0] + 65536) /
        rate * 1e3, None)
    print(f"K10f 65536 x {SLICE8_ROWS}: {got[2]} pairs, "
          f"{got[0].shape[0] - got[2]} unmatched build rows")
    return err, timed


#: strings of phase 2j: 0, 1, 7, 8, 15 and 40 bytes, and bytes >= 0x80
K13_STEMS = ["", "a", "abcdefg", "abcdefgh", "abcdefghijklmno", "x" * 40,
             "ÿé", "日本語x"]
#: phase 2j's substrings: positive, zero, negative and past-the-end pos,
#: with and without a length
K13_SUBSTRINGS = ((1, 5), (2, 3), (0, 2), (-1, None), (-3, 2), (-50, 4),
                  (41, None), (3, None), (1, 0))


def check_slice10(session, rng, rate: float):
    """Phase 2j: K13 (substring at every pos class, with and without a
    length; a concat of a literal, a column and a literal; two columns;
    a literal alone; with nulls in either column; every call also through
    a row map) over 1M and 2**20 + 3 rows of 0- to 40-byte strings with
    10% nulls, and K10's null-safe mode (an int and a string key, 10%
    null keys on both sides: semi and anti with 64k build rows against
    1M probes, inner, outer and full with 6,554 against 100k) against
    their plain versions.  Then each timed: K13's substring
    and concat over 2**20 + 3 rows, K10n's semi join over 1M probes.
    Returns the max |d| of each and the timings (no single PyTorch call
    computes either: library None)."""
    import torch
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import HostColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.ops import join_ops as J
    from spark_rapids_tpu_torch.ops import string_ops as SO
    tr, dev = session.transfers, session.device
    err = {"K13": 0.0, "K10n": 0.0}
    timed = {}
    for n in (1_000_000, SLICE3_SIZES[-1]):
        cols = [string_column(rng, n, K13_STEMS, 0.1) for _ in range(2)]
        a, b = tr.upload_batch(HostColumnarBatch(cols, n, ["a", "b"])
                               ).columns
        rows = torch.from_numpy(rng.integers(0, n, n // 3)).to(dev)
        calls = [((SO.SUBSTRING, [a]), {"pos": p, "length": ln})
                 for p, ln in K13_SUBSTRINGS]
        calls += [((SO.CONCAT, [b"store", a, b"#"]), {}),
                  ((SO.CONCAT, [a, b]), {}),
                  ((SO.CONCAT, [b"web channel"]), {})]
        for (op, parts), kw in calls:
            for r in (None, rows):
                m = n if r is None else r.shape[0]
                got = SO.string_column(op, parts, m, dev, tr, rows=r, **kw)
                torch.cuda.synchronize()
                err["K13"] = max(err["K13"], same_columns(
                    [got], [SO.string_column_plain(op, parts, m, dev, tr,
                                                   rows=r, **kw)],
                    f"K13 op {op} {kw}, {m} rows"))
    n = SLICE3_SIZES[-1]
    for what, (op, parts), kw in (
            ("substring", (SO.SUBSTRING, [a]), {"pos": 1, "length": 5}),
            ("concat", (SO.CONCAT, [b"store", a, b"#"]), {})):
        got = SO.string_column(op, parts, n, dev, tr, **kw)
        timed[f"K13 {what}"] = (
            time_ms(lambda: SO.string_column(op, parts, n, dev, tr, **kw),
                    10),
            time_ms(lambda: SO.string_column_plain(op, parts, n, dev, tr,
                                                   **kw), 2, 1),
            k13_bytes((op, parts, n), kw, got) / rate * 1e3, None)
        print(f"K13 {what}, {n} rows: {int(got.offsets[-1])} chars written")

    # K10n: 64k build rows, 1M probes, 10% null keys on both sides
    def keys(rows_, card_):
        k = rng.integers(0, card_, rows_)
        valid = torch.from_numpy(rng.random(rows_) >= 0.1).to(dev)
        kcol = DeviceColumn(torch.from_numpy(k).to(dev), valid, T.LONG)
        scol = string_column(rng, rows_, [f"k{x}" for x in range(2000)],
                             0.1)
        return kcol, tr.upload_column(scol)
    build, probe = keys(65536, 3 * 65536), keys(SLICE8_ROWS, 3 * 65536)
    # semi and anti (INTERSECT's and EXCEPT's modes) at that shape; the
    # modes that pair every null probe key with every null build key
    # (6,554 x 100,000 null pairs there) at a tenth of each side
    small = keys(6554, 3 * 6554), keys(SLICE8_ROWS // 10, 3 * 6554)
    for j in (0, 1):
        for kw, (b, p) in (({"mode": "semi"}, (build, probe)),
                           ({"mode": "anti"}, (build, probe)),
                           ({}, small), ({"outer": True}, small),
                           ({"mode": "full"}, small)):
            got = J.join_pairs(b[j], p[j], tr, null_safe=True, **kw)
            torch.cuda.synchronize()
            err["K10n"] = max(err["K10n"], same_output(
                "K10f" if kw.get("mode") == "full" else "K10n",
                (b[j], p[j]), kw, got,
                J.join_pairs_plain(b[j], p[j], tr, null_safe=True, **kw),
                tr, f"K10n {kw} key {j}, {b[j].row_count} x "
                f"{p[j].row_count}"))
    got = J.join_pairs(build[0], probe[0], tr, null_safe=True, mode="semi")
    timed["K10n semi"] = (
        time_ms(lambda: J.join_pairs(build[0], probe[0], tr, null_safe=True,
                                     mode="semi"), 10),
        time_ms(lambda: J.join_pairs_plain(build[0], probe[0], tr,
                                           null_safe=True, mode="semi"),
                2, 1),
        (9 * 65536 + 9 * SLICE8_ROWS + 8 * got[0].shape[0]) / rate * 1e3,
        None)
    print(f"K10n semi 65536 x {SLICE8_ROWS}: {got[0].shape[0]} kept rows")
    return err, timed


#: phase 2k: the dictionary sizes (codes cross as int8, int8, int16 and
#: int32) and the byte lengths of K16's string values
K16_DICT_SIZES = (1, 7, 300, 65536)
K16_STRING_LENGTHS = (0, 1, 7, 8, 15, 40)


def k16_values(session, rng, dt, size: int, nulls: bool):
    """A dictionary of ``size`` values of type ``dt`` on the card (strings
    of 0 to 40 bytes, every byte at or above 0x80 in a third of them;
    with ``nulls``, 10% null values)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import HostColumn
    valid = None if not nulls else rng.random(size) >= 0.1
    if isinstance(dt, T.StringType):
        lens = np.array(K16_STRING_LENGTHS)[np.arange(size) %
                                            len(K16_STRING_LENGTHS)]
        offsets = np.zeros(size + 1, dtype=np.int32)
        np.cumsum(lens, out=offsets[1:])
        chars = rng.integers(0, 256, int(offsets[-1])).astype(np.uint8)
        high = np.repeat(np.arange(size) % 3 == 0, lens)
        chars[high] |= 0x80
        return session.transfers.upload_column(
            HostColumn(chars, valid, T.STRING, offsets))
    if isinstance(dt, T.BooleanType):
        data = rng.random(size) < 0.5
    elif isinstance(dt, T.DoubleType):
        data = rng.normal(0, 1e6, size)
    else:
        data = rng.integers(-2 ** 31, 2 ** 31, size).astype(dt.np_dtype) \
            if isinstance(dt, T.LongType) else \
            rng.integers(-10 ** 6, 10 ** 6, size).astype(dt.np_dtype)
    return session.transfers.upload_column(HostColumn(data, valid, dt))


def check_slice11(session, rng, rate: float):
    """Phase 2k: K16 against its plain version over 1M and 2**20 + 3
    rows: codes sent as int8, int16 and int32 (dictionaries of 1, 7, 300
    and 65,536 values), every fixed type and strings of 0 to 40 bytes
    with bytes >= 0x80, 10% null rows and a column of null rows alone,
    null values; RLE runs of 1 to 1,000 rows of every fixed type, 10% of
    them null, the last run ending the column or rows past it; then
    K5's code-space mode (``=``, ``IN``, ``<>``, ``IS NULL``) against the
    same stage over the decoded column (K5 on strings) and its plain
    version.  Timed over 2**20 + 3 rows: K16 on strings (a dictionary of
    300), on longs (65,536; ``torch.index_select`` as the library), K16's
    RLE form (runs of 1 to 1,000 longs; ``torch.repeat_interleave``), and
    the ``=`` stage in code space against the stage over the decoded
    strings."""
    import pyarrow as pa
    import torch
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import encoding as ENC
    from spark_rapids_tpu_torch.columnar.batch import (ColumnarBatch,
                                                       HostColumnarBatch)
    from spark_rapids_tpu_torch.columnar.column import HostColumn
    from spark_rapids_tpu_torch.exec import fused as FU
    from spark_rapids_tpu_torch.expressions.base import (bind_references,
                                                         col, lit)
    from spark_rapids_tpu_torch.expressions import predicates as P
    from spark_rapids_tpu_torch.ops import decode_ops as D
    tr, dev = session.transfers, session.device
    err = {"K16": 0.0, "K16r": 0.0, "K5d": 0.0}
    timed = {}
    types = (T.STRING, T.BOOLEAN, T.INT, T.DATE, T.LONG, T.DOUBLE)
    for n in (1_000_000, SLICE3_SIZES[-1]):
        for size in K16_DICT_SIZES:
            narrow = ENC._narrow_code_dtype(size)
            codes = tr.to_device(rng.integers(0, size, n).astype(narrow)
                                 ).to(torch.int32)
            masks = {"no nulls": None,
                     "10% null": torch.from_numpy(
                         rng.random(n) >= 0.1).to(dev),
                     "all null": torch.zeros(n, dtype=torch.bool,
                                             device=dev)}
            for dt in types:
                for nulls in (False, True):
                    values = k16_values(session, rng, dt, size, nulls)
                    for what, valid in masks.items():
                        got = D.decode_dictionary(codes, valid, values, tr)
                        torch.cuda.synchronize()
                        err["K16"] = max(err["K16"], same_columns(
                            [got], [D.decode_dictionary_plain(
                                codes, valid, values, tr)],
                            f"K16 {dt} ({narrow} codes, {size} values"
                            f"{', null values' if nulls else ''}), {what}, "
                            f"{n} rows"))
        for dt in types[1:]:
            lens = rng.integers(1, 1001, n // 250 + 2)
            ends = np.cumsum(lens)
            ends = ends[:np.searchsorted(ends, n) + 1]
            ends[-1] = n
            for past in (0, 777):   # rows past the last run are null
                m = n + past
                vals = k16_values(session, rng, dt, len(ends), False).data
                rvalid = torch.from_numpy(rng.random(len(ends)) >= 0.1).to(
                    dev)
                dends = tr.to_device(ends.astype(np.int32))
                got = D.decode_rle(vals, rvalid, dends, m, dt)
                torch.cuda.synchronize()
                err["K16r"] = max(err["K16r"], same_columns(
                    [got], [D.decode_rle_plain(vals, rvalid, dends, m, dt)],
                    f"K16 RLE {dt}, {len(ends)} runs, {m} rows"))

    n = SLICE3_SIZES[-1]
    codes = tr.to_device(rng.integers(0, 300, n).astype(np.int16)).to(
        torch.int32)
    valid = torch.from_numpy(rng.random(n) >= 0.1).to(dev)
    for what, values in (
            ("K16 strings", k16_values(session, rng, T.STRING, 300, False)),
            ("K16 longs", k16_values(session, rng, T.LONG, 65536, False))):
        c = codes if what == "K16 strings" else tr.to_device(
            rng.integers(0, 65536, n).astype(np.int32))
        got = D.decode_dictionary(c, valid, values, tr)
        timed[what] = (
            time_ms(lambda: D.decode_dictionary(c, valid, values, tr), 10),
            time_ms(lambda: D.decode_dictionary_plain(c, valid, values, tr),
                    2, 1),
            k16_bytes((c, valid, values, tr), got) / rate * 1e3,
            None if got.is_string else
            time_ms(lambda: torch.index_select(values.data, 0, c), 10))
    lens = rng.integers(1, 1001, n // 250 + 2)
    ends = np.cumsum(lens)
    ends = ends[:np.searchsorted(ends, n) + 1]
    ends[-1] = n
    vals = tr.to_device(rng.integers(0, 2 ** 40, len(ends)))
    rvalid = torch.ones(len(ends), dtype=torch.bool, device=dev)
    dends = tr.to_device(ends.astype(np.int32))
    counts = tr.to_device(np.diff(ends, prepend=0))
    got = D.decode_rle(vals, rvalid, dends, n, T.LONG)
    timed["K16r"] = (
        time_ms(lambda: D.decode_rle(vals, rvalid, dends, n, T.LONG), 10),
        time_ms(lambda: D.decode_rle_plain(vals, rvalid, dends, n, T.LONG),
                2, 1),
        k16_bytes((vals, rvalid, dends, n, T.LONG), got) / rate * 1e3,
        time_ms(lambda: torch.repeat_interleave(vals, counts,
                                                output_size=n), 10))

    # K5's code-space mode against the stage over the decoded strings
    names = [f"v{i}\u00e9{'x' * (i % 9)}" for i in range(300)]
    settings = ENC.EncodingSettings()
    for m in (1_000_000, SLICE3_SIZES[-1]):
        idx = rng.integers(0, 300, m).astype(np.int32)
        nulls = rng.random(m) < 0.1
        arr = pa.DictionaryArray.from_arrays(
            pa.array(idx, mask=nulls), pa.array(names))
        hb = HostColumnarBatch([ENC.HostDictionaryColumn(arr),
                                HostColumn(np.arange(m, dtype=np.int64),
                                           None, T.LONG)], m, ["s", "k"])
        batch = tr.upload_batch(hb, settings)
        check(isinstance(batch.columns[0], ENC.DictionaryColumn),
              "the dictionary column arrived as codes")
        decoded = ENC.materialize_batch(batch, tr)
        schema = batch.schema
        conds = {"=": P.EqualTo(col("s"), lit(names[3])),
                 "IN": P.In(col("s"), [names[1], names[7], "absent"]),
                 "<>": P.NotEqual(col("s"), lit(names[5])),
                 "IS NULL": P.IsNull(col("s"))}
        for what, cond in conds.items():
            ops = [("filter", bind_references(cond, schema)),
                   ("project", [bind_references(col("s"), schema),
                                bind_references(col("k"), schema)])]
            program = FU.StageProgram(ops, schema, 0)
            lits = FU.LiteralArgs([])
            coded, cb, clits, _kept = program.for_batch(batch, lits, tr)
            check(coded.n_tables == 1, f"{what} runs in code space")
            got = FU.fused_stage_compact(coded, cb, clits, tr)
            plain = FU.fused_stage_compact_plain(coded, cb, clits, tr)
            over = FU.fused_stage_compact(program, decoded, lits, tr)
            torch.cuda.synchronize()
            err["K5d"] = max(err["K5d"], same_indices(
                got[0], plain[0], f"K5d {what}, {m} rows vs plain"),
                same_indices(got[0], over[0], f"K5d {what}, {m} rows vs "
                             "K5 over the decoded strings"))
            if what == "=" and m == SLICE3_SIZES[-1]:
                timed["K5d ="] = (
                    time_ms(lambda: FU.fused_stage_compact(
                        coded, cb, clits, tr), 10),
                    time_ms(lambda: FU.fused_stage_compact_plain(
                        coded, cb, clits, tr), 2, 1),
                    (5 * m + 301 + 8 * got[0].shape[0]) / rate * 1e3,
                    None)
                timed["K5 = over the decoded strings"] = (
                    time_ms(lambda: FU.fused_stage_compact(
                        program, decoded, lits, tr), 10),
                    None, None, None)
    return err, timed


#: phase 2l: the rows of the chunked bounded path's frame test and its
#: chunks (the external sort's merge batches)
BOUNDED_ROWS = (1 << 20) + 3
BOUNDED_CHUNK = 1 << 18


def column_planes_bytes(cols) -> int:
    """Bytes of the columns' planes (each read once)."""
    return sum(column_bytes(c) for c in cols)


def check_slice12(session, rng, rate: float):
    """Phase 2l: K14c (the running window's carry) against its plain
    version chunk by chunk over one sorted stream in chunks of 0, 1, 1000,
    2**20 + 3 and 1000 rows (``testing/fixup_cases.py``: the first form, a
    chunk continuing the carry whole, a group boundary at row 0, a group
    and a peer run across a boundary; int, 0-40-byte string and long
    partition keys with nulls, a double order key with NaN, +-inf, -0.0
    and nulls; row_number, rank, dense_rank, sums, counts, minima and
    maxima of doubles, longs and ints with nulls), then timed on the
    2**20 + 3-row chunk against its bound and a torch.where over the
    prefix (the double sum's library form); and the chunked bounded path
    (forceBoundedBatched, forceOutOfCore, merge batches of 2**18 rows) of
    a 7-row moving average, lag 1 and lead 1 over 2**20 + 3 rows against
    the one-batch K14b and K14o run."""
    import torch
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.exec import sort as SX
    from spark_rapids_tpu_torch.exec import window as WX
    from spark_rapids_tpu_torch.ops import window_ops as W
    from spark_rapids_tpu_torch.testing import fixup_cases as FC
    tr, dev = session.transfers, session.device
    err = {"K14c": 0.0, "bounded": 0.0}
    timed = {}
    sizes = FC.SIZES
    pk, ok, outs_a, outs_b = FC.stream(rng, dev, tr, sizes)
    big = sizes.index(max(sizes))
    for kinds, outs in ((FC.KINDS_A, outs_a), (FC.KINDS_B, outs_b)):
        # the plain version first: the kernel fixes the columns in place
        ref = FC.run_stream(W.running_fixup_plain, pk, ok, kinds, outs, tr,
                            sizes)
        before = W.FIXUP_LAUNCHES
        got = FC.run_stream(W.running_fixup, pk, ok, kinds, outs, tr,
                            sizes)
        torch.cuda.synchronize()
        check(W.FIXUP_LAUNCHES - before == sum(k > 0 for k in sizes),
              "K14c launched once a chunk of rows")
        for c, ((gf, gc), (rf, rc)) in enumerate(zip(got, ref)):
            what = f"K14c, chunk {c} of {sizes[c]} rows"
            err["K14c"] = max(err["K14c"], same_frames(
                gf, rf, [None] * len(gf), what))
            check((gc is None) == (rc is None), f"{what}: carry")
            if gc is None:
                continue
            err["K14c"] = max(err["K14c"], same_columns(
                gc.keys, rc.keys, f"{what}: carried key row"))
            check(bool(torch.equal(gc.state, rc.state)),
                  f"{what}: carried rows, rank, dense rank "
                  f"{gc.state.tolist()} vs {rc.state.tolist()}")
            for g, r in zip(gc.values, rc.values):
                if g is not None:
                    check(bool(torch.equal(g[1], r[1])) and (
                        not bool(r[1][0]) or bool(torch.equal(g[0], r[0]))
                        or bool(torch.isnan(g[0]).all() and
                                torch.isnan(r[0]).all())),
                          f"{what}: carried aggregate")
        states = [None if c is None else c.state.tolist() for _f, c in got]
        print(f"K14c stream carries (rows, rank, dense rank): {states}")
    # timing: the 2**20 + 3-row chunk, carried from the chunk before it
    chunks_k = FC.chunks(list(pk) + list(ok), tr, sizes)
    chunks_w = FC.chunks(outs_a, tr, sizes)
    n = sizes[big]
    carry = FC.run_stream(W.running_fixup, pk, ok, FC.KINDS_A, outs_a, tr,
                          sizes)[big - 1][1]
    keys, win = chunks_k[big], chunks_w[big]
    args = (keys[:3], keys[3:], FC.KINDS_A, win, n, carry, tr)
    bound = k14c_bound(keys[:3], keys[3:], win, n, carry, rate)
    s = win[3]   # the double sum
    acc = carry.values[3][0]
    prefix = W.carried_prefix(keys[:3], carry, n, dev)
    timed["K14c"] = (
        time_ms(lambda: W.running_fixup(*args), 10),
        time_ms(lambda: W.running_fixup_plain(*args), 2, 1), bound,
        time_ms(lambda: torch.where(prefix, s.data + acc, s.data), 10))
    print(f"K14c on a chunk of {n} rows (4 keys, 7 window columns): "
          f"{timed['K14c'][0]:.4f} ms, plain {timed['K14c'][1]:.4f}, bound "
          f"{bound:.6f}, torch.where over the prefix {timed['K14c'][3]:.4f}")
    # the chunked bounded path against the one-batch K14b and K14o run
    m = BOUNDED_ROWS
    d = {"g": (np.arange(m) * 3 // m).astype(np.int64),
         "o": np.arange(m, dtype=np.int64),
         "v": rng.normal(size=m)}
    w = F.Window.partition_by("g").order_by("o")

    def q(sess):
        return sess.create_dataframe(d).select(
            F.col("g"), F.col("o"),
            F.avg("v").over(w.rows_between(-6, 0)).alias("ma"),
            F.lag("v", 1).over(w).alias("lg"),
            F.lead("v", 1).over(w).alias("ld")).collect_batch()
    one = q(session)
    prev = SX._MERGE_OUT_ROWS
    SX._MERGE_OUT_ROWS = BOUNDED_CHUNK
    ev = (WX.BOUNDED_WINDOW_EVENTS, SX.EXTERNAL_SORT_EVENTS)
    try:
        chunked = q(TorchSession({
            "spark.rapids.sql.test.window.forceBoundedBatched": "true",
            "spark.rapids.sql.test.sort.forceOutOfCore": "true"}))
    finally:
        SX._MERGE_OUT_ROWS = prev
    check(WX.BOUNDED_WINDOW_EVENTS > ev[0] and
          SX.EXTERNAL_SORT_EVENTS > ev[1], "the chunked bounded path ran")
    check(chunked.row_count == one.row_count == m, "bounded path rows")
    for a, b, name in zip(one.columns, chunked.columns, one.names):
        va = np.ones(m, bool) if a.validity is None else a.validity
        vb = np.ones(m, bool) if b.validity is None else b.validity
        check(bool(np.array_equal(va, vb)), f"bounded path: {name} validity")
        x, y = a.data[va], b.data[va]
        diff = float(np.abs(x - y).max()) if len(x) else 0.0
        check(diff <= 1e-12 * max(1.0, float(np.abs(x).max())),
              f"bounded path: {name} values ({diff})")
        err["bounded"] = max(err["bounded"], diff)
    print(f"chunked bounded path: {m} rows in chunks of {BOUNDED_CHUNK}, a "
          f"7-row moving average, lag 1, lead 1: equal to the one-batch "
          f"K14b/K14o run (max |d| {err['bounded']!r})")
    return err, timed


def minmax_fused(session, hb):
    """Phase 2m's K1 chain over a minmax_cases batch: ``g > 7``, then
    min and max of each fixed-width column and the four row-order kinds
    of every column: its fused exec."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import col, lit
    from spark_rapids_tpu_torch.expressions.predicates import GreaterThan
    aggs = []
    for c in ("i", "d", "l", "v"):
        aggs += [F.min(c), F.max(c)]
    for c in ("i", "d", "l", "v", "s"):
        aggs += [F.first(c), F.last(c), F.first(c, True), F.last(c, True)]
    return fused_exec_of(session.create_dataframe(hb).filter(
        GreaterThan(col("g"), lit(7))).agg(
        *[a.alias(f"a{j}") for j, a in enumerate(aggs)]))


def same_words(got, ref, doubles, what: str) -> float:
    """K3's output, or a K1 table folded by K3's plain version, against
    the plain version's: the validity and the valid words exactly;
    returns the measured max |d| over the valid words, by value (the
    words that ``doubles`` marks as doubles, over the finite ones)."""
    import torch
    check(bool(torch.equal(got[1], ref[1])), f"{what}: validity")
    gw = torch.where(ref[1], got[0], 0)
    rw = torch.where(ref[1], ref[0], 0)
    check(bool(torch.equal(gw, rw)), f"{what}: words")
    return max(max_diff(gw[~doubles], rw[~doubles]),
               max_diff(gw[doubles].view(torch.float64),
                        rw[doubles].view(torch.float64)))


def global_bytes(values, kinds) -> int:
    """Bytes K3 must move over a ``[rows, columns]`` word table of
    ``kinds``: sum, min and max read a cell's word and validity (9 B),
    count its validity byte alone; first_valid and last_valid read the
    validity bytes and the picked row's 9 B, first and last the picked
    row's 9 B alone; 9 B a column out."""
    from spark_rapids_tpu_torch.ops import agg_ops as G
    n = values.shape[0]
    total = 0
    for kind in kinds:
        if kind in (G.FIRST, G.LAST):
            total += 9 * min(n, 1)
        elif kind in (G.FIRST_VALID, G.LAST_VALID):
            total += n + 9 * min(n, 1)
        elif kind == G.COUNT:
            total += n
        elif kind == G.DEC128_LO:
            total += 8 * n   # its validity is the hi column's
        else:
            total += 9 * n
    return total + 9 * len(kinds)


def keyed_bytes(keys, inputs, kinds, res) -> int:
    """Bytes K9 must move: its keys; each distinct input once, whole
    where a slot folds every row of it (sum, count, m2, min, max), else
    its validity where a first_valid or last_valid slot reads it, and
    each pick slot's picked row of each group (a string's validity alone:
    its pick writes the row, which K7 gathers); a group index and each
    slot's output (word and validity) per group."""
    from spark_rapids_tpu_torch.ops import agg_ops as G
    groups = res[0][0].shape[0] if res else 0
    need = {}
    for c, k in zip(inputs, kinds):
        if c is None:
            continue
        e = need.setdefault(id(c), [c, False, False, 0])
        if k not in G.KEYED_PICK:
            e[1] = True
        elif k in (G.KEYED_FIRST_VALID, G.KEYED_LAST_VALID):
            e[2] = True
        if k in G.KEYED_PICK:
            e[3] += 1
    total = sum(column_bytes(c) for c in keys)
    for c, whole, valid, picks in need.values():
        if whole:
            total += column_bytes(c)
            continue
        if valid and not c.all_valid:
            total += c.row_count
        total += picks * ((0 if c.all_valid else groups) if c.is_string
                          else column_bytes(c, groups))
    return total + groups * 8 + sum(v.numel() * v.element_size() + ok.numel()
                                    for v, ok in res)


def check_slice13(session, rng, rate: float):
    """Phase 2m: on testing/minmax_cases.py batches of 0, 1, 1000 and
    2^20+3 rows (nulls, NaN, +-inf, +-0.0 in both orders, INT64_MIN and
    MAX, strings, an all-null and an all-NaN group), against their plain
    versions, exactly (doubles by their bits): K9's min, max, first, last,
    first_valid and last_valid over 4096 groups and over one group of
    every row; K9's merge kinds over the two halves' partials; K3's kinds
    (a string's by its rows), and -0.0 against 0.0 in both orders; K1's
    update forms (folded by K3's plain version) and the rows K7 gathers.
    Returns the measured max |d| by kernel (by value; the comparisons are
    exact, so a pass measures 0) and, at 2^20+3 rows, each kernel's (ms,
    plain ms, bound ms, library ms)."""
    import torch
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exec import fused as FU
    from spark_rapids_tpu_torch.ops import agg_ops as G
    from spark_rapids_tpu_torch.testing import minmax_cases as MC
    tr = session.transfers
    errs = {"K9": 0.0, "K1": 0.0, "K3": 0.0}
    timed = {}
    specs = MC.global_specs()
    k3_doubles = torch.tensor([dt == T.DOUBLE for _o, _k, _c, dt in specs],
                              device=session.device)
    for n in (0, 1, 1000, SLICE13_ROWS):
        hb = MC.host_batch(int(rng.integers(1 << 30)), n)
        b = tr.upload_batch(hb)
        inputs, kinds = MC.keyed_slots(b.columns)
        for key in (0, 1):
            keys = [b.columns[key]]
            got = G.keyed_aggregate(keys, inputs, kinds, tr)
            torch.cuda.synchronize()
            errs["K9"] = max(errs["K9"], same_keyed(
                keys, inputs, kinds, got, G.keyed_aggregate_plain(
                    keys, inputs, kinds, tr), tr,
                f"K9, {n} rows, key {key}"))
        # the merge kinds over the halves' partials (fixed-width slots)
        mkeys, merged, fk = MC.merged_halves(b.columns, inputs, kinds, tr)
        got = G.keyed_aggregate(mkeys, merged, fk, tr)
        torch.cuda.synchronize()
        errs["K9"] = max(errs["K9"], same_keyed(
            mkeys, merged, fk, got, G.keyed_aggregate_plain(
                mkeys, merged, fk, tr), tr, f"K9 merge, {n} rows"))
        # K3's kinds
        values, valid, k3 = G.pack_columns(b.columns, specs)
        got = G.global_reduce(values, valid, k3)
        torch.cuda.synchronize()
        errs["K3"] = max(errs["K3"], same_words(
            got, G.global_reduce_plain(values, valid, k3), k3_doubles,
            f"K3, {n} rows"))
        # K1's update forms, folded by K3's plain version, and K7's rows
        fx = minmax_fused(session, hb)
        tb = tr.upload_batch(hb)
        lits = FU.LiteralArgs.upload(fx.promoted, tr)
        folded = []
        for table in (FU.fused_agg_update(fx.program, tb, lits),
                      FU.fused_agg_update_plain(fx.program, tb, lits)):
            w, ok = G.global_reduce_plain(*table, fx.program.fold_kinds)
            folded.append((w, ok, fx.program.buffer_row(
                w, ok, tb, fx.scalar.buffer_names, tr)))
        torch.cuda.synchronize()
        (kw, kv, krow), (pw, pv, prow) = folded
        # the min and max buffers of doubles hold values; the row kinds'
        # buffers hold rows
        k1_doubles = torch.tensor([k in (G.MIN_F64, G.MAX_F64)
                                   for k in fx.program.fold_kinds],
                                  device=session.device)
        errs["K1"] = max(errs["K1"], same_words(
            (kw, kv), (pw, pv), k1_doubles, f"K1, {n} rows"),
            same_columns(krow.columns, prow.columns, f"K1's rows, {n} rows"))
    for first in (0.0, -0.0):
        zeros = torch.tensor([first, -first, first], dtype=torch.float64,
                             device=session.device).view(torch.int64)
        ones = torch.ones(3, 1, dtype=torch.bool, device=session.device)
        for kind, sign in ((G.MIN_F64, True), (G.MAX_F64, False)):
            w, _ok = G.global_reduce(zeros[:, None].contiguous(), ones,
                                     [kind])
            check(bool(torch.signbit(w.view(torch.float64))[0]) == sign,
                  f"K3 {kind} of zeros, {first} first")
    # times at 2^20+3 rows: the last loop's batch and its calls
    keys = [b.columns[0]]
    rep, res, gid = G.keyed_aggregate(keys, inputs, kinds, tr,
                                      row_groups=True)

    def fold_only(cols, ks, groups, n_out):
        """The library's fold of the min/max slots over K9's own group
        ids (``scatter_reduce``; the fold only)."""
        mm = [(c.data, "amin" if k == G.KEYED_MIN else "amax")
              for c, k in zip(cols, ks) if k in (G.KEYED_MIN, G.KEYED_MAX)]
        return lambda: [
            torch.zeros(n_out, dtype=x.dtype, device=x.device)
            .scatter_reduce_(0, groups, x, how, include_self=False)
            for x, how in mm]
    timed["K9"] = (
        time_ms(lambda: G.keyed_aggregate(keys, inputs, kinds, tr), 5),
        time_ms(lambda: G.keyed_aggregate_plain(keys, inputs, kinds, tr),
                2, 1),
        keyed_bytes(keys, inputs, kinds, res) / rate * 1e3,
        time_ms(fold_only(inputs, kinds, gid, rep.shape[0]), 5))
    mrep, mres, mgid = G.keyed_aggregate(mkeys, merged, fk, tr,
                                         row_groups=True)
    timed["K9 merge"] = (
        time_ms(lambda: G.keyed_aggregate(mkeys, merged, fk, tr), 5),
        time_ms(lambda: G.keyed_aggregate_plain(mkeys, merged, fk, tr), 2,
                1),
        keyed_bytes(mkeys, merged, fk, mres) / rate * 1e3,
        time_ms(fold_only(merged, fk, mgid, mrep.shape[0]), 5))
    ints = torch.where(valid, values, INT64_MAX)
    timed["K3"] = (
        time_ms(lambda: G.global_reduce(values, valid, k3), 20),
        time_ms(lambda: G.global_reduce_plain(values, valid, k3), 2, 1),
        global_bytes(values, k3) / rate * 1e3,
        time_ms(lambda: torch.amin(ints, 0), 20))
    table = FU.fused_agg_update(fx.program, tb, lits)
    # the chain's one string reference is the row kinds' argument, whose
    # validity alone K1 reads
    k1_in = sum(column_bytes(c) if not c.is_string else
                0 if c.all_valid else c.row_count
                for c in (tb.columns[o] for o in fx.program.used))
    timed["K1"] = (
        time_ms(lambda: FU.fused_agg_update(fx.program, tb, lits), 10),
        time_ms(lambda: FU.fused_agg_update_plain(fx.program, tb, lits), 2,
                1),
        (k1_in + 9 * table[0].numel()) / rate * 1e3, None)
    return errs, timed


#: phase 2n: rows of the decimal checks
SLICE14_ROWS = (1 << 20) + 3


def check_slice14(session, rng, rate: float):
    """Phase 2n: on ``testing/decimal_cases.py``'s batch of 2^20+3 rows
    (decimal(7,2), (18,4), (20,4) and (30,6) columns with nulls and their
    bounds; int and long partners), each decimal kernel against its plain
    version, bit for bit: K12 inside K6 (every operation the JAX gate
    admits, comparisons, casts, If), inside K5 (behind a filter) and
    inside K1 (the recipe's decimal form, 128-bit sums); K9's decimal64
    and decimal128 sum kinds over 4096 groups; K3's decimal128 sum; the
    decimal avg finish; K8's decimal64 and decimal128 words; K7, K7c and
    K7s moving decimal128 rows.  Returns the measured max |d| by kernel
    and each form's (ms, plain ms, bound ms, library ms)."""
    import torch
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import (HostColumnarBatch,
                                                       decimal_column,
                                                       host_column)
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.exec import fused as FU
    from spark_rapids_tpu_torch.expressions.base import (Alias,
                                                         bind_references)
    from spark_rapids_tpu_torch.ops import agg_ops as G
    from spark_rapids_tpu_torch.ops import batch_ops as BO
    from spark_rapids_tpu_torch.ops import decimal_ops as DO
    from spark_rapids_tpu_torch.ops import partition_ops as PO
    from spark_rapids_tpu_torch.ops import sort_ops as S
    from spark_rapids_tpu_torch.testing import decimal_cases as DC
    tr = session.transfers
    n = SLICE14_ROWS
    hb = DC.decimal_batch(n, int(rng.integers(1 << 30)))
    b = tr.upload_batch(hb)
    cols = dict(zip(b.names, b.columns))
    none = FU.LiteralArgs([])
    errs, timed = {}, {}

    def program(ops):
        return FU.StageProgram(ops, hb.schema, 0)

    def bound(used_cols, out_cols) -> float:
        return (sum(column_bytes(c) for c in used_cols) +
                sum(column_bytes(c) for c in out_cols)) / rate * 1e3

    # K12 inside K6: every operation, comparison and cast
    exprs = [Alias(bind_references(x, hb.schema), f"o{j}") for j, x in
             enumerate(DC.k12_expressions() + DC.k12_predicates())]
    p6 = program([("project", exprs)])
    got = FU.fused_project(p6, b, none)
    torch.cuda.synchronize()
    errs["K12 in K6"] = same_columns(
        got, FU.fused_project_plain(p6, b, none), "K12 in K6")
    timed["K12 in K6"] = (
        time_ms(lambda: FU.fused_project(p6, b, none), 5),
        time_ms(lambda: FU.fused_project_plain(p6, b, none), 2, 1),
        bound([b.columns[i] for i in p6.used], got), None)
    # K12 inside K5: the operations behind a filter
    from spark_rapids_tpu_torch.expressions import predicates as P
    from spark_rapids_tpu_torch.expressions.base import col
    cond = bind_references(P.GreaterThan(col("a"), col("w")), hb.schema)
    outs = [Alias(bind_references(x, hb.schema), f"o{j}")
            for j, x in enumerate(DC.k12_expressions())]
    p5 = program([("filter", cond), ("project", outs)])
    got5 = FU.fused_stage_compact(p5, b, none, tr)
    torch.cuda.synchronize()
    errs["K12 in K5"] = same_output(
        "K5", (p5, b, none, tr), {}, got5,
        FU.fused_stage_compact_plain(p5, b, none, tr), tr, "K12 in K5")
    timed["K12 in K5"] = (
        time_ms(lambda: FU.fused_stage_compact(p5, b, none, tr), 5),
        time_ms(lambda: FU.fused_stage_compact_plain(p5, b, none, tr), 2,
                1),
        (sum(column_bytes(b.columns[i]) for i in p5.used) +
         8 * got5[0].shape[0] + sum(column_bytes(c) for c in got5[1]))
        / rate * 1e3, None)
    # K12 inside K1: the recipe's decimal form, its 128-bit sums
    k = cols["k"].data.cpu().numpy()
    w = cols["w"].data.cpu().numpy()
    d = DC.cents(rng, n, -300.0, 300.0)
    rb = HostColumnarBatch([host_column(k), host_column(w),
                            decimal_column(d, DC.MONEY)], n, ["k", "w", "d"])
    fx = fused_exec_of(DC.recipe_decimal(session.create_dataframe(rb)))
    tb = tr.upload_batch(rb)
    lits = FU.LiteralArgs.upload(fx.promoted, tr)
    table = FU.fused_agg_update(fx.program, tb, lits)
    torch.cuda.synchronize()
    errs["K12 in K1"] = same_kernel1(
        (fx.program, tb, lits), table,
        FU.fused_agg_update_plain(fx.program, tb, lits), "K12 in K1")
    timed["K12 in K1"] = (
        time_ms(lambda: FU.fused_agg_update(fx.program, tb, lits), 10),
        time_ms(lambda: FU.fused_agg_update_plain(fx.program, tb, lits), 2,
                1),
        (sum(column_bytes(tb.columns[i]) for i in fx.program.used) +
         9 * table[0].numel()) / rate * 1e3, None)
    # K9's decimal sum kinds over 4096 groups: decimal64 (the long sum of
    # a decimal(7,2)'s cents) and decimal128 (a decimal(30,6), and a
    # decimal(18,4) summed into 128 bits)
    g = DeviceColumn(torch.from_numpy(rng.integers(0, 4096, n)).to(
        session.device), torch.ones(n, dtype=torch.bool,
                                    device=session.device), T.LONG, True)
    for what, ins, kinds in (
            ("K9 decimal64 sum", [cols["a"]], [G.KEYED_SUM_I64]),
            ("K9 decimal128 sum", [cols["e"], cols["b"]],
             [G.KEYED_SUM_DEC128, G.KEYED_SUM_DEC128])):
        rep, res, gid = G.keyed_aggregate([g], ins, kinds, tr,
                                          row_groups=True)
        torch.cuda.synchronize()
        errs[what] = same_keyed([g], ins, kinds, (rep, res),
                                G.keyed_aggregate_plain([g], ins, kinds, tr),
                                tr, what)
        library = None
        if what == "K9 decimal64 sum":
            x = ins[0]

            def library(x=x, gid=gid, groups=rep.shape[0]):
                return torch.zeros(groups, dtype=torch.int64,
                                   device=x.device).index_add_(
                    0, gid, torch.where(x.validity, x.data, 0))
        timed[what] = (
            time_ms(lambda: G.keyed_aggregate([g], ins, kinds, tr), 5),
            time_ms(lambda: G.keyed_aggregate_plain([g], ins, kinds, tr), 2,
                    1),
            keyed_bytes([g], ins, kinds, res) / rate * 1e3,
            None if library is None else time_ms(library, 5))
    # K3's decimal128 sum over the rows of a decimal(30,6)
    values, valid, k3 = G.pack_columns([cols["e"]], [
        (0, "sum", True, T.DecimalType(38, 6))])
    got3 = G.global_reduce(values, valid, k3)
    torch.cuda.synchronize()
    errs["K3 decimal128 sum"] = same_kernel2(
        (values, valid, k3), got3, G.global_reduce_plain(values, valid, k3),
        "K3 decimal128 sum")
    timed["K3 decimal128 sum"] = (
        time_ms(lambda: G.global_reduce(values, valid, k3), 20),
        time_ms(lambda: G.global_reduce_plain(values, valid, k3), 2, 1),
        global_bytes(values, k3) / rate * 1e3, None)
    # the decimal avg finish: decimal(17,2) sums and counts
    sums = torch.from_numpy(DC.cents(rng, n, -1e9, 1e9)).to(session.device)
    counts = torch.from_numpy(rng.integers(0, 100_000, n)).to(session.device)
    ok_in = cols["a"].validity
    ones = torch.ones_like(ok_in)
    got_avg = DO.avg_finish(sums, ok_in, counts, ones, DC.MONEY)
    torch.cuda.synchronize()
    ref_avg = DO.avg_finish_plain(sums, ok_in, counts, ones, DC.MONEY)
    check(bool(torch.equal(got_avg[1], ref_avg[1])), "avg finish: validity")
    errs["avg finish"] = same_indices(got_avg[0], ref_avg[0],
                                      "avg finish: averages")
    timed["avg finish"] = (
        time_ms(lambda: DO.avg_finish(sums, ok_in, counts, ones, DC.MONEY),
                10),
        time_ms(lambda: DO.avg_finish_plain(sums, ok_in, counts, ones,
                                            DC.MONEY), 1, 0),
        avg_bytes(sums, got_avg[0]) / rate * 1e3, None)
    # K8's decimal words: a decimal64 key descending, a decimal128 key
    # ascending (nulls first)
    for what, key, order in (("K8 decimal64 key", cols["a"],
                              S.SortOrder(0, False, False)),
                             ("K8 decimal128 key", cols["e"],
                              S.SortOrder(0, True, True))):
        perm = S.sort_permutation([key], [order], tr)
        torch.cuda.synchronize()
        errs[what] = same_indices(perm, S.sort_permutation_plain(
            [key], [order], tr), what)
        library = None
        if not key.data_type.is_decimal128:
            word = S.order_words_plain(key, order)[-1]

            def library(word=word):
                return torch.argsort(word, stable=True)
        timed[what] = (
            time_ms(lambda: S.sort_permutation([key], [order], tr), 5),
            time_ms(lambda: S.sort_permutation_plain([key], [order], tr), 2,
                    1),
            (column_bytes(key) + 8 * n) / rate * 1e3,
            None if library is None else time_ms(library, 5))
    # K7, K7c and K7s on decimal128 rows (16-byte planes)
    wide = [cols["c"], cols["e"]]
    idx = torch.from_numpy(rng.integers(-1, n, n)).to(session.device)
    got7 = BO.gather_columns(wide, idx, tr, unique=True, nullable=True)
    torch.cuda.synchronize()
    errs["K7 decimal128"] = same_columns(got7, BO.gather_columns_plain(
        wide, idx, tr, unique=True, nullable=True), "K7 decimal128")
    timed["K7 decimal128"] = (
        time_ms(lambda: BO.gather_columns(wide, idx, tr, unique=True,
                                          nullable=True), 10),
        time_ms(lambda: BO.gather_columns_plain(wide, idx, tr, unique=True,
                                                nullable=True), 2, 1),
        (8 * n + sum(2 * column_bytes(c) for c in got7)) / rate * 1e3, None)
    thirds = [BO.slice_batch(b.select([2, 3], ["c", "e"]), i * (n // 3),
                             n // 3, tr) for i in range(3)]
    got7c = BO.concat_batches(thirds)
    torch.cuda.synchronize()
    errs["K7c decimal128"] = same_columns(
        got7c.columns, BO.concat_batches_plain(thirds).columns,
        "K7c decimal128")
    pids = torch.from_numpy(rng.integers(0, 4, n).astype(np.int32)).to(
        session.device)
    counts4 = torch.bincount(pids.long(), minlength=4)
    got7s = PO.split_columns(wide, pids, counts4.tolist())
    torch.cuda.synchronize()
    errs["K7s decimal128"] = max([same_columns(
        x, y, f"K7s decimal128, partition {p}") for p, (x, y) in enumerate(
        zip(got7s, PO.split_columns_plain(wide, pids, counts4.tolist())))]
        + [0.0])
    return errs, timed


def query_3d(df, threshold=0):
    """Phase 3d: the recipe's decimal form (``testing/decimal_cases.py
    recipe_decimal``)."""
    from spark_rapids_tpu_torch.testing import decimal_cases as DC
    return DC.recipe_decimal(df, threshold)


def run_3d(session, data, args, rate: float, errs14, slice14_one,
           recipe_row):
    """Phase 3d: the recipe's decimal form over the recipe's table
    with ``d`` = ``v`` rounded to cents as DECIMAL(7,2), at
    ``args.parts`` partitions: launches (every K1 running K12, every K3
    a decimal128 sum), one sync, the sums' types and values against
    exact integers (``sk`` and ``sh`` against phase 3's ``recipe_row``),
    best and median of ``args.reps``, and its kernels (K1, K3, K7c) held
    against their plain versions and timed; returns their entries of the
    kernels line."""
    from spark_rapids_tpu_torch.columnar.batch import (HostColumnarBatch,
                                                       decimal_column,
                                                       host_column)
    from spark_rapids_tpu_torch.columnar.column import decimal_value
    from spark_rapids_tpu_torch.exec.stage_compiler import stats as kstats
    from spark_rapids_tpu_torch.testing import decimal_cases as DC
    kernels = []
    cents = np.rint(data["v"] * 100).astype(np.int64)   # v to cents
    hb3d = HostColumnarBatch([host_column(data["k"]), host_column(data["w"]),
                              decimal_column(cents, DC.MONEY)], args.rows,
                             ["k", "w", "d"])
    df3d = session.create_dataframe(hb3d, num_partitions=args.parts)
    first3d = query_3d(df3d).collect()
    counted3d = ("K1", "K3", "K7c")
    for k in counted3d:
        setattr(*counter_of(k), 0)
    dec3d = {k: counter_of_decimal(k) for k in ("K12", "K3d")}
    for mod, attr in dec3d.values():
        setattr(mod, attr, 0)
    tr0, ks0 = session.transfers.stats(), kstats()
    t0 = time.perf_counter()
    result3d = query_3d(df3d).collect()
    main3d_s = time.perf_counter() - t0
    launches3d = {k: getattr(*counter_of(k)) for k in counted3d}
    decimal3d = {k: getattr(mod, a) for k, (mod, a) in dec3d.items()}
    tr1, ks1 = session.transfers.stats(), kstats()
    print(f"phase 3d main path: {main3d_s * 1e3:.3f} ms, launches "
          f"{launches3d}, of them running K12 or a decimal128 sum "
          f"{decimal3d}, transfers {({k: tr1[k] - tr0[k] for k in tr1})}")
    check(launches3d == {"K1": args.parts, "K3": args.parts + 1,
                         "K7c": int(args.parts > 1)},
          f"phase 3d: K1 and K3 a partition, K3's merge, K7c: {launches3d}")
    check(decimal3d == {"K12": args.parts, "K3d": args.parts + 1},
          f"phase 3d: every K1 runs K12, every K3 a decimal128 sum: "
          f"{decimal3d}")
    check(tr1["syncs"] - tr0["syncs"] == 1, "phase 3d: one sync per query")
    check(ks1["builds"] == ks0["builds"], "phase 3d builds nothing anew")
    check(result3d == first3d, "phase 3d: a repeated query, the same row")
    types3d = dict(zip(query_3d(df3d).schema.names,
                       query_3d(df3d).schema.types))
    exact3d = DC.recipe_decimal_exact(data["k"], data["w"], cents)
    for name_, dt in DC.RECIPE_SUM_TYPES.items():
        check(types3d[name_] == dt, f"phase 3d: {name_} is {dt}: "
              f"{types3d[name_]}")
        got_ = result3d[0][name_]
        check(got_ == decimal_value(exact3d[name_], dt.scale) and
              got_.as_tuple().exponent == -dt.scale,
              f"phase 3d: {name_} {got_} is the exact {exact3d[name_]}")
    check(result3d[0]["sk"] == recipe_row["sk"] and
          result3d[0]["sh"] == recipe_row["sh"],
          f"phase 3d: sk, sh {result3d[0]} are phase 3's {recipe_row}")
    times3d = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        query_3d(df3d).collect()
        times3d.append(time.perf_counter() - t0)
    with Recorder() as rec3d:
        query_3d(df3d).collect()
    recorded3d = {k: sum(c[0] == k for c in rec3d.calls) for k in counted3d}
    check(recorded3d == launches3d, f"every phase 3d launch was recorded: "
          f"{recorded3d}")
    timed3d = time_kernels(session, rec3d.calls, rate, 5, counted3d)
    print(f"phase 3d result {result3d[0]} is exact; best of {args.reps} "
          f"{min(times3d) * 1e3:.3f} ms, median "
          f"{float(np.median(times3d)) * 1e3:.3f} ms, "
          f"{args.rows / min(times3d):.6e} rows/s")
    for k, o in timed3d.items():
        print(f"  {k}: {o['ms']:.4f} ms per query over {launches3d[k]} "
              f"launches (per launch: {'; '.join(o['shapes'])}), plain "
              f"{o['plain_ms']:.4f} ms, bound {o['bound_ms']:.6f} ms "
              f"({o['bytes']} B), library {o['library_ms']}, max |d| "
              f"{o['max_abs_err']}")
    for k, name_, err_key in (
            ("K1", "k12_fused_agg_update.recipe_decimal", "K12 in K1"),
            ("K3", "global_reduce.decimal128_sum", "K3 decimal128 sum"),
            ("K7c", "concat.recipe_decimal", None)):
        _name, route, source, replaces = TPCDS_KERNELS[k]
        o = timed3d[k]
        entry = {"name": name_,
                 "path": "phase 3d (the recipe's decimal form)",
                 "route": route, "source": source, "replaces": replaces,
                 "launches": launches3d[k], "max_abs_err": max(
                     o["max_abs_err"], errs14.get(err_key, 0.0)),
                 "ms": o["ms"], "plain_ms": o["plain_ms"],
                 "bound_ms": o["bound_ms"], "bound_by": "bytes",
                 "library_ms": o["library_ms"], "per": "query",
                 "passed": True}
        if k == "K1":
            entry["replaces"] = DECIMAL_REPLACES["K12"]
            entry["also_replaces"] = [replaces, DECIMAL_REPLACES["K3d"]]
        if k == "K3":
            entry["replaces"] = DECIMAL_REPLACES["K3d"]
            entry["also_replaces"] = [replaces]
        if err_key is not None:
            ms_, plain_, bound_, lib_ = slice14_one[err_key]
            entry.update({"phase_2n_ms": ms_, "phase_2n_plain_ms": plain_,
                          "phase_2n_bound_ms": bound_,
                          "phase_2n_library_ms": lib_})
        kernels.append(entry)
    return kernels


def query_3b(df, threshold=0):
    """Phase 3b: the recipe's global form, ``filter(w > t)`` then min,
    max, first and last of its columns."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions import predicates as P
    from spark_rapids_tpu_torch.expressions.base import col, lit
    return (df.filter(P.GreaterThan(col("w"), lit(threshold)))
            .agg(F.min("v").alias("min_v"), F.max("v").alias("max_v"),
                 F.min("k").alias("min_k"), F.max("w").alias("max_w"),
                 F.first("k").alias("first_k"), F.last("v").alias("last_v"),
                 F.first("v", True).alias("first_v"),
                 F.last("w", True).alias("last_w")))


def numpy_3b(data, parts: int, threshold=0) -> dict:
    """Phase 3b in numpy, partition by partition as the port cuts the
    table (``create_dataframe``): each partition's buffers, then the
    merge in partition order, where ``first`` and ``last`` take the first
    and last partition's buffer even when that partition kept no row (the
    JAX merge rule, ROADMAP queue 3); the table holds no null."""
    n = len(data["k"])
    per = -(-n // parts)
    bufs = []
    for p in range(parts):
        lo, hi = p * per, min(n, (p + 1) * per)
        sel = np.flatnonzero(data["w"][lo:hi] > threshold) + lo
        bufs.append(sel)
    every = np.concatenate(bufs)

    def value(name, rows):
        return None if not len(rows) else data[name][rows].item()
    out = {"min_v": value("v", [every[np.argmin(data["v"][every])]])
           if len(every) else None,
           "max_v": value("v", [every[np.argmax(data["v"][every])]])
           if len(every) else None,
           "min_k": int(data["k"][every].min()) if len(every) else None,
           "max_w": int(data["w"][every].max()) if len(every) else None,
           "first_k": value("k", bufs[0][:1]),
           "last_v": value("v", bufs[-1][-1:]),
           "first_v": value("v", every[:1]),
           "last_w": value("w", every[-1:])}
    return out


#: phase 9f: the device pool of q51 out of core
OOC_POOL = "128m"


def k14c_bound(pk, ok, outs, n: int, carry, rate: float) -> float:
    """K14c's bound in ms: the key planes read once (the partition keys
    only in the first form), each window column's rows [0, L) read and
    written and its row n - 1 read (L: the rows continuing the carry)."""
    from spark_rapids_tpu_torch.ops import window_ops as W
    if n == 0:
        return 0.0
    L = int(W.carried_prefix(pk, carry, n, outs[0].device).sum())
    keys = list(pk) if carry is None else list(pk) + list(ok)
    row = column_planes_bytes(outs) / n
    return (column_planes_bytes(keys) + row * (2 * L + (L < n))) / rate \
        * 1e3


def k14c_calls(calls, rate: float):
    """K14c's recorded main-path calls, each held against its plain
    version on the same inputs (the chunk's keys, its window columns as
    K14 wrote them, which the Recorder keeps on the host because the
    kernel fixes them in place, and the carry the call got), then timed:
    ``(max |d|, ms, plain ms, bound ms, library ms)`` summed over the
    calls (library: a torch.where over the carried prefix of the first
    window column)."""
    import torch
    from spark_rapids_tpu_torch.columnar.batch import DeviceColumn
    from spark_rapids_tpu_torch.ops import window_ops as W
    err = ms = plain_ms = bound = lib_ms = 0.0
    for a, kw in calls:
        pk, ok, kinds, saved, n, carry = a[:6]
        dev = (list(pk) + list(ok))[0].device

        def outs():
            return [DeviceColumn(d.to(dev), v.to(dev), t, av)
                    for d, v, t, av in saved]
        ref = W.running_fixup_plain(pk, ok, kinds, outs(), n, carry,
                                    *a[6:], **kw)
        got = W.running_fixup(pk, ok, kinds, outs(), n, carry, *a[6:], **kw)
        torch.cuda.synchronize()
        err = max(err, same_frames(got[0], ref[0], [None] * len(got[0]),
                                   f"K14c on a q51 chunk of {n} rows"))
        check(bool(torch.equal(got[1].state, ref[1].state)),
              "K14c's carry on a q51 chunk")
        cols = outs()
        args = (pk, ok, kinds, cols, n, carry, *a[6:])
        ms += time_ms(lambda: W.running_fixup(*args, **kw), 5)
        plain_ms += time_ms(lambda: W.running_fixup_plain(*args, **kw), 1, 1)
        bound += k14c_bound(pk, ok, cols, n, carry, rate)
        c = cols[0]
        acc = torch.zeros(1, dtype=c.data.dtype, device=dev) \
            if carry is None or carry.values[0] is None \
            else carry.values[0][0]
        prefix = W.carried_prefix(pk, carry, n, dev)
        lib_ms += time_ms(lambda: torch.where(prefix, c.data + acc, c.data),
                          5)
    return err, ms, plain_ms, bound, lib_ms


def run_q51_out_of_core(main_session, tables, rate: float, reference,
                        peak_9b: float, parts_list=(1, 4)):
    """Phase 9f: q51 at sf 1000 under a 128 MiB pool (the runtime shut
    down and shaped anew): every window takes the chunked running path
    over the external sort (K14c carries each chunk), at 4 partitions
    the FINAL group-bys re-partition; the rows are held against phase
    9b's and numpy's.  At one partition it times best and median of 3,
    prints syncs, the spill bytes by tier, retries and split retries,
    the peak device memory against 9b's and K14c's device ms from the
    profiler.  Returns K14c's launches and device ms, and the chunks."""
    import torch
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch.exec import aggregate as A
    from spark_rapids_tpu_torch.exec import sort as SX
    from spark_rapids_tpu_torch.exec import window as WX
    from spark_rapids_tpu_torch.memory import device_manager as DM
    from spark_rapids_tpu_torch.memory import retry as R
    from spark_rapids_tpu_torch.ops import window_ops as W
    from spark_rapids_tpu_torch.testing import tpcds
    _r, names, _f = QUERIES["q51"]
    host = host_tables({t: tables[t] for t in names})
    DM.shutdown()
    session = TorchSession({"spark.rapids.tpu.memory.pool.size": OOC_POOL})
    check(DM.get_runtime().catalog.device_limit == 128 << 20,
          "the 128 MiB pool")
    chunks = [0]
    sorted_chunks = WX.TorchWindowExec._sorted_chunks

    def counting(self, batches, transfers):
        for c in sorted_chunks(self, batches, transfers):
            chunks[0] += 1
            yield c
    out = {}
    WX.TorchWindowExec._sorted_chunks = counting
    try:
        for parts in parts_list:
            dfs = tpcds.partitioned_frames(session, host, names, parts) \
                if parts > 1 else [session.create_dataframe(host[t])
                                   for t in names]

            def run():
                return tpcds.q51(*dfs)[0].collect()
            label = f"q51 out of core at {parts} partition" + \
                ("s" if parts > 1 else "")
            for mod, attr, _k in [(*counter_of(k), k) for k in COUNTERS]:
                setattr(mod, attr, 0)
            WX.RUNNING_WINDOW_EVENTS = SX.EXTERNAL_SORT_EVENTS = 0
            A.REPARTITION_EVENTS = W.FIXUP_LAUNCHES = chunks[0] = 0
            R.RETRY_COUNT = R.SPLIT_RETRY_COUNT = 0
            m0 = DM.memory_stats()
            tr0 = session.transfers.stats()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with Recorder() as rec:
                got = run()
            main_s = time.perf_counter() - t0
            m1 = DM.memory_stats()
            tr1 = session.transfers.stats()
            ev = {"RUNNING_WINDOW_EVENTS": WX.RUNNING_WINDOW_EVENTS,
                  "EXTERNAL_SORT_EVENTS": SX.EXTERNAL_SORT_EVENTS,
                  "FIXUP_LAUNCHES": W.FIXUP_LAUNCHES,
                  "REPARTITION_EVENTS": A.REPARTITION_EVENTS,
                  "chunks": chunks[0]}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            spill = {k: m1[k] - m0[k] for k in (
                "device_to_host", "device_to_host_bytes", "host_to_disk",
                "host_to_disk_bytes", "unspills", "unspill_bytes")}
            spill_syncs = m1["transfers"]["syncs"] - m0["transfers"]["syncs"]
            syncs = tr1["syncs"] - tr0["syncs"] + spill_syncs
            print(f"{label}: {main_s * 1e3:.3f} ms, {len(got)} rows, "
                  f"counters {ev}; spills {spill}; retries "
                  f"{m1['retry']}, split retries {m1['splitRetry']}; "
                  f"syncs {syncs} (session {tr1['syncs'] - tr0['syncs']}, "
                  f"spills {spill_syncs})"
                  f"; peak device memory {peak:.3f} GiB (9b in memory "
                  f"{peak_9b:.3f})")
            check(ev["RUNNING_WINDOW_EVENTS"] >= 3,
                  f"{label}: every window ran the running path: {ev}")
            check(ev["EXTERNAL_SORT_EVENTS"] >= 3,
                  f"{label}: the external sort ran: {ev}")
            check(ev["FIXUP_LAUNCHES"] == ev["chunks"] > 0,
                  f"{label}: K14c once a chunk: {ev}")
            if parts == 1:
                check(spill["device_to_host"] > 0,
                      f"{label}: a device-to-host spill: {spill}")
            else:
                check(ev["REPARTITION_EVENTS"] > 0,
                      f"{label}: the FINAL merge re-partitioned: {ev}")
            rows_match(reference["numpy"], got, f"{label} vs numpy")
            rows_match(reference["rows"], got, f"{label} vs phase 9b")
            print(f"{label} matches phase 9b's rows and numpy")
            calls = [(a, kw) for k, a, kw in rec.calls if k == "K14c"]
            check(len(calls) == ev["FIXUP_LAUNCHES"],
                  f"{label}: every K14c launch recorded")
            del rec
            err, ms, plain_ms, bound, lib_ms = k14c_calls(calls, rate)
            del calls
            print(f"{label}: K14c over its {ev['FIXUP_LAUNCHES']} main-path "
                  f"calls vs plain: pass, max |d| {err!r}; {ms:.4f} ms per "
                  f"query, plain {plain_ms:.4f}, bound {bound:.6f}, "
                  f"torch.where over the prefix {lib_ms:.4f}")
            out[parts] = {"launches": ev["FIXUP_LAUNCHES"],
                          "max_abs_err": err, "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": bound,
                          "library_ms": lib_ms, "query_ms": main_s * 1e3}
            if parts > 1:
                continue
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                run()
                times.append(time.perf_counter() - t0)
            print(f"{label} best of 3: {min(times) * 1e3:.3f} ms, median "
                  f"{float(np.median(times)) * 1e3:.3f} ms")
            device_ms = profile_query(label, run, ["K14c"], reps=1)
            out[parts]["device_ms"] = device_ms["K14c"]
            out[parts]["best_ms"] = min(times) * 1e3
    finally:
        WX.TorchWindowExec._sorted_chunks = sorted_chunks
        # the phases after this one run with the default pool again
        DM.shutdown()
        DM.initialize(main_session.conf, main_session.device)
    return out


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
            elif isinstance(x, decimal.Decimal):
                # exact, at the same scale (Spark's result type)
                ok = isinstance(y, decimal.Decimal) and x == y and \
                    x.as_tuple().exponent == y.as_tuple().exponent
            else:
                ok = x == y
            check(ok, f"{what}: row {i} {key} {x!r} vs {y!r}")


def counter_of_decimal(form: str):
    """(module, attribute) of a decimal form's launch counter."""
    import importlib
    mod, attr = DECIMAL_COUNTERS[form]
    return importlib.import_module(f"spark_rapids_tpu_torch.{mod}"), attr


def counter_of(kernel: str):
    """(module, attribute) of a TPC-DS kernel's launch counter."""
    import importlib
    mod, attr = COUNTERS[kernel]
    return importlib.import_module(f"spark_rapids_tpu_torch.{mod}"), attr


class Recorder:
    """Records the calls of the TPC-DS kernels' wrappers that launched
    their kernel during one run, so each kernel can be checked and timed
    on the inputs the main path gave it; with ``mark``, each call runs in
    a profiler range named ``srt.<kernel>``, which sums the device time of
    the kernels the call launched."""

    def __init__(self, mark: bool = False):
        self.mark = mark
        from spark_rapids_tpu_torch.exec import fused, joins
        from spark_rapids_tpu_torch.ops import (agg_ops, batch_ops,
                                                decimal_ops, decode_ops,
                                                partition_ops, sort_ops,
                                                string_ops, window_ops)
        self.calls = []
        self._patches = [
            (fused, "fused_agg_update", "K1"),
            (agg_ops, "global_reduce", "K3"),
            (agg_ops, "count_distinct", "K15d"),
            (fused, "fused_stage_compact", "K5"),
            (fused, "fused_project", "K6"),
            (batch_ops, "gather_columns", "K7"),
            (joins, "gather_columns", "K7"),
            (batch_ops, "concat_batches", "K7c"),
            (sort_ops, "sort_permutation", "K8"),
            (agg_ops, "keyed_aggregate", "K9"),
            (joins, "join_pairs", "K10"),
            (window_ops, "window_reduce", "K14"),
            (window_ops, "window_rank", "K14r"),
            (joins, "cross_pairs", "K10x"),
            (partition_ops, "hash_partition", "K11h"),
            (partition_ops, "range_partition", "K11r"),
            (partition_ops, "split_columns", "K7s"),
            (window_ops, "window_running", "K14s"),
            (window_ops, "window_bounded", "K14b"),
            (window_ops, "window_offset", "K14o"),
            (window_ops, "window_ntile", "K14on"),
            (window_ops, "window_fill", "K14of"),
            (string_ops, "string_column", "K13"),
            (decode_ops, "decode_dictionary", "K16"),
            (decode_ops, "decode_rle", "K16r"),
            (window_ops, "running_fixup", "K14c"),
            (decimal_ops, "avg_finish", "K12avg"),
            (agg_ops, "collect", "K15"),
            (string_ops, "string_length", "K13l")]
        self._saved = []

    def __enter__(self):
        for mod, name, kernel in self._patches:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))

            def wrapped(*a, _fn=fn, _k=kernel, **kw):
                if _k == "K10":
                    _k = k10_name(kw)
                if _k == "K5" and a[0].n_tables:
                    _k = "K5d"   # the stage's code-space mode
                if _k == "K15" and (a[3] if len(a) > 3 else
                                    kw.get("distinct")):
                    _k = "K15s"   # K15's set mode
                counter = counter_of(K14O_PARTS.get(_k, _k))
                before = getattr(*counter)
                kept = a
                if _k == "K14c":
                    # K14c fixes its window columns in place: the record
                    # keeps them as they came, on the host
                    kept = a[:3] + ([(c.data.cpu(), c.validity.cpu(),
                                      c.data_type, c.all_valid)
                                     for c in a[3]],) + a[4:]
                if self.mark:
                    import torch
                    with torch.profiler.record_function(
                            f"srt.{K14O_PARTS.get(_k, _k)}"):
                        out = _fn(*a, **kw)
                else:
                    out = _fn(*a, **kw)
                if getattr(*counter) != before:
                    self.calls.append((_k, kept, kw))
                return out
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def k10_name(kw) -> str:
    """The record name of a K10 call: K10f for its full mode, K10n for
    its null-safe mode in the others, else K10 (each has its counter)."""
    if kw.get("mode") == "full":
        return "K10f"
    safe = kw.get("null_safe")
    flags = safe if isinstance(safe, (list, tuple)) else [safe]
    return "K10n" if any(flags) else "K10"


def column_bytes(c, rows=None) -> int:
    """Bytes of a column's planes (of ``rows`` rows of a fixed-width one;
    a string's or an array's whole)."""
    n = c.row_count if rows is None else rows
    if c.offsets is not None:
        # a string's chars, an array's elements
        return c.offsets.element_size() * (n + 1) + \
            int(c.offsets[-1]) * c.data.element_size() + \
            (0 if c.all_valid else n)
    width = c.data.element_size() * (c.data.shape[1] if c.data.dim() == 2
                                     else 1)
    return n * (width + (0 if c.all_valid else 1))


def same_output(name: str, args, kw, got, ref, tr, what: str) -> float:
    """A TPC-DS kernel's output on one recorded call against its plain
    version's, by phase 2b's comparators; returns the measured max |d|."""
    if name in ("K5", "K5d"):
        return max(same_indices(got[0], ref[0], f"{what}: survivors"),
                   same_columns(got[1], ref[1], what))
    if name in ("K6", "K7"):
        return same_columns(got, ref, what)
    if name in ("K13", "K16", "K16r", "K13l", "K15", "K15s"):
        return same_columns([got], [ref], what)
    if name == "K7c":
        check(got.row_count == ref.row_count, f"{what}: row count")
        return same_columns(got.columns, ref.columns, what)
    if name == "K8":
        return same_indices(got, ref, f"{what}: permutation")
    if name == "K9":
        err = same_keyed(*args[:3], got[:2], ref[:2], tr, what)
        if len(got) > 2:   # each row's group, for K15d
            err = max(err, same_indices(got[2], ref[2],
                                        f"{what}: row groups"))
        return err
    if name == "K14":
        return same_window_call(args, got, ref, what)
    if name == "K14r":
        return max([same_indices(g.data, r.data, f"{what}: ranks")
                    for g, r in zip(got, ref)] + [0.0])
    if name in ("K14s", "K14b"):
        return same_frame_call(name, args, got, ref, what)
    if name == "K14o":
        return max([same_indices(g, r, f"{what}: source rows")
                    for g, r in zip(got, ref)] + [0.0])
    if name == "K14on":
        return max([same_indices(g.data, r.data, f"{what}: tiles")
                    for g, r in zip(got, ref)] + [0.0])
    if name == "K14of":
        return same_columns([got], [ref], f"{what}: default")
    if name == "K10f":
        check(got[2] == ref[2], f"{what}: pairs {got[2]} vs {ref[2]}")
        return max(same_indices(got[0], ref[0], f"{what}: probe rows"),
                   same_indices(got[1], ref[1], f"{what}: build rows"))
    if name == "K1":
        return same_kernel1(args, got, ref, what)
    if name == "K12avg":
        check(bool(torch_equal(got[1], ref[1])), f"{what}: validity")
        return same_indices(got[0], ref[0], f"{what}: averages")
    if name == "K3":
        return same_kernel2(args, got, ref, what)
    if name == "K15d":
        return same_indices(got, ref, f"{what}: distinct counts")
    if name in ("K11h", "K11r"):
        return max(same_indices(got[0], ref[0], f"{what}: partition ids"),
                   same_indices(got[1], ref[1], f"{what}: histogram"))
    if name == "K7s":
        check(len(got) == len(ref), f"{what}: partitions")
        return max([same_columns(g, r, f"{what}, partition {p}")
                    for p, (g, r) in enumerate(zip(got, ref))] + [0.0])
    if got[1] is None:   # semi and anti: the kept probe rows
        check(ref[1] is None, f"{what}: build rows")
        return same_indices(got[0], ref[0], f"{what}: kept rows")
    return max(same_indices(g, r, f"{what}: {side} rows")
               for g, r, side in zip(got, ref, ("probe", "build")))


def avg_bytes(sdata, out) -> int:
    """Bytes the decimal avg finish must move: the sums, their validity,
    the counts and their validity read, the averages and their validity
    written."""
    n = sdata.shape[0]
    return sdata.numel() * 8 + n + 8 * n + n + out.numel() * 8 + n


def torch_equal(a, b) -> bool:
    import torch
    return torch.equal(a.cpu(), b.cpu())


def k16_bytes(args, got) -> int:
    """Bytes K16 must move for one call: the codes (int32) and their
    validity, or the runs and their ends, read; the dictionary's values
    read once; the output written."""
    if isinstance(args[3], int):    # RLE: values, validity, ends, n
        vals, rvalid, ends = args[:3]
        read = vals.numel() * vals.element_size() + 4 * ends.numel() + \
            (0 if rvalid is None else rvalid.numel())
    else:
        codes, valid, values = args[:3]
        read = 4 * codes.numel() + (0 if valid is None else valid.numel()) \
            + column_bytes(values)
    return read + column_bytes(got)


def k13_bytes(args, kw, got) -> int:
    """Bytes K13 must move for one call: each column part's offsets of the
    rows it reads, its validity and the chars the function needs from it,
    the row map, and the output's offsets, validity and chars."""
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn

    def arg(i, name, default=None):
        return kw.get(name, args[i] if len(args) > i else default)
    parts = args[1]
    pos, length, rows = arg(5, "pos", 1), arg(6, "length"), arg(7, "rows")
    n = got.row_count
    out = 8 * (n + 1) + n + int(got.offsets[-1])
    read = 0 if rows is None else 8 * n
    for p in parts:
        if isinstance(p, DeviceColumn):
            read += p.offsets.element_size() * (n + 1) + \
                (0 if p.all_valid else n)
    if args[0] == 0 and pos >= 0 and length is not None:
        # neither the clamp nor the take needs the row's character count:
        # a row is read up to the lead byte after its last character
        return read + out + substring_reach(parts[0], rows, pos, length)
    if args[0] in (0, 3, 4):
        # a substring from the end or to the end counts the row's
        # characters and a case map maps them: each input row's bytes
        # are read once
        return read + out + row_chars(parts[0], rows)
    # the copied chars: every output byte was read once from a part
    return read + out + int(got.offsets[-1])


def substring_reach(c, rows, pos: int, length: int) -> int:
    """The chars a substring at character ``pos >= 0`` of ``length``
    characters must read of the (valid) rows of string column ``c``: the
    skipped prefix, the substring and the lead byte after it, or the
    whole row where the substring reaches its end."""
    import torch
    from spark_rapids_tpu_torch.ops import string_ops as SO
    off = c.offsets.long()
    first, last = off[:-1], off[1:]
    valid = c.validity
    if rows is not None:
        first, last, valid = first[rows], last[rows], valid[rows]
    b0, take = SO.substring_range(c.data, first, last, pos, length)
    reach = torch.minimum(b0 + take + 1, last) - first
    return int(reach[valid].sum())


def k13l_bytes(column, n: int, rows=None) -> int:
    """Bytes K13's length pass must move: the rows' offsets, validity and
    chars (and the row map) read, an int32 and a validity byte a row
    written."""
    return column.offsets.element_size() * (n + 1) + \
        (0 if column.all_valid else n) + row_chars(column, rows) + \
        (0 if rows is None else 8 * n) + 5 * n


def k15_bytes(values, gid, got) -> int:
    """Bytes K15 must move: the values and their validity and the group
    ids read once, the offsets, validity and elements written."""
    n = values.row_count
    return column_bytes(values) + (0 if gid is None else 8 * n) + \
        column_bytes(got)


def k15_library(values, gid):
    """One PyTorch call that gives a collect_set's distinct (group, value)
    pairs: ``torch.unique(dim=0)`` over the stacked present (group id,
    value word) rows (the normalizing of the words is not timed)."""
    import torch
    from spark_rapids_tpu_torch.ops import agg_ops as G
    keep = values.validity
    words = G.collect_words_plain(values)[keep]
    g = torch.zeros_like(words) if gid is None else gid[keep]
    pairs = torch.stack([g, words], 1)

    def library(pairs=pairs):
        return torch.unique(pairs, dim=0)
    return library


def row_chars(c, rows=None) -> int:
    """The chars of the rows of string column ``c`` (``rows`` of them)."""
    off = c.offsets.long()
    if rows is None:
        return int(off[-1] - off[0])
    return int((off[rows + 1] - off[rows]).sum())


def same_kernel1(args, got, ref, what: str) -> float:
    """A kernel-1 call against its plain version: both partial tables
    folded by kernel 2's plain version, then compare_rows with each double
    buffer's tolerance from the call's own inputs (the sum of |x| over the
    rows the chain keeps)."""
    import torch
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.expressions.base import EvalContext
    from spark_rapids_tpu_torch.expressions.evaluator import batch_cols
    from spark_rapids_tpu_torch.ops import agg_ops as G
    program, batch, lits = args[:3]
    # the chain flattened over the input columns, as the kernel reads it
    ctx = EvalContext(batch_cols(batch), batch.row_count, batch.device,
                      lits.values, lits.tables)
    sel = torch.ones(batch.row_count, dtype=torch.bool, device=batch.device)
    for cond in program.conditions:
        p = cond.eval(ctx)
        sel = sel & p.valid & p.data
    abs_sum = 0.0
    for ordinal, kind, _cv, dtype in program.update_specs:
        if kind == "sum" and dtype.is_floating:
            c = program.update_inputs[ordinal].eval(ctx)
            x = c.data.to(torch.float64)
            abs_sum = max(abs_sum, float(torch.where(
                sel & c.valid & torch.isfinite(x), x.abs(), 0.0).sum()))
    # a min or max compares its word exactly, a first/last its row, a
    # decimal128 sum its two words
    from spark_rapids_tpu_torch.kernels.fused_agg import buffer_words
    types = [dt if kind == "sum" and dt.is_floating else T.LONG
             for _o, kind, _cv, dt in program.update_specs
             for _w in range(buffer_words(dt))]
    return compare_rows(G.global_reduce_plain(*got, program.fold_kinds),
                        G.global_reduce_plain(*ref, program.fold_kinds),
                        types, max(abs_sum, 1.0), what)


def same_kernel2(args, got, ref, what: str) -> float:
    """A kernel-2 call against its plain version: words and validity
    exact, a double sum within F64_SUM_RTOL of its column's sum |x|."""
    import torch
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.ops import agg_ops as G
    values, valid, kinds = args[:3]
    # a double sum within the tolerance; every other word (a double's min
    # or max by its bits, a picked row's word) exactly
    types = [T.DOUBLE if k == G.SUM_F64 else T.LONG for k in kinds]
    f = values.view(torch.float64)
    abs_sum = float(torch.where(valid.bool() & torch.isfinite(f), f.abs(),
                                0.0).sum()) if values.numel() else 0.0
    return compare_rows(got, ref, types, max(abs_sum, 1.0), what)


def same_window_call(args, got, ref, what: str) -> float:
    """A K14 call against its plain version: same_window's tolerance from
    the call's own inputs (each row's partition sum |v| over its present
    finite values, over their count for a mean)."""
    import torch
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.ops import window_ops as W
    keys, values, kinds, n, dev = args
    absum = []
    for c, kind in zip(values, kinds):
        if kind not in (W.WIN_SUM_F64, W.WIN_MEAN):
            absum.append(None)
            continue
        a = DeviceColumn(torch.where(torch.isfinite(c.data), c.data.abs(),
                                     0.0), c.validity, T.DOUBLE)
        s, cnt = (x.data for x in W.window_reduce_plain(
            keys, [a, a], [W.WIN_SUM_F64, W.WIN_COUNT], n, dev))
        absum.append(s if kind == W.WIN_SUM_F64 else
                     torch.where(cnt > 0, s / cnt.clamp(min=1), 0.0))
    return same_window(got, ref, absum, what)


def same_frames(got, ref, absum, what: str) -> float:
    """Frame outputs against the plain version's: validity, integers,
    NaN and infinities exact; a finite double within F64_SUM_RTOL of its
    frame's sum of |x| (``absum[j]``; exact where it is None)."""
    import torch
    err = 0.0
    for j, (g, r) in enumerate(zip(got, ref)):
        w = f"{what}, function {j}"
        ok = r.validity
        check(bool(torch.equal(g.validity, ok)), f"{w}: validity")
        zero = torch.zeros((), dtype=r.data.dtype, device=r.data.device)
        gd, rd = torch.where(ok, g.data, zero), torch.where(ok, r.data,
                                                            zero)
        if not rd.dtype.is_floating_point:
            check(bool(torch.equal(gd, rd)), f"{w}: values")
            err = max(err, max_diff(gd, rd))
            continue
        check(bool(torch.equal(torch.isnan(gd), torch.isnan(rd))),
              f"{w}: NaN")
        inf = torch.isinf(rd)
        check(bool(torch.equal(torch.where(inf, gd, 0.0),
                               torch.where(inf, rd, 0.0))),
              f"{w}: infinities")
        d = torch.where(torch.isfinite(rd), (gd - rd).abs(), 0.0)
        worst = float(d.max()) if d.numel() else 0.0
        limit = 0.0 if absum[j] is None else F64_SUM_RTOL * absum[j]
        check(bool((d <= limit).all()), f"{w}: values ({worst})")
        err = max(err, worst)
    return err


def same_frame_call(name, args, got, ref, what: str) -> float:
    """A K14s or K14b call against its plain version: a running double sum
    or mean within F64_SUM_RTOL of its frame's sum of |x| (the plain
    version rebases prefix sums), everything else exact (K14b and the
    plain version fold each frame in row order alike)."""
    import torch
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.ops import window_ops as W
    if name == "K14b":
        return same_frames(got, ref, [None] * len(got), what)
    keys, order, funcs, values, n, dev = args
    absum = []
    for f, c in zip(funcs, values):
        if f.kind not in (W.WIN_SUM_F64, W.WIN_MEAN):
            absum.append(None)
            continue
        a = DeviceColumn(torch.where(torch.isfinite(c.data), c.data.abs(),
                                     0.0), c.validity, T.DOUBLE)
        absum.append(W.window_running_plain(
            keys, order, [W.FrameAgg(W.WIN_SUM_F64, f.frame, f.lo, f.hi)],
            [a], n, dev)[0].data)
    return same_frames(got, ref, absum, what)


def k5_library(program, batch, lits):
    """One-call PyTorch yardstick of a K5 launch whose filter is one
    numeric ``column = literal``: the mask, ``torch.nonzero`` and
    ``index_select`` of the stage's fixed-width planes (the gather of those
    planes is K7's work on the kernel side); None for any other filter."""
    import torch
    from spark_rapids_tpu_torch.expressions.base import BoundReference
    from spark_rapids_tpu_torch.expressions.predicates import EqualTo
    if len(program.conditions) != 1:
        return None
    cond = program.conditions[0]
    if not isinstance(cond, EqualTo) or \
            not isinstance(cond.children[0], BoundReference) or \
            not cond.children[0].data_type.is_numeric:
        return None
    c = batch.columns[cond.children[0].ordinal]
    value = lits.values[0] if lits.values else cond.children[1].value
    kept = [batch.columns[b] for b in program.bare if b is not None]
    planes = [k.data for k in kept if not k.is_string] + \
        [k.validity for k in kept]

    def compact():
        rows = torch.nonzero(c.data == value).flatten()
        return [torch.index_select(p, 0, rows) for p in planes]
    return compact


def time_kernels(session, calls, rate: float, reps: int, kernels):
    """Per query: each kernel's device ms, plain ms, bound ms and library
    ms, summed over its recorded launches (0 with ``reps`` 0), and the
    max |d| of its output on each of them against its plain version's.  A kernel's library ms
    is None when one of its launches has no one-call PyTorch
    equivalent."""
    import torch
    from spark_rapids_tpu_torch.exec import fused as FU
    from spark_rapids_tpu_torch.ops import agg_ops as G
    from spark_rapids_tpu_torch.ops import batch_ops as BO
    from spark_rapids_tpu_torch.ops import decimal_ops as DO
    from spark_rapids_tpu_torch.ops import decode_ops as D
    from spark_rapids_tpu_torch.ops import join_ops as J
    from spark_rapids_tpu_torch.ops import partition_ops as PO
    from spark_rapids_tpu_torch.ops import sort_ops as S
    from spark_rapids_tpu_torch.ops import string_ops as SO
    from spark_rapids_tpu_torch.ops import window_ops as W
    tr = session.transfers
    plain = {"K1": FU.fused_agg_update_plain, "K3": G.global_reduce_plain,
             "K15d": G.count_distinct_plain,
             "K5": FU.fused_stage_compact_plain, "K6": FU.fused_project_plain,
             "K7": BO.gather_columns_plain, "K7c": BO.concat_batches_plain,
             "K8": S.sort_permutation_plain,
             "K9": G.keyed_aggregate_plain, "K10": J.join_pairs_plain,
             "K14": W.window_reduce_plain, "K14r": W.window_rank_plain,
             "K10x": J.cross_pairs_plain, "K11h": PO.hash_partition_plain,
             "K11r": PO.range_partition_plain,
             "K7s": PO.split_columns_plain,
             "K14s": W.window_running_plain, "K14b": W.window_bounded_plain,
             "K14o": W.window_offset_plain, "K14on": W.window_ntile_plain,
             "K14of": W.window_fill_plain, "K10f": J.join_pairs_plain,
             "K10n": J.join_pairs_plain, "K13": SO.string_column_plain,
             "K16": D.decode_dictionary_plain, "K16r": D.decode_rle_plain,
             "K5d": FU.fused_stage_compact_plain,
             "K12avg": DO.avg_finish_plain, "K15": G.collect_plain,
             "K15s": G.collect_plain, "K13l": SO.string_length_plain}
    kernel = {"K1": FU.fused_agg_update, "K3": G.global_reduce,
              "K15d": G.count_distinct,
              "K5": FU.fused_stage_compact, "K6": FU.fused_project,
              "K7": BO.gather_columns, "K7c": BO.concat_batches,
              "K8": S.sort_permutation,
              "K9": G.keyed_aggregate, "K10": J.join_pairs,
              "K14": W.window_reduce, "K14r": W.window_rank,
              "K10x": J.cross_pairs, "K11h": PO.hash_partition,
              "K11r": PO.range_partition, "K7s": PO.split_columns,
              "K14s": W.window_running, "K14b": W.window_bounded,
              "K14o": W.window_offset, "K14on": W.window_ntile,
              "K14of": W.window_fill, "K10f": J.join_pairs,
              "K10n": J.join_pairs, "K13": SO.string_column,
              "K16": D.decode_dictionary, "K16r": D.decode_rle,
              "K5d": FU.fused_stage_compact, "K12avg": DO.avg_finish,
              "K15": G.collect, "K15s": G.collect,
              "K13l": SO.string_length}
    out = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "library_ms": 0.0,
               "shapes": [], "max_abs_err": 0.0} for k in kernels}
    for i, (name, args, kw) in enumerate(calls):
        o = out[K14O_PARTS.get(name, name)]
        got = kernel[name](*args, **kw)
        torch.cuda.synchronize()
        o["max_abs_err"] = max(o["max_abs_err"], same_output(
            name, args, kw, got, plain[name](*args, **kw), tr,
            f"main path, {name} call {i}"))
        # reps 0: compared only, not timed
        ms = time_ms(lambda: kernel[name](*args, **kw), reps) if reps \
            else 0.0
        o["ms"] += ms
        o["plain_ms"] += time_ms(lambda: plain[name](*args, **kw), 2, 1) \
            if reps else 0.0
        library = None
        if name == "K1":
            program, batch = args[0], args[1]
            words = got[0]
            o["bytes"] += sum(column_bytes(batch.columns[c])
                              for c in program.used) + 9 * words.numel()
            o["shapes"].append(f"{batch.row_count} rows, {len(program.used)}"
                               f" columns: {ms:.4f} ms")
        elif name == "K3":
            values = args[0]
            o["bytes"] += global_bytes(values, args[2])
            o["shapes"].append(f"{values.shape[0]}x{values.shape[1]}: "
                               f"{ms:.4f} ms")
        elif name == "K15d":
            values = args[0]
            gid = args[1] if len(args) > 1 else None
            o["bytes"] += column_bytes(values) + 8 * got.shape[0] + \
                (0 if gid is None else 8 * values.row_count)
            o["shapes"].append(f"{values.row_count} rows -> {got.shape[0]}"
                               f" groups: {ms:.4f} ms")
            if gid is None:
                def library(v=values):
                    return torch.unique(v.data[v.validity]).numel()
        elif name in ("K5", "K5d"):
            program, batch, lits, _tr = args
            idx = got[0]
            used = [batch.columns[i] for i in program.used]
            # K5d also reads its lookup tables
            o["bytes"] += sum(column_bytes(c) for c in used) + \
                8 * idx.shape[0] + sum(t.numel() for t in lits.tables)
            o["shapes"].append(f"{batch.row_count}->{idx.shape[0]}: "
                               f"{ms:.4f} ms")
            library = k5_library(program, batch, lits)
        elif name == "K6":
            program, batch = args[0], args[1]
            n = batch.row_count
            # a string output is a view: K6 writes its validity alone
            o["bytes"] += sum(column_bytes(batch.columns[i])
                              for i in program.used) + \
                sum(n if c.is_string else column_bytes(c) for c in got)
            o["shapes"].append(f"{n} rows, {len(got)} outputs: {ms:.4f} ms")
        elif name == "K7":
            cols, idx = args[0], args[1]
            n = idx.shape[0]
            o["bytes"] += 8 * n + sum(column_bytes(g) * 2 for g in got)
            o["shapes"].append(f"{len(cols)}x{n}: {ms:.4f} ms")
            planes = [c.data for c in cols if not c.is_string]
            planes += [c.validity for c in cols]
            if not kw.get("nullable"):
                def library(planes=planes, idx=idx):
                    return [torch.index_select(p, 0, idx) for p in planes]
        elif name == "K7c":
            batches = args[0]
            o["bytes"] += 2 * sum(column_bytes(c) for b in batches
                                  for c in b.columns)
            o["shapes"].append(f"{len(batches)} batches of "
                               f"{len(batches[0].columns)} columns -> "
                               f"{got.row_count} rows: {ms:.4f} ms")
            if not any(c.is_string for c in batches[0].columns):
                def library(batches=batches):
                    return [torch.cat([b.columns[j].data for b in batches])
                            for j in range(len(batches[0].columns))] + \
                        [torch.cat([b.columns[j].validity for b in batches])
                         for j in range(len(batches[0].columns))]
        elif name == "K8":
            cols, orders = args[0], args[1]
            n = cols[0].row_count
            o["bytes"] += sum(column_bytes(cols[x.ordinal]) for x in orders) \
                + 8 * n
            o["shapes"].append(f"{n} rows, {len(orders)} keys: {ms:.4f} ms")
            numeric = [x for x in orders if not cols[x.ordinal].is_string]
            if len(numeric) == len(orders):
                x = numeric[min(1, len(numeric) - 1)]
                word = S.order_words_plain(cols[x.ordinal], x)[-1]

                def library(word=word):
                    return torch.argsort(word, stable=True)
        elif name == "K9":
            keys, inputs = args[0], args[1]
            rep, res = got[:2]
            g = rep.shape[0]
            o["bytes"] += keyed_bytes(keys, inputs, args[2], res)
            o["shapes"].append(f"{keys[0].row_count}->{g} groups: "
                               f"{ms:.4f} ms")
        elif name == "K14":
            keys, values, _kinds, n = args[:4]
            o["bytes"] += sum(column_bytes(c) for c in keys) + \
                sum(column_bytes(c) for c in values if c is not None) + \
                sum(column_bytes(c) for c in got)
            o["shapes"].append(f"{n} rows, {len(keys)} keys, {len(got)} "
                               f"functions: {ms:.4f} ms")
        elif name == "K14r":
            keys, order, _kinds, n = args[:4]
            o["bytes"] += sum(column_bytes(c) for c in keys + order) + \
                sum(column_bytes(c) for c in got)
            o["shapes"].append(f"{n} rows, {len(keys)} partition and "
                               f"{len(order)} order keys, {len(got)} "
                               f"functions: {ms:.4f} ms")
        elif name in ("K11h", "K11r"):
            keys = args[0]
            strings = args[2] if name == "K11h" else args[4]
            parts = args[1] if name == "K11h" else args[3]
            n = got[0].shape[0]
            # the key planes read (and the bounds, and the offsets of the
            # strings whose chars it counts), the pids and histogram written
            o["bytes"] += sum(column_bytes(k) for k in keys) + 4 * n + \
                8 * got[1].numel() + sum(
                    c.offsets.element_size() * (n + 1) for c in strings)
            if name == "K11r":
                o["bytes"] += sum(column_bytes(b) for b in args[1])
            o["shapes"].append(f"{n} rows, {len(keys)} keys -> {parts} "
                               f"partitions: {ms:.4f} ms")
            if name == "K11r" and len(keys) == 1 and keys[0].all_valid \
                    and not keys[0].is_string:
                x = S.SortOrder(0, *args[2][0])
                row_word = S.order_words_plain(keys[0], x)[-1]
                bound_word = S.order_words_plain(args[1][0], x)[-1]

                def library(r=row_word, b=bound_word):
                    return torch.searchsorted(b, r)
        elif name == "K7s":
            cols, pids = args[0], args[1]
            n = pids.shape[0]
            o["bytes"] += 4 * n + 2 * sum(column_bytes(c) for c in cols)
            o["shapes"].append(f"{len(cols)} columns x {n} rows -> "
                               f"{len(args[2])} partitions: {ms:.4f} ms")
            if not any(c.is_string for c in cols):
                planes = [p for c in cols for p in (c.data, c.validity)]

                def library(planes=planes, pids=pids):
                    perm = torch.argsort(pids, stable=True)
                    return [torch.index_select(p, 0, perm) for p in planes]
        elif name in ("K14s", "K14b"):
            keys = args[0]
            order = args[1] if name == "K14s" else []
            funcs, values, n = args[-4:-1] if name == "K14s" else args[1:4]
            peers = name == "K14s" and any(
                f.running_form()[1] == W.TAKE_PEERS for f in funcs)
            o["bytes"] += sum(column_bytes(c) for c in keys) + \
                (sum(column_bytes(c) for c in order) if peers else 0) + \
                sum(0 if c is None else n * (1 if f.kind == W.WIN_COUNT
                                             else 1 + c.data.element_size())
                    for f, c in zip(funcs, values)) + \
                sum(column_bytes(c) for c in got)
            o["shapes"].append(f"{n} rows, {len(keys)} keys, {len(funcs)} "
                               f"functions: {ms:.4f} ms")
        elif name in ("K14o", "K14on"):
            keys, counts, n = args[:3]
            o["bytes"] += sum(column_bytes(c) for c in keys) + \
                (8 if name == "K14o" else 4) * n * len(counts)
            o["shapes"].append(f"{n} rows, {len(counts)} "
                               f"{'offsets' if name == 'K14o' else 'ntiles'}"
                               f": {ms:.4f} ms")
        elif name == "K14of":
            c, src = args[0], args[1]
            o["bytes"] += 2 * column_bytes(c) + 8 * src.shape[0]
            o["shapes"].append(f"default into {src.shape[0]} rows: "
                               f"{ms:.4f} ms")
        elif name == "K13":
            n = got.row_count
            o["bytes"] += k13_bytes(args, kw, got)
            form = {0: "substring", 1: "concat", 3: "upper",
                    4: "lower"}[args[0]]
            o["shapes"].append(f"{n} rows -> {int(got.offsets[-1])} chars "
                               f"({form} of {len(args[1])} parts): "
                               f"{ms:.4f} ms")
        elif name == "K13l":
            column, n = args[0], args[1]
            rows = args[2] if len(args) > 2 else kw.get("rows")
            o["bytes"] += k13l_bytes(column, n, rows)
            o["shapes"].append(f"length of {n} rows: {ms:.4f} ms")
        elif name in ("K15", "K15s"):
            values, gid, groups = args[0], args[1], args[2]
            o["bytes"] += k15_bytes(values, gid, got)
            o["shapes"].append(f"{values.row_count} rows -> {groups} "
                               f"groups, {int(got.offsets[-1])} elements: "
                               f"{ms:.4f} ms")
            if name == "K15s":
                library = k15_library(values, gid)
        elif name == "K16":
            o["bytes"] += k16_bytes(args, got)
            o["shapes"].append(f"{got.row_count} rows from "
                               f"{args[2].row_count} values"
                               f"{' (strings)' if got.is_string else ''}: "
                               f"{ms:.4f} ms")
            if not got.is_string:
                def library(v=args[2].data, c=args[0]):
                    return torch.index_select(v, 0, c)
        elif name == "K16r":
            o["bytes"] += k16_bytes(args, got)
            o["shapes"].append(f"{got.row_count} rows from "
                               f"{args[0].shape[0]} runs: {ms:.4f} ms")
        elif name == "K12avg":
            sdata = args[0]
            n = sdata.shape[0]
            o["bytes"] += avg_bytes(sdata, got[0])
            o["shapes"].append(f"{n} groups: {ms:.4f} ms")
        elif name == "K10x":
            n_probe, n_build = args[:2]
            o["bytes"] += 16 * n_probe * n_build
            o["shapes"].append(f"{n_probe} x {n_build}: {ms:.4f} ms")

            def library(n_probe=n_probe, n_build=n_build, dev=args[2]):
                return torch.cartesian_prod(
                    torch.arange(n_probe, device=dev),
                    torch.arange(n_build, device=dev))
        else:
            b, p = J.key_list(args[0]), J.key_list(args[1])
            pr = got[0]
            o["bytes"] += sum(column_bytes(c) for c in b + p) + \
                (8 if got[1] is None else 16) * pr.shape[0]
            if name == "K10f":
                o["bytes"] += b[0].row_count   # the matched flags
            mode = " outer" if kw.get("outer") else \
                f" {kw['mode']}" if kw.get("mode") else ""
            o["shapes"].append(f"{b[0].row_count} x {p[0].row_count} ->"
                               f"{mode} {pr.shape[0]} ({len(b)} keys): "
                               f"{ms:.4f} ms")
        if library is None or o["library_ms"] is None:
            o["library_ms"] = None
        elif reps:
            o["library_ms"] += time_ms(library, reps)
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


def profile_query(query: str, run, kernels, reps: int = 3):
    """Device time by kernel over ``reps`` queries (torch.profiler, which
    traces the card through CUPTI), the share of the window in which the
    card ran nothing, and each kernel's device ms per query (what its
    wrapper calls ran on the card), or None where the profiler saw no
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            Recorder(mark=True):
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    found = [e for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and not e.key.startswith("srt.")]

    def dev_us(e):
        return next((getattr(e, n) for n in ("self_device_time_total",
                                             "self_cuda_time_total")
                     if hasattr(e, n)), 0)
    busy = sum(dev_us(e) for e in found)
    if not found or not busy:
        print(f"{query} profile: the profiler recorded no device time (not "
              "measured)")
        return {k: None for k in kernels}
    print(f"{query} profile over {reps} queries: device busy "
          f"{busy / reps:.1f} us per query of {wall_us / reps:.1f} us wall "
          f"(profiler on); idle share {1 - busy / wall_us:.4f}; "
          f"{len(found)} kernels")
    for e in sorted(found, key=lambda e: -dev_us(e))[:14]:
        print(f"  {dev_us(e) / reps:9.1f} us/query  {e.count // reps:4d} x  "
              f"{e.key[:90]}")
    by_range = device_us_by_range(prof.events())
    device_ms = {k: by_range[k] / reps / 1e3 if by_range.get(k) else None
                 for k in kernels}
    print(f"{query} device ms per query by kernel (work inside each "
          f"wrapper's profiler range): {device_ms}; outside them "
          f"{(busy - sum(by_range.values())) / reps / 1e3:.4f} ms")
    return device_ms


#: each TPC-DS query: recipe and numpy version (testing/tpcds.py names;
#: q20 is q12's recipe over catalog_sales), its tables in the recipe's
#: order, the fact table its rows/s count
QUERIES = {
    "q3": ("q3", ("date_dim", "store_sales", "item"), "store_sales"),
    "q1": ("q1", ("date_dim", "store_returns", "store", "customer"),
           "store_returns"),
    "q7": ("q7", ("store_sales", "customer_demographics", "date_dim",
                  "item", "promotion"), "store_sales"),
    "q15": ("q15", ("catalog_sales", "customer", "customer_address",
                    "date_dim"), "catalog_sales"),
    "q12": ("q12", ("web_sales", "item", "date_dim"), "web_sales"),
    "q20": ("q20", ("catalog_sales", "item", "date_dim"), "catalog_sales"),
    "q13": ("q13", ("store_sales", "store", "customer_demographics",
                    "household_demographics", "customer_address",
                    "date_dim"), "store_sales"),
    "q19": ("q19", ("date_dim", "store_sales", "item", "customer",
                    "customer_address", "store"), "store_sales"),
    "q16": ("q16", ("catalog_sales", "date_dim", "customer_address",
                    "call_center", "catalog_returns"), "catalog_sales"),
    "q17": ("q17", ("store_sales", "store_returns", "catalog_sales",
                    "date_dim", "store", "item"), "store_sales"),
    "q17v": ("q17", ("store_sales", "store_returns", "catalog_sales",
                     "date_dim", "store", "item"), "store_sales"),
    "q10": ("q10", ("customer", "customer_address", "customer_demographics",
                    "store_sales", "web_sales", "catalog_sales", "date_dim"),
            "store_sales"),
    "q18": ("q18", ("catalog_sales", "customer_demographics", "customer",
                    "customer_address", "date_dim", "item"),
            "catalog_sales"),
    "q6": ("q6", ("customer_address", "customer", "store_sales", "date_dim",
                  "item"), "store_sales"),
    "q28": ("q28", ("store_sales",), "store_sales"),
    "q36": ("q36", ("store_sales", "date_dim", "item", "store"),
            "store_sales"),
    "q51": ("q51", ("web_sales", "store_sales", "date_dim"), "store_sales"),
    "q51w": ("q51w", ("store_sales", "date_dim"), "store_sales"),
    "q8": ("q8", ("store_sales", "date_dim", "store", "customer_address",
                  "customer"), "store_sales"),
    "q5": ("q5", ("store_sales", "store_returns", "catalog_sales",
                  "catalog_returns", "web_sales", "web_returns", "date_dim",
                  "store", "catalog_page", "web_site"), "store_sales"),
    "q35": ("q35", Q35_TABLES, "store_sales"),
    "q35v": ("q35", Q35_TABLES, "store_sales"),
    "q3d": ("q3", ("date_dim", "store_sales", "item"), "store_sales"),
    "q19d": ("q19", ("date_dim", "store_sales", "item", "customer",
                     "customer_address", "store"), "store_sales"),
    "q7d": ("q7", ("store_sales", "customer_demographics", "date_dim",
                   "item", "promotion"), "store_sales"),
}
#: the queries whose K9 folds min and max (K9 entries name the JAX
#: reductions beside the keyed program)
MIN_MAX_QUERIES = ("q35v",)
#: the queries that must join on a string key (K10)
STRING_JOIN_QUERIES = ("q6",)
#: keyword arguments of a query's recipe and numpy version: q17v is q17
#: with its ``sr_item_sk = cs_item_sk`` conjunct dropped, q35v is q35
#: with ``d_year = 2001`` (as written it keeps no row)
QUERY_KW = {"q17v": {"same_item": False}, "q35v": {"year": 2001}}
#: the rows each query gives at sf 1000 (q3: at least; q17 as written:
#: whatever numpy gives, none at sf 1 to 20)
QUERY_ROWS = {"q3": 10, "q1": 100, "q7": 100, "q15": 40, "q12": 100,
              "q20": 100, "q13": 1, "q19": 100, "q16": 1, "q17": None,
              "q17v": 100, "q10": 100, "q18": 100, "q6": 10, "q28": 1,
              "q36": 100, "q51": 100, "q51w": 1, "q8": 9, "q5": 100,
              "q35": 0, "q35v": 100, "q3d": 10, "q19d": 100, "q7d": 100}
#: phases 4 to 9g, in bench.py's TPC-DS order within each slice
TPCDS_ORDER = ("q3", "q1", "q7", "q15", "q12", "q20", "q13", "q19", "q16",
               "q17", "q17v", "q10", "q18", "q6", "q28", "q36", "q51",
               "q51w", "q8", "q5", "q35", "q35v", "q3d", "q19d", "q7d")
#: the queries run at a scale of their own (at most ``--sf``), their CPU
#: run held against a card run at a tenth of it: q5's web returns join
#: web_sales on a page drawn from 60 values on both sides, about
#: 1.07e5 * sf^2 rows, so sf 1000 would give 1.07e11 rows
OWN_SF = {"q5": 10.0}


#: each generated column's host form, by the id of its numpy array (the
#: queries' cuts share the generator's arrays): a string column is encoded
#: once for every query that reads it, not once per query and run
_HOST_COLUMNS = {}


def host_tables(tables):
    """A query's tables (the generator's column dicts) as host batches,
    each column built once (``_HOST_COLUMNS``)."""
    from spark_rapids_tpu_torch.columnar.batch import (HostColumnarBatch,
                                                       host_column)
    out = {}
    for name, cols in tables.items():
        built = []
        for values in cols.values():
            key = id(values)
            if key not in _HOST_COLUMNS:
                # the array is kept with its column, so its id stays its own
                _HOST_COLUMNS[key] = (values, host_column(values))
            built.append(_HOST_COLUMNS[key][1])
        out[name] = HostColumnarBatch(built, len(built[0]), list(cols))
    return out


def recipe_of(tpcds, name: str):
    """A query's recipe: q20 is q12's over catalog_sales, q17v q17's
    with ``same_item=False``."""
    if name == "q20":
        return lambda *dfs: tpcds.q12(*dfs, prefix="cs")
    kw = QUERY_KW.get(name, {})
    recipe = getattr(tpcds, QUERIES[name][0])
    return lambda *dfs: recipe(*dfs, **kw)


def run_query(session, query: str, tables, rate: float,
              full_size: bool = True, cross_tables=None, parts: int = 1,
              reference=None, parquet_root=None):
    """Phases 4 to 10: one TPC-DS query over ``tables`` (the generator's
    output, cut to the query's columns) through TorchSession(); checks it
    against numpy and the CPU run, and times its kernels.  With
    ``cross_tables`` (the same cut of smaller tables) the CPU run is held
    against a card run over those instead of the full-size one.  With
    ``parts`` > 1 (phase 10) the tables are cut into that many partitions
    (``testing/tpcds.py partitioned_frames``) and the rows are held
    against ``reference``, the one-partition card run's rows and numpy's.
    With ``parquet_root`` (phase 9e) the tables are read from the files
    there (``testing/tpcds.py parquet_frames``, the scan cache on), the
    rows held against ``reference``, the in-memory run's rows and
    numpy's.  Returns the launches, the kernels' timings and the rows."""
    import torch
    from spark_rapids_tpu_torch.columnar import encoding as ENC
    from spark_rapids_tpu_torch.exec.stage_compiler import stats as kstats
    from spark_rapids_tpu_torch.testing import tpcds
    recipe_name, names, fact = QUERIES[query]
    recipe = recipe_of(tpcds, query)
    numpy_kw = QUERY_KW.get(query, {})

    raw = tables

    def numpy_query():
        return getattr(tpcds, f"{recipe_name}_numpy")(raw, **numpy_kw)
    rows = {t: len(next(iter(tables[t].values()))) for t in names}
    t_tables = time.perf_counter()
    if parquet_root is None:
        tables = host_tables({t: tables[t] for t in names})
    t_tables = time.perf_counter() - t_tables
    torch.cuda.reset_peak_memory_stats()
    label = query if parts == 1 else f"{query} at {parts} partitions"
    if parquet_root is not None:
        label = f"{query} from parquet"
        dfs = tpcds.parquet_frames(session, parquet_root,
                                   {t: list(tables[t]) for t in names})
        device_bytes = scan_and_upload(session, dfs, label)
    else:
        dfs = tpcds.partitioned_frames(session, tables, names, parts) \
            if parts > 1 else [session.create_dataframe(tables[t])
                               for t in names]

    def run():
        return recipe(*dfs)[0].collect()
    t0 = time.perf_counter()
    first = run()
    first_s = time.perf_counter() - t0
    if parquet_root is None:
        device_bytes = sum(column_bytes(c) for df in dfs for part in
                           df._plan.device_cache[str(session.device)]
                           for b in part for c in b.columns)
    print(f"{label}: rows {rows}; {device_bytes} B of device columns; "
          f"first action (upload, builds, query) {first_s:.3f} s")

    import importlib
    counters = [(*counter_of(k), k) for k in COUNTERS]
    for mod, attr, _k in counters:
        setattr(mod, attr, 0)
    ooc = [(importlib.import_module(f"spark_rapids_tpu_torch.{m}"), a)
           for m, a in OOC_COUNTERS]
    for mod, attr in ooc:
        setattr(mod, attr, 0)
    mm_mod = importlib.import_module(
        f"spark_rapids_tpu_torch.{MIN_MAX_COUNTER[0]}")
    setattr(mm_mod, MIN_MAX_COUNTER[1], 0)
    dec = {k: (importlib.import_module(f"spark_rapids_tpu_torch.{m}"), a)
           for k, (m, a) in DECIMAL_COUNTERS.items()}
    for mod, attr in dec.values():
        setattr(mod, attr, 0)
    tr0, ks0, enc0 = session.transfers.stats(), kstats(), \
        ENC.encoding_stats()
    t0 = time.perf_counter()
    result = run()
    main_s = time.perf_counter() - t0
    launched = {k: getattr(mod, attr) for mod, attr, k in counters}
    min_max_launches = getattr(mm_mod, MIN_MAX_COUNTER[1])
    decimal_launches = {k: getattr(mod, a) for k, (mod, a) in dec.items()}
    out_of_core = {a: getattr(mod, a) for mod, a in ooc}
    check(not any(out_of_core.values()), f"{label} keeps its fast paths "
          f"with the default pool: {out_of_core}")
    enc1 = ENC.encoding_stats()
    # the kernels the query must launch, and any other it did launch
    required = PARQUET_KERNELS[query] if parquet_root is not None else \
        QUERY_KERNELS[query] + (() if parts == 1 else tuple(
            k for k in PARTS_KERNELS.get(query, PARTS_DEFAULT_KERNELS)
            if k not in QUERY_KERNELS[query]))
    kernels = required + tuple(
        k for k in COUNTERS if k not in required and launched[k])
    launches = {k: launched[k] for k in kernels}
    tr1, ks1 = session.transfers.stats(), kstats()
    syncs = tr1["syncs"] - tr0["syncs"]
    builds = ks1["builds"] - ks0["builds"]
    print(f"{label} main path: {main_s * 1e3:.3f} ms, {len(result)} rows, "
          f"launches {launches}, transfers "
          f"{({k: tr1[k] - tr0[k] for k in tr1})}, builds {builds}")
    for k, n in launches.items():
        check(n > 0, f"{label} launched {k}: {launches}")
    if query in DECIMAL_QUERIES:
        print(f"{label}: the decimal forms' launches on the main path "
              f"{decimal_launches}")
        for k in DECIMAL_QUERIES[query]:
            check(decimal_launches[k] > 0, f"{label} launched {k}: "
                  f"{decimal_launches}")
    if parquet_root is not None:
        decoded = {c: n - enc0["decoded_columns"].get(c, 0)
                   for c, n in enc1["decoded_columns"].items()
                   if n != enc0["decoded_columns"].get(c, 0)}
        print(f"{label} encoding counters of the main run: decoded bytes "
              f"{enc1['decoded_bytes'] - enc0['decoded_bytes']}, K16 "
              f"launches {launches.get('K16', 0)}, K5 code-space launches "
              f"{launches.get('K5d', 0)}, columns decoded {decoded}")
        if query == "q7":
            check(not set(decoded) & set(Q7_CODE_SPACE_COLUMNS),
                  f"q7's filtered columns never decode: {decoded}")
    check(builds == 0, f"a repeated {label} builds nothing")
    check(result == first, f"a repeated {label} gives the same rows")
    want = QUERY_ROWS[query]
    if want is None:
        pass   # numpy says how many
    elif query in ("q3", "q3d") or not full_size:
        check(len(result) >= min(want, 10), f"{query} gives at least "
              f"{min(want, 10)} rows: {len(result)}")
    else:
        check(len(result) == want, f"{query} gives {want} rows: "
              f"{len(result)}")

    stage = {"host tables": t_tables,
             "first and main": time.perf_counter() - t0 + first_s}
    t_stage = time.perf_counter()
    reps = PARTS_REPS if parts > 1 else \
        TPCDS_REPS if query not in NEW_QUERIES else \
        2 if main_s > 2 else NEW_REPS
    if query in NEW_QUERIES and main_s > 2:
        print(f"{label}: one run took {main_s:.3f} s (over 2 s): "
              f"{reps} timed runs")
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    best, median = min(times), float(np.median(times))

    if reference is not None:
        against = "the in-memory card run" if parquet_root is not None \
            else "its one-partition card run"
        rows_match(reference["numpy"], result, f"{label} vs numpy")
        rows_match(reference["rows"], result, f"{label} vs {against}")
        print(f"{label} matches numpy and {against}; first rows "
              f"{result[:2]}")
        numpy_rows = reference["numpy"]
    else:
        numpy_rows = check_against_cpu(query, recipe, names, tables,
                                       cross_tables, session, result,
                                       numpy_query)
    stage["timed runs and checks"] = time.perf_counter() - t_stage
    t_stage = time.perf_counter()
    device_ms = profile_query(label, run, kernels)
    stage["profile"] = time.perf_counter() - t_stage
    t_stage = time.perf_counter()
    with Recorder() as rec:
        run()
    recorded = {k: sum(K14O_PARTS.get(c[0], c[0]) == k for c in rec.calls)
                for k in kernels}
    check(recorded == launches, f"every launch of the {label} main path "
          f"was recorded: {recorded} vs {launches}")
    from spark_rapids_tpu_torch.ops import agg_ops as G
    recorded_mm = sum(c[0] == "K9" and any(k in G.KEYED_KEEPS_TYPE
                                           for k in c[1][2])
                      for c in rec.calls)
    check(recorded_mm == min_max_launches, f"{label}: K9's launches with a "
          f"min, max, first or last slot, {min_max_launches} on the main "
          f"path, {recorded_mm} recorded")
    if query in MIN_MAX_QUERIES:
        check(min_max_launches > 0, f"{label} launched K9's min, max, "
              f"first and last kinds")
        print(f"{label}: {min_max_launches} of K9's launches on the main "
              f"path have a min, max, first or last slot")
    if query in STRING_JOIN_QUERIES:
        from spark_rapids_tpu_torch.ops.join_ops import key_list
        check(any(k == "K10" and any(c.is_string for c in key_list(a[0]))
                  for k, a, _kw in rec.calls),
              f"{query} launched K10 with a string key")
    timed = time_kernels(session, rec.calls, rate, 5 if parts == 1 else 3,
                         kernels)
    stage["kernels vs plain, timed"] = time.perf_counter() - t_stage
    print(f"{label} seconds by stage: "
          f"{({k: round(v, 1) for k, v in stage.items()})}")
    print(f"{label} kernels vs plain on the main path's {len(rec.calls)} "
          f"calls: pass, max |d| "
          f"{({k: o['max_abs_err'] for k, o in timed.items()})}")
    print(f"{label} best of {reps}: {best * 1e3:.3f} ms, median "
          f"{median * 1e3:.3f} ms, {rows[fact] / best:.6e} {fact} rows/s; "
          f"{syncs} syncs and {builds} builds per query; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    for k, o in timed.items():
        o["device_ms"] = device_ms[k]
        print(f"  {k}: {o['ms']:.4f} ms per query over {launches[k]} "
              f"launches (per launch: {'; '.join(o['shapes'])}), plain "
              f"{o['plain_ms']:.4f} ms, bound {o['bound_ms']:.6f} ms "
              f"({o['bytes']} B), library {o['library_ms']}")
    kernel_ms = sum(o["ms"] for o in timed.values())
    print(f"{label} breakdown: kernels {kernel_ms:.4f} ms (each timed "
          f"alone, syncs inside), rest {best * 1e3 - kernel_ms:.4f} ms of "
          f"{best * 1e3:.4f} ms")
    return launches, timed, {"rows": result, "numpy": numpy_rows,
                             "peak": torch.cuda.max_memory_allocated()
                             / 2 ** 30, "min_max_launches": min_max_launches,
                             "decimal_launches": decimal_launches}


def scan_and_upload(session, dfs, label: str) -> int:
    """Phase 9e: each table's parquet read on the host, then its upload
    (the scan cache on, so the query's runs find both), timed apart, with
    the encoding counters of the upload; returns the device bytes of the
    uploaded columns (codes for a dictionary column)."""
    import torch
    from spark_rapids_tpu_torch.columnar import encoding as ENC
    from spark_rapids_tpu_torch.plan.base import ExecContext
    enc0 = ENC.encoding_stats()
    t0 = time.perf_counter()
    for df in dfs:
        scan = df._plan.scan
        for p in range(scan.num_partitions):
            list(scan.execute_partition(
                p, ENC.EncodingSettings.of(session.conf)))
    host_s = time.perf_counter() - t0
    tr0 = session.transfers.stats()
    t0 = time.perf_counter()
    ctx = ExecContext(session.device, session.transfers)
    batches = [b for df in dfs for part in df.executed_plan().execute(ctx)
               for b in part]
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    tr1, enc1 = session.transfers.stats(), ENC.encoding_stats()
    delta = {k: enc1[k] - enc0[k] for k in enc1
             if isinstance(enc1[k], int)}
    print(f"{label}: parquet read on the host {host_s * 1e3:.3f} ms, "
          f"upload {upload_s * 1e3:.3f} ms ({len(batches)} batches, "
          f"{tr1['h2d_bytes'] - tr0['h2d_bytes']} B over "
          f"{tr1['h2d_copies'] - tr0['h2d_copies']} copies); encoded "
          f"columns {delta['encoded_columns']}, bytes of codes and "
          f"dictionaries sent {delta['encoded_bytes_in']} against plain "
          f"bytes avoided {delta['decode_avoided_bytes']}, dictionary "
          f"fallbacks {delta['dict_fallbacks']} "
          f"{enc1['fallback_reasons']}")
    return sum(column_bytes(c) for b in batches for c in b.columns)


def write_parquet(tpcds, cuts, sf: float) -> str:
    """Phase 9e: the columns the parquet queries read, of the tables the
    in-memory queries ran over, written as the JAX package's
    ``register_tables(storage="parquet")`` writes them (one part a
    table at one partition, pyarrow's default row groups) under the
    git-ignored ``build/``; the scan cache goes on."""
    import shutil
    from spark_rapids_tpu_torch.io import multifile
    from spark_rapids_tpu_torch.kernels.build import build_dir
    root = str(build_dir(f"parquet_sf{sf:g}"))
    shutil.rmtree(root)
    merged = {}
    for cut in cuts.values():
        for t, cols in cut.items():
            merged.setdefault(t, {}).update(cols)
    t0 = time.perf_counter()
    tpcds.write_parquet_tables(merged, root, 1)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _s, fs in os.walk(root) for f in fs)
    print(f"phase 9e: {sum(len(c) for c in merged.values())} columns of "
          f"{len(merged)} tables written to parquet in "
          f"{time.perf_counter() - t0:.1f} s ({size} B)")
    multifile.enable_scan_cache(True)
    return root


def drop_parquet(root: str) -> None:
    """Phase 9e's end: the scan cache off (what it held dropped) and the
    files deleted."""
    import shutil
    from spark_rapids_tpu_torch.io import multifile
    multifile.enable_scan_cache(False)
    shutil.rmtree(root, ignore_errors=True)


def check_against_cpu(query, recipe, names, tables, cross_tables, session,
                      result, numpy_query):
    """Phases 4 to 9: the rows against numpy and the CPU run (over
    ``cross_tables`` against a card run over them where given); returns
    numpy's rows."""
    from spark_rapids_tpu_torch import TorchSession
    numpy_rows = numpy_query()
    rows_match(numpy_rows, result, f"{query} vs numpy")
    cpu = TorchSession(device="cpu")
    t0 = time.perf_counter()
    small = tables if cross_tables is None else \
        host_tables({t: cross_tables[t] for t in names})
    cpu_rows = recipe(*[cpu.create_dataframe(small[t])
                        for t in names])[0].collect()
    cpu_s = time.perf_counter() - t0
    card_rows = result if cross_tables is None else recipe(*[
        session.create_dataframe(small[t]) for t in names])[0].collect()
    rows_match(cpu_rows, card_rows, f"{query} vs the CPU run")
    scale = "" if cross_tables is None else \
        f" (the CPU run against a card run over the smaller tables, " \
        f"{len(card_rows)} rows)"
    print(f"{query} matches numpy and the CPU run{scale} ({cpu_s:.1f} s); "
          f"first rows {result[:2]}")
    return numpy_rows


SLICE15_ROWS = (1 << 20) + 3
#: phase 2o's collect groups: 4096, and one group of every row
SLICE15_GROUPS = (4096, 1)


def check_slice15(session, rng, rate: float):
    """Phase 2o: K13's length pass, its case maps (upper, lower) and its
    substring by characters at every pos class, each also through a row
    map, over 2**20 + 3 rows of 0- to 40-byte strings (``testing/
    text_cases.py``: ASCII, 'é', 'ß', 'İ', sigma final and inner,
    case-ignorable marks, CJK, emoji, bytes outside UTF-8, 10% nulls);
    the substring view in K6 and K5, compared byte by byte with K13's
    written substrings; K15 in list and set mode over 4096 groups and one
    group of every row on long, int, date, boolean, double (NaN, +-0.0,
    +-inf) and decimal64 values with 15% nulls -- each against its plain
    version, bit for bit.  Then each timed at that size.  Returns the max
    |d| of each and the timings (library: ``torch.unique(dim=0)`` over
    the stacked (group, value) rows for a set; none for the others)."""
    import torch
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.exec import fused as FU
    from spark_rapids_tpu_torch.ops import agg_ops as G
    from spark_rapids_tpu_torch.ops import string_ops as SO
    from spark_rapids_tpu_torch.testing import text_cases as TC
    tr, dev = session.transfers, session.device
    n = SLICE15_ROWS
    err = {k: 0.0 for k in ("K13l", "K13 case", "K13 substring", "K6 view",
                            "K5 view", "K15", "K15s")}
    timed = {}
    a = tr.upload_column(TC.string_column(rng, n))
    rows = torch.from_numpy(rng.integers(0, n, n // 3)).to(dev)
    for r in (None, rows):
        m = n if r is None else r.shape[0]
        got = SO.string_length(a, m, r)
        torch.cuda.synchronize()
        err["K13l"] = max(err["K13l"], same_columns(
            [got], [SO.string_length_plain(a, m, r)], f"K13 length, {m} rows"))
        for op, kw in [(SO.UPPER, {}), (SO.LOWER, {})] + [
                (SO.SUBSTRING, {"pos": p, "length": ln})
                for p, ln in TC.SUBSTRINGS]:
            got = SO.string_column(op, [a], m, dev, tr, rows=r, **kw)
            torch.cuda.synchronize()
            key = "K13 substring" if op == SO.SUBSTRING else "K13 case"
            err[key] = max(err[key], same_columns(
                [got], [SO.string_column_plain(op, [a], m, dev, tr, rows=r,
                                               **kw)],
                f"K13 op {op} {kw}, {m} rows"))
    # the view: K6 and K5 compare it with K13's written substrings
    written = [SO.string_column(SO.SUBSTRING, [a], n, dev, tr, pos=p,
                                length=ln) for p, ln in TC.SUBSTRINGS]
    schema = T.StructType([T.StructField("s", T.STRING)] + [
        T.StructField(f"w{j}", T.STRING) for j in range(len(written))])
    batch = ColumnarBatch([a] + written, n, schema.names)
    lits = FU.LiteralArgs([])
    present = int(a.validity.sum())
    k6 = TC.view_program(schema, TC.SUBSTRINGS, False)
    got = FU.fused_project(k6, batch, lits)
    torch.cuda.synchronize()
    err["K6 view"] = same_columns(got, FU.fused_project_plain(k6, batch,
                                                              lits),
                                  "K6 substring views")
    for c in got[:-1]:
        check(bool((c.data | ~c.validity).all()) and
              int(c.validity.sum()) == present,
              "K6: each substring view equals K13's written substring")
    k5 = TC.view_program(schema, TC.SUBSTRINGS, True)
    got5 = FU.fused_stage_compact(k5, batch, lits, tr)
    torch.cuda.synchronize()
    ref5 = FU.fused_stage_compact_plain(k5, batch, lits, tr)
    err["K5 view"] = max(same_indices(got5[0], ref5[0], "K5 view survivors"),
                         same_columns(got5[1], ref5[1], "K5 view outputs"))
    check(got5[0].shape[0] == present, f"K5: every present row passes its "
          f"substring views ({got5[0].shape[0]} of {present})")
    # K15: list and set, 4096 groups and one group
    for kind in TC.COLLECT_TYPES:
        v = tr.upload_column(TC.collect_values(rng, kind, n))
        for groups in SLICE15_GROUPS:
            gid = None if groups == 1 else \
                torch.from_numpy(rng.integers(0, groups, n)).to(dev)
            for distinct in (False, True):
                got = G.collect(v, gid, groups, distinct, tr)
                torch.cuda.synchronize()
                key = "K15s" if distinct else "K15"
                err[key] = max(err[key], same_columns(
                    [got], [G.collect_plain(v, gid, groups, distinct, tr)],
                    f"K15 {kind}, {groups} groups, set {distinct}"))
    # times at 2**20 + 3 rows
    m = n
    for what, op, kw in (("K13 upper", SO.UPPER, {}),
                         ("K13 lower", SO.LOWER, {}),
                         ("K13 substring", SO.SUBSTRING,
                          {"pos": 1, "length": 4})):
        out = SO.string_column(op, [a], m, dev, tr, **kw)
        timed[what] = (
            time_ms(lambda: SO.string_column(op, [a], m, dev, tr, **kw), 10),
            time_ms(lambda: SO.string_column_plain(op, [a], m, dev, tr,
                                                   **kw), 2, 1),
            k13_bytes((op, [a], m), kw, out) / rate * 1e3, None)
    timed["K13 length"] = (
        time_ms(lambda: SO.string_length(a, m), 20),
        time_ms(lambda: SO.string_length_plain(a, m), 3, 1),
        k13l_bytes(a, m) / rate * 1e3, None)
    # the views: K6's reads of s and the written substrings, its bytes out
    k6_bytes = sum(column_bytes(c) for c in batch.columns) + \
        2 * m * (len(written) + 1)
    timed["K6 view"] = (
        time_ms(lambda: FU.fused_project(k6, batch, lits), 10),
        time_ms(lambda: FU.fused_project_plain(k6, batch, lits), 2, 1),
        k6_bytes / rate * 1e3, None)
    v = tr.upload_column(TC.collect_values(rng, "long", n))
    gid = torch.from_numpy(rng.integers(0, 4096, n)).to(dev)
    for what, g, groups, distinct in (("K15 list", gid, 4096, False),
                                      ("K15 set", gid, 4096, True),
                                      ("K15 set one group", None, 1, True)):
        out = G.collect(v, g, groups, distinct, tr)
        timed[what] = (
            time_ms(lambda: G.collect(v, g, groups, distinct, tr), 10),
            time_ms(lambda: G.collect_plain(v, g, groups, distinct, tr), 3,
                    1),
            k15_bytes(v, g, out) / rate * 1e3,
            time_ms(k15_library(v, g), 5) if distinct else None)
    return err, timed


#: phase 9i: ScaleTest's fact rows (the largest whose skew join fits the
#: card: PERF.md section 4), the rows of its check against the CPU run,
#: its timed runs
SCALE_ROWS = 500_000
SCALE_CHECK_ROWS = 50_000
SCALE_REPS = 3
#: the kernels of this slice each query's main path must launch
SCALE_KERNELS = {"collect_set": ("K15s",), "filter_project": ("K13l",),
                 "string_ops": ("K13",)}
#: the queries of tens of seconds a run (skew_join: K9 folds 676 groups of
#: about 590,000 rows on one thread each): no warm-up (every kernel they
#: run is built by then) and best of 2, to keep the script inside its time
SCALE_SLOW = ("skew_join",)
#: the queries phase 9i profiles (one run each): the slowest, and the two
#: that run this slice's kernels most
SCALE_PROFILED = ("skew_join", "join_two_dims", "rollup", "agg_multi",
                  "collect_set", "string_ops")


def scale_counts(rows: int, seed: int = 7) -> dict:
    """Each ScaleTest query's row count from the generated planes, in
    numpy (the joins from key counts, the group-bys from distinct keys, a
    null a key of its own)."""
    from spark_rapids_tpu_torch.testing import datagen as PD
    from spark_rapids_tpu_torch.testing import scaletest as ST
    specs = ST.table_specs(rows, seed)
    t = {name: PD.gen_batch(g, n, s_) for name, (g, n, s_, _p) in
         specs.items()}
    fact, dim, dim2 = t["fact"], t["dim"], t["dim2"]

    def planes(hb, name):
        c = hb.columns[hb.names.index(name)]
        return c.data, (np.ones(len(c), bool) if c.validity is None
                        else c.validity)
    fkey, _ = planes(fact, "key")
    dkey, _ = planes(dim, "key")
    key2, key2_ok = planes(fact, "key2")
    v2, v2_ok = planes(fact, "v2")
    # the keys hold the generator's specials (the int64 extremes) too
    keys = np.unique(np.concatenate([fkey, dkey]))
    cf = np.bincount(np.searchsorted(keys, fkey), minlength=len(keys))
    cd = np.bincount(np.searchsorted(keys, dkey), minlength=len(keys))
    inner = int((cf * cd).sum())
    left = inner + int(cf[cd == 0].sum())
    full = left + int(cd[cf == 0].sum())
    matched = cd[np.searchsorted(keys, fkey)] > 0

    def distinct_keys(k, ok):
        return len(np.unique(k[ok])) + int((~ok).any())
    groups = distinct_keys(key2, key2_ok)
    dname = dim.columns[dim.names.index("name")].to_pylist()
    d2key, _ = planes(dim2, "key2")
    grp = dim2.columns[dim2.names.index("grp")].to_pylist()
    joined_key2 = set(key2[key2_ok & matched].tolist())
    s_vals = fact.columns[fact.names.index("s")].to_pylist()
    d, d_ok = planes(fact, "d")
    pos, small = v2_ok & (v2 > 0), v2_ok & (v2 < 500)
    both = set(key2[pos & key2_ok].tolist()) & \
        set(key2[small & key2_ok].tolist())
    null_both = bool((pos & ~key2_ok).any() and (small & ~key2_ok).any())
    pairs = set(zip(key2.tolist(), key2_ok.tolist(), s_vals))
    rollup = len({(k if ok else None, s_) for k, ok, s_ in pairs}) + \
        groups + 1
    return {
        "agg_sum": groups, "agg_multi": groups, "join_inner": inner,
        "join_left": left,
        "join_two_dims": len({g_ for k, g_ in zip(d2key.tolist(), grp)
                              if k in joined_key2}),
        "sort_limit": min(100, rows), "filter_project": int(pos.sum()),
        "distinct": groups, "window_rank": rows, "union_count": groups,
        "join_full": full, "join_semi": int(cf[cd > 0].sum()),
        "join_anti": int(cf[cd == 0].sum()), "window_running_sum": rows,
        "window_bounded": rows, "window_lag_lead": rows,
        "rollup": rollup, "count_distinct": groups, "collect_set": groups,
        "string_ops": len({None if x is None else x[:4] for x in s_vals}),
        "skew_join": len({nm for k, nm in zip(dkey.tolist(), dname)
                          if k == 0}),
        "intersect": len(both) + int(null_both),
        "range_sort": rows,
        "date_agg": min(50, distinct_keys(d, d_ok)),
    }


def run_scaletest(session, rate: float, rows: int, check_rows: int,
                  reps: int):
    """Phase 9i: ScaleTest's 24 queries through ``testing/scaletest.py``'s
    own ``run_scale_test`` over ``build_tables(session, rows)`` (seed 7,
    2 partitions): per query one warm-up, then ``reps`` timed runs (a
    ``SCALE_SLOW`` query no warm-up and 2), the first of them the main
    path (every launch counter set to 0 just
    before it and read just after), its syncs and peak memory; each row
    count against numpy (``scale_counts``); this slice's kernels launched
    where ``SCALE_KERNELS`` says, and their main-path calls held against
    their plain versions and timed.  Then all 24 queries at
    ``check_rows`` on the card against the port's CPU run (``scaletest.
    rows_agree``), every kernel call of that run against its plain
    version.  Returns (per-query report, the new kernels' timings, their
    main-path launches, the max |d| of every kernel at the check size)."""
    import torch
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch.ops import string_ops as SO
    from spark_rapids_tpu_torch.testing import scaletest as ST
    t0 = time.perf_counter()
    tables = ST.build_tables(session, rows)
    expected = scale_counts(rows)
    print(f"9i: ScaleTest tables at {rows} fact rows built on the host in "
          f"{time.perf_counter() - t0:.1f} s")
    report, launched = {}, {}
    names = ST.QUERY_NAMES
    for name in names:
        q0 = time.perf_counter()
        slow = name in SCALE_SLOW
        if not slow:
            warm = ST.run_scale_test(session, queries=[name], tables=tables)
            check(warm[0]["status"] == "OK", f"9i {name} warm-up: "
                  f"{warm[0]['status']}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in COUNTERS:
            setattr(*counter_of(k), 0)
        SO.CASE_LAUNCHES = SO.SUBSTRING_LAUNCHES = 0
        tr0 = session.transfers.stats()
        main = ST.run_scale_test(session, queries=[name], tables=tables)
        launches = {k: getattr(*counter_of(k)) for k in COUNTERS
                    if getattr(*counter_of(k))}
        launches["K13 case"] = SO.CASE_LAUNCHES
        launches["K13 substring"] = SO.SUBSTRING_LAUNCHES
        tr1 = session.transfers.stats()
        peak = torch.cuda.max_memory_allocated()
        rest = ST.run_scale_test(session, queries=[name], tables=tables,
                                 iterations=(2 if slow else reps) - 1)
        runs = main + rest
        for r in runs:
            check(r["status"] == "OK", f"9i {name}: {r['status']}")
        secs = [r["seconds"] for r in runs]
        got_rows = main[0]["rows"]
        check(got_rows == expected[name], f"9i {name}: {got_rows} rows, "
              f"numpy says {expected[name]}")
        for k in SCALE_KERNELS.get(name, ()):
            check(launches.get(k, 0) > 0, f"9i {name}: {k} launched on the "
                  f"main path ({launches})")
        if name == "string_ops":
            check(launches["K13 case"] > 0 and launches["K13 substring"] > 0,
                  f"9i string_ops: K13's upper and substring launched "
                  f"({launches})")
        launched[name] = launches
        report[name] = {"ms_best": min(secs) * 1e3,
                        "ms_median": float(np.median(secs)) * 1e3,
                        "rows": got_rows,
                        "syncs": tr1["syncs"] - tr0["syncs"],
                        "peak_gib": peak / 2 ** 30, "launches": {
                            k: v for k, v in launches.items() if v}}
        print(f"9i {name}: best {min(secs) * 1e3:.3f} ms, median "
              f"{float(np.median(secs)) * 1e3:.3f} ms of {len(secs)}, rows "
              f"{got_rows}, syncs {tr1['syncs'] - tr0['syncs']}, peak "
              f"{peak / 2 ** 30:.3f} GiB, launches "
              f"{report[name]['launches']} "
              f"({time.perf_counter() - q0:.1f} s)")
    # device time by kernel and idle share of the slowest queries
    queries = dict(ST._queries())
    for name in SCALE_PROFILED:
        report[name]["device_ms"] = profile_query(
            f"9i {name}", lambda q=queries[name]: q(tables).collect_batch(),
            sorted(k for k in report[name]["launches"] if k in COUNTERS),
            reps=1)
    # this slice's kernels at the main path's shapes
    new = ("K15s", "K13l", "K13")
    with Recorder() as rec:
        for name in SCALE_KERNELS:
            ST.run_scale_test(session, queries=[name], tables=tables)
    calls = [c for c in rec.calls if c[0] in new]
    timed = time_kernels(session, calls, rate, 5, new)
    for k, o in timed.items():
        print(f"9i {k} at the main path's shapes: {o['ms']:.4f} ms over "
              f"{len(o['shapes'])} calls ({'; '.join(o['shapes'])}), plain "
              f"{o['plain_ms']:.4f} ms, bound {o['bound_ms']:.6f} ms, "
              f"library {o['library_ms']}, max |d| {o['max_abs_err']}")
    del tables
    # rows at check_rows: the card against the port's CPU run
    t0 = time.perf_counter()
    cpu = TorchSession(device="cpu")
    card_t = ST.build_tables(session, check_rows)
    card_abs = ST.abs_tables(session, check_rows)
    cpu_t = ST.build_tables(cpu, check_rows)
    errs = {}
    with Recorder() as rec:
        card_rows = {name: q(card_t).collect() for name, q in ST._queries()}
    for name, q in ST._queries():
        bounds = q(card_abs).collect() if name in ST.SUMS else None
        diff = ST.rows_agree(name, card_rows[name], q(cpu_t).collect(),
                             bounds)
        check(diff is None, f"9i at {check_rows} rows: {diff}")
    kinds = sorted({K14O_PARTS.get(c[0], c[0]) for c in rec.calls})
    checked = time_kernels(session, rec.calls, rate, 0, kinds)
    for k, o in checked.items():
        errs[k] = o["max_abs_err"]
    print(f"9i: all {len(names)} queries at {check_rows} rows on the card "
          f"equal the CPU run; every kernel call of that run equals its "
          f"plain version: max |d| {errs} ({time.perf_counter() - t0:.1f} "
          "s)")
    return report, timed, launched, errs


def run_slice15(session, rate: float, phase):
    """Phases 2o and 9i, and the kernels line's entries of K15, K13's
    length, case maps and substring by characters and the substring
    view."""
    rng = np.random.default_rng(15)
    t0 = time.perf_counter()
    errs15, one = check_slice15(session, rng, rate)
    print(f"K15 (collect_list, collect_set: 4096 groups and one group; "
          f"long, int, date, boolean, double, decimal64), K13 (length, upper,"
          f" lower, substring by characters, through row maps), the "
          f"substring view in K6 and K5 against K13's written substrings, "
          f"vs plain: pass, bit for bit ({time.perf_counter() - t0:.1f} s), "
          f"max |d| {errs15}")
    for what, (ms_, plain_, bound_, lib_) in one.items():
        print(f"{what} ({SLICE15_ROWS} rows): {ms_:.4f} ms, plain "
              f"{plain_:.4f} ms, bound {bound_:.6f} ms, library {lib_}")
    phase("phase 2o checked")
    report, timed, launched, errs = run_scaletest(
        session, rate, SCALE_ROWS, SCALE_CHECK_ROWS, SCALE_REPS)
    print("9i report: " + json.dumps({"rows": SCALE_ROWS,
                                      "partitions": 2, "queries": report}))
    phase("phase 9i (ScaleTest) run, checked and timed")
    source = "spark_rapids_tpu_torch/csrc/"
    k13 = "spark_rapids_tpu/expressions/strings.py"
    collect_also = ["spark_rapids_tpu/ops/agg_ops.py:646",
                    "spark_rapids_tpu/ops/agg_ops.py:530"]

    def from_2o(what):
        ms_, plain_, bound_, lib_ = one[what]
        return {"ms": ms_, "plain_ms": plain_, "bound_ms": bound_,
                "library_ms": lib_}

    def from_path(k):
        o = timed[k]
        return {"ms": o["ms"], "plain_ms": o["plain_ms"],
                "bound_ms": o["bound_ms"], "library_ms": o["library_ms"]}

    def phase_2o(what):
        return {f"phase_2o_{k}": v for k, v in from_2o(what).items()}
    out = [
        dict(name="collect_set.scaletest", path="ScaleTest collect_set "
             f"(phase 9i, {SCALE_ROWS} rows)", route="cuda",
             source=source + "collect.cu",
             replaces="spark_rapids_tpu/ops/agg_ops.py:550",
             also_replaces=collect_also,
             launches=launched["collect_set"].get("K15s", 0),
             max_abs_err=max(errs15["K15s"], timed["K15s"]["max_abs_err"],
                             errs.get("K15s", 0.0)),
             **from_path("K15s"), bound_by="bytes", per="query",
             **phase_2o("K15 set"), passed=True),
        dict(name="collect_list", path="phase 2o (no query path)",
             route="cuda", source=source + "collect.cu",
             replaces="spark_rapids_tpu/ops/agg_ops.py:550",
             also_replaces=collect_also, launches=0,
             max_abs_err=errs15["K15"], **from_2o("K15 list"),
             bound_by="bytes", per="launch", passed=True),
        dict(name="string_length.scaletest", path="ScaleTest filter_project"
             f" (phase 9i, {SCALE_ROWS} rows)", route="cuda",
             source=source + "strings.cu", replaces=f"{k13}:49",
             launches=launched["filter_project"].get("K13l", 0),
             max_abs_err=max(errs15["K13l"], timed["K13l"]["max_abs_err"],
                             errs.get("K13l", 0.0)),
             **from_path("K13l"), bound_by="bytes", per="query",
             **phase_2o("K13 length"), passed=True),
        dict(name="string_column.scaletest", path="ScaleTest string_ops "
             f"(phase 9i, {SCALE_ROWS} rows: upper, substring and "
             "concat)", route="cuda", source=source + "strings.cu",
             replaces=f"{k13}:179", also_replaces=[f"{k13}:78",
                                                   f"{k13}:115"],
             launches=launched["string_ops"].get("K13", 0),
             max_abs_err=max(errs15["K13 case"], errs15["K13 substring"],
                             timed["K13"]["max_abs_err"],
                             errs.get("K13", 0.0)),
             **from_path("K13"), bound_by="bytes", per="query",
             passed=True),
        dict(name="string_case_map", path="ScaleTest string_ops (launches);"
             " phase 2o (times, upper)", route="cuda",
             source=source + "strings.cu", replaces=f"{k13}:78",
             launches=launched["string_ops"].get("K13 case", 0),
             max_abs_err=errs15["K13 case"], **from_2o("K13 upper"),
             bound_by="bytes", per="launch",
             lower_ms=one["K13 lower"][0],
             lower_plain_ms=one["K13 lower"][1],
             lower_bound_ms=one["K13 lower"][2], passed=True),
        dict(name="string_column.substring_chars", path="ScaleTest "
             "string_ops (launches); phase 2o (times, substring(s, 1, 4))",
             route="cuda", source=source + "strings.cu",
             replaces=f"{k13}:179",
             launches=launched["string_ops"].get("K13 substring", 0),
             max_abs_err=errs15["K13 substring"],
             **from_2o("K13 substring"), bound_by="bytes", per="launch",
             passed=True),
        dict(name="fused_project.substring_view", path="phase 2o (K6 and "
             "K5 against K13's written substrings; no ScaleTest query "
             "compares a substring)", route="triton",
             source="spark_rapids_tpu_torch/kernels/fused_agg.py",
             replaces="spark_rapids_tpu/expressions/strings.py:179",
             launches=0, max_abs_err=max(errs15["K6 view"],
                                         errs15["K5 view"]),
             **from_2o("K6 view"), bound_by="bytes", per="launch",
             passed=True),
    ]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=128_000_000)
    ap.add_argument("--parts", type=int, default=4,
                    help="partitions of the recipe's table and of phase "
                    "10's TPC-DS tables (bench.py's --parts)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sf", type=float, default=1000.0,
                    help="TPC-DS scale of the query phases (store_sales "
                    "30,000 rows per sf; the CPU cross-check of q3 to q18 "
                    "runs at a tenth of it)")
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
    from spark_rapids_tpu_torch.ops import batch_ops as BO

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

    # -- phase 2c: the slice-3 forms against their plain versions -----------
    t0 = time.perf_counter()
    errs3 = check_slice3(session, rng)
    print(f"K6, K5 (string =, OR), K8 (string keys), K10 (left outer), K7 "
          f"(-1 rows) vs plain: pass ({time.perf_counter() - t0:.1f} s), "
          f"max |d| {errs3}")

    # -- phase 2d: the slice-4 forms against their plain versions -----------
    t0 = time.perf_counter()
    errs4, k14_one = check_slice4(session, rng)
    print(f"K14, K6 and K5 (IN, substring views, <, <=, >=, dates), K9 "
          f"(double and five keys) vs plain: pass "
          f"({time.perf_counter() - t0:.1f} s), max |d| {errs4}")
    print(f"K14 on one partition of {SLICE3_SIZES[-1]} rows (a double sum): "
          f"{k14_one[0]:.4f} ms, bound {k14_one[1]:.6f} ms ({k14_one[2]} B)")

    # -- phase 2e: the slice-5 forms against their plain versions -----------
    t0 = time.perf_counter()
    errs5, k15d_one = check_slice5(session, rng, rate)
    print(f"K10 (semi, anti), K15d (keyed, global), K6 and K5 (<>, NOT, "
          f"string views compared), K1 (string columns) vs plain: pass "
          f"({time.perf_counter() - t0:.1f} s), max |d| {errs5}")
    shapes = {"keyed": "15000000 rows in 5000000 groups",
              "global": f"one group of {SLICE3_SIZES[-1]} rows"}
    for what, (ms_, plain_, bound_, lib_) in k15d_one.items():
        print(f"K15d {what} ({shapes[what]}): {ms_:.4f} ms, plain "
              f"{plain_:.4f} ms, bound {bound_:.6f} ms, library {lib_}")

    # -- phase 2f: the slice-6 forms against their plain versions -----------
    t0 = time.perf_counter()
    errs6, slice6_one = check_slice6(session, rng, rate)
    print(f"K7c, K9 (m2), K10 (two and three keys, four modes), K6 and K5 "
          f"(Subtract, Sqrt, null literals) vs plain: pass "
          f"({time.perf_counter() - t0:.1f} s), max |d| {errs6}")
    shapes = {"all columns": f"five slices of {SLICE3_SIZES[-1]} rows, "
                             "ten columns (three strings)",
              "fixed-width columns": f"five slices of {SLICE3_SIZES[-1]} "
                                     "rows, seven fixed-width columns",
              "m2": f"one group of {SLICE3_SIZES[-1]} rows near 1e9"}
    for what, (ms_, plain_, bound_, lib_) in slice6_one.items():
        kernel = "K9 m2" if what == "m2" else "K7c"
        print(f"{kernel} ({shapes[what]}): {ms_:.4f} ms, plain "
              f"{plain_:.4f} ms, bound {bound_:.6f} ms, library {lib_}")

    # -- phase 2g: the slice-7 forms against their plain versions -----------
    t0 = time.perf_counter()
    errs7, slice7_one = check_slice7(session, rng, rate)
    print(f"K14r (ranking), K10x (cross pairs), K10 (string keys), K6 and "
          f"K5 (div, %, CASE WHEN) vs plain: pass "
          f"({time.perf_counter() - t0:.1f} s), max |d| {errs7}")
    shapes = {"rank": f"one partition of {SLICE3_SIZES[-1]} rows, peers "
                      "of 7, three functions",
              "cross": "3001 x 1024 pairs",
              "string 65536": "65536 build x 1000000 probe string keys "
                              "(keys repeated up to about 1,600 times)",
              "string 65536 distinct": "65536 distinct build x 1000000 "
                                       "probe string keys",
              "string 16": "16 build x 1000000 probe string keys"}
    for what, (ms_, plain_, bound_, lib_) in slice7_one.items():
        kernel = {"rank": "K14r", "cross": "K10x"}.get(what, "K10")
        print(f"{kernel} ({shapes[what]}): {ms_:.4f} ms, plain "
              f"{plain_:.4f} ms, bound {bound_:.6f} ms, library {lib_}")

    # -- phase 2h: the slice-8 kernels against their plain versions ---------
    t0 = time.perf_counter()
    errs8, slice8_one = check_slice8(session, rng, rate)
    print(f"K11h (every key type), K11r, K7s, K9 (merge kinds) vs plain: "
          f"pass ({time.perf_counter() - t0:.1f} s), max |d| {errs8}")
    shapes = {"K11h": "1000000 rows, one long key, 200 partitions",
              "K11r": "1000000 rows, one long key, 199 bounds",
              "K7s": "1000000 rows of three fixed-width columns, 4 "
                     "partitions",
              "merge": "4000000 partial rows (sums, counts, Chan) into "
                       "1000000 groups"}
    for what, (ms_, plain_, bound_, lib_) in slice8_one.items():
        kernel = "K9 merge" if what == "merge" else what
        print(f"{kernel} ({shapes[what]}): {ms_:.4f} ms, plain "
              f"{plain_:.4f} ms, bound {bound_:.6f} ms, library {lib_}")

    # -- phase 2i: the slice-9 kernels against their plain versions ---------
    t0 = time.perf_counter()
    errs9, slice9_one = check_slice9(session, rng, rate)
    print(f"K14s (running frames), K14b (bounded ROWS frames), K14o (lag/"
          f"lead, ntile, defaults), K10f (full outer) vs plain: pass "
          f"({time.perf_counter() - t0:.1f} s), max |d| {errs9}")
    shapes = {"K14s running sum": f"one partition of {SLICE3_SIZES[-1]} "
                                  "rows",
              "K14s running max": f"one partition of {SLICE3_SIZES[-1]} "
                                  "rows",
              "K14b moving average": f"one partition of {SLICE3_SIZES[-1]}"
                                     " rows, ROWS 6 PRECEDING",
              "K14o lag": f"one partition of {SLICE3_SIZES[-1]} rows",
              "K10f": f"65536 build x {SLICE8_ROWS} probe rows"}
    for what, (ms_, plain_, bound_, lib_) in slice9_one.items():
        print(f"{what} ({shapes[what]}): {ms_:.4f} ms, plain "
              f"{plain_:.4f} ms, bound {bound_:.6f} ms, library {lib_}")

    # -- phase 2j: the slice-10 kernels against their plain versions --------
    t0 = time.perf_counter()
    errs10, slice10_one = check_slice10(session, rng, rate)
    print(f"K13 (substring, concat), K10n (null-safe, every mode) vs plain: "
          f"pass ({time.perf_counter() - t0:.1f} s), max |d| {errs10}")
    shapes = {"K13 substring": f"substr(s, 1, 5) of {SLICE3_SIZES[-1]} "
                               "rows",
              "K13 concat": f"'store' || s || '#' of {SLICE3_SIZES[-1]} "
                            "rows",
              "K10n semi": f"65536 build x {SLICE8_ROWS} probe rows"}
    for what, (ms_, plain_, bound_, lib_) in slice10_one.items():
        print(f"{what} ({shapes[what]}): {ms_:.4f} ms, plain "
              f"{plain_:.4f} ms, bound {bound_:.6f} ms, library {lib_}")

    # -- phase 2k: the slice-11 kernels against their plain versions --------
    t0 = time.perf_counter()
    errs11, slice11_one = check_slice11(session, rng, rate)
    print(f"K16 (dictionary: every fixed type and strings, int8 to int32 "
          f"codes; RLE), K5 in code space (=, IN, <>, IS NULL) vs plain and "
          f"vs K5 over the decoded column: pass "
          f"({time.perf_counter() - t0:.1f} s), max |d| {errs11}")
    shapes = {"K16 strings": f"{SLICE3_SIZES[-1]} rows, 300 values of 0 "
                             "to 40 bytes, 10% null rows",
              "K16 longs": f"{SLICE3_SIZES[-1]} rows, 65536 values, 10% "
                           "null rows",
              "K16r": f"{SLICE3_SIZES[-1]} rows of longs in runs of 1 to "
                      "1000",
              "K5d =": f"{SLICE3_SIZES[-1]} rows, s = literal over 300 "
                       "string values, in code space",
              "K5 = over the decoded strings": f"{SLICE3_SIZES[-1]} rows, "
                                               "the same stage on strings"}
    for what, (ms_, plain_, bound_, lib_) in slice11_one.items():
        print(f"{what} ({shapes[what]}): {ms_:.4f} ms, plain {plain_} ms, "
              f"bound {bound_} ms, library {lib_}")

    # -- phase 2l: K14c and the chunked bounded path ------------------------
    t0 = time.perf_counter()
    errs12, slice12_one = check_slice12(session, rng, rate)
    print(f"K14c (the running window's carry: every kind, key type and "
          f"chunk case) vs plain and the chunked bounded path vs one batch: "
          f"pass ({time.perf_counter() - t0:.1f} s), max |d| {errs12}")

    # -- phase 2m: K9's, K1's and K3's min, max, first and last -------------
    t0 = time.perf_counter()
    errs13, slice13_one = check_slice13(session, rng, rate)
    print(f"K9 (min, max, first, last, first_valid, last_valid; by 4096 "
          f"groups, by one group, and merging partials), K3 (the same "
          f"kinds, +-0.0 in both orders), K1 (their update forms) and K7 "
          f"(the picked rows) vs plain: pass "
          f"({time.perf_counter() - t0:.1f} s), max |d| {errs13}")
    for what, (ms_, plain_, bound_, lib_) in slice13_one.items():
        print(f"{what} new kinds ({SLICE13_ROWS} rows): {ms_:.4f} ms, plain "
              f"{plain_:.4f} ms, bound {bound_:.6f} ms, library {lib_}")

    # -- phase 2n: the decimal kernels ---------------------------------------
    t0 = time.perf_counter()
    errs14, slice14_one = check_slice14(session, rng, rate)
    print(f"K12 (decimal arithmetic) in K6, K5 and K1, K9's decimal64 and "
          f"decimal128 sums, K3's decimal128 sum, the decimal avg finish, "
          f"K8's decimal words, K7/K7c/K7s on decimal128 rows vs plain: "
          f"pass, bit for bit ({time.perf_counter() - t0:.1f} s), max |d| "
          f"{errs14}")
    for what, (ms_, plain_, bound_, lib_) in slice14_one.items():
        print(f"{what} ({SLICE14_ROWS} rows): {ms_:.4f} ms, plain "
              f"{plain_:.4f} ms, bound {bound_:.6f} ms, library {lib_}")

    phase("kernels checked")

    # -- phase 3: the bench recipe at full size -----------------------------
    t0 = time.perf_counter()
    data = build_data(args.rows)
    print(f"the recipe's table ({args.rows} rows) built on the host in "
          f"{time.perf_counter() - t0:.1f} s")
    df = session.create_dataframe(data, num_partitions=args.parts)
    t0 = time.perf_counter()
    first = query(df).collect()
    print(f"first action (upload + query): "
          f"{time.perf_counter() - t0:.3f} s")

    FU.LAUNCHES = 0
    G.LAUNCHES = 0
    BO.CONCAT_LAUNCHES = 0
    tr0, ks0 = session.transfers.stats(), kstats()
    t0 = time.perf_counter()
    result = query(df).collect()
    main_s = time.perf_counter() - t0
    launches = {"fused_agg_update": FU.LAUNCHES,
                "global_reduce": G.LAUNCHES, "concat": BO.CONCAT_LAUNCHES}
    tr1, ks1 = session.transfers.stats(), kstats()
    print(f"main path: {main_s * 1e3:.3f} ms, launches {launches}, "
          f"transfers {({k: tr1[k] - tr0[k] for k in tr1})}")
    check(launches["fused_agg_update"] == args.parts,
          f"kernel 1 launched once per partition: {launches}")
    check(launches["global_reduce"] == args.parts + 1,
          f"kernel 2 launched per partition plus the merge: {launches}")
    check(launches["concat"] == int(args.parts > 1),
          f"K7c joined the partitions' partial rows: {launches}")
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

    # the CPU run over the first tenth of the rows, against a card run
    # over the same rows (the whole table's CPU run took about 180 s)
    tenth = {c: v[:args.rows // 10] for c, v in data.items()}
    cpu = TorchSession(device="cpu")
    t0 = time.perf_counter()
    ref = query(cpu.create_dataframe(tenth, num_partitions=args.parts)
                ).collect()
    cpu_s = time.perf_counter() - t0
    card10 = query(session.create_dataframe(
        tenth, num_partitions=args.parts)).collect()
    r, c = card10[0], ref[0]
    check(r["sk"] == c["sk"] and r["sh"] == c["sh"],
          f"sk, sh match the CPU run over the first tenth: {r} vs {c}")
    check(abs(r["sv"] - c["sv"]) < 1e-6 * abs(c["sv"]),
          f"sv matches the CPU run over the first tenth: {r} vs {c}")
    print(f"the CPU run over the first {args.rows // 10} rows matches the "
          f"card's ({cpu_s:.1f} s)")
    r = result[0]
    sel = data["w"] > 0
    np_sk = int(np.sum(data["k"][sel] + 1))
    np_sv = float(np.sum(data["v"][sel] * 2.0))
    check(r["sk"] == np_sk, f"sk matches numpy: {r['sk']} vs {np_sk}")
    check(abs(r["sv"] - np_sv) < 1e-6 * abs(np_sv),
          f"sv matches numpy: {r['sv']} vs {np_sv}")
    print(f"result {result[0]} matches numpy (and, over the first tenth "
          f"of the rows, the CPU run)")

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
    # K7c on the main path's call: the partitions' one-row partials
    with Recorder() as rec:
        query(df).collect()
    partials = [a for k, a, _kw in rec.calls if k == "K7c"]
    if partials:
        parts_ = partials[0][0]
        got = BO.concat_batches(parts_)
        torch.cuda.synchronize()
        k7c_err = same_columns(got.columns, BO.concat_batches_plain(
            parts_).columns, "K7c on the partial rows")
        k7c_bytes = 2 * sum(column_bytes(c) for b in parts_
                            for c in b.columns)
        kernels.append({
            "name": "concat", "path": "bench", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/concat.cu",
            "replaces": "spark_rapids_tpu/ops/batch_ops.py:274",
            "launches": launches["concat"], "max_abs_err": k7c_err,
            "ms": time_ms(lambda: BO.concat_batches(parts_), 50),
            "plain_ms": time_ms(lambda: BO.concat_batches_plain(parts_), 10),
            "bound_ms": k7c_bytes / rate * 1e3, "bound_by": "bytes",
            "library_ms": time_ms(lambda: [
                torch.cat([b.columns[j].data for b in parts_])
                for j in range(len(parts_[0].columns))], 50),
            "per": "launch", "passed": True})
        print(f"K7c on the {len(parts_)} partial rows: "
              f"{kernels[-1]['ms']:.4f} ms, plain "
              f"{kernels[-1]['plain_ms']:.4f} ms, library "
              f"{kernels[-1]['library_ms']:.4f} ms")
    phase("bench recipe's kernels timed")

    # -- phase 3b: the recipe's global form (min, max, first, last) ---------
    first3b = query_3b(df).collect()
    counted3b = ("K1", "K3", "K7", "K7c")
    for k in counted3b:
        setattr(*counter_of(k), 0)
    tr0, ks0 = session.transfers.stats(), kstats()
    t0 = time.perf_counter()
    result3b = query_3b(df).collect()
    main3b_s = time.perf_counter() - t0
    launches3b = {k: getattr(*counter_of(k)) for k in counted3b}
    tr1, ks1 = session.transfers.stats(), kstats()
    print(f"phase 3b main path: {main3b_s * 1e3:.3f} ms, launches "
          f"{launches3b}, transfers {({k: tr1[k] - tr0[k] for k in tr1})}")
    check(launches3b == {"K1": args.parts, "K3": args.parts + 1,
                         "K7": 4 * args.parts, "K7c": int(args.parts > 1)},
          f"phase 3b: K1 and K3 a partition, K3's merge, K7 a first/last "
          f"a partition, K7c: {launches3b}")
    check(tr1["syncs"] - tr0["syncs"] == 1, "phase 3b: one sync per query")
    check(ks1["builds"] == ks0["builds"], "phase 3b builds nothing anew")
    check(result3b == first3b, "phase 3b: a repeated query, the same row")
    want3b = numpy_3b(data, args.parts)
    check(result3b == [want3b], f"phase 3b matches numpy in partition "
          f"order: {result3b} vs {want3b}")
    times3b = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        query_3b(df).collect()
        times3b.append(time.perf_counter() - t0)
    with Recorder() as rec3b:
        query_3b(df).collect()
    recorded3b = {k: sum(c[0] == k for c in rec3b.calls) for k in counted3b}
    check(recorded3b == launches3b, f"every phase 3b launch was recorded: "
          f"{recorded3b}")
    timed3b = time_kernels(session, rec3b.calls, rate, 5, counted3b)
    print(f"phase 3b result {result3b[0]} matches numpy; best of "
          f"{args.reps} {min(times3b) * 1e3:.3f} ms, median "
          f"{float(np.median(times3b)) * 1e3:.3f} ms, "
          f"{args.rows / min(times3b):.6e} rows/s")
    for k, o in timed3b.items():
        print(f"  {k}: {o['ms']:.4f} ms per query over {launches3b[k]} "
              f"launches (per launch: {'; '.join(o['shapes'])}), plain "
              f"{o['plain_ms']:.4f} ms, bound {o['bound_ms']:.6f} ms "
              f"({o['bytes']} B), library {o['library_ms']}, max |d| "
              f"{o['max_abs_err']}")
    for k, name_ in (("K1", "fused_agg_update"), ("K3", "global_reduce"),
                     ("K7", "gather"), ("K7c", "concat")):
        _name, route, source, replaces = TPCDS_KERNELS[k]
        o = timed3b[k]
        entry = {"name": f"{name_}.recipe_global",
                 "path": "phase 3b (the recipe's global form)",
                 "route": route, "source": source, "replaces": replaces,
                 "launches": launches3b[k], "max_abs_err": max(
                     o["max_abs_err"], errs13.get(k, 0.0)),
                 "ms": o["ms"], "plain_ms": o["plain_ms"],
                 "bound_ms": o["bound_ms"], "bound_by": "bytes",
                 "library_ms": o["library_ms"], "per": "query",
                 "passed": True}
        if k in ("K1", "K3"):
            entry["also_replaces"] = GLOBAL_MIN_MAX_REPLACES
            ms_, plain_, bound_, lib_ = slice13_one[k]
            entry.update({"phase_2m_ms": ms_, "phase_2m_plain_ms": plain_,
                          "phase_2m_bound_ms": bound_,
                          "phase_2m_library_ms": lib_})
        kernels.append(entry)
    del df, part0, words, valid
    phase("phase 3b run, checked and timed")

    # -- phase 3d: the recipe's decimal form (K12 inside K1) ----------------
    kernels += run_3d(session, data, args, rate, errs14, slice14_one,
                      result[0])
    del data
    phase("phase 3d run, checked and timed")

    # -- phase 4: TPC-DS q3 at full size; phase 5: q1 and q7; phase 6: q15,
    # q12 and q20 ---------------------------------------------------------
    from spark_rapids_tpu_torch.testing import tpcds
    t0 = time.perf_counter()
    generated = tpcds.generate_tables(args.sf)
    cuts = {q: getattr(tpcds, f"{QUERIES[q][0]}_tables")(generated)
            for q in TPCDS_ORDER if q not in OWN_SF}
    del generated   # the cuts keep the arrays the queries read
    small = tpcds.generate_tables(args.sf / 10)
    small_cuts = {q: getattr(tpcds, f"{QUERIES[q][0]}_tables")(small)
                  for q in TPCDS_ORDER if q not in OWN_SF}
    del small
    own_sf = {}
    for q, sf in OWN_SF.items():
        own_sf[q] = min(sf, args.sf)
        cuts[q] = getattr(tpcds, f"{q}_tables")(
            tpcds.generate_tables(own_sf[q]))
        small_cuts[q] = getattr(tpcds, f"{q}_tables")(
            tpcds.generate_tables(own_sf[q] / 10))
    # phase 9h: the same cuts with their money as DECIMAL(7,2) cents
    for q in DECIMAL_QUERIES:
        cuts[q] = tpcds.decimal_money(cuts[q])
        small_cuts[q] = tpcds.decimal_money(small_cuts[q])
    print(f"TPC-DS sf {args.sf} and sf {args.sf / 10} generated (and "
          f"{own_sf}, a tenth of each) in {time.perf_counter() - t0:.1f} s")
    # phase 6: q15, q12 and q20; phase 7: q13, q19 and q16; phase 8: q17
    # (as written and q17v), q10 and q18; phase 9: q6, q28 and q36, over
    # the same tables
    parts_cuts, parquet_cuts, one_part = {}, {}, {}
    parquet_root = None
    min_max_launches = {False: 0, True: 0}
    #: the decimal forms' main-path launches: one-partition (phase 9h) and
    #: all runs
    decimal_launches = {False: dict.fromkeys(DECIMAL_COUNTERS, 0),
                        True: dict.fromkeys(DECIMAL_COUNTERS, 0)}
    runs = [(q, 1, False) for q in TPCDS_ORDER] + \
        [(q, 1, True) for q in PARQUET_QUERIES] + \
        [(q, args.parts, False) for q in PARTS_QUERIES]
    for q, parts, parquet in runs:
        q0 = time.perf_counter()
        if parquet:
            # phase 9e: the query from parquet files of the same tables
            if parquet_root is None:
                parquet_root = write_parquet(tpcds, parquet_cuts, args.sf)
            launches, timed, got = run_query(
                session, q, parquet_cuts.pop(q), rate, args.sf == 1000,
                reference=one_part[q], parquet_root=parquet_root)
            if not parquet_cuts:
                drop_parquet(parquet_root)
        elif parts == 1:
            tables_ = cuts.pop(q)
            if q in PARTS_QUERIES:
                parts_cuts[q] = tables_
            if q in PARQUET_QUERIES:
                parquet_cuts[q] = tables_
            launches, timed, got = run_query(
                session, q, tables_, rate,
                args.sf == 1000 or own_sf.get(q) == OWN_SF.get(q),
                small_cuts.pop(q, None))
            one_part[q] = got
            if q == "q51":
                # phase 9f: the same tables under a 128 MiB pool
                phase(f"{q} run, checked and timed "
                      f"({time.perf_counter() - q0:.1f} s)")
                q0 = time.perf_counter()
                ooc = run_q51_out_of_core(session, tables_, rate, got,
                                          got["peak"], (1, args.parts))
            del tables_
        else:
            # phase 10: the query over tables cut into partitions
            launches, timed, got = run_query(
                session, q, parts_cuts.pop(q), rate, args.sf == 1000,
                parts=parts, reference=one_part[q])
        for k, n_ in got["decimal_launches"].items():
            decimal_launches[True][k] += n_
            if parts == 1 and not parquet:
                decimal_launches[False][k] += n_
        where = " from parquet" if parquet else "" if parts == 1 \
            else f" at {parts} partitions"
        done = " out of core (phase 9f)" if (q, parts, parquet) == \
            ("q51", 1, False) else where
        phase(f"{q}{done} run, checked and timed "
              f"({time.perf_counter() - q0:.1f} s)")
        for k in launches:
            name_, route, source, replaces = TPCDS_KERNELS[k]
            o = timed[k]
            tag = f"{q}.parquet" if parquet else q if parts == 1 \
                else f"{q}.p{parts}"
            entry = {
                "name": name_ if tag == "q3" else f"{name_}.{tag}",
                "path": f"{q}{where}",
                "route": route, "source": source,
                "replaces": replaces, "launches": launches[k],
                "max_abs_err": max(errs.get(k, 0.0), errs3.get(k, 0.0),
                                   errs4.get(k, 0.0), errs5.get(k, 0.0),
                                   errs6.get(k, 0.0), errs7.get(k, 0.0),
                                   errs8.get(k, 0.0), errs9.get(k, 0.0),
                                   errs10.get(k, 0.0), errs11.get(k, 0.0),
                                   errs13.get(k, 0.0), o["max_abs_err"]),
                "ms": o["ms"], "plain_ms": o["plain_ms"],
                "bound_ms": o["bound_ms"], "bound_by": "bytes",
                "library_ms": o["library_ms"], "device_ms": o["device_ms"],
                "per": "query", "passed": True}
            if q == "q1" and k in ("K7", "K10"):
                entry["also_replaces"] = OUTER_REPLACES
            if q == "q16" and k == "K10":
                entry["also_replaces"] = SEMI_ANTI_REPLACES
            if q in ("q17", "q17v") and k == "K10":
                entry["also_replaces"] = MULTIKEY_REPLACES
            if q == "q17v" and k == "K9":
                entry["also_replaces"] = M2_REPLACES
                entry["m2_one_group_ms"], entry["m2_one_group_plain_ms"], \
                    entry["m2_one_group_bound_ms"], _ = slice6_one["m2"]
            if k == "K7c":
                for what, key in (("all columns", "five_slices"),
                                  ("fixed-width columns",
                                   "five_fixed_slices")):
                    ms_, plain_, bound_, lib_ = slice6_one[what]
                    entry[f"{key}_ms"] = ms_
                    entry[f"{key}_plain_ms"] = plain_
                    entry[f"{key}_bound_ms"] = bound_
                    entry[f"{key}_library_ms"] = lib_
            if k == "K15d":
                entry["also_replaces"] = DISTINCT_REPLACES
                for what, (ms_, plain_, bound_, lib_) in k15d_one.items():
                    entry[f"{what}_ms"] = ms_
                    entry[f"{what}_plain_ms"] = plain_
                    entry[f"{what}_bound_ms"] = bound_
                    entry[f"{what}_library_ms"] = lib_
            if k == "K14":
                entry["one_partition_ms"] = k14_one[0]
                entry["one_partition_bound_ms"] = k14_one[1]
            if q in STRING_JOIN_QUERIES and k == "K10":
                entry["also_replaces"] = STRING_KEY_REPLACES
                for what in ("string 65536", "string 65536 distinct",
                             "string 16"):
                    key = what.replace(" ", "_")
                    ms_, plain_, bound_, _lib = slice7_one[what]
                    entry[f"{key}_ms"] = ms_
                    entry[f"{key}_plain_ms"] = plain_
                    entry[f"{key}_bound_ms"] = bound_
            if k in ("K11h", "K11r", "K7s"):
                if k != "K7s":
                    entry["also_replaces"] = HISTOGRAM_REPLACES
                ms_, plain_, bound_, lib_ = slice8_one[k]
                entry["phase_2h_ms"] = ms_
                entry["phase_2h_plain_ms"] = plain_
                entry["phase_2h_bound_ms"] = bound_
                entry["phase_2h_library_ms"] = lib_
            if parts > 1 and k == "K9":
                entry["also_replaces"] = MERGE_REPLACES
                ms_, plain_, bound_, _lib = slice8_one["merge"]
                entry["merge_ms"] = ms_
                entry["merge_plain_ms"] = plain_
                entry["merge_bound_ms"] = bound_
            if q in MIN_MAX_QUERIES and k == "K9":
                entry["also_replaces"] = entry.get("also_replaces", []) + \
                    MIN_MAX_REPLACES
                # K9's launches with a min, max, first or last slot in the
                # main-path run (at 4 partitions PARTIAL's and FINAL's)
                min_max_launches[parts > 1] = got["min_max_launches"]
            if k in ("K14r", "K10x"):
                what = "rank" if k == "K14r" else "cross"
                if k == "K14r":
                    entry["also_replaces"] = RANK_REPLACES
                ms_, plain_, bound_, lib_ = slice7_one[what]
                entry["phase_2g_ms"] = ms_
                entry["phase_2g_plain_ms"] = plain_
                entry["phase_2g_bound_ms"] = bound_
                entry["phase_2g_library_ms"] = lib_
            if k in ("K14s", "K14b", "K14o", "K10f"):
                entry["also_replaces"] = {"K14s": FRAME_REPLACES,
                                          "K14b": FRAME_REPLACES,
                                          "K14o": NTILE_REPLACES,
                                          "K10f": FULL_REPLACES}[k]
                for what, (ms_, plain_, bound_, lib_) in slice9_one.items():
                    if what.split(" ")[0] != k:
                        continue
                    key = what.replace(" ", "_").lower()
                    entry[f"phase_2i_{key}_ms"] = ms_
                    entry[f"phase_2i_{key}_plain_ms"] = plain_
                    entry[f"phase_2i_{key}_bound_ms"] = bound_
                    entry[f"phase_2i_{key}_library_ms"] = lib_
            if k in ("K13", "K10n"):
                if k == "K10n":
                    entry["also_replaces"] = NULL_SAFE_REPLACES
                elif q == "q5":
                    entry["also_replaces"] = CONCAT_REPLACES
                for what, (ms_, plain_, bound_, lib_) in slice10_one.items():
                    if what.split(" ")[0] != k:
                        continue
                    key = what.replace(" ", "_").lower()
                    entry[f"phase_2j_{key}_ms"] = ms_
                    entry[f"phase_2j_{key}_plain_ms"] = plain_
                    entry[f"phase_2j_{key}_bound_ms"] = bound_
                    entry[f"phase_2j_{key}_library_ms"] = lib_
            if k == "K12avg":
                ms_, plain_, bound_, lib_ = slice14_one["avg finish"]
                entry.update({"phase_2n_ms": ms_,
                              "phase_2n_plain_ms": plain_,
                              "phase_2n_bound_ms": bound_,
                              "phase_2n_library_ms": lib_,
                              "max_abs_err": max(entry["max_abs_err"],
                                                 errs14["avg finish"])})
            if k in ("K16", "K5d"):
                for what, (ms_, plain_, bound_, lib_) in slice11_one.items():
                    if what.split(" ")[0] != k:
                        continue
                    key = what.replace(" ", "_").replace("=", "eq").lower()
                    entry[f"phase_2k_{key}_ms"] = ms_
                    entry[f"phase_2k_{key}_plain_ms"] = plain_
                    entry[f"phase_2k_{key}_bound_ms"] = bound_
                    entry[f"phase_2k_{key}_library_ms"] = lib_
                if k == "K5d":
                    entry["phase_2k_stage_over_decoded_strings_ms"] = \
                        slice11_one["K5 = over the decoded strings"][0]
            kernels.append(entry)
    # the decimal forms: their main-path launches (phase 9h at one
    # partition, or every run) beside phase 2n's times at 2^20+3 rows
    print(f"the decimal forms' main-path launches: at one partition "
          f"{decimal_launches[False]}, in every run {decimal_launches[True]}")
    for form, name_, kernel, launched in (
            ("K12 in K6", "k12_fused_project", "K6",
             decimal_launches[True]["K12p"]),
            ("K12 in K5", "k12_fused_stage", "K5",
             decimal_launches[True]["K12s"]),
            ("K9 decimal64 sum", "keyed_agg.decimal64_sum", "K9",
             decimal_launches[False]["K9d"]),
            ("K9 decimal128 sum", "keyed_agg.decimal128_sum", "K9", 0),
            ("K8 decimal64 key", "sort.decimal64_words", "K8",
             decimal_launches[False]["K8d"]),
            ("K8 decimal128 key", "sort.decimal128_words", "K8", 0),
            ("K7 decimal128", "gather.decimal128_rows", "K7", 0)):
        _name, route, source, replaces = TPCDS_KERNELS[kernel]
        key = {"K6": "K12", "K5": "K12", "K9": "K9d", "K8": "K8d"}.get(kernel)
        ms_, plain_, bound_, lib_ = slice14_one[form]
        kernels.append({
            "name": name_,
            "path": "phase 9h and 10 (launches); phase 2n (times)"
                    if launched else "phase 2n (no query path)",
            "route": route, "source": source,
            "replaces": DECIMAL_REPLACES.get(key, replaces),
            "also_replaces": [replaces] + (DECIMAL_REPLACES["K12 also"]
                                           if key == "K12" else []),
            "launches": launched, "max_abs_err": errs14[form], "ms": ms_,
            "plain_ms": plain_, "bound_ms": bound_, "bound_by": "bytes",
            "library_ms": lib_, "per": "launch", "passed": True})
    check(decimal_launches[False]["K9d"] >= 3 and
          decimal_launches[False]["K8d"] >= 2,
          f"phase 9h: K9's decimal sums and K8's decimal words ran: "
          f"{decimal_launches}")
    # K9's min, max, first and last kinds: q35v's main path at one
    # partition, and the merge's at 4 (PARTIAL and FINAL), with phase 2m's
    # times (2^20+3 rows into 4096 groups, 28 slots; the merge of the two
    # halves' partials, 24 slots; library: torch's scatter_reduce of the
    # min/max slots over K9's own group ids, the fold only)
    check(min_max_launches[False] == 1 and (args.parts == 1 or args.parts
          < min_max_launches[True] <= 2 * args.parts), f"q35v's group-by is "
          f"one K9 launch at one partition, PARTIAL's and FINAL's at "
          f"{args.parts}: {min_max_launches}")
    _name, route, source, replaces = TPCDS_KERNELS["K9"]
    for what, name_, path, merge in (
            ("K9", "keyed_agg.min_max_first_last", "q35v", False),
            ("K9 merge", "keyed_agg.min_max_first_last_merge",
             f"q35v at {args.parts} partitions", True)):
        ms_, plain_, bound_, lib_ = slice13_one[what]
        kernels.append({
            "name": name_, "path": f"{path} (launches); phase 2m (times)",
            "route": route, "source": source,
            "replaces": "spark_rapids_tpu/ops/agg_ops.py:82",
            "also_replaces": MIN_MAX_REPLACES,
            "launches": min_max_launches[merge],
            "max_abs_err": errs13["K9"],
            "ms": ms_, "plain_ms": plain_, "bound_ms": bound_,
            "bound_by": "bytes", "library_ms": lib_, "per": "launch",
            "passed": True})
    # K16's forms that no query path runs: the fixed-width dictionary and
    # RLE (off by default, as in the JAX package), held and timed in 2k
    for k, what, name_ in (("K16", "K16 longs", "decode_dictionary.fixed"),
                           ("K16r", "K16r", "decode_rle")):
        _name, route, source, replaces = TPCDS_KERNELS[k]
        ms_, plain_, bound_, lib_ = slice11_one[what]
        kernels.append({
            "name": name_, "path": "phase 2k (no query path)",
            "route": route, "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": errs11[k], "ms": ms_,
            "plain_ms": plain_, "bound_ms": bound_, "bound_by": "bytes",
            "library_ms": lib_, "per": "launch", "passed": True})
    # K14c: phase 9f's main path (q51 under a 128 MiB pool, one
    # partition), with phase 2l's 2**20 + 3-row chunk beside it
    _name, route, source, replaces = TPCDS_KERNELS["K14c"]
    one_ooc = ooc[1]
    ms_, plain_, bound_, lib_ = slice12_one["K14c"]
    kernels.append({
        "name": "running_fixup.q51_out_of_core",
        "path": "q51 out of core (phase 9f, 128 MiB pool)",
        "route": route, "source": source, "replaces": replaces,
        "launches": one_ooc["launches"],
        "max_abs_err": max(errs12["K14c"], one_ooc["max_abs_err"]),
        "ms": one_ooc["ms"], "plain_ms": one_ooc["plain_ms"],
        "bound_ms": one_ooc["bound_ms"], "bound_by": "bytes",
        "library_ms": one_ooc["library_ms"],
        "device_ms": one_ooc.get("device_ms"), "per": "query",
        "launches_at_4_partitions": ooc[args.parts]["launches"],
        "phase_2l_ms": ms_, "phase_2l_plain_ms": plain_,
        "phase_2l_bound_ms": bound_, "phase_2l_library_ms": lib_,
        "passed": True})
    # phases 2o and 9i: ScaleTest (K15, K13's length and case maps,
    # substring by characters)
    kernels += run_slice15(session, rate, phase)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
