"""The port stands alone: spark_rapids_tpu_torch and chip_smoke.py import
neither jax nor anything of spark_rapids_tpu, kernel modules import triton
only where they launch, and nothing quietly falls back to the CPU."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "spark_rapids_tpu_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, node
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module, node


def _forbidden(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or \
        name.startswith("jaxlib") or name == "spark_rapids_tpu" or \
        name.startswith("spark_rapids_tpu.")


def test_no_port_file_imports_jax_or_the_jax_package():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text())
        for name, node in _imported_modules(tree):
            if _forbidden(name):
                bad.append(f"{path.relative_to(REPO)}:{node.lineno} {name}")
        # importlib.import_module("...") with a literal name, too
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str) and \
                    getattr(node.func, "attr", "") == "import_module" and \
                    _forbidden(node.args[0].value):
                bad.append(f"{path.relative_to(REPO)}:{node.lineno}")
    assert not bad, bad


def test_triton_is_imported_only_inside_functions():
    for path in _port_files():
        tree = ast.parse(path.read_text())
        for stmt in tree.body:
            for name, _node in _imported_modules(ast.Module(body=[stmt],
                                                            type_ignores=[])):
                if isinstance(stmt, (ast.FunctionDef, ast.ClassDef)):
                    continue
                assert not name.startswith("triton"), \
                    f"{path.relative_to(REPO)} imports {name} at module level"


_RECIPE = r"""
import sys
import numpy as np
sys.path.insert(0, {repo!r})
import importlib, pkgutil
import spark_rapids_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from spark_rapids_tpu_torch import TorchSession, functions as F
from spark_rapids_tpu_torch.expressions import arithmetic as A
from spark_rapids_tpu_torch.expressions import hashing as H
from spark_rapids_tpu_torch.expressions import predicates as P
from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
rng = np.random.default_rng(7)
d = {{"k": rng.integers(0, 1 << 20, 1000).astype(np.int64),
     "v": rng.standard_normal(1000),
     "w": rng.integers(-1000, 1000, 1000).astype(np.int32)}}
df = TorchSession(device="cpu").create_dataframe(d, num_partitions=4)
rows = (df.filter(P.GreaterThan(col("w"), lit(0)))
        .select(Alias(A.Add(col("k"), lit(1)), "k1"),
                Alias(A.Multiply(col("v"), lit(2.0)), "v2"),
                Alias(H.Murmur3Hash(col("k"), col("w")), "h"))
        .agg(F.sum("k1").alias("sk"), F.sum("v2").alias("sv"),
             F.sum("h").alias("sh"))).collect()
assert len(rows) == 1 and rows[0]["sk"] is not None, rows
from spark_rapids_tpu_torch.testing import tpcds
tables = tpcds.q3_tables(tpcds.generate_tables(5))
s = TorchSession(device="cpu")
q3 = tpcds.q3(*[s.create_dataframe(tables[t])
                for t in ("date_dim", "store_sales", "item")])[0].collect()
assert len(q3) >= 10, q3
t1 = tpcds.q1_tables(tpcds.generate_tables(0.3))
q1 = tpcds.q1(*[s.create_dataframe(t1[t]) for t in
                ("date_dim", "store_returns", "store", "customer")])[0]
assert q1.collect() == tpcds.q1_numpy(t1), q1.explain()
for m in ("exec.window", "ops.window_ops", "expressions.strings",
          "expressions.window_exprs"):
    importlib.import_module("spark_rapids_tpu_torch." + m)
t12 = tpcds.q12_tables(tpcds.generate_tables(0.2))
q12 = tpcds.q12(*[s.create_dataframe(t12[t]) for t in
                  ("web_sales", "item", "date_dim")])[0]
rows = q12.collect()
assert rows and len(rows) == len(tpcds.q12_numpy(t12)), q12.explain()
t16 = tpcds.q16_tables(tpcds.generate_tables(0.5))
q16 = tpcds.q16(*[s.create_dataframe(t16[t]) for t in
                  ("catalog_sales", "date_dim", "customer_address",
                   "call_center", "catalog_returns")])[0]
got, ref = q16.collect()[0], tpcds.q16_numpy(t16)[0]
assert got["order_count"] == ref["order_count"] > 0, q16.explain()
assert abs(got["total_net_profit"] - ref["total_net_profit"]) <= \
    1e-9 * abs(ref["total_net_profit"]), (got, ref)
t19 = tpcds.q19_tables(tpcds.generate_tables(0.5))
q19 = tpcds.q19(*[s.create_dataframe(t19[t]) for t in
                  ("date_dim", "store_sales", "item", "customer",
                   "customer_address", "store")])[0]
assert len(q19.collect()) == len(tpcds.q19_numpy(t19)), q19.explain()
t13 = tpcds.q13_tables(tpcds.generate_tables(0.5))
wide = dict(prices=((1.0, 300.0),) * 3,
            profits=((-5000.0, 15000.0),) * 3)
q13 = tpcds.q13(*[s.create_dataframe(t13[t]) for t in
                  ("store_sales", "store", "customer_demographics",
                   "household_demographics", "customer_address",
                   "date_dim")], **wide)[0].collect()
assert q13[0]["sum1"] is not None, q13
t17 = tpcds.q17_tables(tpcds.generate_tables(0.5))
q17 = tpcds.q17(*[s.create_dataframe(t17[t]) for t in
                  ("store_sales", "store_returns", "catalog_sales",
                   "date_dim", "store", "item")], same_item=False)[0]
rows = q17.collect()
ref = tpcds.q17_numpy(t17, same_item=False)
assert rows and [(r["i_item_id"], r["s_state"], r["store_sales_quantitycount"])
                 for r in rows] == \
    [(r["i_item_id"], r["s_state"], r["store_sales_quantitycount"])
     for r in ref], q17.explain()
t18 = tpcds.q18_tables(tpcds.generate_tables(0.5))
q18 = tpcds.q18(*[s.create_dataframe(t18[t]) for t in
                  ("catalog_sales", "customer_demographics", "customer",
                   "customer_address", "date_dim", "item")])[0]
rows = q18.collect()
assert rows and len(rows) == len(tpcds.q18_numpy(t18)), q18.explain()
assert all(rows[0][k] is None for k in tpcds.Q18_KEYS), rows[0]
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax")
             or m == "spark_rapids_tpu" or m.startswith("spark_rapids_tpu.")
             or m == "triton" or m.startswith("triton."))
print("LEAKED", bad)
"""


def test_port_runs_the_recipe_without_jax_in_the_process():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c",
                          _RECIPE.format(repo=str(REPO))],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LEAKED []" in out.stdout, out.stdout


def test_session_without_device_refuses_when_cuda_is_absent(monkeypatch):
    import torch
    from spark_rapids_tpu_torch import TorchSession
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchSession()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchSession(device="cuda")
    assert TorchSession(device="cpu").device.type == "cpu"


def test_wrappers_refuse_other_devices():
    import torch
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.ops import (agg_ops, batch_ops, join_ops,
                                            sort_ops, window_ops)
    meta = torch.zeros(2, 1, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        agg_ops.global_reduce(meta, torch.ones(2, 1, dtype=torch.bool,
                                               device="meta"),
                              [agg_ops.SUM_I64])
    col = DeviceColumn(torch.zeros(2, dtype=torch.int64, device="meta"),
                       torch.ones(2, dtype=torch.bool, device="meta"),
                       T.LONG)
    idx = torch.zeros(2, dtype=torch.int64, device="meta")
    batch = ColumnarBatch([col], 2, ["k"])
    calls = [lambda: batch_ops.gather_columns([col], idx, None),
             lambda: join_ops.join_pairs(col, col, None),
             lambda: sort_ops.sort_permutation([col],
                                               [sort_ops.SortOrder(0)]),
             lambda: agg_ops.keyed_aggregate([col], [col],
                                             [agg_ops.KEYED_SUM_I64], None),
             lambda: window_ops.window_reduce([col], [col],
                                              [window_ops.WIN_SUM_I64], 2,
                                              col.device),
             lambda: join_ops.join_pairs(col, col, None, mode="semi"),
             lambda: agg_ops.count_distinct(col),
             lambda: agg_ops.count_distinct(col, idx, 2),
             lambda: join_ops.join_pairs([col, col], [col, col], None),
             lambda: agg_ops.keyed_aggregate([col], [col],
                                             [agg_ops.KEYED_M2], None),
             lambda: batch_ops.concat_batches([batch, batch])]
    for call in calls:
        with pytest.raises(ValueError, match="unsupported device"):
            call()


def test_chip_smoke_alone_or_without_a_card_prints_no_result(tmp_path):
    import torch
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    runs = [alone]
    if not torch.cuda.is_available():
        runs.append(REPO / "chip_smoke.py")
    for script in runs:
        out = subprocess.run([sys.executable, str(script), "--rows", "10"],
                             capture_output=True, text=True, timeout=300,
                             cwd=str(script.parent))
        assert out.returncode != 0, out.stdout
        assert out.stdout.strip() == "", out.stdout
