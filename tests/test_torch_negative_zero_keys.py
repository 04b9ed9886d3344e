"""Double group keys -0.0 and 0.0 (ROADMAP queue 3, a fault of the
reference's CPU engine): ``exec/aggregate.py _arrow_groupby`` groups
through Arrow, which keeps -0.0 and 0.0 apart, so the JAX CPU engine
gives two groups.  Spark normalizes the key (NormalizeFloatingNumbers):
one group.  The JAX device path (on JAX-CPU) does, and so does the port,
so the port is held against the device path here: one group, its key's
sign and its count as the JAX device path gives them."""

import gc
import math

import pytest
import torch

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import functions as F


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
    """The plain versions run many small tensor ops; this module runs on
    one intra-op thread and restores the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DATA = {"k": [1, 2], "d": [-0.0, 0.0]}


@pytest.mark.parametrize("form", ["group by", "distinct"])
def test_negative_zero_key_is_one_group_as_on_the_jax_device_path(form):
    jax = TpuSession({"spark.rapids.sql.enabled": "true"}) \
        .create_dataframe(DATA)
    port = TorchSession(device="cpu").create_dataframe(DATA)
    if form == "group by":
        ref = jax.group_by("d").agg(JF.count("k").alias("n")).collect()
        got = port.group_by("d").agg(F.count("k").alias("n")).collect()
        assert got[0]["n"] == 2
    else:
        ref = jax.select("d").distinct().collect()
        got = port.select("d").distinct().collect()
    assert len(ref) == len(got) == 1
    assert rows_equal(ref, got) is None
    assert math.copysign(1.0, got[0]["d"]) == \
        math.copysign(1.0, ref[0]["d"]) == -1.0
