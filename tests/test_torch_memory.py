"""The port's memory runtime (spark_rapids_tpu_torch/memory/) on the CPU:
the counterparts of tests/test_memory.py's catalog, retry and spillable
cases (``:40-247``), over the same shapes (2048-row batches of a long
and a double column, a 1 MiB device pool, a 64 KiB host tier):

- TestCatalog: add, get and remove; device-to-host spill under pressure,
  the earliest buffer first; host overflow to the disk tier; the unspill
  round trip; spill priorities; an unspillable buffer stays; an
  unsatisfiable reservation raises RetryOOM.
- TestRetry: with_retry_no_split recovers from injected RetryOOMs; a
  SplitAndRetryOOM passes through it; with_retry splits a batch in half
  once; splitting a 1-row batch raises; a nested frame does not split;
  an early exit (MemoryError), an abandoned iteration and split
  exhaustion close the queued spillables; AutoCloseableTargetSize.
- TestSpillable: the life cycle (pinning, spill, host read, close) and a
  spillable made from a host batch.
- New in the port: a ``torch.cuda.OutOfMemoryError`` inside a retry frame
  is retried like a RetryOOM (and counted), and gives MemoryError after
  ``max_retries``; the disk tier round trip under each codec, and the
  JAX shuffle codec ``zlib`` refused by name; the runtime's pool from
  the conf, its warning and re-shaping after ``shutdown()``."""

import logging
import os

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.columnar.batch import batch_from_pydict
from spark_rapids_tpu_torch.columnar.transfer import TransferGateway
from spark_rapids_tpu_torch.config import TorchConf
from spark_rapids_tpu_torch.memory import device_manager as DM
from spark_rapids_tpu_torch.memory import retry as R
from spark_rapids_tpu_torch.memory.catalog import (BufferCatalog,
                                                   SpillPriority,
                                                   StorageTier)
from spark_rapids_tpu_torch.memory.spillable import SpillableColumnarBatch

CPU = TransferGateway(torch.device("cpu"))


def make_batch(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    return CPU.upload_batch(batch_from_pydict({
        "a": rng.integers(0, 1000, n).astype(np.int64),
        "b": rng.standard_normal(n),
    }))


def host_rows(catalog, batch):
    return catalog.gateway().download_batch(batch).to_pydict()


@pytest.fixture
def catalog(tmp_path):
    return BufferCatalog(device_limit_bytes=1 << 20,
                         host_limit_bytes=64 << 10,
                         disk_dir=str(tmp_path))


@pytest.fixture(autouse=True)
def _disarmed():
    """No injection armed, no runtime, before and after each test."""
    ctx = R.task_context()
    ctx.inject_retry_oom = ctx.inject_split_oom = 0
    ctx.retry_count = ctx.split_retry_count = 0
    DM.shutdown()
    yield
    ctx.inject_retry_oom = ctx.inject_split_oom = 0
    DM.shutdown()


class TestCatalog:
    def test_add_get_remove(self, catalog):
        b = make_batch()
        h = catalog.add_device_batch(b)
        assert catalog.tier_of(h) == StorageTier.DEVICE
        got = catalog.get_device_batch(h)
        assert got.row_count == b.row_count
        catalog.remove(h)
        with pytest.raises(KeyError):
            catalog.get_device_batch(h)
        assert catalog.device_bytes == 0

    def test_spill_device_to_host_on_pressure(self, catalog):
        # each batch 2048 * (8 + 1 + 8 + 1) = 36,864 B; 1 MiB fits 28
        handles = [catalog.add_device_batch(make_batch(seed=i))
                   for i in range(40)]
        tiers = [catalog.tier_of(h) for h in handles]
        assert StorageTier.DEVICE in tiers
        assert any(t != StorageTier.DEVICE for t in tiers)
        assert catalog.device_bytes <= catalog.device_limit
        # the same priority spills the earliest first
        assert tiers[0] != StorageTier.DEVICE
        assert catalog.stats()["device_to_host"] > 0
        # each spill is one download: its copies and its sync counted
        tr = catalog.transfer_stats()
        assert tr["syncs"] == catalog.stats()["device_to_host"]
        assert tr["d2h_copies"] == 4 * tr["syncs"]

    def test_host_overflows_to_disk(self, catalog, tmp_path):
        handles = [catalog.add_device_batch(make_batch(seed=i))
                   for i in range(40)]
        tiers = [catalog.tier_of(h) for h in handles]
        assert StorageTier.DISK in tiers, "host limit 64KB must push to disk"
        assert any(f.startswith("spill-") for f in os.listdir(tmp_path))

    def test_unspill_roundtrip(self, catalog):
        b = make_batch(seed=7)
        expect = host_rows(catalog, b)
        h = catalog.add_device_batch(b)
        catalog.synchronous_spill(None)
        assert catalog.tier_of(h) != StorageTier.DEVICE
        got = catalog.get_device_batch(h)
        assert catalog.tier_of(h) == StorageTier.DEVICE
        assert host_rows(catalog, got) == expect

    def test_priority_order(self, catalog):
        low = catalog.add_device_batch(make_batch(seed=1),
                                       SpillPriority.INPUT_FROM_SHUFFLE)
        high = catalog.add_device_batch(make_batch(seed=2),
                                        SpillPriority.ACTIVE_ON_DECK)
        # enough free space that exactly one batch must spill
        catalog.synchronous_spill(catalog.device_limit - (40 << 10))
        assert catalog.tier_of(low) != StorageTier.DEVICE
        assert catalog.tier_of(high) == StorageTier.DEVICE

    def test_unspillable_not_spilled(self, catalog):
        h = catalog.add_device_batch(make_batch(seed=3), spillable=False)
        catalog.synchronous_spill(None)
        assert catalog.tier_of(h) == StorageTier.DEVICE

    def test_reserve_raises_when_unsatisfiable(self, catalog):
        catalog.add_device_batch(make_batch(seed=4), spillable=False)
        with pytest.raises(R.RetryOOM):
            catalog.reserve(2 << 20)  # more than the whole pool

    @pytest.mark.parametrize("codec", ["none", "lz4"])
    def test_disk_tier_roundtrip(self, tmp_path, codec):
        cat = BufferCatalog(1 << 20, 0, disk_dir=str(tmp_path), codec=codec)
        hb = batch_from_pydict({"x": np.arange(300, dtype=np.int64),
                                "s": ["a" * (i % 9) if i % 5 else None
                                      for i in range(300)],
                                "d": [None if i % 7 == 0 else i * 0.5
                                      for i in range(300)]})
        h = cat.add_host_batch(hb)
        assert cat.tier_of(h) == StorageTier.DISK
        assert cat.stats()["host_to_disk"] == 1
        assert cat.get_host_batch(h).to_pydict() == hb.to_pydict()
        cat.remove(h)
        assert not os.listdir(tmp_path)


class TestRetry:
    def test_with_retry_no_split_recovers(self):
        R.force_retry_oom(2)
        calls = []

        def work():
            R.maybe_inject_oom()
            calls.append(1)
            return 42

        before = R.RETRY_COUNT
        assert R.with_retry_no_split(None, work) == 42
        assert len(calls) == 1  # the two faulted attempts never appended
        assert R.task_context().retry_count == 2
        assert R.RETRY_COUNT - before == 2

    def test_split_oom_fatal_in_no_split(self):
        R.force_split_and_retry_oom(1)
        with pytest.raises(R.SplitAndRetryOOM):
            R.with_retry_no_split(None, R.maybe_inject_oom)

    def test_with_retry_splits_batch(self, catalog):
        sb = SpillableColumnarBatch.from_device(make_batch(1000, seed=5),
                                                catalog=catalog)
        R.force_split_and_retry_oom(1)

        def work(s):
            R.maybe_inject_oom()
            return s.row_count

        before = R.SPLIT_RETRY_COUNT
        out = list(R.with_retry(sb, work))
        assert sum(out) == 1000
        assert len(out) == 2  # split in half once
        assert R.task_context().split_retry_count == 1
        assert R.SPLIT_RETRY_COUNT - before == 1

    def test_split_to_exhaustion_raises(self, catalog):
        sb = SpillableColumnarBatch.from_device(make_batch(1, seed=6),
                                                catalog=catalog)
        R.force_split_and_retry_oom(10)
        with pytest.raises(R.SplitAndRetryOOM):
            list(R.with_retry(sb, lambda s: R.maybe_inject_oom()))

    def test_nested_frame_does_not_split(self, catalog):
        sb = SpillableColumnarBatch.from_device(make_batch(100, seed=8),
                                                catalog=catalog)

        def inner(s):
            R.force_split_and_retry_oom(1)
            return list(R.with_retry(s, lambda x: R.maybe_inject_oom()))

        with pytest.raises(R.SplitAndRetryOOM):
            R.with_retry_no_split(sb, inner)

    def test_gen_early_exit_closes_queued_spillables(self, catalog):
        sbs = [SpillableColumnarBatch.from_device(make_batch(100, seed=i),
                                                  catalog=catalog)
               for i in range(3)]

        def work(s):
            R.maybe_inject_oom()
            return s.row_count

        gen = R.with_retry(list(sbs), work, max_retries=1)
        assert next(gen) == 100            # sbs[0] passes clean
        R.force_retry_oom(5)               # more faults than the budget
        with pytest.raises(MemoryError):
            list(gen)
        # sbs[1] failed out, sbs[2] never ran: both closed; sbs[0] was
        # handed to the caller and stays open
        assert not sbs[0].closed
        assert sbs[1].closed and sbs[2].closed

    def test_gen_abandoned_iteration_closes_queue(self, catalog):
        sbs = [SpillableColumnarBatch.from_device(make_batch(50, seed=i),
                                                  catalog=catalog)
               for i in range(3)]
        gen = R.with_retry(list(sbs), lambda s: s.row_count)
        assert next(gen) == 50
        gen.close()
        assert not sbs[0].closed
        assert sbs[1].closed and sbs[2].closed

    def test_gen_split_exhaustion_closes_remaining(self, catalog):
        sbs = [SpillableColumnarBatch.from_device(make_batch(1, seed=i),
                                                  catalog=catalog)
               for i in range(2)]
        R.force_split_and_retry_oom(10)
        with pytest.raises(R.SplitAndRetryOOM):
            list(R.with_retry(list(sbs), lambda s: R.maybe_inject_oom()))
        assert sbs[0].closed and sbs[1].closed

    def test_auto_closeable_target_size(self):
        t = R.AutoCloseableTargetSize(1000, 300)
        t2 = t.split()
        assert t2.target == 500
        with pytest.raises(R.SplitAndRetryOOM):
            t2.split()  # 250 < 300

    def test_cuda_oom_is_retried(self, catalog):
        """A torch.cuda.OutOfMemoryError inside the frame is a RetryOOM:
        the frame spills the runtime's catalog and runs the work again."""
        DM.initialize(TorchConf(), torch.device("cpu"))
        h = DM.get_runtime().catalog.add_device_batch(make_batch(seed=1))
        calls = []

        def work():
            calls.append(1)
            if len(calls) < 3:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
            return "ok"

        before = R.RETRY_COUNT
        assert R.with_retry_no_split(None, work) == "ok"
        assert len(calls) == 3
        assert R.RETRY_COUNT - before == 2
        assert DM.get_runtime().catalog.tier_of(h) == StorageTier.HOST

    def test_cuda_oom_gives_up_after_max_retries(self, catalog):
        sb = SpillableColumnarBatch.from_device(make_batch(10),
                                                catalog=catalog)

        def work(_s):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")

        with pytest.raises(MemoryError, match="giving up after 3"):
            R.with_retry_no_split(None, lambda: work(None), max_retries=2)
        with pytest.raises(MemoryError, match="giving up after 2"):
            list(R.with_retry(sb, work, max_retries=1))
        assert sb.closed


class TestSpillable:
    def test_lifecycle(self, catalog):
        b = make_batch(seed=9)
        expect = host_rows(catalog, b)
        with SpillableColumnarBatch.from_device(b, catalog=catalog) as sb:
            assert sb.row_count == 2048
            assert host_rows(catalog, sb.get_batch()) == expect
            sb.make_unspillable()
            catalog.synchronous_spill(None)
            assert sb.tier == StorageTier.DEVICE
            sb.make_spillable()
            catalog.synchronous_spill(None)
            assert sb.tier == StorageTier.HOST
            assert sb.get_host_batch().to_pydict() == expect
        assert sb.closed

    def test_from_host(self, catalog):
        hb = batch_from_pydict({"x": np.arange(10, dtype=np.int64)})
        sb = SpillableColumnarBatch.from_host(hb, catalog=catalog)
        assert sb.get_batch().row_count == 10
        sb.close()


class TestRuntime:
    def test_pool_from_conf(self):
        TorchSession({"spark.rapids.tpu.memory.pool.size": "128m"},
                     device="cpu")
        assert DM.get_runtime().catalog.device_limit == 128 << 20
        assert DM.free_device_headroom(4) == 32 << 20
        DM.shutdown()
        TorchSession({"spark.rapids.memory.gpu.allocFraction": "0.5"},
                     device="cpu")
        assert DM.get_runtime().catalog.device_limit == \
            DM.CPU_DEVICE_BYTES // 2

    def test_second_session_warns_until_shutdown(self, caplog):
        TorchSession({"spark.rapids.tpu.memory.pool.size": "1m"},
                     device="cpu")
        with caplog.at_level(logging.WARNING):
            TorchSession({"spark.rapids.tpu.memory.pool.size": "2m"},
                         device="cpu")
        assert "startup conf spark.rapids.tpu.memory.pool.size" in \
            caplog.text
        assert DM.get_runtime().catalog.device_limit == 1 << 20
        DM.shutdown()
        TorchSession({"spark.rapids.tpu.memory.pool.size": "2m"},
                     device="cpu")
        assert DM.get_runtime().catalog.device_limit == 2 << 20

    def test_card_session_reshapes_a_cpu_pool(self, caplog):
        """A runtime made for the CPU (the 4 GiB stand-in) is made anew
        for the first card session while its catalog is empty; a CPU
        session after that shares the card's pool.  With a buffer in it,
        the card session is warned and shares it."""
        TorchSession(device="cpu")
        assert DM.get_runtime().catalog.device_limit == \
            int(DM.CPU_DEVICE_BYTES * 0.8)
        card = TorchConf({"spark.rapids.tpu.memory.pool.size": "64m"})
        rt = DM.initialize(card, torch.device("cuda", 0))
        assert rt.device.type == "cuda"
        assert rt.catalog.device_limit == 64 << 20
        TorchSession(device="cpu")
        assert DM.get_runtime() is rt
        DM.shutdown()
        TorchSession(device="cpu")
        h = DM.get_runtime().catalog.add_device_batch(make_batch())
        with caplog.at_level(logging.WARNING):
            rt = DM.initialize(card, torch.device("cuda", 0))
        assert "holds buffers" in caplog.text
        assert rt.device.type == "cpu" and rt.catalog.tier_of(h) == \
            StorageTier.DEVICE

    def test_zlib_codec_refused(self):
        with pytest.raises(ValueError, match="zlib"):
            TorchConf({"spark.rapids.memory.spill.codec": "zlib"})


class TestHandoff:
    def test_spillable_pieces_hand_over(self):
        """spillable_pieces empties the list it is given, so once every
        piece has spilled nothing holds the batch's planes."""
        import weakref

        from spark_rapids_tpu_torch.memory.spillable import spillable_pieces
        DM.initialize(TorchConf({"spark.rapids.tpu.memory.pool.size":
                                 "64k"}), torch.device("cpu"))
        b = make_batch(n=4096, seed=3)
        expect = CPU.download_batch(b).to_pydict()
        alive = weakref.ref(b.columns[0].data)
        batches = [b]
        del b
        spills = spillable_pieces(batches, CPU)
        assert batches == [] and len(spills) > 1 and alive() is not None
        DM.get_runtime().catalog.synchronous_spill(None)
        assert alive() is None
        got = {k: [] for k in expect}
        for sb in spills:
            for k, v in sb.get_host_batch().to_pydict().items():
                got[k] += list(v)
        assert got == {k: list(v) for k, v in expect.items()}

    def test_out_of_core_sort_keeps_a_cached_scan(self):
        """The external sort takes a list of its own from the scan, whose
        cached device batches stay as they were: a second run of the same
        DataFrame sorts the same rows."""
        from spark_rapids_tpu_torch import functions as F
        rng = np.random.default_rng(4)
        d = {"k": rng.integers(0, 50, 3000).astype(np.int64),
             "v": rng.normal(size=3000)}
        s = TorchSession({"spark.rapids.sql.test.sort.forceOutOfCore":
                          "true",
                          "spark.rapids.tpu.memory.pool.size": "16k"},
                         device="cpu")
        df = s.create_dataframe(d, num_partitions=2)
        first = df.order_by(F.asc("k"), F.asc("v")).collect()
        again = df.order_by(F.asc("k"), F.asc("v")).collect()
        order = np.lexsort((d["v"], d["k"]))
        assert first == again
        assert [r["k"] for r in first] == d["k"][order].tolist()
        assert DM.memory_stats()["device_to_host"] > 0

