"""The OOM retry and split-and-retry discipline, with deterministic fault
injection (the analog of ``spark_rapids_tpu/memory/retry.py:28-290``).

- ``RetryOOM``: the work may succeed if run again after memory is
  relieved.  A retry frame spills the catalog and runs it again.
- ``SplitAndRetryOOM``: running again alone will not help; the input must
  be split first.  Only the top-most ``with_retry`` frame of a thread
  splits; nested frames re-raise, so the outermost owner of the inputs
  decides.

New in the port: a ``torch.cuda.OutOfMemoryError`` raised inside a retry
frame is taken as a ``RetryOOM``.  Before the next attempt the frame
returns the caching allocator's free blocks (``torch.cuda.empty_cache``)
and spills the catalog synchronously; after ``max_retries`` attempts it
gives up with ``MemoryError``, as the JAX package does.  Nothing else in
the port catches that error.  A spill frees card memory only for the
batches the catalog alone holds: the out-of-core paths hand theirs over
(``spillable_pieces`` empties its list, ``plan/base.py
owned_partitions`` drops the child's reference), while a cached scan's
batches and what the eager ``Partitions`` lists of other execs hold stay
on the card.  The JAX package's chaos hook, event log and
task metrics have no counterpart here: the process totals
``RETRY_COUNT`` and ``SPLIT_RETRY_COUNT`` count what its metrics
counted."""

from __future__ import annotations

import threading
from typing import Callable, Iterator, List, TypeVar

import torch

X = TypeVar("X")

#: retries and split retries of every thread (what the JAX package's task
#: metrics count), read by ``device_manager.memory_stats``
RETRY_COUNT = 0
SPLIT_RETRY_COUNT = 0
_COUNT_LOCK = threading.Lock()


class RetryOOM(MemoryError):
    """Work should be retried after memory pressure is relieved."""


class SplitAndRetryOOM(MemoryError):
    """Work must be split smaller and retried."""


#: what a retry frame takes as a RetryOOM
_RETRYABLE = (RetryOOM, torch.cuda.OutOfMemoryError)


class _TaskContext(threading.local):
    """Per-thread state: the frames open, the retries taken, and the
    injection armed by ``force_retry_oom``/``force_split_and_retry_oom``."""

    def __init__(self):
        self.retry_count = 0
        self.split_retry_count = 0
        self.retry_frame_depth = 0
        self.inject_retry_oom = 0
        self.inject_retry_skip = 0
        self.inject_split_oom = 0
        self.inject_split_skip = 0
        #: injection fires only inside a retry frame (an unframed fault
        #: would escape as an error)
        self.inject_framed_only = False


_TL = _TaskContext()


def task_context() -> _TaskContext:
    return _TL


def force_retry_oom(num_ooms: int = 1, skip: int = 0,
                    framed_only: bool = False) -> None:
    """Arms RetryOOM on this thread's next ``num_ooms`` tracked
    allocation points after skipping ``skip`` of them."""
    _TL.inject_retry_oom = num_ooms
    _TL.inject_retry_skip = skip
    _TL.inject_framed_only = framed_only


def force_split_and_retry_oom(num_ooms: int = 1, skip: int = 0) -> None:
    """Arms SplitAndRetryOOM likewise."""
    _TL.inject_split_oom = num_ooms
    _TL.inject_split_skip = skip


def maybe_inject_oom() -> None:
    """Called at the tracked allocation points (catalog reservations, the
    out-of-core paths' attempts): raises what was armed."""
    if _TL.inject_retry_oom > 0:
        if _TL.inject_framed_only and _TL.retry_frame_depth == 0:
            pass
        elif _TL.inject_retry_skip > 0:
            _TL.inject_retry_skip -= 1
        else:
            _TL.inject_retry_oom -= 1
            raise RetryOOM("injected RetryOOM")
    if _TL.inject_split_oom > 0:
        if _TL.inject_split_skip > 0:
            _TL.inject_split_skip -= 1
        else:
            _TL.inject_split_oom -= 1
            raise SplitAndRetryOOM("injected SplitAndRetryOOM")


class AutoCloseableTargetSize:
    """A target size halved on each split, down to a floor."""

    def __init__(self, target: int, minimum: int):
        self.target = max(target, minimum)
        self.minimum = minimum

    def split(self) -> "AutoCloseableTargetSize":
        halved = self.target // 2
        if halved < self.minimum:
            raise SplitAndRetryOOM(
                f"cannot split target {self.target} below minimum "
                f"{self.minimum}")
        return AutoCloseableTargetSize(halved, self.minimum)


def split_half_by_rows(spillable) -> List:
    """The default split: a spillable batch in two halves by rows, on the
    host tier."""
    from spark_rapids_tpu_torch.memory.spillable import \
        SpillableColumnarBatch
    batch = spillable.get_host_batch()
    n = batch.row_count
    if n < 2:
        raise SplitAndRetryOOM("cannot split a batch with fewer than 2 rows")
    catalog = spillable.catalog
    spillable.close()
    mid = n // 2
    return [SpillableColumnarBatch.from_host(batch.slice(0, mid),
                                             spillable.priority, catalog),
            SpillableColumnarBatch.from_host(batch.slice(mid, n - mid),
                                             spillable.priority, catalog)]


def _count(split: bool) -> None:
    global RETRY_COUNT, SPLIT_RETRY_COUNT
    with _COUNT_LOCK:
        if split:
            SPLIT_RETRY_COUNT += 1
        else:
            RETRY_COUNT += 1


def _relieve_pressure() -> None:
    """Between attempts: the allocator's free blocks back to the card and
    a synchronous spill of every spillable device buffer."""
    from spark_rapids_tpu_torch.memory.device_manager import get_runtime
    torch.cuda.empty_cache()
    rt = get_runtime()
    if rt is not None:
        rt.catalog.synchronous_spill(None)


def _retried(attempts: int, max_retries: int, e: BaseException) -> None:
    _TL.retry_count += 1
    _count(False)
    if attempts > max_retries:
        raise MemoryError(f"giving up after {attempts} RetryOOMs") from e
    _relieve_pressure()


def with_retry_no_split(spillable_or_none, fn: Callable[..., X],
                        max_retries: int = 100) -> X:
    """Runs ``fn(spillable)`` (or ``fn()``), retrying on RetryOOM; a
    SplitAndRetryOOM passes through."""
    _TL.retry_frame_depth += 1
    try:
        attempts = 0
        while True:
            try:
                if spillable_or_none is None:
                    return fn()
                return fn(spillable_or_none)
            except _RETRYABLE as e:
                attempts += 1
                _retried(attempts, max_retries, e)
    finally:
        _TL.retry_frame_depth -= 1


def with_retry(spillables, fn: Callable[..., X],
               split_policy: Callable = split_half_by_rows,
               max_retries: int = 100) -> Iterator[X]:
    """Runs ``fn`` over each spillable input, retrying on RetryOOM and
    splitting the input on SplitAndRetryOOM where this is the thread's
    top frame (decided when called, not when first iterated)."""
    if not isinstance(spillables, (list, tuple)):
        spillables = [spillables]
    top_level = _TL.retry_frame_depth == 0
    return _with_retry_gen(list(spillables), fn, split_policy, max_retries,
                           top_level)


def _close_quietly(spillable) -> None:
    close = getattr(spillable, "close", None)
    if close is None:
        return
    try:
        close()
    except Exception:   # noqa: BLE001 - cleanup must not mask the cause
        pass


def _with_retry_gen(queue, fn, split_policy, max_retries, top_level):
    _TL.retry_frame_depth += 1
    item = None
    done = False
    try:
        while queue:
            item = queue.pop(0)
            attempts = 0
            while True:
                try:
                    yield fn(item)
                    # delivered: the item is the caller's now
                    item = None
                    break
                except GeneratorExit:
                    item = None
                    raise
                except _RETRYABLE as e:
                    attempts += 1
                    _retried(attempts, max_retries, e)
                except SplitAndRetryOOM:
                    if not top_level:
                        raise
                    _TL.split_retry_count += 1
                    _count(True)
                    pieces = split_policy(item)
                    # the policy closed the item; the queue owns the pieces
                    item = None
                    queue = pieces + queue
                    break
        done = True
    finally:
        _TL.retry_frame_depth -= 1
        if not done:
            # an early exit (MemoryError, split exhaustion, the caller
            # abandoning the iteration): close what is in flight and
            # queued, or it would pin catalog bytes
            if item is not None:
                _close_quietly(item)
            for pending in queue:
                _close_quietly(pending)


def drain_with_retry(spillables, fn: Callable[..., X],
                     split_policy: Callable = split_half_by_rows) -> List[X]:
    """``with_retry`` as a list."""
    return list(with_retry(spillables, fn, split_policy))
