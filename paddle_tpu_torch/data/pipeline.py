"""Device-prefetching input pipeline (counterpart of
`paddle_tpu/data/pipeline.py`; the reference's DoubleBuffer,
DataProvider.h:249, plus the host-to-device leg).

`DevicePrefetcher` moves the feeder and the host-to-device copy off the
training loop: a worker thread runs the feeder, pins each slot in host
memory and copies it to the device on a copy stream of its own, keeping up
to `prefetch_depth` batches ahead, so input preparation and the copies
overlap the step. The consumer side makes the current stream wait for each
batch's copy event and marks the tensors as used on that stream
(`record_stream`) before it hands the batch out, so the trainer reads the
copied values and the allocator does not reuse their memory for the copy
stream early. On the CPU the worker only feeds and converts.

`SGDTrainer.train` and `test` take such batches as they are
(`is_device_batch`), and a `StackedBatch` of K as one K-step dispatch.

With `parallel` (a `parallel.DataParallel`), each batch pads on the worker
through `maybe_pad_batch` (an indivisible trailing batch gains repeated
rows and a row mask instead of dropping) and the rank copies only its own
rows to its device (`shard_batch` / `shard_batches`); the trainer takes
those batches as its cut. Each such batch keeps the feed-ready global batch
it was cut from on the host (`host`; a list of them for a stack) while it
is in flight: after an elastic resize the trainer re-pads and re-cuts the
batches prepared for the old plan from there, since a rank's rows cannot
be cut again for another rank index. `rebind_parallel` points later
batches at another plan."""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.core import faults, stats
from paddle_tpu_torch.device import DeviceLike, resolve_device

log = logging.getLogger("paddle_tpu_torch.pipeline")

_STOP = object()


class StackedBatch(dict):
    """K feed-ready batches stacked on a leading K axis: the payload of one
    K-step dispatch (`SGDTrainer.train` runs it through `multi_step`).
    Still a plain dict of tensors; `k` is the stack's width."""

    k: int = 1
    plan = None  # the DataParallel whose rank's rows these are, if any
    host = None  # under a plan: the K feed-ready global batches, on the host


class _Group(list):
    """A stack_k-sized run of raw reader items (worker side only)."""


class _Singles(list):
    """Prepared single batches the consumer yields one by one: a trailing
    remainder, or a group whose members do not stack."""


def iter_async(reader: Callable, prepare: Callable[[Any], Any], capacity: int,
               name: str = "paddle-tpu-torch-async-producer", retries: int = 0,
               stall_warn_s: Optional[float] = None):
    """The background-producer loop shared by DoubleBuffer and
    DevicePrefetcher: a worker thread runs `prepare(raw)` over `reader()`
    and keeps up to `capacity` results ahead of the consumer. Items come out
    in reader order; a worker exception re-raises in the consumer with the
    worker's traceback;
    abandoning the generator retires the worker at its next bounded put.

    retries: a failing `prepare` is retried that many times on the same
    item, with a short growing backoff, before its error propagates;
    reader() errors are never retried. stall_warn_s (default
    $PADDLE_TPU_STALL_WARN_S or 30; <= 0 disables): the consumer logs a
    warning whenever it has waited that long for the producer."""
    if stall_warn_s is None:
        stall_warn_s = float(os.environ.get("PADDLE_TPU_STALL_WARN_S", "30"))
    if stall_warn_s <= 0:
        stall_warn_s = None
    q: "queue.Queue" = queue.Queue(maxsize=capacity)
    err: List[BaseException] = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def prepare_with_retry(raw):
        for attempt in range(retries + 1):
            try:
                faults.get().maybe_raise("feeder_raise")
                return prepare(raw)
            except Exception as e:
                if attempt >= retries:
                    raise
                stats.FT_EVENTS.incr("feeder_retry")
                log.warning("%s: prepare failed (%s: %s), retry %d/%d", name,
                            type(e).__name__, e, attempt + 1, retries)
                time.sleep(min(0.05 * 2 ** attempt, 1.0))

    def work():
        try:
            for raw in reader():
                if not put(prepare_with_retry(raw)):
                    return
        except BaseException as e:  # handed to the consumer, which re-raises it
            err.append(e)
        finally:
            put(_STOP)

    t = threading.Thread(target=work, daemon=True, name=name)
    t.start()
    try:
        while True:
            try:
                item = q.get(timeout=stall_warn_s)
            except queue.Empty:
                stats.FT_EVENTS.incr("pipeline_stall")
                log.warning("%s: consumer starved for > %.1fs waiting on the producer "
                            "thread (feeder wedged or reader stalled?)", name, stall_warn_s)
                continue
            if item is _STOP:
                break
            yield item
        t.join()
        if err:
            raise err[0]
    finally:
        stop.set()


def _retag(values: Dict[str, Any], like: Any) -> Dict[str, Any]:
    """`values` in a dict of `like`'s class, keeping its `k`, `plan` and
    `host`."""
    if type(like) is dict:
        return values
    out = type(like)(values)
    for attr in ("k", "plan", "host"):
        if hasattr(like, attr):
            setattr(out, attr, getattr(like, attr))
    return out


def _with_host(batch: Any, host: Dict[str, Any]) -> Any:
    batch.host = host
    return batch


def is_device_batch(batch: Any) -> bool:
    """True when `batch` is a non-empty dict whose every slot is already a
    torch tensor (the trainer feeds it as it is)."""
    return (isinstance(batch, dict) and bool(batch)
            and all(isinstance(v, torch.Tensor) for v in batch.values()))


def coerce_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
    """numpy-ify a dict batch, failing fast on ragged or object slots."""
    out: Dict[str, Any] = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)):
            out[k] = v
            continue
        arr = np.asarray(v)
        if arr.dtype == object:
            raise ValueError(f"batch slot {k!r} is ragged or non-numeric; feed it through "
                             "a DataFeeder (which pads sequences) instead of a raw dict")
        out[k] = arr
    return out


class DevicePrefetcher:
    """Host feed and host-to-device copy in a worker thread, ahead of the
    training step.

    reader: callable returning an iterator of raw batches (sample lists with
        `feeder`, else feed-ready dict batches, e.g. from a DoubleBuffer).
    feeder: optional DataFeeder, run on the worker thread.
    prefetch_depth: how many device batches to keep ahead.
    device: where the batches go (None means CUDA, as everywhere in the
        port; "cpu" converts to tensors only).
    feed_retries: a failing feed or copy is retried that many times.
    stack_k: > 1 stacks K consecutive batches into one StackedBatch
        ([K, B, ...] a slot, one copy); a trailing remainder, or a group
        whose shapes differ, comes out as single batches.
    parallel: a `parallel.DataParallel`: batches pad to its data axis and
        only this rank's rows are copied (to the mesh's device).

    One iteration is one pass. Worker errors surface in the consumer;
    abandoning the iterator retires the worker."""

    def __init__(self, reader: Callable, feeder: Optional[Callable] = None,
                 prefetch_depth: int = 2, device: DeviceLike = None,
                 feed_retries: int = 2, stack_k: int = 1, parallel: Any = None):
        if prefetch_depth < 1:
            raise ValueError(f"prefetch_depth must be >= 1, got {prefetch_depth}")
        if stack_k < 1:
            raise ValueError(f"stack_k must be >= 1, got {stack_k}")
        self.reader = reader
        self.feeder = feeder
        self.prefetch_depth = prefetch_depth
        self.parallel = parallel
        self.device = (parallel.device if parallel is not None and device is None
                       else resolve_device(device))
        self.feed_retries = feed_retries
        self.stack_k = stack_k
        self._stream: Optional[torch.cuda.Stream] = None

    def __call__(self):
        return iter(self)

    def rebind_parallel(self, parallel: Any) -> None:
        """Point later batches at another DataParallel plan; each batch reads
        the plan once, so none is padded for one plan and cut for another."""
        self.parallel = parallel

    def _feed(self, raw: Any) -> Dict[str, Any]:
        return (self.feeder(raw) if self.feeder is not None and not isinstance(raw, dict)
                else coerce_batch(raw))


    def _to_device(self, batch: Dict[str, Any]):
        """A feed-ready host batch -> (tensors on the device, the copies'
        CUDA event or None), in a dict of the batch's type with its tags.
        The `h2d_delay` fault site sleeps here, once a copy."""
        faults.get().sleep("h2d_delay")
        host = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
                for k, v in batch.items()}
        if self.device.type != "cuda":
            out = {k: v.to(self.device) for k, v in host.items()}
            return _retag(out, batch), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            out = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        return _retag(out, batch), done

    def _pad(self, batch: Dict[str, Any], plan: Any) -> Optional[Dict[str, Any]]:
        return batch if plan is None else plan.maybe_pad_batch(batch, where="prefetch")

    def _prepare(self, raw: Any):
        plan = self.parallel  # read once: a rebind never splits a batch
        fed = self._feed(raw)
        batch = self._pad(fed, plan)
        if batch is None:
            return None
        if plan is not None:
            batch = plan.shard_batch(batch)
            batch.host = fed
        return self._to_device(batch)

    def _grouped_reader(self):
        buf: List[Any] = []
        for raw in self.reader():
            buf.append(raw)
            if len(buf) == self.stack_k:
                yield _Group(buf)
                buf = []
        if buf:
            yield _Group(buf)

    def _prepare_group(self, group: _Group):
        plan = self.parallel
        fed = [self._feed(raw) for raw in group]
        pairs = [(f, b) for f, b in ((f, self._pad(f, plan)) for f in fed) if b is not None]
        batches = [b for _, b in pairs]
        if (len(batches) != self.stack_k
                or len({stats.batch_signature(b) for b in batches}) != 1):
            return _Singles(self._to_device(b if plan is None else _with_host(
                plan.shard_batch(b), f)) for f, b in pairs)
        stacked = {k: np.stack([np.asarray(b[k]) for b in batches]) for k in batches[0]}
        out, done = self._to_device(stacked if plan is None else plan.shard_batches(stacked))
        sb = StackedBatch(out)
        sb.k, sb.plan = self.stack_k, plan
        if plan is not None:
            sb.host = [f for f, _ in pairs]
        return sb, done

    def _ready(self, item):
        """(batch, event) -> the batch, safe to read on the current stream."""
        batch, done = item
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            for v in batch.values():
                v.record_stream(cur)
        return batch

    def __iter__(self):
        if self.stack_k <= 1:
            items = iter_async(self.reader, self._prepare, self.prefetch_depth,
                               name="paddle-tpu-torch-device-prefetch",
                               retries=self.feed_retries)
        else:
            items = iter_async(self._grouped_reader, self._prepare_group,
                               self.prefetch_depth, name="paddle-tpu-torch-device-prefetch",
                               retries=self.feed_retries)
        try:
            for item in items:
                if item is None:  # a ragged batch the plan could not pad
                    continue
                for one in (item if isinstance(item, _Singles) else [item]):
                    yield self._ready(one)
        finally:
            items.close()  # retire the worker when the consumer stops early
