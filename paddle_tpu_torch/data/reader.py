"""Reader creators and combinators (the port's copy of
`paddle_tpu/data/reader.py`).

API parity with python/paddle/v2/reader (decorator.py: map_readers, buffered,
compose, chain, shuffle, firstn, xmap_readers; creator.py). A reader is a
zero-arg callable returning an iterable of samples — identical contract to the
reference, so user data pipelines port unchanged, and the same samples come
out in the same order as from the JAX package's combinators."""

from __future__ import annotations

import itertools
import queue as _queue
import random
import threading
from typing import Any, Callable, Iterable, Iterator, List

Reader = Callable[[], Iterable[Any]]


class ComposeNotAligned(ValueError):
    pass


def map_readers(func, *readers: Reader) -> Reader:
    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def shuffle(reader: Reader, buf_size: int) -> Reader:
    def shuffled():
        buf: List[Any] = []
        for sample in reader():
            buf.append(sample)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b

    return shuffled


def chain(*readers: Reader) -> Reader:
    def chained():
        for r in readers:
            for sample in r():
                yield sample

    return chained


def compose(*readers: Reader, check_alignment: bool = True) -> Reader:
    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def composed():
        rs = [r() for r in readers]
        if check_alignment:
            for items in itertools.zip_longest(*rs):
                if any(i is None for i in items):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned in compose()"
                    )
                yield sum((make_tuple(i) for i in items), ())
        else:
            for items in zip(*rs):
                yield sum((make_tuple(i) for i in items), ())

    return composed


def buffered(reader: Reader, size: int) -> Reader:
    """Double-buffering in a producer thread — the analog of the async
    DoubleBuffer in gserver/dataproviders/DataProvider.h:249."""

    end = object()

    def buffered_reader():
        q: _queue.Queue = _queue.Queue(maxsize=size)
        err: List[BaseException] = []

        def produce():
            try:
                for sample in reader():
                    q.put(sample)
            except BaseException as e:  # re-raised on the consumer side
                err.append(e)
            finally:
                q.put(end)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            sample = q.get()
            if sample is end:
                if err:
                    raise err[0]
                return
            yield sample

    return buffered_reader


def firstn(reader: Reader, n: int) -> Reader:
    def rd():
        return itertools.islice(reader(), n)

    return rd


def cache(reader: Reader) -> Reader:
    """CacheType.CACHE_PASS_IN_MEM analog (PyDataProvider2.py): materialize the
    first pass, replay from memory afterwards."""
    store: List[Any] = []
    filled = [False]

    def cached():
        if filled[0]:
            for s in store:
                yield s
            return
        # fill a fresh list; only publish it if the pass was fully consumed
        # (a partially-consumed pass must not poison the cache)
        tmp: List[Any] = []
        for s in reader():
            tmp.append(s)
            yield s
        store[:] = tmp
        filled[0] = True

    return cached


def batch(reader: Reader, batch_size: int, drop_last: bool = False) -> Reader:
    """paddle.batch: group samples into lists of batch_size."""

    def batched():
        b: List[Any] = []
        for sample in reader():
            b.append(sample)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batched


def xmap_readers(mapper, reader: Reader, process_num: int, buffer_size: int, order: bool = False) -> Reader:
    """Parallel map over samples with worker threads (reader/decorator.py
    xmap_readers). Thread-based (numpy releases the GIL)."""

    end = object()

    def xreader():
        in_q: _queue.Queue = _queue.Queue(buffer_size)
        out_q: _queue.Queue = _queue.Queue(buffer_size)
        err: List[BaseException] = []

        def feed():
            try:
                for i, s in enumerate(reader()):
                    in_q.put((i, s))
            except BaseException as e:
                err.append(e)
            finally:
                for _ in range(process_num):
                    in_q.put(end)

        def work():
            try:
                while True:
                    item = in_q.get()
                    if item is end:
                        return
                    i, s = item
                    out_q.put((i, mapper(s)))
            except BaseException as e:
                err.append(e)
            finally:
                out_q.put(end)  # always deliver the sentinel, even on error

        threading.Thread(target=feed, daemon=True).start()
        workers = [threading.Thread(target=work, daemon=True) for _ in range(process_num)]
        for w in workers:
            w.start()
        finished = 0
        pending = {}
        next_idx = 0
        while finished < process_num:
            item = out_q.get()
            if item is end:
                finished += 1
                continue
            if not order:
                yield item[1]
            else:
                pending[item[0]] = item[1]
                while next_idx in pending:
                    yield pending.pop(next_idx)
                    next_idx += 1
        if err:
            raise err[0]
        if order:
            for i in sorted(pending):
                yield pending[i]

    return xreader
