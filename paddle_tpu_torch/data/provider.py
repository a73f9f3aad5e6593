"""PyDataProvider2 (the port's copy of `paddle_tpu/data/provider.py`): the
`@provider` decorator and its settings, `MultiDataProvider`'s ratio mixing,
the `DoubleBuffer` background prefetch of converted batches, and
`DataProviderConverter` (input types and names to a DataFeeder). The
shuffles use `random.Random` with the same seeds, so the same samples come
out in the same order as from the JAX package's providers.

Parity targets: the `@provider` decorator and input types
(python/paddle/trainer/PyDataProvider2.py:365), DataProvider.h:249
`DoubleBuffer`, and gserver/dataproviders/MultiDataProvider.cpp.
"""

from __future__ import annotations

import functools
import importlib
import importlib.util
import json
import logging
import os
import random
import sys
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

from paddle_tpu_torch.data.feeder import DataFeeder
from paddle_tpu_torch.data.pipeline import iter_async

log = logging.getLogger("paddle_tpu_torch.provider")


class CacheType:
    NO_CACHE = 0
    CACHE_PASS_IN_MEM = 1


class Settings:
    """The `settings` object handed to user providers (PyDataProvider2.py's
    DataProviderSettings): carries input_types plus anything init_hook sets."""

    def __init__(self, input_types=None, **kwargs):
        self.input_types = input_types
        self.logger = log
        for k, v in kwargs.items():
            setattr(self, k, v)

    # the reference exposes the same field under both names; init_hooks in the
    # wild assign either `settings.slots = [...]` or `settings.input_types`
    @property
    def slots(self):
        return self.input_types

    @slots.setter
    def slots(self, value):
        self.input_types = value


class DataProviderWrapper:
    """Result of @provider: callable over file list(s), exposing the reader
    protocol (`__call__(obj, *files) -> iterator of samples`) plus metadata."""

    def __init__(
        self,
        generator: Callable,
        input_types=None,
        should_shuffle: Optional[bool] = None,
        pool_size: int = -1,
        min_pool_size: int = -1,
        can_over_batch_size: bool = True,
        calc_batch_size: Optional[Callable] = None,
        cache: int = CacheType.NO_CACHE,
        init_hook: Optional[Callable] = None,
        check: bool = False,
        check_fail_continue: bool = False,
    ):
        self.generator = generator
        self.input_types = input_types
        # None keeps the reference semantics: shuffle during training only
        # (PyDataProvider2.py provider(): should_shuffle=None → train-only)
        self.should_shuffle = should_shuffle
        self.pool_size = pool_size
        self.min_pool_size = min_pool_size
        self.can_over_batch_size = can_over_batch_size
        self.calc_batch_size = calc_batch_size
        self.cache = cache
        self.init_hook = init_hook
        self.check = check
        self.check_fail_continue = check_fail_continue
        # pass cache keyed by file_list so train/test calls don't cross-serve
        self._pass_cache: Dict[tuple, List[Any]] = {}
        self._epoch = 0  # reshuffle differently each pass, like the reference
        functools.wraps(generator)(self)

    # -- settings -----------------------------------------------------------
    def make_settings(self, obj=None, file_list: Sequence[str] = (), **kwargs) -> Settings:
        settings = Settings(input_types=self.input_types)
        if self.init_hook is not None:
            self.init_hook(settings, obj=obj, file_list=list(file_list), **kwargs)
        return settings

    # -- iteration ----------------------------------------------------------
    def __call__(
        self,
        obj=None,
        file_list: Union[str, Sequence[str], None] = None,
        is_train: bool = True,
        **kwargs,
    ):
        """Returns an iterator over samples from all files (shuffle-pooled like
        the reference's pool_size window shuffle). `is_train=False` (test /
        inference readers) disables the default shuffle, matching the
        reference's should_shuffle=None train-only semantics."""
        if isinstance(file_list, str):
            file_list = [file_list]
        file_list = list(file_list or [None])
        settings = self.make_settings(obj=obj, file_list=file_list, **kwargs)
        cache_key = tuple(file_list)

        def iter_all():
            cached = self._pass_cache.get(cache_key)
            if self.cache == CacheType.CACHE_PASS_IN_MEM and cached is not None:
                yield from cached
                return
            collected = [] if self.cache == CacheType.CACHE_PASS_IN_MEM else None
            for fname in file_list:
                gen = (
                    self.generator(settings, fname)
                    if fname is not None
                    else self.generator(settings)
                )
                for sample in gen:
                    if self.check and not _check_sample(settings.input_types, sample):
                        if self.check_fail_continue:
                            continue
                        raise ValueError(f"sample fails input_types check: {sample!r}")
                    if collected is not None:
                        collected.append(sample)
                    yield sample
            if collected is not None:
                # only a fully consumed pass is a valid cache
                self._pass_cache[cache_key] = collected

        it = iter_all()
        shuffle = is_train if self.should_shuffle is None else self.should_shuffle
        if shuffle:
            pool = self.pool_size if self.pool_size > 0 else 1000
            if self.min_pool_size > 0:
                pool = max(pool, self.min_pool_size)
            self._epoch += 1
            return _pool_shuffle(it, pool, seed=self._epoch)
        return it

    # -- reader-creator adapter ---------------------------------------------
    def as_reader(self, obj=None, file_list=None, **kwargs) -> Callable:
        """v2 reader creator: provider ported datasets plug into paddle.batch."""

        def reader():
            return self(obj=obj, file_list=file_list, **kwargs)

        return reader


def provider(input_types=None, **kwargs):
    """The @provider decorator (PyDataProvider2.py:365).

    Usage (verbatim from reference demos)::

        @provider(input_types={'pixel': dense_vector(784),
                               'label': integer_value(10)})
        def process(settings, filename):
            for ...: yield {'pixel': ..., 'label': ...}
    """

    def wrap(fn):
        return DataProviderWrapper(fn, input_types=input_types, **kwargs)

    return wrap


def _pool_shuffle(it: Iterable, pool_size: int, seed: int = 0):
    rnd = random.Random(seed)
    pool: List[Any] = []
    for item in it:
        pool.append(item)
        if len(pool) >= pool_size:
            rnd.shuffle(pool)
            yield from pool
            pool = []
    rnd.shuffle(pool)
    yield from pool


def _check_sample(input_types, sample) -> bool:
    if input_types is None:
        return True
    specs = (
        list(input_types.values()) if isinstance(input_types, dict) else list(input_types)
    )
    try:
        if isinstance(sample, dict):
            if not isinstance(input_types, dict):
                return False
            values = [sample[k] for k in input_types]
        elif isinstance(sample, (list, tuple)):
            values = list(sample)
        else:
            values = [sample]
    except KeyError:
        return False
    if len(values) != len(specs):
        return False
    for v, spec in zip(values, specs):
        if spec.kind == "index" and not (
            np.isscalar(v) or (isinstance(v, np.ndarray) and v.ndim == 0)
        ):
            return False
        if spec.kind == "dense":
            dim = spec.dim if isinstance(spec.dim, tuple) else (spec.dim,)
            if int(np.prod(np.shape(v))) != int(np.prod(dim)):
                return False
    return True


# ---------------------------------------------------------------------------
# MultiDataProvider: ratio-mixed sub-providers
# ---------------------------------------------------------------------------


class MultiDataProvider:
    """Mixes sub-readers by sampling ratio (MultiDataProvider.cpp). Each entry
    is (reader_creator, ratio); one mixed stream is produced per pass."""

    def __init__(self, providers: Sequence, seed: int = 0):
        self.entries = [(r, float(ratio)) for r, ratio in providers]
        total = sum(r for _, r in self.entries)
        self.probs = [r / total for _, r in self.entries]
        self.seed = seed
        self._epoch = 0  # vary the mixing order per pass

    def __call__(self):
        self._epoch += 1
        rnd = random.Random(self.seed * 1000003 + self._epoch)
        iters = [iter(r()) for r, _ in self.entries]
        alive = list(range(len(iters)))
        while alive:
            i = rnd.choices(alive, weights=[self.probs[j] for j in alive])[0]
            try:
                yield next(iters[i])
            except StopIteration:
                alive.remove(i)


# ---------------------------------------------------------------------------
# DoubleBuffer: background prefetch of converted batches
# ---------------------------------------------------------------------------


class DoubleBuffer:
    """Async batch prefetcher (DataProvider.h:249).

    Wraps a batched reader (+ optional feeder) and keeps up to `capacity`
    ready-to-feed batches in a background thread, so numpy conversion overlaps
    device execution. Use as: `for batch in DoubleBuffer(reader, feeder): ...`;
    one iteration = one pass.

    Host side only: `data.pipeline.DevicePrefetcher` also moves the copy to
    the device off the training thread; a DoubleBuffer composes as the
    reader of a DevicePrefetcher, which then adds just the device leg."""

    def __init__(self, reader: Callable, feeder: Optional[DataFeeder] = None, capacity: int = 4):
        self.reader = reader
        self.feeder = feeder
        self.capacity = capacity

    def __call__(self):
        return iter(self)

    def __iter__(self):
        prepare = self.feeder if self.feeder is not None else (lambda raw: raw)
        return iter_async(
            self.reader, prepare, self.capacity,
            name="paddle-tpu-torch-double-buffer",
        )


# ---------------------------------------------------------------------------
# DataProviderConverter (py_paddle/dataprovider_converter.py)
# ---------------------------------------------------------------------------


class DataProviderConverter:
    """input_types (list or dict) + names → DataFeeder; mirrors the SWIG-era
    converter that turned numpy/scipy rows into C++ Arguments."""

    def __init__(self, input_types, names: Optional[Sequence[str]] = None):
        if isinstance(input_types, dict):
            feeding = dict(input_types)
        else:
            names = list(names or [f"slot{i}" for i in range(len(input_types))])
            feeding = dict(zip(names, input_types))
        self.feeder = DataFeeder(feeding)

    def __call__(self, samples) -> Dict[str, np.ndarray]:
        return self.feeder(samples)


# ---------------------------------------------------------------------------
# A config's data source: loading, slot binding and batching (the reference
# keeps these in cli.py as `_load_provider_module`, `_load_provider`,
# `bind_provider_types` and `_make_reader`)
# ---------------------------------------------------------------------------

# Names injected into legacy provider modules: the reference embedded
# Python 2, so providers in the wild use py2 builtins.
_PY2_SHIMS = {"xrange": range, "unicode": str, "long": int, "basestring": str}


def load_provider_module(name: str, config_dir: str = ""):
    """Import a provider module, preferring the config script's directory
    (PyDataProvider2.cpp loads module.obj next to the config), with py2
    builtin shims, its `paddle.*` imports on the port's modules."""
    from paddle_tpu_torch.compat import paddle_modules

    path = os.path.join(config_dir or ".", name + ".py") if name else None
    with paddle_modules():
        if path and os.path.exists(path):
            spec = importlib.util.spec_from_file_location(name, path)
            mod = importlib.util.module_from_spec(spec)
            mod.__dict__.update(_PY2_SHIMS)
            sys.modules.setdefault(name, mod)
            spec.loader.exec_module(mod)
            return mod
        if config_dir and config_dir not in sys.path:
            sys.path.insert(0, config_dir)
        mod = importlib.import_module(name)
    for k, v in _PY2_SHIMS.items():
        mod.__dict__.setdefault(k, v)
    return mod


def load_provider(dc):
    """DataConfig -> (provider, file_list, args): the PyDataProvider2 load
    path (gserver/dataproviders/PyDataProvider2.cpp:195 loads module.obj),
    or the builtin ProtoData provider of binary shards (`type: proto*`,
    REGISTER_DATA_PROVIDER proto / proto_sequence,
    ProtoDataProvider.cpp:31; `data/proto_data.py`)."""
    if (dc.type or "").startswith("proto"):
        from paddle_tpu_torch.data.proto_data import make_proto_provider, resolve_data_path

        # one provider per DataConfig: bind_provider_types and make_reader
        # both land here, and the provider caches all decoded shards
        provider = getattr(dc, "_builtin_provider", None)
        if provider is None:
            provider = make_proto_provider(dc)
            dc._builtin_provider = provider
        files: List[str] = []
        flist = resolve_data_path(dc.files, dc.config_dir or "") or dc.files
        if flist and os.path.exists(flist):
            with open(flist) as f:
                files = [ln.strip() for ln in f if ln.strip()]
        elif flist:
            files = [flist]
        return provider, files, None
    mod = load_provider_module(dc.load_data_module, dc.config_dir)
    provider = getattr(mod, dc.load_data_object)
    files: List[str] = []
    flist = dc.files
    if flist and not os.path.exists(flist) and dc.config_dir:
        cand = os.path.join(dc.config_dir, flist)
        if os.path.exists(cand):
            flist = cand
    if flist and os.path.exists(flist):
        with open(flist) as f:
            files = [ln.strip() for ln in f if ln.strip()]
    elif flist:
        files = [flist]
    args = json.loads(dc.load_data_args) if dc.load_data_args else None
    return provider, files, args


def bind_provider_types(topology, dc) -> Optional[Dict[str, int]]:
    """Bind the provider's input_types to the topology's data layers (the
    runtime slot binding PyDataProvider2.cpp does) -> {layer name: slot
    index}. Dict input_types bind by name; list input_types bind
    positionally over the data layers (in Inputs() order when the config
    declared one), except that dense slots whose declared sizes disagree
    rebind to the layers whose sizes match (DataProviderConverter)."""
    from paddle_tpu_torch.nn.graph import record_layers
    from paddle_tpu_torch.v2.layer import data as _v2_data

    provider, files, args = load_provider(dc)
    kwargs = dict(args) if isinstance(args, dict) else {}
    types = provider.make_settings(obj=None, file_list=files, **kwargs).input_types
    if types is None:
        return None
    layers = list(topology.data_layers().values())
    declared = getattr(topology, "declared_inputs", None)
    if declared:
        by_name = {l.name: l for l in layers}
        picked = [by_name[n] for n in declared if n in by_name]
        if len(picked) == len(layers):
            layers = picked

    def apply_spec(layer, spec):
        with record_layers([]):  # a shape probe only: kept out of the graph
            tmpl = _v2_data(layer.name + ".__tmpl__", spec)
        layer.data_type = spec
        layer.shape = tmpl.shape
        layer.is_seq = tmpl.is_seq

    if isinstance(types, dict):
        feeding = {}
        for i, (lname, spec) in enumerate(types.items()):
            layer = topology.data_layers().get(lname)
            if layer is None:
                raise ValueError(f"provider input_types names unknown layer {lname!r}")
            apply_spec(layer, spec)
            feeding[lname] = i
        return feeding
    types = list(types)
    if len(types) != len(layers):
        raise ValueError(f"provider declares {len(types)} slots but the config has "
                         f"{len(layers)} data layers")

    def declared_size(layer):
        size = getattr(layer, "_v1_size", None)
        if size is None and getattr(layer, "shape", None):
            size = 1
            for d in layer.shape:
                size *= int(d)
        return size

    def compatible(layer, spec) -> bool:
        if spec.kind.startswith("dense") and not isinstance(spec.dim, tuple):
            return declared_size(layer) in (None, int(spec.dim))
        return True

    order = list(layers)
    if not all(compatible(l, s) for l, s in zip(order, types)):
        remaining = list(layers)
        order = []
        for spec in types:
            pick = next((l for l in remaining if compatible(l, spec)), remaining[0])
            remaining.remove(pick)
            order.append(pick)
    for layer, spec in zip(order, types):
        apply_spec(layer, spec)
    return {layer.name: i for i, layer in enumerate(order)}


def make_reader(dc, batch_size: int, is_train: bool = True) -> Callable:
    """A reader of sample lists of `batch_size` from the config's provider,
    with the @provider batching knobs: calc_batch_size gives a sample's
    cost (e.g. its token count), can_over_batch_size whether the sample
    that overflows stays in the batch or starts the next."""
    provider, files, args = load_provider(dc)
    kwargs = dict(args) if isinstance(args, dict) else {}
    calc = getattr(provider, "calc_batch_size", None)
    can_over = getattr(provider, "can_over_batch_size", True)

    def reader():
        batch: List[Any] = []
        acc = 0
        for sample in provider(obj=None, file_list=files or None, is_train=is_train,
                               **kwargs):
            cost = int(calc(sample)) if calc is not None else 1
            if batch and not can_over and acc + cost > batch_size:
                yield batch
                batch, acc = [], 0
            batch.append(sample)
            acc += cost
            if acc >= batch_size:
                yield batch
                batch, acc = [], 0
        if batch:
            yield batch

    return reader
