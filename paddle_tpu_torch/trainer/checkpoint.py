"""Checkpoint save/load (counterpart of `paddle_tpu/trainer/checkpoint.py`).

The pass directory is the JAX package's: save_dir/pass-%05d/ holds one
.npz per tree (params / states / opt; an empty tree writes no file), a
manifest.json with the pass id, each file's CRC-32 and its keys' shapes and
dtypes, and the trainer's extra fields (samples, lr_scale, world_size; the
port adds rng and diverged, and a drain's mid_pass and batches_done), and
one v1 binary `Parameter::save` file per parameter (`v1_format.py`), so a
pass directory doubles as a reference model directory. Tree keys are the
JAX package's flattened paths, "/"-joined, dict keys sorted: the optimizer
tree {"opt": {"slots": {name: (m, v)}, "t": t}} flattens to
`opt/slots/<name>/<i>` and `opt/t`, and model averaging's
{"avg": {"avg": {name: a}, "n": n}} beside it to `avg/avg/<name>` and
`avg/n`. save_dir/latest names the newest pass.
Either package loads the other's pass directories.

Writes are atomic (tmp + rename); `keep_last_n` prunes old passes after a
successful write (renamed aside first, so a reader never sees a
half-deleted pass); `verify_pass` / `find_latest_valid_pass` skip torn or
partial passes by their CRCs. The `ckpt_truncate` fault site
(`core/faults.py`) tears a written .npz on purpose.

Async mode: `AsyncCheckpointer` owns one writer thread; `save_pass_async`
hands it host arrays (the trainer fetched them into pinned memory on the
training thread) and a `ready` callable the writer waits on first (the
copies' CUDA event), then does all file I/O there. At most one snapshot is
in flight; `wait()` is the durability barrier and re-raises a writer's
failure on the caller's thread."""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
import threading
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from paddle_tpu_torch.core import faults
from paddle_tpu_torch.trainer import v1_format

log = logging.getLogger("paddle_tpu_torch.checkpoint")

LATEST_FILE = "latest"

Flat = Dict[str, np.ndarray]


def flatten_tree(tree: Any, leaf: Callable[[Any], Any] = np.asarray,
                 prefix: str = "") -> Dict[str, Any]:
    """Nested dicts / tuples / lists -> {"a/b/0": leaf(value)}, keys in the
    JAX package's order (dict keys sorted, sequences by index)."""
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k in sorted(tree):
            out.update(flatten_tree(tree[k], leaf, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, leaf, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: leaf(tree)}


def tree_shape_mismatches(template: Any, flat: Flat) -> List[Tuple[str, Tuple[int, ...],
                                                                     Tuple[int, ...]]]:
    """(key, expected shape, found shape) for every `flat` entry whose shape
    disagrees with the matching `template` leaf. `restore_tree` keeps the
    template's value for those; a caller that must not lose state (the
    trainer's optimizer resume) turns a non-empty result into an error."""
    leaves = flatten_tree(template, leaf=lambda v: v)
    return [(k, tuple(np.shape(v)), tuple(np.shape(flat[k]))) for k, v in leaves.items()
            if k in flat and tuple(np.shape(flat[k])) != tuple(np.shape(v))]


def tree_missing_keys(template: Any, flat: Flat) -> List[str]:
    """Template leaf paths with no entry in `flat` at all (invisible to
    `tree_shape_mismatches`, which compares keys present in both)."""
    return [k for k in flatten_tree(template, leaf=lambda v: v) if k not in flat]


def restore_tree(template: Any, flat: Flat) -> Any:
    """A tree shaped like `template` (nested dicts / tuples / lists of
    tensors) from a flat path -> array dict (the inverse of
    `flatten_tree`): each leaf takes its entry, as a tensor of the
    template leaf's dtype and device; leaves missing from `flat`, or with
    another shape, keep the template's value."""
    import torch

    def rebuild(tree: Any, prefix: str) -> Any:
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(rebuild(v, f"{prefix}{i}/") for i, v in enumerate(tree))
        key = prefix[:-1]
        if key in flat and tuple(np.shape(flat[key])) == tuple(np.shape(tree)):
            if isinstance(tree, torch.Tensor):
                return torch.as_tensor(np.asarray(flat[key])).to(tree.device, tree.dtype)
            return np.asarray(flat[key], dtype=np.asarray(tree).dtype)
        return tree

    return rebuild(template, "")


def _save_npz_atomic(path: str, arrays: Flat) -> int:
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    # suffix must be .npz: np.savez appends it to any other filename
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        with open(tmp, "rb") as f:
            crc = zlib.crc32(f.read())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return crc


def save_pass(save_dir: str, pass_id: int, params: Flat, states: Optional[Flat] = None,
              opt: Optional[Flat] = None, extra_meta: Optional[Dict[str, Any]] = None,
              v1_binary: bool = True, keep_last_n: Optional[int] = None) -> str:
    """Write save_dir/pass-%05d/{params,states,opt}.npz + manifest.json (and
    the v1 binary parameter files), then point save_dir/latest at it.
    Trees are flat {key: host array} dicts (`flatten_tree`)."""
    if keep_last_n is not None and keep_last_n < 0:
        raise ValueError(f"keep_last_n must be >= 0, got {keep_last_n}")
    flats = {name: flat for name, flat in
             (("params", params), ("states", states), ("opt", opt)) if flat}
    pdir = os.path.join(save_dir, f"pass-{pass_id:05d}")
    os.makedirs(pdir, exist_ok=True)
    if v1_binary and "params" in flats:
        v1_format.save_model_dir(pdir, flats["params"])
    manifest: Dict[str, Any] = {"pass_id": pass_id, "files": {}, "version": 1}
    if extra_meta:
        manifest["extra"] = extra_meta
    for name, flat in flats.items():
        path = os.path.join(pdir, f"{name}.npz")
        crc = _save_npz_atomic(path, flat)
        if faults.get().fire("ckpt_truncate"):
            # chaos hook: a torn write that defeated tmp+rename (a lying fs,
            # a power cut after rename); the CRC check must catch it
            with open(path, "r+b") as f:
                f.truncate(max(os.path.getsize(path) // 2, 1))
        manifest["files"][name] = {
            "crc32": crc,
            "keys": {k: [list(v.shape), str(v.dtype)] for k, v in flat.items()},
        }
    fd, tmp = tempfile.mkstemp(dir=pdir, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(pdir, "manifest.json"))
    _write_latest(save_dir, pass_id)
    if keep_last_n:
        _prune_old_passes(save_dir, keep=keep_last_n, just_written=pdir)
    return pdir


class AsyncCheckpointer:
    """One background writer thread, at most one job in flight. A writer
    failure is kept and re-raised at the next `submit()` / `wait()`, on the
    training thread. The thread is a daemon: a kill mid-write is the torn
    write the manifest's CRCs catch."""

    def __init__(self, name: str = "paddle-tpu-torch-ckpt-writer"):
        self._cond = threading.Condition()
        self._job: Optional[Tuple[Callable[[], Any], str]] = None
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._name = name

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name=self._name)
            self._thread.start()

    def _run(self) -> None:
        while True:
            with self._cond:
                while self._job is None:
                    self._cond.wait()
                fn, desc = self._job
            err: Optional[BaseException] = None
            try:
                fn()
            except BaseException as e:  # surfaces at the next submit()/wait()
                err = e
                log.error("async checkpoint write (%s) failed: %s", desc, e)
            with self._cond:
                if err is not None:
                    self._error = err
                self._job = None
                self._cond.notify_all()

    def submit(self, fn: Callable[[], Any], desc: str = "checkpoint") -> None:
        """Queue one write job; blocks while a previous one is in flight."""
        self._ensure_thread()
        with self._cond:
            while self._job is not None:
                self._cond.wait()
            self._raise_pending_locked()
            self._job = (fn, desc)
            self._cond.notify_all()

    def wait(self) -> None:
        """Durability barrier: returns once no write is in flight,
        re-raising (once) the last write's failure."""
        with self._cond:
            while self._job is not None:
                self._cond.wait()
            self._raise_pending_locked()

    def _raise_pending_locked(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def save_pass_async(writer: AsyncCheckpointer, save_dir: str, pass_id: int,
                    params: Flat, states: Optional[Flat] = None,
                    opt: Optional[Flat] = None,
                    extra_meta: Optional[Dict[str, Any]] = None,
                    v1_binary: bool = True, keep_last_n: Optional[int] = None,
                    ready: Optional[Callable[[], Any]] = None) -> str:
    """`save_pass` on `writer`'s thread, after `ready()` (e.g. the event of
    the device-to-host copies that fill these arrays). Returns the pass
    directory, durable once `writer.wait()` returns."""
    if keep_last_n is not None and keep_last_n < 0:
        raise ValueError(f"keep_last_n must be >= 0, got {keep_last_n}")

    def write():
        if ready is not None:
            ready()
        save_pass(save_dir, pass_id, params, states, opt, extra_meta, v1_binary,
                  keep_last_n)

    pdir = os.path.join(save_dir, f"pass-{pass_id:05d}")
    writer.submit(write, desc=pdir)
    return pdir


def _write_latest(save_dir: str, pass_id: int) -> None:
    fd, tmp = tempfile.mkstemp(dir=save_dir, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        f.write(f"pass-{pass_id:05d}\n")
    os.replace(tmp, os.path.join(save_dir, LATEST_FILE))


def _list_pass_ids(save_dir: str) -> List[int]:
    try:
        names = os.listdir(save_dir)
    except OSError:
        return []
    out = []
    for d in names:
        if d.startswith("pass-") and os.path.isdir(os.path.join(save_dir, d)):
            try:
                out.append(int(d.split("-")[1]))
            except ValueError:
                continue
    return sorted(out)


def _prune_old_passes(save_dir: str, keep: int, just_written: str) -> None:
    # trash left by a crash between rename-aside and rmtree in an earlier run
    for d in os.listdir(save_dir):
        if d.startswith(".trash-pass-"):
            shutil.rmtree(os.path.join(save_dir, d), ignore_errors=True)
    passes = _list_pass_ids(save_dir)
    for pid in passes[:-keep] if keep < len(passes) else []:
        victim = os.path.join(save_dir, f"pass-{pid:05d}")
        if os.path.abspath(victim) == os.path.abspath(just_written):
            continue
        trash = os.path.join(save_dir, f".trash-pass-{pid:05d}")
        try:
            os.replace(victim, trash)
        except OSError as e:
            log.warning("checkpoint retention: cannot retire %s: %s", victim, e)
            continue
        shutil.rmtree(trash, ignore_errors=True)


def verify_pass(pdir: str) -> bool:
    """True when `pdir` holds a readable manifest and every file it lists
    exists and passes its CRC."""
    try:
        with open(os.path.join(pdir, "manifest.json")) as f:
            manifest = json.load(f)
        for name, meta in manifest.get("files", {}).items():
            with open(os.path.join(pdir, f"{name}.npz"), "rb") as f:
                if zlib.crc32(f.read()) != meta["crc32"]:
                    return False
    except (OSError, ValueError, KeyError):
        return False
    return True


def find_latest_valid_pass(save_dir: str) -> Optional[int]:
    """Newest pass id under `save_dir` whose checkpoint passes its CRCs, or
    None: the `latest` pointer first, then the pass directories newest to
    oldest; torn or partial ones are skipped with a warning."""
    if not os.path.isdir(save_dir):
        return None
    candidates = _list_pass_ids(save_dir)[::-1]
    try:
        with open(os.path.join(save_dir, LATEST_FILE)) as f:
            pointed = int(f.read().strip().split("-")[1])
        candidates = [pointed] + [p for p in candidates if p != pointed]
    except (OSError, ValueError, IndexError):
        pass
    for pid in candidates:
        pdir = os.path.join(save_dir, f"pass-{pid:05d}")
        if verify_pass(pdir):
            return pid
        log.warning("auto-resume: skipping corrupt/partial checkpoint %s "
                    "(CRC or manifest check failed)", pdir)
    return None


def pass_manifest(save_dir: str, pass_id: int) -> Dict[str, Any]:
    """The manifest of one pass directory, or {}: how auto-resume learns
    whether a checkpoint is a preemption drain's mid-pass save
    (extra.mid_pass, extra.batches_done) or a pass-boundary one."""
    try:
        with open(os.path.join(save_dir, f"pass-{pass_id:05d}", "manifest.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def is_v1_model_dir(dirname: str) -> bool:
    """True when `dirname` looks like a reference ParamUtil model directory:
    no manifest.json, and at least one regular file whose 16 leading bytes
    parse as a `Parameter::Header` consistent with the file's length."""
    if not os.path.isdir(dirname) or os.path.exists(os.path.join(dirname, "manifest.json")):
        return False
    for fn in os.listdir(dirname):
        path = os.path.join(dirname, fn)
        if not os.path.isfile(path):
            continue
        try:
            with open(path, "rb") as f:
                raw = f.read(v1_format.HEADER.size)
            if len(raw) != v1_format.HEADER.size:
                continue
            fmt, value_size, size = v1_format.HEADER.unpack(raw)
            if (fmt == v1_format.PARAM_FORMAT_ORIGINAL and value_size == 4
                    and os.path.getsize(path) == v1_format.HEADER.size + 4 * size):
                return True
        except OSError:
            continue
    return False


def load_pass(save_dir: str, pass_id: Optional[int] = None,
              params_template: Union[None, Dict[str, Any],
                                     Callable[[], Dict[str, Any]]] = None,
              ) -> Tuple[Flat, Flat, Flat, Dict[str, Any]]:
    """(params, states, opt, manifest) as flat host arrays; pass_id=None
    takes the newest. Accepts save_dir/pass-%05d/ with a manifest, a pass
    directory itself, or a reference ParamUtil model directory of raw
    `Parameter::save` files, which needs `params_template` ({name: array}
    or a callable giving it) for the shapes and holds no states or
    optimizer state."""
    v1_sniffed = False
    if os.path.exists(os.path.join(save_dir, "manifest.json")):
        pdir = save_dir
    elif pass_id is None and is_v1_model_dir(save_dir):
        pdir = save_dir
        v1_sniffed = True
    else:
        if pass_id is None:
            passes = _list_pass_ids(save_dir)
            if not passes:
                raise FileNotFoundError(f"no pass-* checkpoints under {save_dir}")
            pass_id = passes[-1]
        pdir = os.path.join(save_dir, f"pass-{pass_id:05d}")
    if not os.path.exists(os.path.join(pdir, "manifest.json")) and (
            v1_sniffed or is_v1_model_dir(pdir)):
        if callable(params_template):
            params_template = params_template()
        if params_template is None:
            raise ValueError(f"{pdir!r} is a reference-format (v1 binary) model dir; "
                             "loading it needs a params_template for shapes")
        params = v1_format.load_model_dir(pdir, params_template)
        return params, {}, {}, {"pass_id": pass_id, "v1_binary": True, "files": {}}
    with open(os.path.join(pdir, "manifest.json")) as f:
        manifest = json.load(f)
    out: Dict[str, Flat] = {}
    for name in ("params", "states", "opt"):
        path = os.path.join(pdir, f"{name}.npz")
        if name in manifest["files"] and os.path.exists(path):
            with open(path, "rb") as f:
                crc = zlib.crc32(f.read())
            if crc != manifest["files"][name]["crc32"]:
                raise IOError(f"checkpoint {path} failed CRC check")
            with np.load(path) as z:
                out[name] = {k: z[k] for k in z.files}
        else:
            out[name] = {}
    return out["params"], out["states"], out["opt"], manifest
