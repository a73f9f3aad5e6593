"""ctypes bindings of the port's native runtime (`csrc/native/`, built by
`runtime/build.py`): the buddy host pool (`pt_pool_*`), recordio
(`pt_recordio_*`), the task master (`pt_master_*`) and the host optimizer
(`pt_opt_*`). Every entry point has its argument and result types declared:
undeclared, ctypes would cut pointers to 32 bits.

The JAX package's library exports the same `pt_*` names; `ctypes.CDLL`
loads with RTLD_LOCAL, so the two stay apart in one process."""

from __future__ import annotations

import ctypes as C
import threading
from typing import Optional

from paddle_tpu_torch.runtime import build

_lib: Optional[C.CDLL] = None
_lock = threading.Lock()

_SIGNATURES = {
    # allocator
    "pt_pool_create": (C.c_void_p, [C.c_size_t, C.c_size_t]),
    "pt_pool_alloc": (C.c_void_p, [C.c_void_p, C.c_size_t]),
    "pt_pool_free": (C.c_int, [C.c_void_p, C.c_void_p]),
    "pt_pool_stats": (None, [C.c_void_p, C.POINTER(C.c_uint64)]),
    "pt_pool_destroy": (None, [C.c_void_p]),
    # recordio
    "pt_recordio_writer_open": (C.c_void_p, [C.c_char_p, C.c_int, C.c_size_t]),
    "pt_recordio_write": (C.c_int, [C.c_void_p, C.c_char_p, C.c_uint64]),
    "pt_recordio_writer_close": (C.c_int, [C.c_void_p]),
    "pt_recordio_reader_open": (C.c_void_p, [C.c_char_p]),
    "pt_recordio_next": (C.c_int64, [C.c_void_p, C.POINTER(C.c_void_p)]),
    "pt_recordio_errors": (C.c_uint64, [C.c_void_p]),
    "pt_recordio_reader_close": (None, [C.c_void_p]),
    # task master
    "pt_master_create": (C.c_void_p, [C.c_double, C.c_int]),
    "pt_master_set_dataset": (None, [C.c_void_p, C.c_char_p, C.c_int]),
    "pt_master_get_task": (C.c_int64, [C.c_void_p, C.c_char_p, C.c_int64]),
    "pt_master_task_finished": (C.c_int, [C.c_void_p, C.c_int64]),
    "pt_master_task_failed": (C.c_int, [C.c_void_p, C.c_int64]),
    "pt_master_pass_finished": (C.c_int, [C.c_void_p, C.c_int]),
    "pt_master_stats": (None, [C.c_void_p, C.POINTER(C.c_int64)]),
    "pt_master_snapshot": (C.c_int, [C.c_void_p, C.c_char_p]),
    "pt_master_restore": (C.c_int, [C.c_void_p, C.c_char_p]),
    "pt_master_destroy": (None, [C.c_void_p]),
    # host optimizer
    "pt_opt_create": (C.c_void_p, [C.c_int] + [C.c_double] * 7 + [C.c_int]),
    "pt_opt_set_lr_policy": (None, [C.c_void_p, C.c_int, C.c_double, C.c_double]),
    "pt_opt_update": (C.c_int, [C.c_void_p, C.POINTER(C.c_float), C.POINTER(C.c_float),
                                C.c_uint64]),
    "pt_opt_current_lr": (C.c_double, [C.c_void_p]),
    "pt_opt_serialize": (C.c_int64, [C.c_void_p, C.c_char_p, C.c_int64]),
    "pt_opt_deserialize": (C.c_int, [C.c_void_p, C.c_char_p, C.c_int64]),
    "pt_opt_destroy": (None, [C.c_void_p]),
}


def lib() -> C.CDLL:
    """The loaded library with every signature declared, built at first use
    (raises when g++ is missing or the build fails)."""
    global _lib
    with _lock:
        if _lib is None:
            loaded = C.CDLL(str(build.build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = loaded
        return _lib
