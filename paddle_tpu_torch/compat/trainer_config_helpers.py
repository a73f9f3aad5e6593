"""`paddle.trainer_config_helpers` on the port: the v1 config-script DSL.

Star-import surface of the reference package (layers.py + activations.py +
poolings.py + attrs.py + optimizers.py + evaluators.py + data_sources.py,
plus the config_parser built-ins it re-exports: settings, get_config_arg,
define_py_data_sources2, outputs), from `config/helpers.py` and
`config/config_parser.py`."""

from paddle_tpu_torch.config.config_parser import (  # noqa: F401
    define_py_data_sources2,
    get_config_arg,
    inputs,
    outputs,
)
from paddle_tpu_torch.config.helpers import *  # noqa: F401,F403
from paddle_tpu_torch.config.helpers import __all__ as _helpers_all

# define_py_data_sources (the older single-module variant) aliases the v2 one
define_py_data_sources = define_py_data_sources2

__all__ = list(_helpers_all) + [
    "outputs", "inputs", "get_config_arg", "define_py_data_sources2",
    "define_py_data_sources",
]
