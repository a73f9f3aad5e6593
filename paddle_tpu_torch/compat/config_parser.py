"""`paddle.trainer.config_parser` on the port: the parse_config entry
points the reference's C++ trainer calls through embedded Python
(TrainerConfigHelper.cpp:34-56), from `config/config_parser.py`."""

from paddle_tpu_torch.config.config_parser import (  # noqa: F401
    ParsedConfig,
    define_py_data_sources2,
    get_config_arg,
    inputs,
    outputs,
    parse_config,
    parse_config_and_serialize,
)
from paddle_tpu_torch.config.optimizers import settings  # noqa: F401
