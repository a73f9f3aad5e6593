"""The v1 config pipeline (counterpart of `paddle_tpu/config/`): config
scripts -> TrainerConfig.

- config_parser: parse_config / parse_config_and_serialize (the entry points
  the reference's C++ trainer calls via embedded Python,
  paddle/trainer/TrainerConfigHelper.cpp:34-56)
- helpers: the trainer_config_helpers DSL surface injected into config scripts
- optimizers: settings() and the *Optimizer classes; build_optimizer
- dump: layer graph -> ModelConfig text (dump_config parity)
"""

from paddle_tpu_torch.config.config_parser import (
    ParsedConfig,
    get_config_arg,
    outputs,
    parse_config,
    parse_config_and_serialize,
)
from paddle_tpu_torch.config.dump import build_model_config, dump_config
from paddle_tpu_torch.config.optimizers import build_optimizer, settings

__all__ = [
    "ParsedConfig", "parse_config", "parse_config_and_serialize",
    "get_config_arg", "outputs", "settings", "build_optimizer",
    "build_model_config", "dump_config",
]
