"""Tooling (counterpart of `paddle_tpu/utils/`; python/paddle/utils, SURVEY
§2.4 'tooling only'): dump_config lives on the CLI; here the model
diagrams and the merged-model inspection."""

from paddle_tpu_torch.utils.make_model_diagram import make_diagram, to_dot  # noqa: F401
from paddle_tpu_torch.utils.show_pb import show_merged_model  # noqa: F401
