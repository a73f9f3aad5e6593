"""paddle.v2 analog (counterpart of `paddle_tpu/v2/`), the parts the v1
config pipeline builds on: activations, attributes, data types, layers,
networks, optimizers, poolings and the topology. The v2 trainer, inference,
parameters, events, plots and datasets are the next slice (ROADMAP.md §1
item 5)."""

from __future__ import annotations

from paddle_tpu_torch.v2 import activation as activation  # noqa: F401
from paddle_tpu_torch.v2 import attr as attr  # noqa: F401
from paddle_tpu_torch.v2 import data_type as data_type  # noqa: F401
from paddle_tpu_torch.v2 import layer as layer  # noqa: F401
from paddle_tpu_torch.v2 import networks as networks  # noqa: F401
from paddle_tpu_torch.v2 import optimizer as optimizer  # noqa: F401
from paddle_tpu_torch.v2 import pooling as pooling  # noqa: F401
from paddle_tpu_torch.v2 import topology as topology  # noqa: F401
