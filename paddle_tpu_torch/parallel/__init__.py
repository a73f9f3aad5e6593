"""Data parallelism on torch.distributed (counterpart of
`paddle_tpu/parallel/`, its `data` axis: ROADMAP.md §1 item 8a).

`make_mesh` / `resize_mesh` (`mesh.py`), the rules table (`rules.py`),
`DataParallel` (`data_parallel.py`), the replicated and ZeRO-1/2/3
updaters (`updaters.py`), compressed collectives (`compression.py`) and
the multi-process bring-up (`distributed.py`). The model and seq axes,
ring / Ulysses attention and the expert-sharded embedding are item 8b;
`make_tp_mesh` raises naming it."""

from paddle_tpu_torch.parallel.mesh import Mesh, make_mesh, resize_mesh  # noqa: F401
from paddle_tpu_torch.parallel.rules import (  # noqa: F401
    DEFAULT_RULES,
    ShardingRules,
    make_tp_mesh,
)
from paddle_tpu_torch.parallel.data_parallel import DataParallel  # noqa: F401
from paddle_tpu_torch.parallel import distributed as distributed  # noqa: F401
from paddle_tpu_torch.parallel.updaters import (  # noqa: F401
    IciAllReduceUpdater,
    ParameterUpdater,
    SgdLocalUpdater,
    ShardedUpdater,
    Zero2Updater,
    Zero3Updater,
)
from paddle_tpu_torch.parallel import compression as compression  # noqa: F401
