"""Parallelism on torch.distributed (counterpart of `paddle_tpu/parallel/`).

`make_mesh` / `resize_mesh` (`mesh.py`: named data, model, seq and expert
axes over one process group, a sub-group per axis), the rules table and
`make_tp_mesh` (`rules.py`), `DataParallel` (`data_parallel.py`), the
replicated and ZeRO-1/2/3 updaters with model-axis parameters
(`updaters.py`), compressed collectives (`compression.py`), ring / Ulysses
attention over the seq axis (`sequence_parallel.py`), the expert-sharded
embedding (`embedding.py`) and the multi-process bring-up with the elastic
rendezvous a live trainer re-shards over (`distributed.py`,
`SGDTrainer.resize_to`)."""

from paddle_tpu_torch.parallel.mesh import Mesh, make_mesh, resize_mesh  # noqa: F401
from paddle_tpu_torch.parallel.rules import (  # noqa: F401
    DEFAULT_RULES,
    ShardingRules,
    make_tp_mesh,
)
from paddle_tpu_torch.parallel.data_parallel import DataParallel  # noqa: F401
from paddle_tpu_torch.parallel import distributed as distributed  # noqa: F401
from paddle_tpu_torch.parallel.sequence_parallel import (  # noqa: F401
    ring_attention,
    ulysses_attention,
)
from paddle_tpu_torch.parallel.embedding import (  # noqa: F401
    ShardedEmbeddingState,
    shard_table,
    sharded_lookup,
)
from paddle_tpu_torch.parallel.updaters import (  # noqa: F401
    IciAllReduceUpdater,
    ParameterUpdater,
    SgdLocalUpdater,
    ShardedUpdater,
    Zero2Updater,
    Zero3Updater,
)
from paddle_tpu_torch.parallel import compression as compression  # noqa: F401
