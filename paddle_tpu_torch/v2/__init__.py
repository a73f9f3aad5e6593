"""paddle.v2 analog (counterpart of `paddle_tpu/v2/`): the user-facing v2
API — layer, activation, pooling, attr, data_type, networks, optimizer,
topology, parameters, trainer.SGD, event, inference.infer, plot, reader,
minibatch.batch, dataset (the readers of `data/datasets/`) and image (the
helpers of `data/image.py`), with `init` (paddle.init). A v2 script written
against the reference runs unchanged:

    paddle.init(use_gpu=True)
    params = paddle.parameters.create(cost)
    trainer = paddle.trainer.SGD(cost, params, paddle.optimizer.Adam(1e-3))
    trainer.train(paddle.batch(reader, 128), num_passes=2, event_handler=h)
    probs = paddle.infer(output_layer=out, parameters=trainer.parameters,
                         input=samples)

`paddle.dataset.<name>.train()` reads a corpus only where it is already
cached under `dataset.common.DATA_HOME`; otherwise it yields deterministic
synthetic records of the same schema, the same records as the JAX
package's."""

from __future__ import annotations

from paddle_tpu_torch.v2 import activation as activation  # noqa: F401
from paddle_tpu_torch.v2 import attr as attr  # noqa: F401
from paddle_tpu_torch.v2 import data_type as data_type  # noqa: F401
from paddle_tpu_torch.v2 import event as event  # noqa: F401
from paddle_tpu_torch.v2 import inference as inference  # noqa: F401
from paddle_tpu_torch.v2 import layer as layer  # noqa: F401
from paddle_tpu_torch.v2 import networks as networks  # noqa: F401
from paddle_tpu_torch.v2 import optimizer as optimizer  # noqa: F401
from paddle_tpu_torch.v2 import parameters as parameters  # noqa: F401
from paddle_tpu_torch.v2 import plot as plot  # noqa: F401
from paddle_tpu_torch.v2 import pooling as pooling  # noqa: F401
from paddle_tpu_torch.v2 import topology as topology  # noqa: F401
from paddle_tpu_torch.v2 import trainer as trainer  # noqa: F401
from paddle_tpu_torch.v2.inference import infer as infer  # noqa: F401
from paddle_tpu_torch.v2.minibatch import batch as batch  # noqa: F401

from paddle_tpu_torch.data import datasets as dataset  # noqa: F401
from paddle_tpu_torch.data import image as image  # noqa: F401
from paddle_tpu_torch.data import reader as reader  # noqa: F401


def init(use_gpu: bool = True, trainer_count: int = 1, seed: int = 0, **kwargs):
    """paddle.init analog (python/paddle/v2/__init__.py:65): the device
    (use_gpu=False: the CPU), the seed and the other flags; trainer.SGD and
    infer read them."""
    from paddle_tpu_torch.core import init_ctx

    return init_ctx.init(use_gpu=use_gpu, trainer_count=trainer_count, seed=seed, **kwargs)

