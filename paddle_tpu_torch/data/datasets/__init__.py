"""Dataset readers (python/paddle/v2/dataset/*; the port's copy of
`paddle_tpu/data/datasets/`).

Every module follows the reference record schemas; when no cached file is
under DATA_HOME (the port never fetches one), each falls back to deterministic synthetic
data with the same schema (see common.fetch_or_synthetic)."""

from paddle_tpu_torch.data.datasets import cifar as cifar  # noqa: F401
from paddle_tpu_torch.data.datasets import common as common  # noqa: F401
from paddle_tpu_torch.data.datasets import conll05 as conll05  # noqa: F401
from paddle_tpu_torch.data.datasets import flowers as flowers  # noqa: F401
from paddle_tpu_torch.data.datasets import imdb as imdb  # noqa: F401
from paddle_tpu_torch.data.datasets import imikolov as imikolov  # noqa: F401
from paddle_tpu_torch.data.datasets import mnist as mnist  # noqa: F401
from paddle_tpu_torch.data.datasets import movielens as movielens  # noqa: F401
from paddle_tpu_torch.data.datasets import mq2007 as mq2007  # noqa: F401
from paddle_tpu_torch.data.datasets import sentiment as sentiment  # noqa: F401
from paddle_tpu_torch.data.datasets import uci_housing as uci_housing  # noqa: F401
from paddle_tpu_torch.data.datasets import voc2012 as voc2012  # noqa: F401
from paddle_tpu_torch.data.datasets import wmt14 as wmt14  # noqa: F401
