"""Streaming evaluators (counterpart of `paddle_tpu/metrics/`)."""

from paddle_tpu_torch.metrics.evaluators import (  # noqa: F401
    AucEvaluator,
    ChunkEvaluator,
    ClassificationErrorEvaluator,
    ColumnSumEvaluator,
    Evaluator,
    PnpairEvaluator,
    PrecisionRecallEvaluator,
    RankAucEvaluator,
    SequenceErrorEvaluator,
    SumEvaluator,
)
