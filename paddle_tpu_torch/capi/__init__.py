"""The deployment surface, paddle/capi parity (counterpart of
`paddle_tpu/capi/`).

The reference's paddle_gradient_machine_create_for_inference_with_parameters
(capi/gradient_machine.h:52) consumes a merged file (the model config and
the parameter blobs, MergeModel.cpp). Here the merged file packs the
config script, its arguments, the TrainerConfig text and the parameter and
state arrays into one .npz (`merge_model`), the same keys the JAX package
writes, so a file merged by either package loads in the other;
`InferenceMachine` rebuilds the graph by re-running the config and serves
forwards on the card. `merge_model_v1` writes the reference's byte layout."""

from paddle_tpu_torch.capi.inference import InferenceMachine, create_for_inference
from paddle_tpu_torch.capi.merge_model import merge_model, merge_model_v1

__all__ = ["merge_model", "merge_model_v1", "InferenceMachine", "create_for_inference"]
