"""Config-driven generation: the reference Trainer's generation job
(counterpart of `paddle_tpu/trainer/generation.py`).

Replicates what test_recurrent_machine_generation.cpp:59-88 drives by hand:
build a GradientMachine from a parsed config, loadParameters(modelDir),
forward one batch in PASS_TEST, then run the declared evaluators — the
seqtext printer writes the generated sequences to its result_file.

The reference resolves the config's relative dict_file/result_file paths
against its working directory; `base_dir` plays that role here, and
`result_file` overrides the config's destination.

`GenerationSession` is the long-lived form: the Network is built and the
checkpoint loaded ONCE, on the first `generate`, then any number of
batches run against the same parameters on `device` (None: CUDA) — the
serving runtime (`serving/server.py` method `generate_config`) runs this
same path. The forward runs eagerly under `torch.no_grad()`.
`run_generation` is the one-shot wrapper."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.nn.graph import Context, Network


def _resolve(path: str, base_dir: Optional[str]) -> str:
    if base_dir is not None and path and not os.path.isabs(path):
        return os.path.join(base_dir, path)
    return path


def _host(x: Any) -> Any:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


class GenerationSession:
    """Build once, load once, generate many.

    Parameter init needs a sample batch for its shapes, hence the build on
    the first `generate` rather than in __init__; later calls reuse the
    same parameter tensors. `device` is resolved here, so a session asked
    for CUDA on a machine without a card fails when it is made."""

    def __init__(self, pc, model_dir: Optional[str] = None, base_dir: Optional[str] = None,
                 seed: int = 0, device: DeviceLike = None):
        self.pc = pc
        self.net = Network(pc.outputs)
        self.model_dir = model_dir
        self.base_dir = base_dir
        self.seed = seed
        self.device = resolve_device(device)
        self._params: Optional[Dict[str, torch.Tensor]] = None
        self._states: Optional[Dict[str, torch.Tensor]] = None
        # the last call's beams of every beam_search node, by name: history
        # [B, K, L], scores [B, K], lengths [B, K] on the device
        self.last_beams: Dict[str, Dict[str, Any]] = {}

    @property
    def built(self) -> bool:
        return self._params is not None

    def _ensure_built(self, batch: Dict[str, Any]) -> None:
        if self._params is not None:
            return
        from paddle_tpu_torch.trainer.checkpoint import load_pass

        params, states = self.net.init(batch, seed=self.seed, device=self.device,
                                       with_states=True)
        if self.model_dir is not None:
            loaded, _, _, _ = load_pass(
                self.model_dir,
                params_template=lambda: {k: v.cpu().numpy() for k, v in params.items()})
            params = {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(self.device)
                      for k, v in loaded.items()}
        self._params, self._states = params, states

    def generate(self, batch: Dict[str, Any], result_file: Optional[str] = None
                 ) -> Dict[str, str]:
        """Forward one batch and write the declared seq_text_printer outputs.

        Returns {evaluator name: result file written}. The generated node is
        the config's output (`__beam_search_predict__` resolution); its
        cached beam payload (scores, every beam's ids) feeds the beam-mode
        print."""
        from paddle_tpu_torch.metrics.evaluators import EVALUATORS

        self._ensure_built(batch)
        ctx = Context("apply", self._params, device=self.device, states=self._states,
                      train=False)
        with torch.no_grad(), dtypes.policy_scope(ctx.policy):
            values = self.net._run(ctx, batch, self.device)
        self.last_beams = {key[1]: v for key, v in ctx.cache.items()
                           if isinstance(key, tuple) and key[0] == "beam"}

        printers = [ec for ec in self.pc.context.evaluators if ec.type == "seq_text_printer"]
        written: Dict[str, str] = {}
        for idx, ec in enumerate(printers):
            out_name = ec.input_layers[0] if ec.input_layers else self.pc.outputs[0].name
            arg = values.get(out_name)
            if arg is None:
                continue
            if result_file and len(printers) > 1:
                # one destination and several printers would keep only the
                # last printer's text: fan out per evaluator
                root, ext = os.path.splitext(result_file)
                dest = f"{root}.{ec.name or idx}{ext}"
            else:
                dest = result_file or _resolve(ec.result_file, self.base_dir)
            printer = EVALUATORS.get("seq_text_printer")(
                result_file=dest, dict_file=_resolve(ec.dict_file, self.base_dir),
                delimited=ec.delimited)
            sample_ids = None
            if len(ec.input_layers) > 1 and ec.input_layers[1] in batch:
                sample_ids = np.asarray(batch[ec.input_layers[1]])
            beam = ctx.cache.get(("beam", out_name))
            printer.start()
            printer.update(
                output=_host(arg.value), sample_ids=sample_ids,
                beam=None if beam is None else {k: _host(v) for k, v in beam.items()},
                lengths=_host(arg.lengths), sub_lengths=_host(arg.sub_lengths))
            printer.finish()
            # unnamed printers must not collide in the result map when a
            # config declares several (the caller reads every entry's file)
            key = ec.name or ("seq_text_printer" if len(printers) == 1
                              else f"seq_text_printer_{idx}")
            written[key] = dest
        return written


def run_generation(pc, batch: Dict[str, Any], model_dir: Optional[str] = None,
                   base_dir: Optional[str] = None, result_file: Optional[str] = None,
                   seed: int = 0, device: DeviceLike = None) -> Dict[str, str]:
    """One-shot generation: a GenerationSession for a single batch."""
    return GenerationSession(pc, model_dir=model_dir, base_dir=base_dir, seed=seed,
                             device=device).generate(batch, result_file=result_file)
