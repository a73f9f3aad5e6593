"""Tensor-parallel serving across ranks: the device half of an engine step,
the leading rank's headers, and the other ranks' worker loop.

The JAX package serves tensor-parallel from one process: one session, one
jitted step over the mesh. The port runs one rank per process (or, in the
tests and on a one-card machine, per thread), each holding its shards of
the model (`ServableLM(mesh=)`) and of the page pools. Rank 0 of the model
axis leads: it runs the `ServingSession` (the scheduler, the page
allocator and prefix cache, `submit`, stats, the front door), and before
each device call of an engine step (`DeviceHalf`) it broadcasts a small
header over the model axis: the call's name and its host inputs (token
ids, positions, block-table rows, sampling rows). Every other rank runs
`TPWorker.run`, which receives the header and makes the same call on its
own shards and pools. The collectives inside the model keep the ranks in
step, and there is no second scheduler that could diverge (ROADMAP.md §3
difference 25).

The headers ride the model axis' group as two broadcasts (the length, then
the pickled bytes): host tensors on a gloo group, which takes them beside
the CUDA tensors of the model's collectives; device tensors on NCCL.

The decode step is a CUDA graph on the card when the group's collectives
can join it (NCCL, or one card without a mesh). A gloo group holding CUDA
tensors cannot be captured (`parallel/mesh.UncapturableGroupError`), so
over gloo the decode step runs eagerly, decided once when the engine is
built and reported as `decode_graph` in `stats()`: not a fallback on
failure, since a capture that fails on NCCL still raises."""

from __future__ import annotations

import pickle
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.serving.decode_graph import DecodeGraph


def decode_mode(device: torch.device, mesh) -> str:
    """How the decode step runs on this rank: "captured" (a CUDA graph),
    "eager: gloo group" (CUDA tensors over gloo) or "eager: cpu"."""
    if device.type != "cuda":
        return "eager: cpu"
    if mesh is not None and mesh.backend != "nccl":
        return "eager: gloo group"
    return "captured"


class HeaderChannel:
    """Broadcasts (op, args) from the model axis' rank 0 to the others."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.device = mesh.device if mesh.backend == "nccl" else torch.device("cpu")

    def send(self, op: str, args: Tuple[Any, ...]) -> None:
        payload = pickle.dumps((op, args), protocol=pickle.HIGHEST_PROTOCOL)
        n = torch.tensor([len(payload)], dtype=torch.int64, device=self.device)
        self.mesh.broadcast_(n, "model")
        buf = torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(self.device)
        self.mesh.broadcast_(buf, "model")

    def recv(self) -> Tuple[str, Tuple[Any, ...]]:
        n = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.mesh.broadcast_(n, "model")
        buf = torch.empty(int(n[0]), dtype=torch.uint8, device=self.device)
        self.mesh.broadcast_(buf, "model")
        return pickle.loads(buf.cpu().numpy().tobytes())


class DeviceHalf:
    """The device work of an engine step's phases on this rank's model
    shards and pools. Every input is host data; on the leading rank each
    call first sends its header (`_lead`), so a worker repeats it.

    Needs: model, device, k_pages, v_pages, max_slots, pages_per_seq,
    decode_mode, _decode_graph, decode_graph_captures."""

    _lead: Optional[HeaderChannel] = None
    # serialises a call's header and collectives against a concurrent stop
    _device_lock: Optional[threading.Lock] = None

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        # a copy: block-table rows are live host views the engine mutates
        return torch.tensor(a, device=self.device)

    def _send(self, op: str, *args) -> None:
        if self._lead is not None:
            self._lead.send(op, args)

    def _dev_prefill(self, toks, length, row, seeds, temps, top_ks) -> torch.Tensor:
        """A bucketed prompt's prefill and its K/V commit -> first token."""
        self._send("prefill", toks, length, row, seeds, temps, top_ks)
        lengths = self._to_device(length)
        first_tok, kc, vc = self.model.prefill(
            self._to_device(toks), lengths, seeds, temps, top_ks)
        self.model.commit_prefill(
            self.k_pages, self.v_pages, kc, vc, lengths, self._to_device(row),
            self._to_device(np.zeros(1, np.int32)))
        return first_tok

    def _dev_prefill_chunk(self, toks, start, length, row, seeds, temps,
                           top_ks) -> torch.Tensor:
        self._send("prefill_chunk", toks, start, length, row, seeds, temps, top_ks)
        return self.model.prefill_chunk(
            self.k_pages, self.v_pages, self._to_device(toks), self._to_device(start),
            self._to_device(length), self._to_device(row), seeds, temps, top_ks)

    def _dev_verify(self, toks, starts, rows, seeds, steps0, temps,
                    top_ks) -> torch.Tensor:
        self._send("verify", toks, starts, rows, seeds, steps0, temps, top_ks)
        return self.model.verify_chunk(
            self.k_pages, self.v_pages, self._to_device(toks), self._to_device(starts),
            self._to_device(rows), seeds, steps0, temps, top_ks)

    def _decode_forward(self, tokens, positions, act_mask, bt, seeds, steps,
                        temps, top_ks) -> torch.Tensor:
        """The decode step's device work -> next_tok [S] on the device.
        Captured: the engine's first decode step runs eagerly and is the
        capture's warm-up, then the step is captured as a CUDA graph and
        every later step replays it (a failed capture raises). Otherwise
        eager, every step."""
        self._send("decode", tokens, positions, act_mask, bt, seeds, steps, temps, top_ks)
        if self._decode_graph is not None:
            logits, greedy = self._decode_graph.replay(tokens, positions, act_mask, bt)
            return self.model._sample(logits, seeds, steps, temps, top_ks, greedy=greedy)
        next_tok = self.model.decode_step(
            self.k_pages, self.v_pages, self._to_device(tokens),
            self._to_device(positions), self._to_device(act_mask),
            self._to_device(bt), seeds, steps, temps, top_ks,
        )
        if self.decode_mode == "captured":
            self._decode_graph = DecodeGraph(
                self.model, self.k_pages, self.v_pages, self.max_slots,
                self.pages_per_seq,
            )
            self.decode_graph_captures += 1
        return next_tok

    def _dev_reset(self) -> None:
        """Zero the pools in place (a decode graph holds their pointers) and
        drop the graph, so the next decode step re-captures it."""
        self._send("reset")
        self.k_pages.zero_()
        self.v_pages.zero_()
        self._decode_graph = None


_OPS = {"prefill": "_dev_prefill", "prefill_chunk": "_dev_prefill_chunk",
        "verify": "_dev_verify", "decode": "_decode_forward", "reset": "_dev_reset"}


class TPWorker(DeviceHalf):
    """A rank > 0 of a tensor-parallel serving engine: `run` repeats the
    leading rank's device calls on this rank's shards until the lead
    stops."""

    def __init__(self, model):
        if model.mesh is None:
            raise ValueError("TPWorker serves a model split over a mesh's model axis")
        self.model = model
        self.mesh = model.mesh
        self.device = model.device
        self.decode_mode = decode_mode(self.device, self.mesh)
        self._decode_graph: Optional[DecodeGraph] = None
        self.decode_graph_captures = 0
        self.k_pages = self.v_pages = None
        self.calls = 0

    def run(self) -> "TPWorker":
        """Serve the leading rank's headers; returns when it stops."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        channel = HeaderChannel(self.mesh)
        while True:
            op, args = channel.recv()
            if op == "stop":
                return self
            if op == "init":
                n_layers, num_pages, page_size, self.max_slots, self.pages_per_seq = args
                shape = (n_layers, num_pages, page_size, self.model.kv_dim)
                self.k_pages = torch.zeros(shape, dtype=torch.float32, device=self.device)
                self.v_pages = torch.zeros(shape, dtype=torch.float32, device=self.device)
                continue
            getattr(self, _OPS[op])(*args)
            self.calls += 1
