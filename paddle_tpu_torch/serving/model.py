"""ServableLM: a decode-oriented causal LM with paged attention, in PyTorch.

The port's counterpart of `paddle_tpu/serving/model.py`, the same model and
the same serving split:

  * `prefill`       — full-context forward over a bucket-padded prompt
                      [B, T_bucket]; returns the first sampled token plus the
                      per-position K/V to commit into the page pool.
  * `prefill_chunk` — ONE fixed-size chunk [1, C] of a long prompt: attends
                      over the slot's committed pages (positions < chunk
                      start) plus causally within the chunk, then commits the
                      chunk's K/V.
  * `commit_prefill` — scatters prompt K/V into the slot's pages at an
                      arbitrary `starts` offset.
  * `decode_step`   — ONE token for ALL slots at the fixed [max_slots] shape:
                      write the step K/V into each slot's current page, then
                      ragged paged attention up to each slot's own position
                      through the CUDA kernel (ops/paged_attention.py; its
                      plain version on CPU tensors). Its forward,
                      `decode_logits`, is what the session captures as one
                      CUDA graph on the card.
  * `verify_chunk`  — speculative decoding: scores [last token, K drafts] in
                      ONE chunk-shaped call through `_chunk_forward` (the
                      chunk path's gather attention, as the JAX package's)
                      and commits all K+1 positions' K/V.

Pre-RMSNorm multi-head attention, a 4*d GELU MLP (tanh approximation, as
`jax.nn.gelu` defaults to), learned positions, untied unembed. Parameters
live in the module (`embed`, `pos`, `lnf`, `unembed`, `layers[i].wq ...`),
laid out as the JAX package's ([in, out] matrices); `serving/convert.py`
maps them to and from the JAX parameter names (`l{i}.wq`), and
`save`/`load` read and write the JAX package's .npz checkpoints.

Differences from the JAX package, each on purpose:

  * The JAX package donates the page pools through its jitted steps; the
    port updates them in place (`commit_prefill`, `decode_step`).
  * XLA clamps out-of-range gather indices silently; PyTorch raises on the
    CPU and asserts on the device. Every gather that relied on the clamp
    clamps explicitly here.
  * Masking uses NEG_INF = -1e9, never -inf, as the JAX package does: a
    fully masked row (bucket padding) gets uniform weights, not NaN.
  * Sampling draws its gumbel noise on jax's threefry bits
    (`core/prng.py`): the key is `fold_in(PRNGKey(seed), step)` and the noise
    `uniform(key, (V,), 1e-20, 1.0)`, as the JAX package draws them, so
    sampled tokens match the JAX package's as greedy ones do.

Parameters and pools are f32.

Tensor parallelism over a mesh's `model` axis (`parallel.make_tp_mesh`):
every parameter declares LOGICAL axes once (`param_logical_axes`, the
Megatron layout of the JAX package), and the rules table maps them to the
mesh. Each rank then holds its slices of the canonical tensors
(`shard_params`): q/k/v and w1/b1 column slices (its heads, its MLP
columns), wo and w2 row slices, the embed table's rows and the unembed's
columns of its vocab range; norms, positions and b2 replicated. Each method
the session calls runs on the rank's shards, with the JAX package's
collectives placed by hand: one all-reduce over the model axis after each
row-parallel product (wo, w2; b2 is added once, after it), one all-reduce
combining the embed gather (each rank gathers the ids of its vocab rows and
writes zero rows for the others, so the sum is exact), and one all-gather
making the logits full, so sampling runs on the full logits on every rank.
Per decode step that is 2 L + 1 all-reduces and 1 all-gather. Paged
attention runs per rank over its heads (`_paged_attention_local` at
n_heads / tp) on a pool of kv_dim / tp columns. A mesh whose model axis is
1 is dropped, as in the JAX package: the single-card program is unchanged.
The ranks run in lockstep: the serving session leads on one rank and the
others replay its calls (`serving/session.py`). Checkpoints are canonical
full arrays both ways (`save` gathers, `load(mesh=)` slices)."""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.ops.paged_attention import paged_attention_decode
from paddle_tpu_torch.parallel.rules import ShardingRules
from paddle_tpu_torch.serving.convert import params_from_jax

NEG_INF = -1e9

# the paged KV pools' logical axes [n_layers, num_pages, page_size, kv_dim]:
# only the flattened (kv_heads * head_dim) dim shards, over the model axis
POOL_LOGICAL_AXES = (None, None, None, "kv_heads")

_PORT_LAYER = re.compile(r"^layers\.(\d+)\.(\w+)$")
_JAX_LAYER = re.compile(r"^l(\d+)\.(\w+)$")


def _jax_name(key: str) -> str:
    m = _PORT_LAYER.match(key)
    return f"l{m.group(1)}.{m.group(2)}" if m else key


def _port_name(name: str) -> str:
    m = _JAX_LAYER.match(name)
    return f"layers.{m.group(1)}.{m.group(2)}" if m else name


@dataclasses.dataclass(frozen=True)
class LMConfig:
    vocab: int
    n_layers: int = 2
    d_model: int = 64
    n_heads: int = 2
    max_len: int = 512
    bos_id: int = 1
    eos_id: int = 2

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * scale


def _param(*shape: int, device, fill: float = 0.0) -> nn.Parameter:
    # serving never differentiates: no autograd graph is built
    return nn.Parameter(
        torch.full(shape, fill, dtype=torch.float32, device=device),
        requires_grad=False,
    )


class Block(nn.Module):
    """One transformer layer's parameters (JAX keys `l{i}.<name>`), at the
    shapes `shape(name, canonical shape)` gives (this rank's slices under
    tensor parallelism)."""

    MATRICES = ("wq", "wk", "wv", "wo", "w1", "w2")

    def __init__(self, d: int, device, shape=lambda name, s: s):
        super().__init__()
        canon = {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d),
                 "w1": (d, 4 * d), "w2": (4 * d, d), "b1": (4 * d,), "b2": (d,),
                 "ln1": (d,), "ln2": (d,)}
        for name, c in canon.items():
            fill = 1.0 if name.startswith("ln") else 0.0
            setattr(self, name, _param(*shape(name, c), device=device, fill=fill))


class ServableLM(nn.Module):
    def __init__(self, cfg: LMConfig, device: DeviceLike = None, *, mesh=None,
                 rules: Optional[ShardingRules] = None):
        super().__init__()
        self.cfg = cfg
        self.scale = 1.0 / float(np.sqrt(cfg.head_dim))
        self.rules = rules if rules is not None else ShardingRules()
        self._axes_cache: Optional[Dict[str, Tuple[Optional[str], ...]]] = None
        # a mesh whose model axis is 1 (or absent) is the single-card path:
        # drop it so every program stays the unsharded one
        tp = mesh.extent("model") if mesh is not None else 1
        self.mesh = mesh if tp > 1 else None
        if self.mesh is not None:
            for what, n in (("n_heads", cfg.n_heads), ("vocab", cfg.vocab)):
                if n % tp:
                    raise ValueError(
                        f"tensor parallelism over {tp} chips needs {what} % {tp} == 0 "
                        f"(got {what}={n}): heads and vocab split over the mesh "
                        "'model' axis")
            if device is None:
                device = mesh.device
        dev = resolve_device(device)
        # {JAX name: the dimension split over the model axis}, from the rules
        self._split: Dict[str, int] = {}
        if self.mesh is not None:
            for name, axes in self.param_logical_axes().items():
                spec = self.rules.spec_for(axes, self.mesh, param=name)
                dims = [i for i, a in enumerate(spec) if a is not None]
                if any(spec[i] != "model" for i in dims) or len(dims) > 1:
                    raise ValueError(f"{name!r} resolves to {spec}: the port splits a "
                                     "serving parameter along the 'model' axis only")
                if dims:
                    self._split[name] = dims[0]
            self._check_layout()
        self.heads_split = "l0.wq" in self._split
        self.mlp_split = "l0.w1" in self._split
        self.vocab_split = "embed" in self._split
        self.local_heads = cfg.n_heads // self.tp_size if self.heads_split else cfg.n_heads
        d, v = cfg.d_model, cfg.vocab
        shape = self._local_shape
        self.embed = _param(*shape("embed", (v, d)), device=dev)
        self.pos = _param(*shape("pos", (cfg.max_len, d)), device=dev)
        self.lnf = _param(*shape("lnf", (d,)), device=dev, fill=1.0)
        self.unembed = _param(*shape("unembed", (d, v)), device=dev)
        self.layers = nn.ModuleList(
            Block(d, dev, shape=lambda n, c, i=i: shape(f"l{i}.{n}", c))
            for i in range(cfg.n_layers))

    # -- tensor parallelism -----------------------------------------------------
    @property
    def tp_size(self) -> int:
        return self.mesh.extent("model") if self.mesh is not None else 1

    def _check_layout(self) -> None:
        """The layouts the forward knows: heads (q/k/v columns, wo rows),
        the MLP (w1/b1 columns, w2 rows) and the vocab (embed rows, unembed
        columns) each split as a group, or not at all; d_model never."""
        groups = {
            "heads": {"wq": 1, "wk": 1, "wv": 1, "wo": 0},
            "mlp": {"w1": 1, "b1": 0, "w2": 0},
        }
        for group, members in groups.items():
            for i in range(self.cfg.n_layers):
                got = {n: self._split.get(f"l{i}.{n}") for n in members}
                if set(got.values()) != {None} and got != members:
                    raise ValueError(f"the rules split the {group} parameters of layer "
                                     f"{i} as {got}: the port splits {members} or none")
        vocab = {"embed": self._split.get("embed"), "unembed": self._split.get("unembed")}
        if set(vocab.values()) != {None} and vocab != {"embed": 0, "unembed": 1}:
            raise ValueError(f"the rules split the vocab as {vocab}: the port splits "
                             "the embed rows and the unembed columns together or neither")
        for name in self._split:
            tail = name.split(".")[-1]
            if tail in ("pos", "lnf", "b2", "ln1", "ln2"):
                raise ValueError(f"{name!r} is split over 'model': the port keeps d_model "
                                 "replicated")

    def _local_shape(self, name: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        dim = self._split.get(name)
        if dim is None:
            return shape
        out = list(shape)
        out[dim] //= self.tp_size
        return tuple(out)

    def param_logical_axes(self) -> Dict[str, Tuple[Optional[str], ...]]:
        """Every parameter's LOGICAL axes, under its JAX name, resolved
        through the rules table: q/k/v and w1 column-parallel (heads, mlp),
        wo and w2 row-parallel, embed rows and unembed columns over vocab;
        norms, biases b2 and positions replicated."""
        if self._axes_cache is not None:
            return self._axes_cache
        axes: Dict[str, Tuple[Optional[str], ...]] = {
            "embed": ("vocab", "embed"),
            "pos": ("length", "embed"),
            "lnf": ("embed",),
            "unembed": ("embed", "vocab"),
        }
        for i in range(self.cfg.n_layers):
            axes.update({
                f"l{i}.wq": ("embed", "heads"),
                f"l{i}.wk": ("embed", "kv_heads"),
                f"l{i}.wv": ("embed", "kv_heads"),
                f"l{i}.wo": ("heads", "embed"),
                f"l{i}.w1": ("embed", "mlp"),
                f"l{i}.w2": ("mlp", "embed"),
                f"l{i}.b1": ("mlp",),
                f"l{i}.b2": ("embed",),
                f"l{i}.ln1": ("embed",),
                f"l{i}.ln2": ("embed",),
            })
        self._axes_cache = axes
        return axes

    def param_sharding(self, name: str, ndim: int):
        """One parameter's spec (a mesh axis or None a dimension) through
        the rules table, or None when there is no TP mesh. A parameter
        missing from param_logical_axes raises: replicating it silently
        would erode the per-rank memory the table exists to save."""
        if self.mesh is None:
            return None
        axes = self.param_logical_axes().get(name)
        if axes is None:
            raise KeyError(
                f"param {name!r} has no entry in param_logical_axes — every tensor must "
                "declare its logical axes (use ('embed',)-style replicated entries "
                "explicitly, never by omission)")
        return self.rules.spec_for(axes, self.mesh, ndim=ndim, param=name)

    def shard_params(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Canonical tensors under their JAX names -> this rank's slices
        (the same tensors on one card)."""
        out = {}
        for name, value in params.items():
            value = torch.as_tensor(np.asarray(value, np.float32)
                                    if not isinstance(value, torch.Tensor) else value)
            self.param_sharding(name, value.dim())  # an unknown name raises
            dim = self._split.get(name)
            if dim is not None:
                w = value.shape[dim] // self.tp_size
                value = value.narrow(dim, self.mesh.index("model") * w, w)
            out[name] = value
        return out

    def pool_sharding(self):
        """The paged KV pools' spec: kv_heads (inside the flattened KD dim)
        over the model axis; None on one card."""
        if self.mesh is None:
            return None
        return self.rules.spec_for(POOL_LOGICAL_AXES, self.mesh, param="k_pages")

    @property
    def kv_dim(self) -> int:
        """This rank's pool width: its heads' K (or V) columns."""
        return self.local_heads * self.cfg.head_dim

    @torch.no_grad()
    def load_canonical(self, params) -> "ServableLM":
        """Copy canonical tensors (JAX names, or the port's state-dict keys)
        into this rank's parameters, slicing them under TP."""
        jax_named = {_jax_name(k): v for k, v in params.items()}
        own = {_jax_name(k): p for k, p in self.state_dict(keep_vars=True).items()}
        if set(jax_named) != set(own):
            raise KeyError(f"parameter names differ: missing "
                           f"{sorted(set(own) - set(jax_named))}, unknown "
                           f"{sorted(set(jax_named) - set(own))}")
        for name, value in self.shard_params(jax_named).items():
            own[name].copy_(value.to(own[name].device, torch.float32))
        return self

    @torch.no_grad()
    def canonical_params(self) -> Dict[str, torch.Tensor]:
        """Every parameter as its canonical full tensor under its JAX name:
        under TP the slices are gathered over the model axis (a collective:
        every rank calls it)."""
        from paddle_tpu_torch.parallel.updaters import axis_gather

        out = {}
        for key, p in self.state_dict().items():
            name = _jax_name(key)
            dim = self._split.get(name)
            out[name] = p if dim is None else axis_gather(self.mesh, p, dim, "model")
        return out

    def _reduce(self, t: torch.Tensor, split: bool) -> torch.Tensor:
        """The row-parallel partial sums of a split group, summed over the
        model axis (one all-reduce); t itself when the group is whole."""
        if split:
            self.mesh.all_reduce_(t, "model")
        return t

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (long) -> their embedding rows; under a vocab split each
        rank gathers the ids in its rows and one all-reduce combines them
        (exact: one rank adds each nonzero row)."""
        if not self.vocab_split:
            return self.embed[tokens]
        rows = self.embed.shape[0]
        off = tokens - self.mesh.index("model") * rows
        mine = (off >= 0) & (off < rows)
        part = torch.where(mine[..., None], self.embed[off.clamp(0, rows - 1)],
                           self.embed.new_zeros(()))
        return self._reduce(part.contiguous(), True)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- params -------------------------------------------------------------
    @torch.no_grad()
    def init_params(
        self, generator: Optional[torch.Generator] = None
    ) -> "ServableLM":
        """Random weights at the JAX package's scales: N(0, 0.1) for the
        embeddings and matrices, N(0, 0.02) for positions, ones for the
        norms, zeros for the biases. Drawn in a fixed order from `generator`
        (default: a CPU generator seeded 0) on the generator's device, so a
        seed gives the same weights whatever device the model is on. The
        numbers differ from jax's for the same seed — jax.random cannot be
        reproduced in torch — so parity with the JAX package comes from
        moving its weights across (`convert.params_from_jax`)."""
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        cfg = self.cfg
        d = cfg.d_model
        canon = {"embed": (cfg.vocab, d), "pos": (cfg.max_len, d), "unembed": (d, cfg.vocab),
                 "wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d),
                 "w1": (d, 4 * d), "w2": (4 * d, d)}

        def draw(p: torch.Tensor, name: str, std: float) -> None:
            # the canonical tensor's draw (the same under any layout), then
            # this rank's slice of it
            full = std * torch.randn(canon[name.split(".")[-1]], generator=g,
                                     device=g.device)
            p.copy_(self.shard_params({name: full})[name])

        draw(self.embed, "embed", 0.1)
        draw(self.pos, "pos", 0.02)
        self.lnf.fill_(1.0)
        draw(self.unembed, "unembed", 0.1)
        for i, blk in enumerate(self.layers):
            for name in Block.MATRICES:
                draw(getattr(blk, name), f"l{i}.{name}", 0.1)
            blk.b1.zero_()
            blk.b2.zero_()
            blk.ln1.fill_(1.0)
            blk.ln2.fill_(1.0)
        return self

    def save(self, path: str) -> None:
        """The JAX package's .npz checkpoint: config scalars + every
        parameter under its JAX name, [in, out] layouts unchanged. Under TP
        the slices are gathered into canonical full arrays (every rank of
        the model axis calls it; its rank 0 writes)."""
        c = self.cfg
        params = {k: v.detach().to("cpu", torch.float32).numpy()
                  for k, v in self.canonical_params().items()}
        if self.mesh is not None and self.mesh.index("model") != 0:
            return
        np.savez(path, __vocab__=c.vocab, __n_layers__=c.n_layers,
                 __d_model__=c.d_model, __n_heads__=c.n_heads,
                 __max_len__=c.max_len, __bos__=c.bos_id, __eos__=c.eos_id,
                 **params)

    @classmethod
    def load(cls, path: str, device: DeviceLike = None, *, mesh=None,
             rules: Optional[ShardingRules] = None) -> "ServableLM":
        """A model from a .npz checkpoint written by either package, on
        any layout: one card, or this rank's slices on a TP mesh."""
        with np.load(path) as z:
            cfg = LMConfig(
                vocab=int(z["__vocab__"]), n_layers=int(z["__n_layers__"]),
                d_model=int(z["__d_model__"]), n_heads=int(z["__n_heads__"]),
                max_len=int(z["__max_len__"]), bos_id=int(z["__bos__"]),
                eos_id=int(z["__eos__"]),
            )
            params = {k: z[k] for k in z.files if not k.startswith("__")}
        model = cls(cfg, device=device, mesh=mesh, rules=rules)
        model.load_canonical(params_from_jax(params))
        return model

    # -- sampling -----------------------------------------------------------
    def _sample(
        self,
        logits: torch.Tensor,  # [B, V]
        seeds: np.ndarray,     # [B] uint32 per-request seed (host)
        steps: np.ndarray,     # [B] int32 token index within the request (host)
        temps: np.ndarray,     # [B] f32; 0 = greedy argmax (host)
        top_ks: np.ndarray,    # [B] int32; 0 = no top-k truncation (host)
        greedy: Optional[torch.Tensor] = None,  # [B] argmax, when computed
    ) -> torch.Tensor:
        """Per-slot token choice -> [B] int64 on the logits' device.

        Greedy is argmax (first index on ties, as jnp.argmax); a caller that
        already has it (the decode graph computes it on the card) passes it
        as `greedy`. Whether any
        slot samples is read from the host-side `temps`, so an all-greedy
        batch — the default serving config — never syncs and never runs the
        sampled branch. A sampled slot keeps logits >= its k-th largest
        (ties kept), divides by its temperature and takes the gumbel-max
        with threefry noise from the key `fold_in(PRNGKey(seed), step)`, as
        the JAX package does: its token depends on its own row and identity
        only, and a replay of (seed, step) draws the same token."""
        if greedy is None:
            greedy = logits.argmax(-1)
        temps = np.asarray(temps, np.float32)
        sampled = np.flatnonzero(temps > 0.0)
        if sampled.size == 0:
            return greedy
        out = greedy.clone()
        vocab = logits.shape[-1]
        for b in sampled:
            lg = logits[b]
            k = int(top_ks[b])
            # a [1] divisor, not a Python scalar: CUDA divides by a host
            # scalar through its reciprocal, an ulp off jnp's division
            z = lg / lg.new_full((1,), float(temps[b]))
            if k > 0:
                thr = torch.topk(lg, min(k, vocab)).values[-1]
                z = torch.where(lg >= thr, z, NEG_INF)
            key = prng.fold_in(prng.PRNGKey(int(seeds[b]), device=lg.device), int(steps[b]))
            u = prng.uniform(key, (vocab,), 1e-20, 1.0)
            out[b] = torch.argmax(z.float() - torch.log(-torch.log(u)))
        return out

    # -- shared block body --------------------------------------------------
    def _mlp(self, blk: Block, x: torch.Tensor) -> torch.Tensor:
        h = _rms(x, blk.ln2)
        # tanh GELU: jax.nn.gelu's default (torch's default is exact erf)
        a = F.gelu(h @ blk.w1 + blk.b1, approximate="tanh")
        if not self.mlp_split:
            return x + (a @ blk.w2 + blk.b2)
        # row-parallel w2: sum the partial products, then b2 once
        return x + (self._reduce(a @ blk.w2, True) + blk.b2)

    def _attn_out(self, blk: Block, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        """x + ctx @ wo; row-parallel under a heads split."""
        return x + self._reduce(ctx @ blk.wo, self.heads_split)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        logits = _rms(x, self.lnf) @ self.unembed
        if not self.vocab_split:
            return logits
        # column-parallel unembed: one all-gather makes the logits full
        tp = self.tp_size
        lead, vl = logits.shape[:-1], logits.shape[-1]
        full = self.mesh.all_gather(logits.reshape(1, -1), "model")
        return full.reshape((tp,) + tuple(lead) + (vl,)).movedim(0, -2).reshape(
            tuple(lead) + (tp * vl,))

    # -- full-context forward (prefill + the sequential reference path) -----
    def _context_forward(
        self, tokens: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The one causal forward: padded [B, T] tokens -> (final residual
        stream [B, T, D], kc, vc [L, B, T, kv_dim]). Plain matmuls and an
        f32 softmax with NEG_INF masking, as the JAX package computes it."""
        cfg = self.cfg
        b, t = tokens.shape
        nh, hd = self.local_heads, cfg.head_dim
        x = self._embed(tokens.long()) + self.pos[:t][None]
        causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
        kcs, vcs = [], []
        for blk in self.layers:
            h = _rms(x, blk.ln1)
            q = (h @ blk.wq).reshape(b, t, nh, hd)
            kf = h @ blk.wk
            vf = h @ blk.wv
            kcs.append(kf)
            vcs.append(vf)
            k = kf.reshape(b, t, nh, hd)
            v = vf.reshape(b, t, nh, hd)
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) * self.scale
            s = torch.where(causal, s, NEG_INF)
            w = torch.softmax(s.float(), -1).to(x.dtype)
            ctx = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, t, -1)
            x = self._attn_out(blk, x, ctx)
            x = self._mlp(blk, x)
        return x, torch.stack(kcs), torch.stack(vcs)

    @torch.no_grad()
    def forward_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """Causal forward over padded [B, T] prompts -> logits [B, T, V]."""
        return self._logits(self._context_forward(tokens)[0])

    @torch.no_grad()
    def prefill(
        self,
        tokens: torch.Tensor,   # [B, T_bucket] int
        lengths: torch.Tensor,  # [B] int
        seeds: np.ndarray,
        temps: np.ndarray,
        top_ks: np.ndarray,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Bucket-padded prompt forward -> (first_tok [B] — sampled at each
        prompt's last valid position, step 0 of its request — kc, vc
        [L, B, T, kv_dim] to commit). Only the last positions are unembedded:
        the logits of the padding never exist."""
        x, kc, vc = self._context_forward(tokens)
        b, t = tokens.shape
        # the JAX package relies on XLA clamping this gather; clamp explicitly
        last_idx = (lengths.long() - 1).clamp(0, t - 1)
        last = x[torch.arange(b, device=x.device), last_idx]  # [B, D]
        first_tok = self._sample(
            self._logits(last), seeds, np.zeros(b, np.int32), temps, top_ks
        )
        return first_tok, kc, vc

    # -- chunked prefill ----------------------------------------------------
    @torch.no_grad()
    def prefill_chunk(
        self,
        k_pages: torch.Tensor,     # [L, NP, PS, KD] — updated in place
        v_pages: torch.Tensor,
        tokens: torch.Tensor,      # [1, C] int — chunk tokens, zero-padded
        starts: torch.Tensor,      # [1] int — chunk's first position
        lengths: torch.Tensor,     # [1] int — the FULL prompt length
        block_rows: torch.Tensor,  # [1, max_pages_per_seq] int — the slot's row
        seeds: np.ndarray,         # [1] (sampling: used on the final chunk)
        temps: np.ndarray,
        top_ks: np.ndarray,
    ) -> torch.Tensor:
        """One C-token chunk of a long prompt: attention = (committed pages,
        masked to positions < start) ++ (causal within the chunk), so the
        chunks together reproduce the whole-prompt forward. Commits the
        chunk's K/V into the pools in place and returns tok [1], sampled at
        position length-1 — meaningful only on the final chunk."""
        b, c = tokens.shape
        x, kc, vc = self._chunk_forward(
            k_pages, v_pages, tokens, starts, block_rows
        )
        # the last valid position falls in this chunk only on the final
        # chunk; the clamp keeps the index in range for the earlier ones
        last_in_chunk = (lengths.long() - 1 - starts.long()).clamp(0, c - 1)
        last = x[torch.arange(b, device=x.device), last_in_chunk]
        tok = self._sample(
            self._logits(last), seeds, np.zeros(b, np.int32), temps, top_ks
        )
        self.commit_prefill(
            k_pages, v_pages, kc, vc, lengths, block_rows, starts,
        )
        return tok

    def _chunk_forward(
        self,
        k_pages: torch.Tensor,     # [L, NP, PS, KD]
        v_pages: torch.Tensor,
        tokens: torch.Tensor,      # [1, C] int
        starts: torch.Tensor,      # [1] int — position of tokens[:, 0]
        block_rows: torch.Tensor,  # [1, max_pages_per_seq] int
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The one chunk-shaped forward -> (final residual stream [1, C, D],
        kc, vc [L, 1, C, KD]); the pools are only read here."""
        cfg = self.cfg
        b, c = tokens.shape
        nh, hd = self.local_heads, cfg.head_dim
        ps = k_pages.shape[2]
        dev = k_pages.device
        pos = starts.long()[:, None] + torch.arange(c, device=dev)[None, :]
        # the padded tail may run past max_len; clamp the INDEX only (those
        # positions are causally invisible to every valid one)
        x = self._embed(tokens.long()) + self.pos[pos.clamp(max=cfg.max_len - 1)]
        rows = block_rows.long()
        t_ctx = rows.shape[1] * ps
        ctx_idx = torch.arange(t_ctx, device=dev)
        # committed-context mask: this chunk sees positions strictly before it
        past = ctx_idx[None, None, :] < starts.long()[:, None, None]  # [1, 1, T]
        causal = torch.ones((c, c), dtype=torch.bool, device=dev).tril()
        kcs, vcs = [], []
        for i, blk in enumerate(self.layers):
            h = _rms(x, blk.ln1)
            q = (h @ blk.wq).reshape(b, c, nh, hd)
            kf = h @ blk.wk
            vf = h @ blk.wv
            kcs.append(kf)
            vcs.append(vf)
            k_self = kf.reshape(b, c, nh, hd)
            v_self = vf.reshape(b, c, nh, hd)
            k_past = k_pages[i][rows].reshape(b, t_ctx, nh, hd)
            v_past = v_pages[i][rows].reshape(b, t_ctx, nh, hd)
            sp = torch.einsum("bqhd,bkhd->bhqk", q, k_past) * self.scale
            sp = torch.where(past[:, None], sp, NEG_INF)
            ss = torch.einsum("bqhd,bkhd->bhqk", q, k_self) * self.scale
            ss = torch.where(causal, ss, NEG_INF)
            s_all = torch.cat([sp, ss], -1)  # [1, H, C, T + C]
            w = torch.softmax(s_all.float(), -1).to(x.dtype)
            ctx = (
                torch.einsum("bhqk,bkhd->bqhd", w[..., :t_ctx], v_past)
                + torch.einsum("bhqk,bkhd->bqhd", w[..., t_ctx:], v_self)
            ).reshape(b, c, -1)
            x = self._attn_out(blk, x, ctx)
            x = self._mlp(blk, x)
        return x, torch.stack(kcs), torch.stack(vcs)

    # -- speculative decoding -----------------------------------------------
    @torch.no_grad()
    def verify_chunk(
        self,
        k_pages: torch.Tensor,     # [L, NP, PS, KD] — chunk K/V commits here
        v_pages: torch.Tensor,
        tokens: torch.Tensor,      # [1, K+1] int: last committed token + K drafts
        starts: torch.Tensor,      # [1] int — position of the last committed token
        block_rows: torch.Tensor,  # [1, max_pages_per_seq] int — the slot's row
        seeds: np.ndarray,         # [1] uint32 — the request's sampling seed
        steps0: np.ndarray,        # [1] int32 — emitted-token index of sampled[0]
        temps: np.ndarray,         # [1] f32
        top_ks: np.ndarray,        # [1] int32
    ) -> torch.Tensor:
        """Score K drafted tokens in ONE chunk-shaped call (prompt-lookup
        speculative decoding). The chunk is [last_token, draft_1..K] at
        positions [starts .. starts+K]: the logits at chunk position i are
        what a sequential decode would see after emitting drafts 1..i, so
        `sampled[i]` is the token the model WOULD emit there — the host
        accepts draft_{i+1} while sampled[i] == draft_{i+1} and takes the
        first divergent token free.

        Position i samples with the emitted-token index `steps0 + i` — the
        index the plain decode loop would use, never the engine step — so a
        replay regenerates bitwise-identical tokens at temperature > 0 too.

        All K+1 positions' K/V commit into the slot's pages (in place).
        Positions past the slot's reserved pages fall through the row's zero
        entries into dump page 0; rejected positions leave stale K/V that
        every mask excludes until the next step rewrites them. Returns
        sampled [K+1] int64 on the device."""
        b, c = tokens.shape
        x, kc, vc = self._chunk_forward(
            k_pages, v_pages, tokens, starts, block_rows
        )
        lane = np.arange(c, dtype=np.int32)
        sampled = self._sample(
            self._logits(x)[0],                          # [K+1, V]
            np.broadcast_to(np.asarray(seeds, np.uint32), (c,)),
            np.asarray(steps0, np.int32) + lane,         # emitted-token index
            np.broadcast_to(np.asarray(temps, np.float32), (c,)),
            np.broadcast_to(np.asarray(top_ks, np.int32), (c,)),
        )
        # commit every chunk position (lengths = starts + K + 1)
        self.commit_prefill(
            k_pages, v_pages, kc, vc, starts + c, block_rows, starts,
        )
        return sampled

    # -- page pool plumbing -------------------------------------------------
    @torch.no_grad()
    def commit_prefill(
        self,
        k_pages: torch.Tensor,     # [L, NP, PS, KD] — updated in place
        v_pages: torch.Tensor,
        kc: torch.Tensor,          # [L, B, T, KD] from prefill / prefill_chunk
        vc: torch.Tensor,
        lengths: torch.Tensor,     # [B] — the FULL prompt length
        block_rows: torch.Tensor,  # [B, max_pages_per_seq] int
        starts: torch.Tensor,      # [B] — position of kc[..., 0, :]
    ) -> None:
        """Scatter prompt K/V into the slots' pages at offset `starts`.
        Positions past a prompt's length land in dump page 0.

        The port writes the pools in place where the JAX package donated
        them. Padding positions can share a (page 0, offset) target: on the
        device one arbitrary writer wins, which is harmless because no live
        slot ever reads page 0 unmasked."""
        ps = k_pages.shape[2]
        n_l, b, t, kd = kc.shape
        dev = k_pages.device
        pos = starts.long()[:, None] + torch.arange(t, device=dev)[None, :]
        valid = pos < lengths.long()[:, None]  # [B, T]
        rows = block_rows.long()
        logical = (pos // ps).clamp(max=rows.shape[1] - 1)
        page = torch.where(valid, rows.gather(1, logical), 0).reshape(-1)
        offs = (pos % ps).reshape(-1)
        k_pages[:, page, offs] = kc.reshape(n_l, b * t, kd)
        v_pages[:, page, offs] = vc.reshape(n_l, b * t, kd)

    # -- the decode step ----------------------------------------------------
    def _paged_attention_local(
        self,
        q: torch.Tensor,            # [S, KD]
        k_pages_i: torch.Tensor,    # [NP, PS, KD] — one layer's pool
        v_pages_i: torch.Tensor,
        block_table: torch.Tensor,  # [S, P] int32
        positions: torch.Tensor,    # [S] int32
        n_heads: int,
    ) -> torch.Tensor:
        """Ragged paged attention over `n_heads` heads (this rank's head
        slice under TP: heads never mix, so the per-rank math is the
        single-card math for those heads): the CUDA kernel for tensors on
        the card, its plain version (the JAX package's dense gather oracle)
        for tensors on the CPU."""
        return paged_attention_decode(
            q, k_pages_i, v_pages_i, block_table, positions,
            scale=self.scale, n_heads=n_heads,
        )

    @torch.no_grad()
    def decode_logits(
        self,
        k_pages: torch.Tensor,      # [L, NP, PS, KD] — updated in place
        v_pages: torch.Tensor,
        tokens: torch.Tensor,       # [S] int: each slot's last token
        positions: torch.Tensor,    # [S] int: that token's position
        active: torch.Tensor,       # [S] bool
        block_table: torch.Tensor,  # [S, max_pages_per_seq] int
    ) -> torch.Tensor:
        """The decode step's forward -> logits [S, V]: writes each active
        slot's step K/V into its current page (inactive slots into dump
        page 0), then attends over the slot's pages up to its own position.
        Every op keeps the slot dimension; nothing reduces across slots."""
        cfg = self.cfg
        ps = k_pages.shape[2]
        pos = positions.long()
        bt32 = block_table.to(torch.int32).contiguous()
        pos32 = positions.to(torch.int32).contiguous()
        # admission keeps live positions < max_len and inside the slot's
        # pages; the clamps keep the inactive lanes' gathers in range on a
        # device that asserts where XLA clamped
        x = self._embed(tokens.long()) + self.pos[pos.clamp(0, cfg.max_len - 1)]
        logical = (pos // ps).clamp(0, bt32.shape[1] - 1)
        cur_page = bt32.long().gather(1, logical[:, None])[:, 0]
        # inactive slots all write (page 0, offset): duplicate targets, one
        # arbitrary writer wins, never read unmasked by a live slot
        cur_page = torch.where(active, cur_page, 0)
        offs = pos % ps
        for i, blk in enumerate(self.layers):
            h = _rms(x, blk.ln1)
            q = h @ blk.wq  # [S, KD]
            # in place where the JAX package donated the pools
            k_pages[i, cur_page, offs] = h @ blk.wk
            v_pages[i, cur_page, offs] = h @ blk.wv
            # this rank's heads (all of them on one card)
            ctx = self._paged_attention_local(
                q, k_pages[i], v_pages[i], bt32, pos32, self.local_heads,
            )
            x = self._attn_out(blk, x, ctx)
            x = self._mlp(blk, x)
        return self._logits(x)

    def decode_step(
        self,
        k_pages: torch.Tensor,
        v_pages: torch.Tensor,
        tokens: torch.Tensor,
        positions: torch.Tensor,
        active: torch.Tensor,
        block_table: torch.Tensor,
        seeds: np.ndarray,   # [S] uint32 per-request sampling seed (host)
        steps: np.ndarray,   # [S] int32 token index within the request
        temps: np.ndarray,   # [S] f32 temperature (0 = greedy)
        top_ks: np.ndarray,  # [S] int32 top-k truncation (0 = off)
    ) -> torch.Tensor:
        """One decode step for all slots at the fixed [max_slots] shape:
        `decode_logits` then per-slot sampling -> next_tok [S] int64 on the
        device. The pools are updated in place."""
        logits = self.decode_logits(
            k_pages, v_pages, tokens, positions, active, block_table
        )
        return self._sample(logits, seeds, steps, temps, top_ks)
