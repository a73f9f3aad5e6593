"""`python -m paddle_tpu_torch` — the port's CLI (counterpart of
`paddle_tpu/cli.py`): `train`, `dump_config`, `merge_model`, `serve` and
`version`, with the
reference's flags and output lines, plus `--device` (default `cuda`; the
tests pass `cpu`; the v1 flags `--use_gpu=0` / `--use_tpu=0` mean `cpu`):

    python -m paddle_tpu_torch train --config=conf.py [--config_args=k=v,...]
        [--job=train|test|time] [--num_passes=N] [--save_dir=DIR]
        [--init_model_path=DIR --start_pass=N] [--log_period=N] [--seed=N]
        [--precision=f32|bf16] [--steps_per_dispatch=K] [--auto_resume=1]
        [--keep_last_n=N] [--async_checkpoint=0|1] [--prefetch_depth=N]
        [--divergence_policy=skip_batch|rollback|raise] [--remat=...]
        [--faults=SPEC] [--master_endpoints=H:P[,H:Q]] [--elastic=0|1]
        [--profile=pass:N --profile_dir=DIR] [--device=cuda|cpu]
    python -m paddle_tpu_torch dump_config --config=conf.py [--config_args=...]
    python -m paddle_tpu_torch merge_model --config=conf.py --model_dir=DIR
        --output=FILE [--config_args=...]
    python -m paddle_tpu_torch serve [--device=cuda|cpu] [--port=N]
        [--demo | --load=model.npz] [--config=gen.conf --model_dir=DIR
        --config_args=...] [--max_slots=N] [--page_size=N]
        [--prefill_buckets=16,32,64] [--prefill_chunk=C] [--speculate_k=K]
        [--prefix_cache] [--max_new_limit=N] [--max_queue=N]
        [--tenant_tokens=CAP] [--tenant_tokens_per_s=R] [--tenant_concurrent=N]
        [--default_deadline_s=S] [--default_ttft_deadline_s=S]
        [--engine_restart_max=N] [--engine_stall_timeout_s=S]
        [--lease_s=S] [--require_register=0|1]
        [--router_endpoints=H:P[,H:Q]] [--advertise_host=H]
        [--stall_fence_s=S] [--exit_on_drain] [--master_endpoints=H:P]
    python -m paddle_tpu_torch version

`train` parses the v1 config (`config/config_parser.py`), builds the
optimizer from its `settings()` (`config/optimizers.build_optimizer`),
binds the provider's input types to the data layers, and trains through
`SGDTrainer` (on the card, each step a replay of the step graph). It prints
a line per pass, `pass N: avg_cost=... [test_cost=...] [Evaluator=...]`;
`--job=test` prints `{"test_cost", "samples"}` and `--job=time`
`{"ms_per_batch", "batches"}`. `--master_endpoints` pulls the training
samples from a task master (`runtime/master.cluster_reader`: pickled
provider-format samples in recordio shards; a primary,standby list fails
over) in place of the config's provider, so a config without data sources
trains there. `--elastic` at `--trainer_count=1` says it needs a mesh and
trains on, as in the reference (a resize epoch reaching the trainer is
ignored); at `--trainer_count > 1` with `--master_endpoints` the job joins
the master's resize plane (below). `--profile=pass:N` captures pass N as a torch.profiler trace
and writes `profile.json` (the step's FLOP and byte buckets,
`obs/profile.py`) under `--profile_dir`, printing `{"profile_json",
"trace_dir"}`; with `--job=time` the buckets join the timing line as
`hlo_cost`. `--compile_cache` (jax's cache) has no counterpart and exits
2 naming it.

`--trainer_count=N` (N > 1) trains data-parallel over N ranks
(`parallel/`), with `--shard_update` (zero1 / zero2 / zero3) and
`--grad_compression` (none / bf16 / int8). The JAX package runs one process
over N local devices; the port runs one process per rank, so the command
starts N copies of itself (`python -m paddle_tpu_torch` with the same
arguments), joined through a store on 127.0.0.1 (`parallel.distributed`):
NCCL with rank r on `cuda:r` on the card, gloo with `--device=cpu`. Each
rank reads the same data, pads each batch to a multiple of N and trains on
its own rows; rank 0 prints the lines a single trainer prints and writes
the checkpoints, the others print nothing. N larger than the visible GPUs
raises, naming both counts. `--shard_update` and `--grad_compression` at
`--trainer_count=1` warn and are ignored, as in the reference. The launcher
hosts the job's store (a `TCPStore` it opens on a free port) and the ranks
join it as clients.

`--elastic=1 --trainer_count=N --master_endpoints=...`: rank 0 holds the
job's one `runtime.master.ResizeClient` (the master counts one trainer a
job, as for the JAX package's one process) and every rank follows its
resize epochs (`SGDTrainer.train(elastic=True)`). The ranks read the
config's provider, each the same global batches; the master carries the
resize plane only (a task queue cannot be replayed by a joiner). On a grow
the launcher, which watches the store for rank 0's announcement, starts
the joining rank processes (`parallel.distributed.join`); a rank that a
shrink leaves out exits 0, which the launcher takes as normal. On the card
a world above the visible GPUs is rejected after the drain and training
goes on at the old size.

`merge_model` folds the config and a pass of `--model_dir` (the newest,
or a pass directory itself) into one .npz (`capi/merge_model.py`) and
prints its path; `capi.create_for_inference(path)` serves it.

`serve` prints `{"role": "serve", "address": [host, port]}` once listening
and, on SIGTERM or SIGINT, `{"final_stats": {...}}` (with a token engine)
before it exits 0. `--config` serves a v1 generating config's
`trainer/generation.GenerationSession` on the parameters of `--model_dir`
(RPC method `generate_config`), beside `--demo` / `--load`'s token engine
or alone. `--router_endpoints` joins a router's fleet as a replica
(`serving/fleet.ReplicaAgent`; a primary,standby list rotates to the
standby when the primary dies); the router itself is `python -m
paddle_tpu_torch.serving.router serve|standby`. `--tp N` (N > 1) with
`--demo` or `--load` serves tensor-parallel over N ranks: the command
starts its N rank processes itself, as `train --trainer_count` does; rank
0 listens and leads the session, the others repeat its device calls
(`serving/tp.py`). Each rank needs a card of its own (NCCL refuses two
ranks on one); on the CPU they run over gloo. With `--config` alone,
`--tp` is ignored, as in the JAX package."""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

log = logging.getLogger("paddle_tpu_torch.cli")


class NotPorted(NotImplementedError):
    """A flag whose subsystem the port has no counterpart of; `main` prints
    it and exits with code 2."""


def _str2bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "on")


def _shard_update_mode(v: str):
    """--shard_update value: a boolean (the zero1 alias) or zero1/2/3."""
    s = str(v).strip().lower()
    if s in ("zero1", "zero2", "zero3"):
        return s
    if s in ("1", "true", "yes", "on"):
        return "zero1"
    if s in ("0", "false", "no", "off", "none", ""):
        return False
    raise argparse.ArgumentTypeError(
        f"--shard_update must be a boolean or one of zero1/zero2/zero3, got {v!r}")


def _train_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", required=True, help="config script path")
    p.add_argument("--config_args", default="",
                   help="k=v,... passed to get_config_arg")
    p.add_argument("--device", default="cuda",
                   help="where training runs: cuda (default) or cpu")
    p.add_argument("--use_tpu", type=_str2bool, default=True,
                   help="v1 flag: 0 means --device=cpu")
    p.add_argument("--use_gpu", type=_str2bool, default=None,
                   help="v1 flag: 0 means --device=cpu")
    p.add_argument("--trainer_count", type=int, default=1)
    p.add_argument("--num_passes", type=int, default=1)
    p.add_argument("--save_dir", default=None)
    p.add_argument("--init_model_path", default=None)
    p.add_argument("--start_pass", type=int, default=0)
    p.add_argument("--log_period", type=int, default=100,
                   help="log the cost every N batches (0 = off)")
    p.add_argument("--test_period", type=int, default=0)
    p.add_argument("--saving_period", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default=None, choices=[None, "float32", "bfloat16"])
    p.add_argument("--precision", default=None, choices=[None, "f32", "bf16"],
                   help="dtype policy of this trainer's step: bf16 casts dot/conv "
                        "inputs to bfloat16, parameters stay f32 masters "
                        "(default: f32, or the --dtype policy)")
    p.add_argument("--remat", default=None,
                   choices=[None, "none", "dots", "conv_only", "full"],
                   help="backward rematerialization policy")
    p.add_argument("--job", default="train", choices=["train", "test", "time"])
    p.add_argument("--num_batches", type=int, default=20, help="--job=time batches")
    p.add_argument("--prefetch_depth", type=int, default=2,
                   help="batches fed and copied to the device ahead of the "
                        "step on a worker thread (0 = off)")
    p.add_argument("--compile_cache", default=None,
                   help="the JAX package's XLA compilation cache (no "
                        "counterpart here: raises)")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="train steps stacked into one dispatch (one graph "
                        "replay); events and the log line fire per dispatch")
    p.add_argument("--shard_update", type=_shard_update_mode, default=False,
                   help="ZeRO-sharded update (needs --trainer_count > 1)")
    p.add_argument("--grad_compression", default="none",
                   choices=["none", "bf16", "int8"],
                   help="compressed collectives (needs --trainer_count > 1)")
    p.add_argument("--guard_check_every", type=int, default=16,
                   help="steps between divergence-guard polls")
    p.add_argument("--async_checkpoint", type=_str2bool, default=True,
                   help="write checkpoints on a writer thread after a "
                        "non-blocking device-to-host copy (0 = synchronous)")
    p.add_argument("--auto_resume", type=_str2bool, default=False,
                   help="resume from the newest CRC-valid checkpoint under "
                        "--save_dir")
    p.add_argument("--divergence_policy", default=None,
                   choices=["skip_batch", "rollback", "raise"],
                   help="react to a NaN/Inf step cost (default: guard off)")
    p.add_argument("--keep_last_n", type=int, default=0,
                   help="keep only the newest N pass checkpoints (0 = all)")
    p.add_argument("--faults", default=None,
                   help="chaos-injection spec, e.g. 'nan_loss:step=37'")
    p.add_argument("--master_endpoints", default=None,
                   help="pull training data from an elastic task master instead "
                        "of the config's provider: 'host:port' or a failover "
                        "list 'a:p1,b:p2' (primary + standby); shards hold "
                        "pickled provider-format samples")
    p.add_argument("--profile", default=None, metavar="pass:N",
                   help="capture a torch.profiler trace of pass N and write the "
                        "step's FLOP/byte buckets as profile.json; with "
                        "--job=time the buckets join the printed JSON line")
    p.add_argument("--profile_dir", default=None,
                   help="where the trace and profile.json go (default: "
                        "<save_dir>/profile, else a directory under TMPDIR)")
    p.add_argument("--preempt_grace_s", type=float, default=30.0,
                   help="drain budget after SIGTERM/SIGINT: checkpoint and "
                        "exit with code 77")
    p.add_argument("--elastic", type=_str2bool, default=False,
                   help="join the master's elastic-resize plane (needs "
                        "--master_endpoints and --trainer_count > 1, a mesh "
                        "to re-shape; without them training goes on without "
                        "elastic resize); the launcher starts joining ranks")


def _refuse_unported(args: argparse.Namespace) -> None:
    """Raise NotPorted for a flag whose subsystem the port lacks."""
    if args.compile_cache:
        raise NotPorted(
            "--compile_cache is the JAX package's persistent XLA compilation "
            "cache; paddle_tpu_torch has no counterpart (its kernels build "
            "once per checkout under build/)")


def _make_evaluator(ec, base_dir: str):
    from paddle_tpu_torch.metrics.evaluators import EVALUATORS

    kw: Dict[str, Any] = {}
    if ec.type == "chunk":
        kw = dict(scheme=ec.chunk_scheme or "IOB",
                  num_chunk_types=ec.num_chunk_types or 1,
                  excluded_chunk_types=ec.excluded_chunk_types)
    elif ec.type == "precision_recall":
        kw = dict(positive_label=(None if ec.positive_label in (-1, None)
                                  else ec.positive_label))
    elif ec.type == "max_id_printer":
        kw = dict(num_results=ec.num_results)
    elif ec.type == "seq_text_printer":
        # the config's relative result/dict paths follow the config's
        # directory; the default result file stays cwd-relative
        def resolve(path: str) -> str:
            return os.path.join(base_dir, path) if path and not os.path.isabs(path) else path

        kw = dict(result_file=(resolve(ec.result_file) if ec.result_file
                               else "generated_sequences.txt"),
                  dict_file=resolve(ec.dict_file), delimited=ec.delimited)
    return EVALUATORS.get(ec.type)(**kw)


class _EvaluatorFeed:
    """The evaluators' per-step inputs, copied off the device explicitly
    and only when the config declares evaluators. On the card each step
    starts non-blocking copies into pinned memory (`host_copy`); the
    evaluators read a step's values when the next step's arrive (its copies
    have landed by then), so the feed adds no sync of its own to the step,
    and `finish` reads the pass's last step. On the CPU the values are
    copies of the step's own tensors, read the same way."""

    def __init__(self, active):
        self.active = active  # [(evaluator, [layer names])]
        self.names = sorted({n for _, names in active for n in names})
        self.pending: Optional[tuple] = None  # (host values, copied event)

    def start(self) -> None:
        self.pending = None
        for ev, _ in self.active:
            ev.start()

    def step(self, outputs: Dict[str, Any]) -> None:
        import torch

        from paddle_tpu_torch.trainer.trainer import host_copy

        host: Dict[str, Any] = {}
        copied = None
        for n in self.names:
            v = outputs.get(n)
            if v is None:
                continue
            if v.dtype in (torch.bfloat16, torch.float16):
                v = v.float()
            # the copies run in stream order: the last one's event covers all
            host[n], copied = host_copy(v)
        self.flush()
        self.pending = (host, copied)

    def flush(self) -> None:
        if self.pending is None:
            return
        host, copied = self.pending
        self.pending = None
        if copied is not None:
            copied.synchronize()
        for ev, names in self.active:
            vals = [host.get(n) for n in names]
            if not vals or vals[0] is None:
                continue
            kw = {"output": vals[0].numpy()}
            if len(vals) > 1 and vals[1] is not None:
                kw["label"] = vals[1].numpy()
            if len(vals) > 2 and vals[2] is not None:
                kw["weight"] = vals[2].numpy()
            ev.update(**kw)

    def finish(self) -> Dict[str, Any]:
        self.flush()
        return {type(ev).__name__: ev.finish() for ev, _ in self.active}


def _train_device(args: argparse.Namespace) -> str:
    """--device, or cpu when a v1 flag turns the accelerator off."""
    if args.use_gpu is False or args.use_tpu is False:
        return "cpu"
    return args.device


class TrainJob:
    """A parsed `train` command, built and ready to run: the trainer, the
    feeder, the readers and the evaluators. `prepare_train` builds it and
    `run` runs the job; a caller in process keeps it to read the trainer
    and the evaluators afterwards."""

    def __init__(self, args, trainer, feeder, reader, test_reader, evaluators,
                 join=None):
        self.args = args
        self.join = join  # a joining rank's plan (parallel.distributed.ElasticPlan)
        self.trainer = trainer
        self.feeder = feeder
        self.reader = reader
        self.test_reader = test_reader
        self.evaluators = evaluators  # [(evaluator, [input layer names])]

    def run(self) -> int:
        from paddle_tpu_torch.core import preempt
        from paddle_tpu_torch.trainer.events import BeginPass, EndIteration, EndPass
        from paddle_tpu_torch.trainer.trainer import Preempted

        args, trainer, feeder = self.args, self.trainer, self.feeder
        reader, test_reader = self.reader, self.test_reader
        if reader is None and args.job != "test":
            print("config declares no data sources (define_py_data_sources2)",
                  file=sys.stderr)
            return 2
        profiler = None
        profile_dir = None
        if args.profile:
            from paddle_tpu_torch.obs import profile as obs_profile

            profile_dir = args.profile_dir or (
                os.path.join(args.save_dir, "profile") if args.save_dir
                else os.path.join(tempfile.gettempdir(), "paddle_tpu_torch_profile"))
            try:
                profiler = obs_profile.PassProfiler.from_spec(args.profile,
                                                              logdir=profile_dir)
            except ValueError as e:
                print(str(e), file=sys.stderr)
                return 2
        if args.init_model_path:
            trainer.init_state(feeder(next(iter(reader() if reader else test_reader()))))
            trainer.load(args.init_model_path,
                         args.start_pass - 1 if args.start_pass else None)
        if args.job == "time":
            return _job_time(trainer, reader, feeder, args.num_batches,
                             profile_dir=profile_dir)
        if args.job == "test":
            if test_reader is None:
                print("--job=test needs a test data source", file=sys.stderr)
                return 2
            if trainer.state is None:
                trainer.init_state(feeder(next(iter(test_reader()))))
            res = trainer.test(test_reader, feeder)
            print(json.dumps({"test_cost": res["cost"], "samples": res["samples"]}))
            return 0

        evals = _EvaluatorFeed(self.evaluators)

        def handler(event):
            if isinstance(event, BeginPass):
                evals.start()
            elif isinstance(event, EndIteration) and self.evaluators:
                evals.step(event.raw_metrics)
            elif isinstance(event, EndPass):
                stats = evals.finish()
                line = f"pass {event.pass_id}: avg_cost={event.metrics['avg_cost']:.6f}"
                if "test_cost" in event.metrics:
                    line += f" test_cost={event.metrics['test_cost']:.6f}"
                for k, v in stats.items():
                    line += f" {k}={v}"
                print(line, flush=True)

        if profiler is not None:
            handler = profiler.wrap(handler)
        profile_reader = reader  # the cost report's batch, before the prefetcher
        elastic = bool(args.elastic and args.master_endpoints
                       and trainer.parallel is not None)
        resize_client = None
        if args.elastic and not elastic:
            # the reference's message for a trainer without a mesh; train on
            print("--elastic needs --master_endpoints (the resize plane rides "
                  "the master heartbeats) and --trainer_count > 1 (a mesh to "
                  "re-shape); continuing without elastic resize", file=sys.stderr)
        elif elastic and self.join is None and trainer.mesh.rank == 0:
            # one member a job: rank 0 acks the epochs for every rank
            from paddle_tpu_torch.runtime.master import ResizeClient

            try:
                resize_client = ResizeClient(args.master_endpoints)
            except ConnectionError as e:
                # an unreachable master must not abort training, as in the
                # reference: the other ranks still agree on every boundary
                print(f"--elastic: master unreachable ({e}); continuing without "
                      "elastic resize", file=sys.stderr)
        if args.prefetch_depth > 0:
            # feed and host-to-device copy on a worker thread, ahead of the step
            from paddle_tpu_torch.data.pipeline import DevicePrefetcher

            reader = DevicePrefetcher(reader, feeder, prefetch_depth=args.prefetch_depth,
                                      device=trainer.device, parallel=trainer.parallel,
                                      stack_k=args.steps_per_dispatch)
        preempt.install(grace_s=args.preempt_grace_s)
        try:
            trainer.train(
                reader, num_passes=args.num_passes, event_handler=handler, feeder=feeder,
                test_reader=test_reader, save_dir=args.save_dir,
                log_period=args.log_period, auto_resume=args.auto_resume,
                keep_last_n=args.keep_last_n or None,
                steps_per_dispatch=args.steps_per_dispatch,
                async_checkpoint=args.async_checkpoint,
                resize_barrier=resize_client.barrier if resize_client else None,
                elastic=elastic, join=self.join)
        except Preempted as p:
            where = (f"checkpoint saved to {p.checkpoint_dir}" if p.checkpoint_dir
                     else "no mid-pass checkpoint (no --save_dir or grace expired)")
            print(f"preempted ({p.reason}): drained at pass {p.pass_id} batch "
                  f"{p.batches_done}; {where}; restart with --auto_resume=1 to continue",
                  file=sys.stderr)
            return preempt.EXIT_PREEMPTED
        finally:
            preempt.reset()
            if resize_client is not None:
                resize_client.close()
        if trainer.left is not None:
            print(f"rank {trainer.left['rank']} left the job at the resize to "
                  f"{trainer.left['world']}", file=sys.stderr)
            return 0
        if profiler is not None:
            self._profile_report(profiler, profile_dir, profile_reader)
        return 0

    def _profile_report(self, profiler, profile_dir: str, reader) -> None:
        """Write profile.json (whether the pass was captured, and the step's
        cost buckets against the reader's first batch) and print where."""
        from paddle_tpu_torch.obs import profile as obs_profile

        report = {"profile": self.args.profile, "trace_dir": profile_dir,
                  "captured": profiler.captured}
        try:
            raw = next(iter(reader()), None) if reader is not None else None
            if raw is not None and self.trainer.state is not None:
                batch = (self.feeder(raw) if self.feeder is not None
                         and not isinstance(raw, dict) else raw)
                report.update(obs_profile.trainer_cost_report(self.trainer, batch))
        except Exception as e:  # the report must not fail a finished run
            log.warning("step cost report failed: %r", e)
            report["error"] = repr(e)[-400:]
        path = obs_profile.write_report(report, os.path.join(profile_dir, "profile.json"))
        print(json.dumps({"profile_json": path,
                          "trace_dir": profile_dir if profiler.captured else None}))


def prepare_train(args: argparse.Namespace) -> TrainJob:
    """Parse the config of a `train` command and build its job: the
    optimizer from `settings()`, the trainer, the provider bound to the
    data layers, the readers and the declared evaluators."""
    from paddle_tpu_torch.config import build_optimizer, parse_config
    from paddle_tpu_torch.core import faults, init_ctx
    from paddle_tpu_torch.data.provider import bind_provider_types, make_reader
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.trainer.trainer import SGDTrainer

    _refuse_unported(args)
    parallel = join = None
    rank = _rank_env()
    if args.trainer_count > 1:
        if rank is None:
            raise ValueError("--trainer_count > 1 runs one process per rank: start it "
                             "through `python -m paddle_tpu_torch train` (cmd_train "
                             "launches the ranks)")
        from paddle_tpu_torch.parallel import DataParallel, distributed, make_mesh

        dev_name = _train_device(args)
        on_card = resolve_device(dev_name).type == "cuda"
        if on_card:
            dev_name = f"cuda:{rank}"
        device = resolve_device(dev_name)
        if _JOIN_ENV in os.environ:
            # a rank the launcher started for a grown resize epoch
            store = distributed.connect(os.environ[_COORD_ENV])
            try:
                group, join = distributed.join(store, int(os.environ[_JOIN_ENV]), rank,
                                               device)
            except ValueError as e:  # the job went on at its old size
                print(f"rank {rank}: {e}", file=sys.stderr)
                raise SystemExit(0)
            mesh = make_mesh(join.axes, group=group, device=device)
        else:
            distributed.initialize(os.environ[_COORD_ENV], args.trainer_count, rank,
                                   backend="nccl" if on_card else "gloo", host_store=False)
            mesh = make_mesh({"data": args.trainer_count}, device=device)
        parallel = DataParallel(mesh)
    else:
        device = resolve_device(_train_device(args))
    init_ctx.init(device=device.type, trainer_count=args.trainer_count,
                  log_period=args.log_period, seed=args.seed,
                  **({"dtype_policy": args.dtype} if args.dtype else {}))
    if parallel is None and (args.shard_update or args.grad_compression != "none"):
        log.warning("--shard_update/--grad_compression need --trainer_count > 1 "
                    "(no data axis to shard over); ignoring them")
        args.shard_update, args.grad_compression = False, "none"
    if args.faults:
        faults.get().configure(args.faults)

    pc = parse_config(args.config, args.config_args, emit_proto=False)
    oc = pc.trainer_config.opt_config
    bundle = build_optimizer(oc)
    # Outputs() may mix training costs with plain fetch layers: only cost
    # layers join the objective, the rest ride as extra outputs
    cost_outputs = [l for l in pc.outputs if getattr(l, "is_cost", False)]
    fetch_outputs = [l for l in pc.outputs if not getattr(l, "is_cost", False)]
    if not cost_outputs:
        cost_outputs, fetch_outputs = pc.outputs, []
    # evaluator inputs must be network outputs so the step returns them
    extra_layers = list(fetch_outputs)
    seen = {l.name for l in cost_outputs} | {l.name for l in fetch_outputs}
    eval_objs = []
    net_layers = pc.topology.network.layers_by_name
    for ec in pc.context.evaluators:
        ins = [net_layers[n] for n in ec.input_layers if n in net_layers]
        for l in ins:
            if l.name not in seen:
                seen.add(l.name)
                extra_layers.append(l)
        eval_objs.append((ec, [l.name for l in ins]))

    trainer = SGDTrainer(
        cost_outputs, bundle.optimizer, seed=args.seed, device=device,
        precision=args.precision, extra_outputs=extra_layers,
        schedule=bundle.schedule, model_average=bundle.model_average,
        remat=args.remat, divergence_policy=args.divergence_policy,
        guard_check_every=args.guard_check_every, parallel=parallel,
        shard_update=args.shard_update if parallel is not None else False,
        grad_compression=args.grad_compression if parallel is not None else None)
    batch_size = oc.batch_size or 32
    data_config = pc.trainer_config.data_config
    test_config = pc.trainer_config.test_data_config
    # bind strictly, as PyDataProvider2's slot binding does: a mis-bound
    # provider would train on garbage
    bind_dc = data_config or test_config
    feeding = bind_provider_types(pc.topology, bind_dc) if bind_dc is not None else None
    feeder = pc.topology.make_feeder(feeding)
    reader = make_reader(data_config, batch_size) if data_config else None
    if args.master_endpoints and parallel is None:
        # the cluster data path: this trainer is a stateless consumer of the
        # master's task queue; the endpoint list gives it a standby to fail
        # over to when the primary dies mid-pass. Ranks of a mesh read the
        # provider instead: each needs the same global batches
        from paddle_tpu_torch.data import reader as rd
        from paddle_tpu_torch.runtime.master import cluster_reader

        reader = rd.batch(cluster_reader(args.master_endpoints), batch_size)
    test_reader = make_reader(test_config, batch_size, is_train=False) if test_config else None

    base_dir = ((bind_dc.config_dir if bind_dc is not None else None)
                or os.path.dirname(os.path.abspath(args.config)))
    evaluators = [(_make_evaluator(ec, base_dir), names) for ec, names in eval_objs]
    if evaluators and args.steps_per_dispatch > 1:
        # a K-step dispatch hands out no per-batch outputs: the evaluators
        # would count nothing, so the fusion goes, loudly
        log.warning("config declares %d evaluator(s), which need per-batch network "
                    "outputs — --steps_per_dispatch=%d would starve them; falling "
                    "back to steps_per_dispatch=1", len(evaluators), args.steps_per_dispatch)
        args.steps_per_dispatch = 1
    return TrainJob(args, trainer, feeder, reader, test_reader, evaluators, join=join)


_RANK_ENV = "PADDLE_TPU_TORCH_RANK"
_COORD_ENV = "PADDLE_TPU_TORCH_COORDINATOR"
_JOIN_ENV = "PADDLE_TPU_TORCH_JOIN_ATTEMPT"


def _rank_env() -> Optional[int]:
    """This process's rank when a `--trainer_count` launcher started it."""
    v = os.environ.get(_RANK_ENV)
    return None if v is None else int(v)


def cmd_train(args: argparse.Namespace) -> int:
    if args.trainer_count > 1 and _rank_env() is None:
        return _launch_ranks(args, args.trainer_count, _train_device(args),
                             "--trainer_count",
                             elastic=bool(args.elastic and args.master_endpoints))
    job = prepare_train(args)
    code = job.run()
    if job.trainer.mesh is not None and code == 0:
        job.trainer.close()  # every rank ends here together
    return code


def _launch_ranks(args: argparse.Namespace, n: int, device, flag: str,
                  elastic: bool = False) -> int:
    """Start `n` copies of this command, one a rank, and wait for them:
    rank 0's output is this command's; another rank's stderr is shown only
    if it fails. The launcher hosts the job's store (a TCPStore on a free
    port of 127.0.0.1) and hands its address to the ranks. A SIGTERM or
    SIGINT to this process goes on to rank 0. `elastic`: watch the store
    for rank 0's resize announcements and start the joining ranks of a
    grown world; a rank's exit 0 (a leaver's) is normal. Returns the first
    failing rank's exit code, else rank 0's."""
    import datetime
    import signal
    import subprocess

    import torch.distributed as dist

    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.parallel import distributed

    visible = None
    if resolve_device(device).type == "cuda":
        visible = torch_cuda_device_count()
        if n > visible:
            raise RuntimeError(f"{flag}={n} needs {n} GPUs, one a rank, but "
                               f"{visible} are visible")
    store = dist.TCPStore("127.0.0.1", 0, None, True,
                          timeout=datetime.timedelta(seconds=300), wait_for_workers=False)
    # the ranks import this package from where this process did
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.pathsep.join([pkg_root] + [p for p in os.environ.get("PYTHONPATH", "")
                                         .split(os.pathsep) if p])
    procs: List[Any] = []  # [rank, process, stderr file or None, exit code]

    def start(r: int, extra: Dict[str, str]) -> None:
        env = {**os.environ, _RANK_ENV: str(r), _COORD_ENV: f"127.0.0.1:{store.port}",
               "PYTHONPATH": path, **extra}
        err = None if r == 0 else tempfile.TemporaryFile()
        procs.append([r, subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch"]
            + list(getattr(args, "argv", sys.argv[1:])), env=env,
            stdout=None if r == 0 else subprocess.DEVNULL,
            stderr=None if r == 0 else err), err, None])

    seen = 0  # the newest resize attempt handled
    try:
        for r in range(n):
            start(r, {})
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                signal.signal(sig, lambda *_: procs[0][1].poll() is None
                              and procs[0][1].send_signal(signal.SIGTERM))
        while any(e[3] is None for e in procs):
            for e in procs:
                if e[3] is None:
                    e[3] = e[1].poll()
            failed = [e[3] for e in procs if e[3] not in (None, 0)]
            if failed and any(e[3] is None for e in procs):
                for e in procs:  # one rank died: the others would wait forever
                    if e[1].poll() is None:
                        e[1].send_signal(signal.SIGTERM)
            if elastic and not failed:
                plan = distributed.latest_plan(store)
                if plan is not None and plan.attempt > seen:
                    seen = plan.attempt
                    if plan.world > plan.old_world and (visible is None
                                                        or plan.world <= visible):
                        for r in range(plan.old_world, plan.world):
                            start(r, {_JOIN_ENV: str(plan.attempt)})
            time.sleep(0.05)
    finally:
        for e in procs:
            if e[1].poll() is None:
                e[1].kill()
                e[1].wait()
    for r, _, err, code in procs:
        if code and err is not None:
            err.seek(0)
            tail = err.read()[-4000:].decode(errors="replace")
            print(f"rank {r} exited {code}:\n{tail}", file=sys.stderr)
        if err is not None:
            err.close()
    failed = [e[3] for e in procs if e[3]]
    return failed[0] if failed else procs[0][3]


def torch_cuda_device_count() -> int:
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _job_time(trainer, reader, feeder, num_batches: int,
              profile_dir: Optional[str] = None) -> int:
    """--job=time (TrainerBenchmark.cpp): the mean time of `num_batches`
    training steps. The first step of the batch signature runs eagerly and,
    on the card, is captured; only the replays that follow are timed, with
    one synchronize at the end. With `profile_dir` (--profile) the timed
    window is a torch.profiler trace there, and the step's cost buckets
    (one eager step on a copy of the state) join the line as `hlo_cost`."""
    import torch

    it = iter(reader())
    batches = []
    for _ in range(num_batches):
        try:
            batches.append(feeder(next(it)))
        except StopIteration:
            break
    if not batches:
        print("no data", file=sys.stderr)
        return 2
    if trainer.state is None:
        trainer.init_state(batches[0])
    cuda = trainer.device.type == "cuda"
    trainer.step(batches[0])  # eager, then captured
    if cuda:
        torch.cuda.synchronize()
    if profile_dir is not None:
        from paddle_tpu_torch.core import stats

        stats.profiler_start(profile_dir)
    t0 = time.perf_counter()
    for b in batches:
        trainer.step(b)
    if cuda:
        torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / len(batches)
    out = {"ms_per_batch": dt * 1e3, "batches": len(batches)}
    if profile_dir is not None:
        from paddle_tpu_torch.obs import profile as obs_profile

        stats.profiler_stop()
        out["trace_dir"] = profile_dir
        out["hlo_cost"] = obs_profile.trainer_cost_report(
            trainer, batches[0])["executables"]["train_step"]
    print(json.dumps(out))
    return 0


def cmd_dump_config(args: argparse.Namespace) -> int:
    from paddle_tpu_torch import proto
    from paddle_tpu_torch.config import parse_config

    pc = parse_config(args.config, args.config_args)
    sys.stdout.write(proto.to_text(pc.trainer_config))
    return 0


def cmd_merge_model(args: argparse.Namespace) -> int:
    from paddle_tpu_torch.capi.merge_model import merge_model

    print(merge_model(args.config, args.model_dir, args.output, args.config_args))
    return 0


def _serve_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="where the engine runs: cuda (default) or cpu")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0, help="0 picks a free port")
    p.add_argument(
        "--demo", action="store_true",
        help="serve the built-in seeded demo LM (smoke/bench mode)",
    )
    p.add_argument("--load", default=None,
                   help="ServableLM .npz to serve (either package's format)")
    p.add_argument(
        "--config", default=None,
        help="v1 config script: serve whole-request generation through a "
             "long-lived GenerationSession (RPC method generate_config)",
    )
    p.add_argument("--model_dir", default=None, help="params for --config")
    p.add_argument("--config_args", default="")
    p.add_argument("--max_slots", type=int, default=8,
                   help="concurrent decode slots = the continuous batch width")
    p.add_argument("--page_size", type=int, default=16,
                   help="tokens per KV page")
    p.add_argument("--num_pages", type=int, default=0,
                   help="KV page pool size (0 = worst case for max_slots)")
    p.add_argument("--prefill_buckets", default="16,32,64",
                   help="padded prompt lengths of the whole-prompt prefill")
    p.add_argument("--prefill_chunk", type=int, default=0,
                   help="chunked prefill (0 = off): prompts longer than this "
                        "commit their KV one C-token chunk per engine step, "
                        "interleaved with decode; also lifts the bucket cap "
                        "on prompt length")
    p.add_argument("--speculate_k", type=int, default=0,
                   help="prompt-lookup speculative decoding (0 = off): draft "
                        "up to K tokens per request per step from the "
                        "request's own n-grams and score them in ONE "
                        "[1, K+1] verify call; tokens are identical to "
                        "--speculate_k 0")
    p.add_argument("--prefix_cache", action="store_true",
                   help="shared-prefix KV cache (needs --prefill_chunk)")
    p.add_argument("--prefix_cache_pages", type=int, default=0,
                   help="cap on cached prefix pages (0 = bounded by the pool)")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="default sampling temperature (0 = greedy argmax)")
    p.add_argument("--top_k", type=int, default=0,
                   help="default top-k truncation (0 = off)")
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel size: > 1 serves --demo / --load over "
                        "that many rank processes (one card each)")
    p.add_argument("--max_new_limit", type=int, default=64)
    p.add_argument("--max_queue", type=int, default=256)
    p.add_argument("--tenant_tokens", type=float, default=0.0,
                   help="per-tenant token-bucket capacity (0 = unlimited)")
    p.add_argument("--tenant_tokens_per_s", type=float, default=0.0)
    p.add_argument("--tenant_concurrent", type=int, default=0,
                   help="per-tenant concurrent-request cap (0 = unlimited)")
    p.add_argument("--default_deadline_s", type=float, default=0.0,
                   help="total-latency deadline for requests that do not set "
                        "one (0 = none); also arms load-aware shedding")
    p.add_argument("--default_ttft_deadline_s", type=float, default=0.0,
                   help="time-to-first-token deadline default (0 = none); "
                        "misses are counted, not fatal")
    p.add_argument("--engine_restart_max", type=int, default=3,
                   help="engine crash/stall recoveries before the server "
                        "fails outstanding requests ('engine_error')")
    p.add_argument("--engine_stall_timeout_s", type=float, default=10.0,
                   help="supervisor stall watchdog: no step progress for this "
                        "long with work pending restarts the engine")
    p.add_argument("--lease_s", type=float, default=30.0,
                   help="tenant lease; silent clients are evicted and their "
                        "queued requests cancelled")
    p.add_argument("--require_register", type=_str2bool, default=False,
                   help="reject requests without a registered tenant lease")
    p.add_argument(
        "--master_endpoints", default=None,
        help="master to health-check: its stats keys (or its "
             "unreachability) ride this server's stats() as `master`",
    )
    p.add_argument(
        "--router_endpoints", default=None,
        help="join a serving router's fleet as a replica: register this "
             "server's endpoint with the router at host:port and renew the "
             "lease with load-snapshot heartbeats; a wedged engine "
             "self-fences so the router fails its work over to a survivor. "
             "A comma-separated primary,standby list rotates to the standby "
             "router when the primary dies, whose takeover sweep re-adopts "
             "this replica's in-flight work",
    )
    p.add_argument(
        "--advertise_host", default=None,
        help="hostname the router dials this replica back on (default "
             "--host)",
    )
    p.add_argument("--stall_fence_s", type=float, default=5.0,
                   help="replica self-fence: with work pending and no engine "
                        "progress for this long (between steps), heartbeats "
                        "to the router stop so its lease can lapse")
    p.add_argument("--exit_on_drain", action="store_true",
                   help="exit cleanly when a router-ordered planned drain "
                        "completes")
    # demo model shape knobs (ignored with --load)
    p.add_argument("--max_len", type=int, default=0,
                   help="demo model position capacity (0 = largest bucket + "
                        "max_new_limit)")
    p.add_argument("--vocab", type=int, default=128)
    p.add_argument("--n_layers", type=int, default=2)
    p.add_argument("--d_model", type=int, default=32)
    p.add_argument("--n_heads", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)


def cmd_serve(args: argparse.Namespace) -> int:
    """Long-lived serving process: load once, serve until SIGTERM/SIGINT."""
    import signal as _signal

    from paddle_tpu_torch.serving.quota import TenantQuotas
    from paddle_tpu_torch.serving.server import ServingServer

    tp = args.tp if args.tp and args.tp > 1 and (args.demo or args.load) else 0
    if tp and _rank_env() is None:
        return _launch_ranks(args, tp, args.device, "--tp")
    if tp:
        # this rank's process group; the model's mesh is built over it below
        from paddle_tpu_torch.device import resolve_device
        from paddle_tpu_torch.parallel import distributed

        rank = _rank_env()
        dev = resolve_device(args.device)
        if dev.type == "cuda":
            dev = resolve_device(f"cuda:{rank}")
        distributed.initialize(os.environ[_COORD_ENV], tp, rank,
                               backend="nccl" if dev.type == "cuda" else "gloo",
                               host_store=False)
        args.device = str(dev)
    quotas = None
    if args.tenant_tokens_per_s > 0 and args.tenant_tokens <= 0:
        # a refill rate without a bucket capacity is a no-op; saying nothing
        # would leave the operator believing rate limiting is on
        print(
            "--tenant_tokens_per_s needs --tenant_tokens (the bucket "
            "capacity); no token quota will be enforced", file=sys.stderr,
        )
    elif args.tenant_tokens > 0 and args.tenant_tokens_per_s <= 0:
        # the inverse surprise: a bucket that never refills is a LIFETIME
        # cap, not a rate limit
        print(
            "--tenant_tokens without --tenant_tokens_per_s never refills: "
            "each tenant gets a one-time lifetime budget of "
            f"{args.tenant_tokens:.0f} tokens", file=sys.stderr,
        )
    if args.tenant_tokens > 0 or args.tenant_concurrent > 0:
        quotas = TenantQuotas(
            token_capacity=args.tenant_tokens or None,
            tokens_per_s=args.tenant_tokens_per_s,
            max_concurrent=args.tenant_concurrent or None,
        )
    session = None
    if args.demo or args.load:
        from paddle_tpu_torch.serving.model import ServableLM
        from paddle_tpu_torch.serving.session import (
            ServingSession, make_demo_session, tp_mesh)
        from paddle_tpu_torch.serving.tp import TPWorker

        buckets = tuple(
            int(b) for b in args.prefill_buckets.split(",") if b.strip()
        )
        session_kw = dict(
            max_slots=args.max_slots,
            page_size=args.page_size,
            num_pages=args.num_pages or None,
            prefill_buckets=buckets,
            prefill_chunk=args.prefill_chunk or None,
            prefix_cache=args.prefix_cache,
            prefix_cache_pages=args.prefix_cache_pages or None,
            speculate_k=args.speculate_k,
            default_temperature=args.temperature,
            default_top_k=args.top_k,
            max_new_limit=args.max_new_limit,
            max_queue=args.max_queue,
            quotas=quotas,
            default_deadline_s=args.default_deadline_s or None,
            default_ttft_deadline_s=args.default_ttft_deadline_s or None,
            engine_restart_max=args.engine_restart_max,
            engine_stall_timeout_s=args.engine_stall_timeout_s,
        )
        if args.load:
            mesh = tp_mesh(tp, None, args.device) if tp else None
            model = ServableLM.load(args.load, device=args.device, mesh=mesh)
            session = (ServingSession(model, device=args.device, **session_kw)
                       if mesh is None or mesh.index("model") == 0 else TPWorker(model))
        else:
            session = make_demo_session(
                vocab=args.vocab, n_layers=args.n_layers, d_model=args.d_model,
                n_heads=args.n_heads, seed=args.seed,
                max_len=args.max_len or None, device=args.device,
                tp=tp, **session_kw,
            )
        if isinstance(session, TPWorker):
            # a rank > 0: repeat the leading rank's device calls until it stops
            session.run()
            return 0

    gen_session = None
    if args.config:
        from paddle_tpu_torch.config import parse_config
        from paddle_tpu_torch.trainer.generation import GenerationSession

        pc = parse_config(args.config, args.config_args, emit_proto=False)
        gen_session = GenerationSession(
            pc, model_dir=args.model_dir,
            base_dir=os.path.dirname(os.path.abspath(args.config)), device=args.device)

    if session is None and gen_session is None:
        print("serve needs a model: --demo, --load=model.npz, or "
              "--config=conf.py [--model_dir=DIR]", file=sys.stderr)
        return 2

    stop_evt = threading.Event()
    server = ServingServer(
        session=session, gen_session=gen_session, host=args.host, port=args.port,
        lease_s=args.lease_s,
        require_register=args.require_register,
        master_endpoints=args.master_endpoints,
        router_endpoints=args.router_endpoints,
        advertise_host=args.advertise_host,
        stall_fence_s=args.stall_fence_s,
        # planned drain complete -> leave cleanly and exit 0
        on_drained=(stop_evt.set if args.exit_on_drain else None),
    ).start()
    _signal.signal(_signal.SIGTERM, lambda *_: stop_evt.set())
    _signal.signal(_signal.SIGINT, lambda *_: stop_evt.set())
    print(json.dumps({"role": "serve", "address": list(server.address)}),
          flush=True)
    stop_evt.wait()
    server.stop()
    if session is not None:
        from paddle_tpu_torch.ops import paged_attention

        # the process's decode-kernel launches (one session a process): a
        # fleet drill holds them to decode_steps x n_layers
        print(json.dumps({"final_stats": session.stats(),
                          "paged_attention_launches": paged_attention.LAUNCHES}),
              flush=True)
    return 0


def cmd_version(_args: argparse.Namespace) -> int:
    """Print the JAX package's line, `paddle-tpu <version>`."""
    from paddle_tpu_torch import __version__

    print(f"paddle-tpu {__version__}")
    return 0


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """The command line of `main` -> its namespace (`fn` runs the command)."""
    parser = argparse.ArgumentParser(prog="paddle_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_train = sub.add_parser("train", help="train/test/benchmark a v1 config")
    _train_args(p_train)
    p_train.set_defaults(fn=cmd_train)
    p_dump = sub.add_parser("dump_config", help="print the TrainerConfig text")
    p_dump.add_argument("--config", required=True)
    p_dump.add_argument("--config_args", default="")
    p_dump.set_defaults(fn=cmd_dump_config)
    p_merge = sub.add_parser("merge_model", help="fold a config and its parameters "
                             "into one file")
    p_merge.add_argument("--config", required=True)
    p_merge.add_argument("--model_dir", required=True)
    p_merge.add_argument("--output", required=True)
    p_merge.add_argument("--config_args", default="")
    p_merge.set_defaults(fn=cmd_merge_model)
    p_serve = sub.add_parser(
        "serve", help="continuous-batching inference server"
    )
    _serve_args(p_serve)
    p_serve.set_defaults(fn=cmd_serve)
    p_ver = sub.add_parser("version", help="print the package version")
    p_ver.set_defaults(fn=cmd_version)
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    args.argv = list(sys.argv[1:] if argv is None else argv)
    try:
        return args.fn(args)
    except NotPorted as e:
        print(f"{type(e).__name__}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
