#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paddle_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases (any failure exits non-zero and prints no result line):
  1. card    — nvidia-smi name + power limit; TF32 off for matmul and cuDNN.
  2. build   — nvcc builds every CUDA source of the port from this checkout.
  3. kernels — each kernel's wrapper on card tensors vs its plain PyTorch
               version on the same tensors, at a small odd shape and at the
               main path's shapes: paged attention at GPT-2-small decode
               shapes, S = 8 and 32 with ragged positions, S = 8 at the
               decode profile's contexts of 16-34 tokens and S = 1 at
               position 1023 (max_abs_err <= 1e-4, two calls
               bit-identical, achieved TB/s, the wrapper's host µs per
               call, and the split + merge pair's time inside a CUDA graph
               of 20 back-to-back calls, L2 flushed before each in the graph
               and the flushes' own graph time subtracted, as the decode
               step's graph holds them); the GRU forward (hs, h_last
               <= 1e-4) and backward (each of dproj, dW_zr, dW_c, db, dh0
               <= 1e-3 x max(1, max|plain|)) in both directions at
               T=7/B=5/H=24, at the seq2seq encoder's T=50/B=128/H=512
               with ragged lengths 30-50 and at T=50/B=64/H=1024 (lengths
               30-50, wider than 4 units per SM); the LSTM forward (hs, h_last,
               c_last <= 1e-4) and backward (dproj, dW, db, dh0, dc0, as
               the GRU's) in both directions with non-zero h0 and c0 at
               T=7/B=5/H=24, the text classifier's T=100/B=128/H=512 with
               ragged lengths 60-100 and BASELINE's widest H=1280/B=64;
               attention (<= 1e-4) at (B,Tq,Tk,D,Dv) = (3,5,7,8,6) with a
               [B,1,Tk] and a [B,Tq,Tk] mask, each with a fully masked row,
               at (2,5,9,16,257), and timed at (32,512,512,64,64),
               (8,1024,1024,128,128) with a [B,1,Tk] mask and
               (2,512,512,512,300). Kernel, plain version and (where
               one exists) one PyTorch library call timed with CUDA events
               (L2 flushed and the card given a ~0.5 ms head start
               before each launch), beside the least time the
               card could take (bytes or operations over its peaks: f32
               for the recurrences, three TF32 passes on the tensor cores
               for attention's 3xTF32 products; a recurrent forward counts
               the rows it must compute, a backward the valid steps only). For each
               recurrent forward also its time per step, the time of its
               step loop's grid syncs alone at its own grid and T (the
               library's sync probe) and its time at B = 8, 32 and the
               main batch; for each
               recurrent backward also its layout plan, its parts from
               torch.profiler (walk, split-K dW GEMM with db folded in,
               the pass over the splits) and, as a note, torch.mm of the
               same dW sums in f32 with TF32 off.
  4. serve   — the serving engine at GPT-2 small's widths (12 layers,
               d_model 768, 12 heads, vocab 50257, max_len 1024; random
               weights from seed 0) answers 8 greedy requests of mixed prompt
               length, one chunked past the largest bucket; its first decode
               step runs eagerly, then the step is one captured CUDA graph,
               replayed. Checks: every request finished, no page leaked, one
               decode signature, one capture, the decode kernel launched
               n_layers times per decode step (replays count the calls they
               hold), and the first REPLAYED step's logits, read from the
               graph's static buffers, agree with the CPU plain path at the
               same weights and pool (atol 1e-3). Graph vs eager: the same
               inputs through a replay and through the eager step, logits
               within 1e-5 relative (bitwise recorded), greedy identical.
               Then 16 decode-only steps unprofiled (host ms a step, the
               graph's device time by CUDA events) and under torch.profiler
               (busy time and share, kernels and the top kernels a step). A
               small model's greedy tokens on the card must equal its
               tokens on the CPU.
 4b. wire    — the port's ServingServer on 127.0.0.1 port 0 over a
               serve_forever session of phase 4's configuration: phase 4's
               8 prompts through a framed ServingClient give phase 4's
               tokens exactly; then serving/workload.run_closed_loop_rpc,
               16 requests of 16-128 prompt tokens and 32 new, at
               concurrency 8 and 1 (tokens/s, TTFT p50/p99, inter-token
               p50/p99). Checks: no page leak, one decode signature,
               launches = decode steps x n_layers.
 4c. speculation — speculate_k=4 against 0 on 8 repetitive prompts, in
               process: identical tokens, one verify and one decode
               signature, free pages back where they started; acceptance
               rate and spec_effective_k printed.
 4d. recovery — the supervised engine under decode_raise:step=8 and then
               engine_stall:step=6 (stall 3 s past a 1 s watchdog): every
               request completes with phase 4's tokens exactly, one
               restart, the graph captured twice (the re-capture after
               recovery), no page leak.
  5. train   — seq2seq NMT training at the reference's headline widths
               (bench.py:211-245: vocab 30000, embed = hidden = 512, batch
               128, lengths 50; random weights from seed 0): SGDTrainer +
               Adam(1e-3), f32, 2 warm-up + 10 timed steps on one batch.
               Checks: 2 forward + 2 backward GRU launches per step (encoder
               fw and bw), finite costs, the last below the first. Then
               torch.profiler over 2 steps: device busy share, launches per
               step, top kernels, the GRU kernels' share.
  6. card vs CPU — the same model, batch 8 with ragged lengths: step-1 cost
               (1e-5 relative) and all 22 gradients (rtol 1e-3, atol 1e-4)
               on the card (kernels) vs the CPU (plain versions), same
               parameters and batch.
  7. LSTM    — text classification training, the reference's RNN benchmark
               (benchmarks/rnn_bench.py: vocab 10000, embed 128, 2 LSTM
               layers, 2 classes, SGD(0.01)) at BASELINE.md's middle LSTM
               row (hidden 512, batch 128, length 100; ids and labels from
               RandomState(0) as rnn_bench draws them), peephole-free
               layers, f32, 2 warm-up + 10 timed steps. Checks: 2 forward +
               2 backward LSTM launches per step, finite costs, the last
               below the first; torch.profiler over 2 steps. Then the same
               model at batch 8 with ragged lengths: step-1 cost (1e-5
               relative) and all 11 gradients (rtol 1e-3, atol 1e-4), card
               vs CPU.
  8. attention — `dot_product_attention` (its only path) at B=32,
               Tq=Tk=512, D=Dv=64 with a per-row mask: forward (1e-4) and
               q/k/v gradients (1e-4 x max(1, max|g|)) through the kernel vs
               the plain body, launches counted from 0.
  9. route   — the shapes the recurrent kernels do not lay out compute
               through the plain step loops and launch no recurrent kernel:
               lstm_scan at T=1, B=207, H=1280 and gru_scan at T=3, B=249,
               H=1280 (vs the CPU, 1e-4 and 1e-3 x max(1, max|g|)); the
               first B without a layout for each RNN at H = 512, 1024,
               1280. dot_product_attention at D=512/Dv=64 and Dv=257, with
               fused=None and fused=True, launches the attention kernel (it
               tiles D and Dv) and matches the plain body on the CPU (1e-4
               and 1e-4 x max(1, max|g|)).
 10. resnet  — ResNet-50 training as bench.py:656-830 run_bench drives the
               reference: 224x224, batch 256, 1000 classes, the bf16
               policy, SGD(0.1, momentum 0.9), 8 stacked batches a
               `multi_step` call (BENCH_SCAN), images and labels from
               RandomState(0); 1 warm-up and 2 timed calls. Prints
               bench.py's fields (resnet50_images_per_sec_per_chip,
               ms_per_step, mfu over the card's dense bf16 peak with
               bench.py's 3 x 8.18 GFLOP an image, platform, device_kind,
               precision, batch_size, image_size, scan_k) and peak memory.
               Checks: finite costs, every batch-norm moving statistic
               moved from its 0 / 1 start. Then torch.profiler over one
               call: device busy share, launches per step, time by kernel
               group (conv, batch-norm reductions, elementwise, pooling)
               and the top kernels; fails if layout transposes run as
               often as the convs (the NHWC activations are to reach cuDNN
               as channels_last, uncopied).
 11. resnet vs CPU — ResNet-50 at 64x64, batch 4, 10 classes from the
               same parameters. f32 with TF32 off: step-1 cost (5e-5
               relative), all 161 gradients (each within 0.1, all together
               within 0.05, relative L2 norm) and all 106 new states (5e-4
               of each one's largest value): the whole graph is
               ill-conditioned at this size (tests/test_torch_resnet.py).
               bf16: each layer fed the CPU's input to it within 5e-2
               relative L2, all but 2 within 1e-3 (a relu may flip an
               output within an ulp of 0); the step's cost finite.
 12. lenet   — LeNet at 28x28, batch 8, f32: step-1 cost (1e-5 relative),
               all gradients (rtol 1e-3, atol 1e-4 x max(1, max|g|)) and
               the parameters after two SGD steps (atol 1e-5), card vs CPU.
 13. lines   — nvidia-smi line, {"kernels": [...]}, then the last line
               {"ok": true, "device": {...}}.

Details also go to build/chip_smoke.json (ignored by git)."""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100/H200 data-sheet peaks (SXM parts unless named): memory bytes/s, f32
# FLOP/s outside the tensor cores, and dense TF32 and dense bf16 FLOP/s on them
_PEAKS = (
    ("H200", 4.8e12, 67e12, 495e12, 989e12),
    ("H100 NVL", 3.9e12, 60e12, 417.5e12, 835.5e12),
    ("H100 PCIe", 2.0e12, 51e12, 378e12, 756e12),
    ("H100", 3.35e12, 67e12, 495e12, 989e12),
)

GPT2_SMALL = dict(vocab=50257, n_layers=12, d_model=768, n_heads=12)
PROMPT_LENS = (16, 40, 100, 128, 200, 350, 500, 700)
NEW_TOKENS = 32
KERNEL_TOL = 1e-4
LOGITS_TOL = 1e-3
GRAPH_RTOL = 1e-5
# the reference's headline NMT training shape (bench.py:211-245, the
# train.conf scale of demo/seqToseq): vocab 30k, embed = hidden = 512
S2S = dict(vocab=30000, embed=512, hidden=512, batch=128, src_len=50, trg_len=50)
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
GRU_FWD_TOL = 1e-4
# dW and db sum T*B = 6400 terms in another order than the plain version
GRU_BWD_RTOL = 1e-3
CPU_BATCH = 8
CPU_COST_RTOL = 1e-5
CPU_GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
# the reference's RNN benchmark (benchmarks/rnn_bench.py: vocab 10000, embed
# 128, 2 LSTM layers, 2 classes, SGD(0.01)) at BASELINE.md's middle LSTM
# row (hidden 512, batch 128, sequence length 100), peephole-free layers
LSTM = dict(vocab=10000, embed=128, hidden=512, layers=2, classes=2, batch=128,
            seq_len=100)
LSTM_FWD_TOL = 1e-4
# dW and db sum up to T*B = 12800 terms in another order than the plain version
LSTM_BWD_RTOL = 1e-3
# attention: B, Tq, Tk, D, Dv of the large kernel shape
ATTN_MAIN = (32, 512, 512, 64, 64)
ATTN_TOL = 1e-4
ATTN_GRAD_RTOL = 1e-4
# the reference's headline benchmark (bench.py:656-830 run_bench): ResNet-50,
# 224x224, batch 256, 1000 classes, SGD(0.1, momentum 0.9), the bf16 policy,
# 8 steps a dispatch (BENCH_SCAN); 1 warm-up and 2 timed dispatches here
RESNET = dict(image_size=224, batch=256, classes=1000, scan_k=8, warmup=1, dispatches=2)
# bench.py's count: ResNet-50 forward at 224x224 is 8.18 GFLOP, training 3x
RESNET_FLOPS_PER_IMAGE = 3 * 8.18e9
# card vs CPU at bench.py's reduced shape (64x64, batch 4, 10 classes).
# The whole graph is ill-conditioned there (tests/test_torch_resnet.py: two
# f32 evaluations' gradients part by percents), so its gradients are held
# as vectors (relative L2 norm), its states to a share of their largest
# value; in bf16 each layer is held on its own, fed the CPU's input to it
RESNET_CPU = dict(image_size=64, batch=4, classes=10)
RESNET_COST_RTOL = 5e-5
RESNET_GRAD_REL_L2 = 0.1
RESNET_ALL_GRADS_REL_L2 = 0.05
RESNET_STATE_RTOL = 5e-4
RESNET_BF16_LAYER_REL_L2 = 5e-2
RESNET_BF16_LAYER_TIGHT = 1e-3
RESNET_BF16_RELU_FLIPS = 2
# LeNet (BASELINE config #1) at MNIST's 28x28, batch 8
LENET_BATCH = 8


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def peaks(name: str):
    """(bytes/s, f32 FLOP/s, dense TF32 FLOP/s) of the card."""
    for key, *rates in _PEAKS:
        if key in name:
            return tuple(rates[:3])
    fail(f"no data-sheet peaks for {name!r}")


def bf16_peak(name: str) -> float:
    """Dense bf16 FLOP/s of the card (its data sheet)."""
    for key, *rates in _PEAKS:
        if key in name:
            return rates[3]
    fail(f"no data-sheet peaks for {name!r}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


_SLEEP_CYCLES = []


def head_start_cycles(torch, ms: float = 0.5) -> int:
    """GPU clock cycles of `torch.cuda._sleep` that take about `ms`
    (measured once with CUDA events)."""
    if not _SLEEP_CYCLES:
        torch.cuda._sleep(1000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(1_000_000)
        b.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES.append(int(ms * 1_000_000 / a.elapsed_time(b)))
    return _SLEEP_CYCLES[0]


def time_ms(torch, fn, flush, iters: int = 30) -> float:
    """Mean device ms per call: CUDA events around each call, with L2
    flushed (a 64 MiB write) before it, as a decode step that has read the
    other layers' pages in between finds it. The card then spins ~0.5 ms
    (`torch.cuda._sleep`) before the first event, so the host has queued
    the call by the time the card reaches it: the interval holds the
    card's time, not the wrapper's host overhead (a call whose host work
    outlasts the card's, as a plain version's loop of small ops may, still
    shows its host time). `host_us` reads the host's side."""
    cycles = head_start_cycles(torch)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def host_us(torch, fn, calls: int = 100, loops: int = 10):
    """The host's side of a call, without flush or head start: µs to issue
    one call (`calls` back to back, no sync), and wall µs per call of the
    same loop run to its end (synchronised) — the larger of the host's and
    the card's time a call, as a host-bound decode step meets it. Each the
    least of `loops` loops: the host is shared, and other work only adds
    (its CPU-time clock ticks too coarsely to read one call)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    issue, wall = [], []
    for _ in range(loops):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        issue.append((t1 - t0) / calls * 1e6)
        wall.append((t2 - t0) / calls * 1e6)
    return min(issue), min(wall)


def paged_inputs(torch, seed, s, h, hd, ps, pmax, min_pos, max_pos, dump_slot):
    """Random ragged decode inputs on the card: positions drawn in
    min_pos..max_pos, shuffled physical pages, partly filled last pages,
    unused table entries on dump page 0, and (when `dump_slot`) a last slot
    at position 0 with an all-dump row."""
    g = torch.Generator().manual_seed(seed)
    kd = h * hd
    n_pages = 1 + s * pmax
    q = torch.randn(s, kd, generator=g)
    kp = torch.randn(n_pages, ps, kd, generator=g)
    vp = torch.randn(n_pages, ps, kd, generator=g)
    free = (torch.randperm(n_pages - 1, generator=g) + 1).tolist()
    bt = torch.zeros(s, pmax, dtype=torch.int32)
    pos = torch.zeros(s, dtype=torch.int32)
    for i in range(s - 1 if dump_slot else s):
        p = int(torch.randint(min_pos, max_pos + 1, (1,), generator=g))
        n = p // ps + 1
        bt[i, :n] = torch.tensor([free.pop() for _ in range(n)], dtype=torch.int32)
        pos[i] = p
    return [t.cuda() for t in (q, kp, vp, bt, pos)]


def graph_ms(torch, fn, flush, calls: int = 20, replays: int = 10):
    """Device ms per call with `calls` calls captured back to back in one
    CUDA graph, as the decode step's graph holds them (no host launch
    between kernels): (cold, warm). Cold: the graph flushes L2 (a 64 MiB
    write) before each call, and a graph of the flushes alone is timed and
    subtracted. Warm: the calls alone, back to back. Each is the median of
    `replays` replays timed with CUDA events after a ~0.5 ms head start."""
    cycles = head_start_cycles(torch)
    fn()
    torch.cuda.synchronize()

    def capture(body):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                body()
        return g

    def replay_ms(g):
        g.replay()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(replays):
            torch.cuda._sleep(cycles)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            g.replay()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)

    flushes = capture(flush.zero_)
    both = capture(lambda: (flush.zero_(), fn()))
    warm = capture(fn)
    cold_ms = (replay_ms(both) - replay_ms(flushes)) / calls
    warm_ms = replay_ms(warm) / calls
    del flushes, both, warm
    return cold_ms, warm_ms


def paged_parts_ms(torch, fn, flush, calls: int = 10):
    """Device ms per paged-attention call by kernel, from torch.profiler over
    `calls` calls with L2 flushed before each: the split grid and the merge
    grid (a design with one kernel shows it as the split). Profiled again,
    up to 3 windows, when the profiler records no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
            for _ in range(calls):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        parts = {"split": 0.0, "merge": 0.0}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and "paged_decode" in e.key:
                part = "merge" if "merge" in e.key else "split"
                parts[part] += e.self_device_time_total / 1e3 / calls
        if parts["split"] > 0:
            return parts
    return None


PAGED_SHAPES = (
    # name, seed, S, H, hd, PS, P, positions drawn in min..max, dump slot
    ("small_odd", 0, 5, 2, 8, 4, 7, 0, 27, True),
    ("gpt2_small_s8", 1, 8, 12, 64, 16, 64, 0, 1023, False),
    ("gpt2_small_s32", 2, 32, 12, 64, 16, 64, 0, 1023, False),
    # one long request: the fewest slots to spread over the card
    ("gpt2_small_s1_long", 3, 1, 12, 64, 16, 64, 1023, 1023, False),
    # the decode profile's contexts (16-34 tokens): a slot's tiles one to a split
    ("gpt2_small_s8_short", 4, 8, 12, 64, 16, 64, 15, 33, False),
)


def kernel_phase(torch, flush, bw, f32_flops):
    """Paged attention vs its plain version at PAGED_SHAPES (1e-4, and two
    calls bit-identical), timed beside the plain version, SDPA + gather and
    the byte bound, with the achieved TB/s and the wrapper's host µs per
    call. Uses the wrapper's public calls only, so it times any checkout's
    package put first on sys.path."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import paged_attention as pa

    rows = []
    for name, seed, s, h, hd, ps, pmax, min_pos, max_pos, dump in PAGED_SHAPES:
        q, kp, vp, bt, pos = paged_inputs(torch, seed, s, h, hd, ps, pmax,
                                          min_pos, max_pos, dump)
        scale = 1.0 / hd ** 0.5
        kw = dict(scale=scale, n_heads=h)
        got = pa.paged_attention_decode(q, kp, vp, bt, pos, **kw)
        again = pa.paged_attention_decode(q, kp, vp, bt, pos, **kw)
        want = pa.paged_attention_decode_ref(q, kp, vp, bt, pos, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        t_ctx = pmax * ps
        mask = (torch.arange(t_ctx, device="cuda")[None, :]
                <= pos.long()[:, None])[:, None, None, :]

        def library():
            k = kp[bt.long()].reshape(s, t_ctx, h, hd).transpose(1, 2)
            v = vp[bt.long()].reshape(s, t_ctx, h, hd).transpose(1, 2)
            o = F.scaled_dot_product_attention(
                q.view(s, h, 1, hd), k, v, attn_mask=mask, scale=scale)
            return o.reshape(s, h * hd)

        lib_err = float((library() - want).abs().max())
        kernel_ms = time_ms(
            torch, lambda: pa.paged_attention_decode(q, kp, vp, bt, pos, **kw),
            flush)
        plain_ms = time_ms(
            torch,
            lambda: pa.paged_attention_decode_ref(q, kp, vp, bt, pos, **kw),
            flush)
        library_ms = time_ms(torch, library, flush)
        parts = paged_parts_ms(
            torch, lambda: pa.paged_attention_decode(q, kp, vp, bt, pos, **kw), flush)
        issue_us, loop_us = host_us(
            torch, lambda: pa.paged_attention_decode(q, kp, vp, bt, pos, **kw))
        g_cold, g_warm = graph_ms(
            torch, lambda: pa.paged_attention_decode(q, kp, vp, bt, pos, **kw),
            flush)
        # least work: each visible K and V row read once, q/table/positions
        # read and out written once; 4 flops per visible token per KD element
        tokens = int((pos.long() + 1).clamp(max=t_ctx).sum())
        kd = h * hd
        nbytes = 2 * 4 * tokens * kd + 2 * 4 * s * kd + 4 * s * pmax + 4 * s
        ops = 4 * tokens * kd
        t_bytes, t_ops = nbytes / bw * 1e3, ops / f32_flops * 1e3
        row = dict(
            shape=name, S=s, H=h, hd=hd, PS=ps, P=pmax,
            visible_tokens=tokens, max_abs_err=err, library_err=lib_err,
            bit_identical=bool(torch.equal(got, again)),
            kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            graph_ms=g_cold, graph_warm_ms=g_warm,
            parts_ms=parts, host_issue_us=issue_us, loop_us=loop_us,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            achieved_tb_s=nbytes / (kernel_ms * 1e-3) / 1e12,
            bytes=nbytes, operations=ops,
        )
        print("kernel", json.dumps(row), flush=True)
        if not err <= KERNEL_TOL:
            fail(f"paged_attention_decode vs plain at {name}: max_abs_err "
                 f"{err} > {KERNEL_TOL}")
        if not row["bit_identical"]:
            fail(f"paged_attention_decode at {name}: two calls differ")
        rows.append(row)
    return rows


def gru_inputs(torch, seed, t, b, h, lengths, h0_scale):
    """Time-major GRU inputs on the card: proj [T,B,3H], mask [T,B] from
    `lengths`, smart-normal weights, bias, h0, and cotangents dhs, dh_last."""
    g = torch.Generator().manual_seed(seed)
    proj = torch.randn(t, b, 3 * h, generator=g)
    lens = torch.as_tensor(lengths)
    mask = (torch.arange(t)[:, None] < lens[None, :]).float()
    w_hzr = torch.randn(h, 2 * h, generator=g) / h ** 0.5
    w_hc = torch.randn(h, h, generator=g) / h ** 0.5
    bias = 0.1 * torch.randn(3 * h, generator=g)
    h0 = h0_scale * torch.randn(b, h, generator=g)
    dhs = torch.randn(t, b, h, generator=g)
    dh_last = torch.randn(b, h, generator=g)
    return [x.cuda() for x in (proj, mask, w_hzr, w_hc, bias, h0, dhs, dh_last)]


def gru_kernel_phase(torch, flush, bw, f32_flops):
    """Both GRU kernels vs their plain versions on the card, both
    directions, at a small odd shape and at the encoder's shape in the
    seq2seq training step; kernel and plain times (CUDA events, L2 flushed)
    beside the bound, at each shape in the forward direction."""
    from paddle_tpu_torch.ops import rnn_kernels as K

    g = torch.Generator().manual_seed(5)
    main_lens = torch.randint(30, 51, (S2S["batch"],), generator=g)
    main_lens[0] = S2S["src_len"]
    wide_lens = torch.randint(30, 51, (64,), generator=g)
    wide_lens[0] = S2S["src_len"]
    shapes = (
        # name, seed, T, B, H, lengths, h0 scale
        ("small_odd", 11, 7, 5, 24, [7, 3, 1, 5, 6], 0.5),
        ("s2s_encoder", 12, S2S["src_len"], S2S["batch"], S2S["hidden"],
         main_lens.tolist(), 0.0),
        ("wide_h1024", 13, S2S["src_len"], 64, 1024, wide_lens.tolist(), 0.5),
    )
    rows = []
    for name, seed, t, b, h, lens, h0_scale in shapes:
        proj, mask, w_hzr, w_hc, bias, h0, dhs, dh_last = gru_inputs(
            torch, seed, t, b, h, lens, h0_scale)
        fwd_args = (proj, mask, w_hzr, w_hc, bias, h0)
        row = dict(shape=name, T=t, B=b, H=h, lengths_min=min(lens),
                   lengths_max=max(lens), plan=K.gru_seq_plan(h, b, t))
        for reverse in (False, True):
            hs, zrc = K.gru_seq_fwd(*fwd_args, reverse=reverse)
            hs_ref, zrc_ref = K.gru_seq_fused_ref(*fwd_args, reverse=reverse)
            last = 0 if reverse else -1
            bwd_tail = (h0, mask, w_hzr, w_hc, dhs, dh_last)
            got = K.gru_seq_bwd(zrc, hs, *bwd_tail, reverse=reverse)
            want = K.gru_seq_bwd_ref(zrc_ref, hs_ref, *bwd_tail, reverse=reverse)
            torch.cuda.synchronize()
            d = "rev" if reverse else "fwd"
            errs = {
                "hs": float((hs - hs_ref).abs().max()),
                "h_last": float((hs[last] - hs_ref[last]).abs().max()),
                "zrc": float((zrc - zrc_ref).abs().max()),
            }
            row[f"fwd_err_{d}"] = errs
            for k in errs:
                if not errs[k] <= GRU_FWD_TOL:
                    fail(f"gru_seq_fwd vs plain at {name} ({d}): {k} max_abs_err "
                         f"{errs[k]} > {GRU_FWD_TOL}")
            berrs = {}
            for k, a, w in zip(("dproj", "dw_zr", "dw_c", "db", "dh0"), got, want):
                scale = max(1.0, float(w.abs().max()))
                err = float((a - w).abs().max())
                berrs[k] = dict(max_abs_err=err, limit=GRU_BWD_RTOL * scale)
                if not err <= GRU_BWD_RTOL * scale:
                    fail(f"gru_seq_bwd vs plain at {name} ({d}): {k} max_abs_err "
                         f"{err} > {GRU_BWD_RTOL} x {scale}")
            row[f"bwd_err_{d}"] = berrs
        hs, zrc = K.gru_seq_fwd(*fwd_args)
        bwd_tail = (h0, mask, w_hzr, w_hc, dhs, dh_last)
        row["fwd_kernel_ms"] = time_ms(torch, lambda: K.gru_seq_fwd(*fwd_args), flush)
        fwd_steps(torch, row, lambda: K.gru_seq_fwd_sync(h, b, t), flush)
        row["fwd_plain_ms"] = time_ms(
            torch, lambda: K.gru_seq_fused_ref(*fwd_args), flush, iters=10)
        row["bwd_kernel_ms"] = time_ms(
            torch, lambda: K.gru_seq_bwd(zrc, hs, *bwd_tail), flush)
        row["bwd_plain_ms"] = time_ms(
            torch, lambda: K.gru_seq_bwd_ref(zrc, hs, *bwd_tail), flush, iters=10)
        row["bwd_parts_ms"] = bwd_parts_ms(
            torch, lambda: K.gru_seq_bwd(zrc, hs, *bwd_tail), "gru")
        row["bwd_parts_note"] = BWD_PARTS_NOTE
        dproj = K.gru_seq_bwd(zrc, hs, *bwd_tail)[0].reshape(t * b, 3 * h)
        hp = K._h_prev_seq(hs, h0, False).reshape(t * b, h)
        rh = zrc[..., h:2 * h].reshape(t * b, h) * hp
        row["note_cublas_dw_ms"] = cublas_dw_ms(
            torch, [(hp, dproj[:, :2 * h]), (rh, dproj[:, 2 * h:])], flush)
        # least work, each input read once and each output written once,
        # f32. The forward writes every row's gates, masked ones too, but a
        # masked step carries h through: h W_zr is needed at the valid steps
        # and once after a row's last one (fwd_product_rows), (r*h) W_c at
        # all T*B rows (r changes with x_t). The backward's products run
        # over the valid steps only (a masked step's dproj is 0 and its dh
        # carries through: 2*steps*H*3H for the W^T products, as much for
        # dW). Notes: the forward over all T*B rows, and over valid steps.
        mm = 2 * sum(lens) * h * 3 * h
        fwd_ops = 2 * fwd_product_rows(lens, t) * h * 2 * h + 2 * t * b * h * h
        f = 4
        fwd_bytes = f * (t * b * 3 * h + t * b + 3 * h * h + 3 * h + b * h
                         + t * b * h + t * b * 3 * h)
        bwd_bytes = f * (t * b * 3 * h + t * b * h + b * h + t * b + 3 * h * h
                         + t * b * h + b * h
                         + t * b * 3 * h + 3 * h * h + 3 * h + b * h)
        set_bounds(row, bw, f32_flops, fwd=(fwd_ops, fwd_bytes), bwd=(2 * mm, bwd_bytes),
                   fwd_all_rows=(2 * t * b * h * 3 * h, fwd_bytes),
                   fwd_valid_steps=(mm, fwd_bytes))
        if name == "s2s_encoder":
            row["note_torch_nn_gru_fwd_ms"] = torch_gru_ms(torch, t, b, h, flush)
            row["fwd_kernel_ms_by_batch"] = fwd_by_batch(
                torch, K.gru_seq_fwd, fwd_args, (0, 1), (5,), b, flush)
        print("gru_kernel", json.dumps(row), flush=True)
        rows.append(row)
    return rows


def fwd_product_rows(lens, t):
    """Rows of h_{t-1} W that a forward (time order) must compute: a row
    of length l changes h at its l valid steps, so it needs the product at
    step 0 and after each valid step before T: min(l + 1, T) steps."""
    return sum(min(n + 1, t) for n in lens)


def set_bounds(row, bw, f32_flops, **legs):
    """row[<leg>_bound_ms] and its parts for legs = {leg: (f32
    operations, bytes)}: the larger of the bytes over the card's memory
    rate and the operations over its f32 peak."""
    for leg, (ops, nbytes) in legs.items():
        t_bytes, t_ops = nbytes / bw * 1e3, ops / f32_flops * 1e3
        row[f"{leg}_bound_ms"] = max(t_bytes, t_ops)
        row[f"{leg}_bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        row[f"{leg}_bytes"] = nbytes
        row[f"{leg}_operations"] = ops


def fwd_steps(torch, row, sync_probe, flush):
    """A forward's time per step, and the part of it its grid syncs take
    alone: the library's sync probe runs the same step loop with nothing
    but the syncs, at the forward's own grid and T."""
    t = row["T"]
    row["fwd_us_per_step"] = row["fwd_kernel_ms"] * 1e3 / t
    row["fwd_sync_us_per_step"] = time_ms(torch, sync_probe, flush) * 1e3 / t
    row["fwd_sync_share"] = row["fwd_sync_us_per_step"] / row["fwd_us_per_step"]


def fwd_by_batch(torch, fwd, args, seq, state, b, flush):
    """The forward's ms at B = 8, 32 and b on the first rows of `args`
    (args[i] is [T, B, ...] for i in `seq`, a [B, H] state for i in
    `state`, else a weight): how its time per step moves with the rows."""
    out = {}
    for bb in (8, 32, b):
        sub = [x[:, :bb].contiguous() if i in seq else x[:bb].contiguous() if i in state
               else x for i, x in enumerate(args)]
        out[bb] = time_ms(torch, lambda: fwd(*sub), flush, iters=10)
    return out


def torch_gru_ms(torch, t, b, h, flush):
    """torch.nn.GRU (cuDNN) forward at the same shape: a DIFFERENT function
    (reset gate applied after the recurrent product, r*(W_hn h + b_hn), an
    input projection of its own, no step mask), timed only as a note."""
    gru = torch.nn.GRU(h, h).cuda()
    x = torch.randn(t, b, h, device="cuda")
    with torch.no_grad():
        return time_ms(torch, lambda: gru(x), flush)


def bwd_parts_ms(torch, fn, tag, calls=3):
    """Device ms per backward call by part, from torch.profiler over
    `calls` calls: the walk (`<tag>_bwd_kernel`), the split-K dW GEMM with
    db folded in (`<tag>_dw_kernel`) and its second pass over the splits
    (`<tag>_dw_sum_kernel`, which also sums db); "other" is the list of
    valid rows. Each kernel launches once per call: its mean over the
    launches the profiler recorded is its part. The profiler now and then
    records no device events at all; such a window is profiled again, up
    to 3 windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = {f"{tag}_bwd_kernel": "walk", f"{tag}_dw_kernel": "dw",
             f"{tag}_dw_sum_kernel": "dw_sum"}
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        parts = dict.fromkeys(list(names.values()) + ["other"], 0.0)
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                part = next((v for k, v in names.items() if k in e.key), "other")
                parts[part] += e.self_device_time_total / 1e3 / e.count
        if any(parts.values()):
            break
    if parts["walk"] <= 0 or parts["dw"] <= 0:
        fail(f"torch.profiler saw no {tag} backward kernels: {parts}")
    return parts


BWD_PARTS_NOTE = ("db is folded into dw (column sums of the staged dproj tiles) and "
                  "dw_sum (the second pass over the splits)")


def cublas_dw_ms(torch, pairs, flush):
    """torch.mm of each (A, D) pair as A^T D in f32 with TF32 off: the same
    sums as the dW reduction, a yardstick only (never called by the port)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    return time_ms(torch, lambda: [torch.mm(a.T, d) for a, d in pairs], flush)


def lstm_inputs(torch, seed, t, b, h, lengths):
    """Time-major LSTM inputs on the card: proj [T,B,4H], mask [T,B] from
    `lengths`, a smart-normal W, bias, non-zero h0 and c0, and cotangents
    dhs, dh_last, dc_last."""
    g = torch.Generator().manual_seed(seed)
    proj = torch.randn(t, b, 4 * h, generator=g)
    lens = torch.as_tensor(lengths)
    mask = (torch.arange(t)[:, None] < lens[None, :]).float()
    w_hh = torch.randn(h, 4 * h, generator=g) / h ** 0.5
    bias = 0.1 * torch.randn(4 * h, generator=g)
    h0 = 0.5 * torch.randn(b, h, generator=g)
    c0 = 0.5 * torch.randn(b, h, generator=g)
    dhs = torch.randn(t, b, h, generator=g)
    dh_last = torch.randn(b, h, generator=g)
    dc_last = torch.randn(b, h, generator=g)
    return [x.cuda() for x in (proj, mask, w_hh, bias, h0, c0, dhs, dh_last, dc_last)]


def lstm_kernel_phase(torch, flush, bw, f32_flops):
    """Both LSTM kernels vs their plain versions on the card, both
    directions, non-zero h0 and c0, at a small odd shape, at the text
    classifier's shape with ragged lengths and at BASELINE's widest row;
    kernel and plain times (CUDA events, L2 flushed) beside the bound, at
    each shape in the forward direction."""
    from paddle_tpu_torch.ops import rnn_kernels as K

    g = torch.Generator().manual_seed(6)
    main_lens = torch.randint(60, LSTM["seq_len"] + 1, (LSTM["batch"],), generator=g)
    main_lens[0] = LSTM["seq_len"]
    wide_lens = torch.randint(60, LSTM["seq_len"] + 1, (64,), generator=g)
    wide_lens[0] = LSTM["seq_len"]
    shapes = (
        # name, seed, T, B, H, lengths
        ("small_odd", 21, 7, 5, 24, [7, 3, 1, 5, 6]),
        ("text_cls", 22, LSTM["seq_len"], LSTM["batch"], LSTM["hidden"],
         main_lens.tolist()),
        ("wide_h1280", 23, LSTM["seq_len"], 64, 1280, wide_lens.tolist()),
    )
    rows = []
    for name, seed, t, b, h, lens in shapes:
        proj, mask, w_hh, bias, h0, c0, dhs, dh_last, dc_last = lstm_inputs(
            torch, seed, t, b, h, lens)
        fwd_args = (proj, mask, w_hh, bias, h0, c0)
        bwd_tail = (h0, c0, mask, w_hh, dhs, dh_last, dc_last)
        row = dict(shape=name, T=t, B=b, H=h, lengths_min=min(lens),
                   lengths_max=max(lens), plan=K.lstm_seq_plan(h, b, t))
        for reverse in (False, True):
            hs, gates, ct, cs = K.lstm_seq_fwd(*fwd_args, reverse=reverse)
            ref = K.lstm_seq_fused_ref(*fwd_args, reverse=reverse)
            last = 0 if reverse else -1
            got = K.lstm_seq_bwd(gates, ct, hs, cs, *bwd_tail, reverse=reverse)
            want = K.lstm_seq_bwd_ref(ref[1], ref[2], ref[0], ref[3], *bwd_tail,
                                      reverse=reverse)
            torch.cuda.synchronize()
            d = "rev" if reverse else "fwd"
            errs = {
                "hs": float((hs - ref[0]).abs().max()),
                "h_last": float((hs[last] - ref[0][last]).abs().max()),
                "c_last": float((cs[last] - ref[3][last]).abs().max()),
                "gates": float((gates - ref[1]).abs().max()),
                "ct": float((ct - ref[2]).abs().max()),
                "cs": float((cs - ref[3]).abs().max()),
            }
            row[f"fwd_err_{d}"] = errs
            for k in errs:
                if not errs[k] <= LSTM_FWD_TOL:
                    fail(f"lstm_seq_fwd vs plain at {name} ({d}): {k} max_abs_err "
                         f"{errs[k]} > {LSTM_FWD_TOL}")
            berrs = {}
            for k, a, w in zip(("dproj", "dw", "db", "dh0", "dc0"), got, want):
                scale = max(1.0, float(w.abs().max()))
                err = float((a - w).abs().max())
                berrs[k] = dict(max_abs_err=err, limit=LSTM_BWD_RTOL * scale)
                if not err <= LSTM_BWD_RTOL * scale:
                    fail(f"lstm_seq_bwd vs plain at {name} ({d}): {k} max_abs_err "
                         f"{err} > {LSTM_BWD_RTOL} x {scale}")
            row[f"bwd_err_{d}"] = berrs
        hs, gates, ct, cs = K.lstm_seq_fwd(*fwd_args)
        saved = (gates, ct, hs, cs)
        row["fwd_kernel_ms"] = time_ms(torch, lambda: K.lstm_seq_fwd(*fwd_args), flush)
        fwd_steps(torch, row, lambda: K.lstm_seq_fwd_sync(h, b, t), flush)
        row["fwd_plain_ms"] = time_ms(
            torch, lambda: K.lstm_seq_fused_ref(*fwd_args), flush, iters=5)
        row["bwd_kernel_ms"] = time_ms(
            torch, lambda: K.lstm_seq_bwd(*saved, *bwd_tail), flush)
        row["bwd_plain_ms"] = time_ms(
            torch, lambda: K.lstm_seq_bwd_ref(*saved, *bwd_tail), flush, iters=5)
        row["bwd_parts_ms"] = bwd_parts_ms(
            torch, lambda: K.lstm_seq_bwd(*saved, *bwd_tail), "lstm")
        row["bwd_parts_note"] = BWD_PARTS_NOTE
        dproj = K.lstm_seq_bwd(*saved, *bwd_tail)[0].reshape(t * b, 4 * h)
        hp = K._h_prev_seq(hs, h0, False).reshape(t * b, h)
        row["note_cublas_dw_ms"] = cublas_dw_ms(torch, [(hp, dproj)], flush)
        # least work, each input read once and each output written once,
        # f32. The forward writes every row's gates, masked ones too, but a
        # masked step carries h through, so h W is needed at the valid
        # steps and once after a row's last one (fwd_product_rows). The
        # backward's products run over the valid steps only (2*steps*H*4H
        # for dh_prev, as much for dW). Notes: the forward over all T*B
        # rows, and over valid steps.
        mm = 2 * sum(lens) * h * 4 * h
        fwd_ops = 2 * fwd_product_rows(lens, t) * h * 4 * h
        f, tb = 4, t * b
        fwd_bytes = f * (tb * 4 * h + tb + 4 * h * h + 4 * h + 2 * b * h
                         + 3 * tb * h + tb * 4 * h)
        bwd_bytes = f * (tb * 4 * h + 4 * tb * h + 2 * b * h + tb + 4 * h * h
                         + 2 * b * h + tb * 4 * h + 4 * h * h + 4 * h + 2 * b * h)
        set_bounds(row, bw, f32_flops, fwd=(fwd_ops, fwd_bytes), bwd=(2 * mm, bwd_bytes),
                   fwd_all_rows=(2 * tb * h * 4 * h, fwd_bytes),
                   fwd_valid_steps=(mm, fwd_bytes))
        if name == "text_cls":
            row["note_torch_nn_lstm_fwd_ms"] = torch_lstm_ms(torch, t, b, h, flush)
            row["fwd_kernel_ms_by_batch"] = fwd_by_batch(
                torch, K.lstm_seq_fwd, fwd_args, (0, 1), (4, 5), b, flush)
        print("lstm_kernel", json.dumps(row), flush=True)
        rows.append(row)
    return rows


def torch_lstm_ms(torch, t, b, h, flush):
    """torch.nn.LSTM (cuDNN) forward at the same shape: a DIFFERENT function
    (an input projection of its own, two biases, no step mask), timed only
    as a note."""
    lstm = torch.nn.LSTM(h, h).cuda()
    x = torch.randn(t, b, h, device="cuda")
    with torch.no_grad():
        return time_ms(torch, lambda: lstm(x), flush)


def attn_inputs(torch, seed, b, tq, tk, d, dv, per_row):
    """q, k, v and a 0/1 mask ([B,Tq,Tk] when `per_row`, else [B,1,Tk],
    ~70 % kept) on the card, with one fully masked row."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, tq, d, generator=g)
    k = torch.randn(b, tk, d, generator=g)
    v = torch.randn(b, tk, dv, generator=g)
    mask = (torch.rand(b, tq if per_row else 1, tk, generator=g) > 0.3).float()
    mask[-1, -1, :] = 0.0
    return [x.cuda() for x in (q, k, v, mask)]


ATTN_SHAPES = (
    # name, seed, B, Tq, Tk, D, Dv, per-row mask, timed
    ("small_kv_mask", 31, 3, 5, 7, 8, 6, False, False),
    ("small_row_mask", 32, 3, 5, 7, 8, 6, True, False),
    ("d16_dv257", 36, 2, 5, 9, 16, 257, True, False),
    ("b32_t512", 33, *ATTN_MAIN, True, True),
    ("b8_t1024_d128", 37, 8, 1024, 1024, 128, 128, False, True),
    ("b2_d512_dv300", 38, 2, 512, 512, 512, 300, True, True),
)


def attn_kernel_phase(torch, flush, bw, f32_flops, tf32_flops, names=None):
    """The attention kernel vs its plain version on the card at the JAX
    tests' shape with both mask shapes and a fully masked row, at a wide v
    (Dv=257), and timed at B=32, Tq=Tk=512, D=Dv=64 (per-row mask), at
    B=8, Tq=Tk=1024, D=Dv=128 ([B,1,Tk] mask) and at B=2, Tq=Tk=512,
    D=512, Dv=300: kernel, plain and F.scaled_dot_product_attention
    (additive mask; never called by the port) beside the least time: the
    bytes, or the products as the kernel issues them, three TF32 passes on
    the tensor cores (the f32 SIMT figure kept as a note). `names` picks
    rows of ATTN_SHAPES (all by default); the phase uses the wrapper's
    public calls only, so it times any checkout's package put first on
    sys.path."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import rnn_kernels as K

    rows = []
    for name, seed, b, tq, tk, d, dv, per_row, timed in ATTN_SHAPES:
        if names is not None and name not in names:
            continue
        q, k, v, mask = attn_inputs(torch, seed, b, tq, tk, d, dv, per_row)
        scale = 1.0 / d ** 0.5
        got = K.attention_seq_fwd(q, k, v, mask, scale)
        want = K.attention_seq_fused_ref(q, k, v, mask, scale)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        masked_row_err = float((got[-1, -1] - want[-1, -1]).abs().max())
        row = dict(shape=name, B=b, Tq=tq, Tk=tk, D=d, Dv=dv, Mq=mask.shape[1],
                   max_abs_err=err, fully_masked_row_err=masked_row_err,
                   tensor_core="3xTF32")
        if not (err <= ATTN_TOL and bool(torch.isfinite(got).all())):
            fail(f"attention_seq_fwd vs plain at {name}: max_abs_err {err} > {ATTN_TOL}")
        if timed:
            additive = torch.where(mask > 0, 0.0, -1e9)

            def library():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=additive,
                                                      scale=scale)

            row["library_err"] = float((library() - want).abs().max())
            row["kernel_ms"] = time_ms(
                torch, lambda: K.attention_seq_fwd(q, k, v, mask, scale), flush)
            row["plain_ms"] = time_ms(
                torch, lambda: K.attention_seq_fused_ref(q, k, v, mask, scale), flush)
            row["library_ms"] = time_ms(torch, library, flush)
            ops = 2 * b * tq * tk * (d + dv)
            nbytes = 4 * (b * tq * d + b * tk * d + b * tk * dv + mask.numel()
                          + b * tq * dv)
            t_bytes, t_ops = nbytes / bw * 1e3, 3 * ops / tf32_flops * 1e3
            row.update(bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       bytes=nbytes, operations=ops, tensor_core_operations=3 * ops,
                       bound_ms_f32_simt=max(t_bytes, ops / f32_flops * 1e3))
        print("attn_kernel", json.dumps(row), flush=True)
        rows.append(row)
    return rows


def attn_path_phase(torch):
    """`ops/attention.dot_product_attention`, the fused op's own path, at
    B=32, Tq=Tk=512, D=Dv=64 with a per-row mask: forward and q/k/v
    gradients with fused=None (the kernel; ATTN_LAUNCHES counted from 0)
    against fused=False (the plain body) on the card."""
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import rnn_kernels as K

    q, k, v, mask = attn_inputs(torch, 34, *ATTN_MAIN, True)
    out = {}
    for fused in (None, False):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        if fused is None:
            K.ATTN_LAUNCHES = 0
        o = A.dot_product_attention(*xs, mask=mask, fused=fused)
        grads = torch.autograd.grad((o * o).sum(), xs)
        torch.cuda.synchronize()
        if fused is None:
            launches = K.ATTN_LAUNCHES
        out[fused] = (o.detach(), grads)
    errs = {"out": float((out[None][0] - out[False][0]).abs().max())}
    limits = {"out": ATTN_TOL}
    for n, a, w in zip("qkv", out[None][1], out[False][1]):
        errs[f"d{n}"] = float((a - w).abs().max())
        limits[f"d{n}"] = ATTN_GRAD_RTOL * max(1.0, float(w.abs().max()))
    res = dict(shape=list(ATTN_MAIN), launches=launches, errors_vs_plain_body=errs,
               limits=limits)
    print("attn_path", json.dumps(res), flush=True)
    if launches < 1:
        fail("dot_product_attention did not launch the attention kernel")
    bad = [k for k in errs if not errs[k] <= limits[k]]
    if bad:
        fail(f"dot_product_attention fused vs plain body differ in {bad}: {errs}")
    return res


def first_b_without_layout(fits, h: int, t: int = 1, hi: int = 4096):
    """The smallest batch in [1, hi] whose (T, B, H) the kernels' plan cannot
    lay out (None if it lays out all), by bisection: a larger batch only
    needs more of a block's shared memory."""
    if fits(h, hi, t):
        return None
    lo = 0  # fits(h, lo) holds (vacuously at 0)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(h, mid, t) else (lo, mid)
    return hi


def route_phase(torch):
    """The shapes where the recurrent kernels have no layout compute on the
    card through the plain step loops and launch no recurrent kernel:
    lstm_scan at T=1, B=207, H=1280 and gru_scan at T=3, B=249, H=1280
    (outputs and every gradient vs the plain path on the CPU: 1e-4, and
    1e-3 x max(1, max|g|)). The attention shapes that once had no fit, q, k
    [1,1,512] / v [1,1,64] and Dv=257, now launch the attention kernel with
    dot_product_attention(fused=None) and fused=True (output and gradients
    vs the plain body on the CPU: 1e-4, and 1e-4 x max(1, max|g|)). Also
    where each recurrent plan runs out on this card: the first B without a
    layout at H = 512, 1024, 1280."""
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import rnn as R
    from paddle_tpu_torch.ops import rnn_kernels as K

    def counters():
        return (K.FWD_LAUNCHES, K.BWD_LAUNCHES, K.LSTM_FWD_LAUNCHES,
                K.LSTM_BWD_LAUNCHES)

    res = {"first_b_without_layout": {
        name: {h: first_b_without_layout(fits, h) for h in (512, 1024, 1280)}
        for name, fits in (("lstm", K.lstm_seq_fits), ("gru", K.gru_seq_fits))}}
    errs, limits = {}, {}
    before = counters()

    def rnn_case(name, t, b, h, gates, run):
        g = torch.Generator().manual_seed(b + h)
        x = {"proj": torch.randn(b, t, gates * h, generator=g),
             "w": torch.randn(h, gates * h, generator=g) * (0.3 * (64 / h) ** 0.5),
             "bias": torch.randn(gates * h, generator=g) * 0.1,
             "h0": torch.randn(b, h, generator=g)}
        mask = (torch.arange(t)[None, :] < 1 + torch.arange(b)[:, None] % t).float()
        out = {}
        for dev in ("cuda", "cpu"):
            xs = {k: v.to(dev).requires_grad_(True) for k, v in x.items()}
            hs, h_last = run(xs, mask.to(dev))
            grads = torch.autograd.grad((hs * hs).sum() + h_last.sum(), list(xs.values()))
            out[dev] = [hs.detach().cpu(), h_last.detach().cpu()] + [gr.cpu() for gr in grads]
        for i, (a, w) in enumerate(zip(out["cuda"], out["cpu"])):
            key = f"{name}_{('hs', 'h_last', *x)[i]}"
            errs[key] = float((a - w).abs().max())
            limits[key] = KERNEL_TOL if i < 2 else 1e-3 * max(1.0, float(w.abs().max()))

    def lstm(xs, mask):
        hs, h_last, _ = R.lstm_scan(xs["proj"], mask, R.LstmParams(xs["w"], xs["bias"]),
                                    h0=xs["h0"], c0=torch.zeros_like(xs["h0"]))
        return hs, h_last

    def gru(xs, mask):
        h = xs["h0"].shape[1]
        p = R.GruParams(xs["w"][:, :2 * h], xs["w"][:, 2 * h:], xs["bias"])
        return R.gru_scan(xs["proj"], mask, p, h0=xs["h0"], reverse=True)

    res["lstm_b207_h1280_fits"] = K.lstm_seq_fits(1280, 207, 1)
    res["gru_b249_h1280_fits"] = K.gru_seq_fits(1280, 249, 3)
    rnn_case("lstm", 1, 207, 1280, 4, lstm)
    rnn_case("gru", 3, 249, 1280, 3, gru)
    rnn_launches = [a - b for a, b in zip(counters(), before)]
    attn_launches = {}
    for name, (b, tq, tk, d, dv) in (("attn_d512", (1, 1, 1, 512, 64)),
                                     ("attn_dv257", (2, 5, 9, 16, 257))):
        q, k, v, mask = attn_inputs(torch, 35, b, tq, tk, d, dv, True)
        for fused in (None, True):
            key = f"{name}_{'none' if fused is None else 'true'}"
            outs = {}
            # the kernel on the card against the plain body on the CPU
            for dev, how in (("cuda", fused), ("cpu", False)):
                xs = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
                n0 = K.ATTN_LAUNCHES
                o = A.dot_product_attention(*xs, mask=mask.to(dev), fused=how)
                outs[dev] = [t.cpu() for t in
                             [o.detach()] + list(torch.autograd.grad((o * o).sum(), xs))]
                if dev == "cuda":
                    attn_launches[key] = K.ATTN_LAUNCHES - n0
            for i, part in enumerate(("out", "dq", "dk", "dv")):
                a, w = outs["cuda"][i], outs["cpu"][i]
                errs[f"{key}_{part}"] = float((a - w).abs().max())
                limits[f"{key}_{part}"] = ATTN_TOL * (1.0 if i == 0 else
                                                      max(1.0, float(w.abs().max())))
    torch.cuda.synchronize()
    res.update(rnn_kernel_launches=rnn_launches, attn_kernel_launches=attn_launches,
               errors=errs, limits=limits)
    print("route", json.dumps(res), flush=True)
    if res["lstm_b207_h1280_fits"] or res["gru_b249_h1280_fits"]:
        fail(f"the fault shapes now have a layout: {res}")
    if any(rnn_launches):
        fail(f"the plain step loops launched recurrent kernels: {rnn_launches}")
    if not all(n >= 1 for n in attn_launches.values()):
        fail(f"dot_product_attention did not launch the attention kernel: {attn_launches}")
    bad = [k for k in errs if not errs[k] <= limits[k]]
    if bad:
        fail(f"routes on the card differ from their references in {bad}: {errs}")
    return res


SERVE = dict(GPT2_SMALL, max_len=1024, max_slots=8, page_size=16,
             prefill_buckets=(64, 128, 256, 512), max_new_limit=64,
             prefill_chunk=128, seed=0)


def gpt2_session(**kw):
    """Phase 4's configuration on the card: GPT-2 small's widths, random
    weights from seed 0 (the same weights in every phase)."""
    from paddle_tpu_torch.serving import make_demo_session

    return make_demo_session(**{**SERVE, **kw}, device="cuda")


def release(torch) -> None:
    """Return the memory of sessions the caller dropped (their pools, decode
    graphs and the graphs' memory pools) before the next one is built."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def serve_phase(torch):
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving.decode_graph import DecodeGraph
    from paddle_tpu_torch.serving.model import ServableLM

    t0 = time.perf_counter()
    sess = gpt2_session()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    model = sess.model
    rng = torch.Generator().manual_seed(1)
    prompts = [
        [model.cfg.bos_id]
        + torch.randint(3, model.cfg.vocab, (n - 1,), generator=rng).tolist()
        for n in PROMPT_LENS
    ]

    # the first REPLAYED decode step's inputs (read back from the graph's
    # static buffers), its pools before the step and its logits, for the
    # CPU reference
    first = {}
    orig_replay = DecodeGraph.replay

    def spy(graph, *host):
        if first:
            return orig_replay(graph, *host)
        # copies: the step and the later ones update the pools in place
        first["pools"] = tuple(t.to("cpu", copy=True)
                               for t in (graph.k_pages, graph.v_pages))
        logits, greedy = orig_replay(graph, *host)
        first["args"] = [t.to("cpu", copy=True) for t in graph.inputs]
        first["logits"] = logits.to("cpu", copy=True)
        return logits, greedy

    DecodeGraph.replay = spy
    step_ms = []
    orig_decode = sess._decode_once

    def timed_decode(skip=frozenset()):
        before = sess.decode_steps
        t = time.perf_counter()
        orig_decode(skip)  # ends in the step's token fetch: synchronised
        if sess.decode_steps != before:
            step_ms.append((time.perf_counter() - t) * 1e3)

    sess._decode_once = timed_decode

    torch.cuda.reset_peak_memory_stats()
    pa.LAUNCHES = 0
    t0 = time.perf_counter()
    handles = [sess.submit(p, NEW_TOKENS) for p in prompts]
    sess.run_until_idle()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = pa.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    DecodeGraph.replay = orig_replay
    del sess._decode_once

    n_tok = sum(len(h.tokens) for h in handles)
    st = sess.stats()
    result = dict(
        config=dict(SERVE, prefill_buckets=list(SERVE["prefill_buckets"]),
                    prompt_lens=list(PROMPT_LENS), new_tokens=NEW_TOKENS),
        setup_s=setup_s, wall_s=wall_s, tokens=n_tok,
        tokens_per_s=n_tok / wall_s,
        decode_steps=sess.decode_steps,
        decode_step_ms_median=statistics.median(step_ms),
        decode_step_ms_min=min(step_ms),
        # the first decode step runs eagerly (the capture's warm-up and the
        # capture itself); the rest replay the graph
        decode_step_ms_first=step_ms[0],
        decode_step_ms_median_replayed=statistics.median(step_ms[1:]),
        decode_graph_captures=sess.decode_graph_captures,
        graph_kernel_calls=sess._decode_graph.kernel_calls,
        prefill_chunks=sess.prefill_chunks_committed,
        launches=launches, peak_memory_bytes=peak,
        finish=[h.finish_reason for h in handles],
        pages_in_use=st["pages_in_use"],
        decode_shape_signatures=sess.decode_shape_signatures(),
    )
    if not all(h.done and h.finish_reason in ("length", "eos") for h in handles):
        fail(f"not every request finished: {result['finish']}")
    if st["pages_in_use"] != 0:
        fail(f"{st['pages_in_use']} KV pages leaked")
    if sess.decode_shape_signatures() != 1:
        fail(f"{sess.decode_shape_signatures()} decode signatures, want 1")
    want = sess.decode_steps * model.cfg.n_layers
    if launches != want:
        fail(f"decode kernel launched {launches} times, want decode_steps x "
             f"n_layers = {want}")
    if sess.decode_graph_captures != 1 or "logits" not in first:
        fail(f"the decode step was captured {sess.decode_graph_captures} "
             f"times, want 1 (and replayed)")

    # the first replayed decode step again on the CPU: plain paged
    # attention, same weights, same pool and inputs
    cpu_model = ServableLM(model.cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    kp, vp = first["pools"]
    ref = cpu_model.decode_logits(kp, vp, *first["args"])
    err = float((ref - first["logits"]).abs().max())
    result["first_step_logits_max_abs_err_vs_cpu"] = err
    print("serve", json.dumps(result), flush=True)
    if not err <= LOGITS_TOL:
        fail(f"first decode step logits differ from the CPU path by {err}")
    result["graph_vs_eager"] = graph_vs_eager_phase(torch, sess)
    result["decode_profile"] = profile_decode(torch, sess, prompts)
    result["tokens"] = [h.tokens for h in handles]
    result["prompts"] = prompts
    del sess, model, cpu_model, first, kp, vp, ref
    release(torch)
    return result


def graph_vs_eager_phase(torch, sess):
    """The same decode inputs through the graph replay and through the
    eager `decode_logits` (on a copy of the pools taken before the replay):
    logits within 1e-5 relative (bitwise where the same kernels run in the
    same order: recorded), greedy tokens identical."""
    g = sess._decode_graph
    s, p = g.block_table.shape
    ps = sess.cache.page_size
    rng = torch.Generator().manual_seed(2)
    pos = torch.randint(0, p * ps, (s,), generator=rng, dtype=torch.int32)
    pages = torch.randperm(sess.cache.num_pages - 1, generator=rng)[: s * p] + 1
    bt = pages.reshape(s, p).to(torch.int32)
    tokens = torch.randint(3, sess.cfg.vocab, (s,), generator=rng, dtype=torch.int32)
    active = torch.ones(s, dtype=torch.bool)
    kp, vp = sess.k_pages.clone(), sess.v_pages.clone()
    logits, greedy = g.replay(tokens.numpy(), pos.numpy(), active.numpy(), bt.numpy())
    logits, greedy = logits.clone(), greedy.clone()
    eager = sess.model.decode_logits(kp, vp, *(t.cuda() for t in (tokens, pos, active, bt)))
    torch.cuda.synchronize()
    rel = float((logits - eager).abs().max() / eager.abs().max())
    out = dict(
        bitwise=bool(torch.equal(logits, eager)),
        max_abs_err=float((logits - eager).abs().max()),
        max_rel_err=rel,
        greedy_equal=bool(torch.equal(greedy, eager.argmax(-1))),
        pools_after_max_abs_err=max(float((kp - sess.k_pages).abs().max()),
                                    float((vp - sess.v_pages).abs().max())),
    )
    print("graph_vs_eager", json.dumps(out), flush=True)
    if not rel <= GRAPH_RTOL or not out["greedy_equal"]:
        fail(f"the decode graph disagrees with the eager step: {out}")
    return out


def profile_decode(torch, sess, prompts, steps: int = 16):
    """Where a steady decode step's time goes, over `steps` decode-only
    engine steps of 8 slots (admission and prefill run before each window),
    twice: unprofiled, the host clock per step and CUDA events around each
    graph replay (the graph's device time, its four input copies included);
    then under torch.profiler, the kernels by name. Device busy share =
    the profiled kernels' time over the unprofiled step's wall time (the
    profiler's own overhead stretches its window's wall); the rest is the
    card idle while the host runs the engine step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving.decode_graph import DecodeGraph

    events = []
    orig_replay = DecodeGraph.replay

    def timed_replay(graph, *host):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = orig_replay(graph, *host)
        b.record()
        events.append((a, b))
        return out

    def window(profiled: bool):
        hs = [sess.submit(p[:16], steps + 2) for p in prompts]
        sess.step()  # admit + prefill + first decode, outside the window
        before = sess.decode_steps
        torch.cuda.synchronize()
        prof = None
        if profiled:
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                           acc_events=True)
            prof.__enter__()
        else:
            DecodeGraph.replay = timed_replay
        try:
            t0 = time.perf_counter()
            for _ in range(steps):
                sess.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            DecodeGraph.replay = orig_replay
            if prof is not None:
                prof.__exit__(None, None, None)
        n = sess.decode_steps - before
        sess.run_until_idle()
        if not all(h.done for h in hs) or sess.cache.pages_in_use:
            fail("profiled requests did not finish cleanly")
        return n, wall_ms, prof

    n_plain, wall_plain, _ = window(False)
    graph_ms = sum(a.elapsed_time(b) for a, b in events) / max(1, len(events))
    n, wall_ms, prof = window(True)
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels[e.key] = (kernels.get(e.key, (0.0, 0))[0]
                              + e.self_device_time_total / 1e3,
                              kernels.get(e.key, (0.0, 0))[1] + e.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    out = dict(
        decode_steps=n, wall_ms_per_step=wall_plain / n_plain,
        graph_device_ms_per_step=graph_ms,
        graph_replays_per_step=len(events) / n_plain,
        device_busy_ms_per_step=busy_ms / n,
        device_busy_share=(busy_ms / n) / (wall_plain / n_plain),
        profiled_wall_ms_per_step=wall_ms / n,
        profiled_busy_share=busy_ms / wall_ms,
        kernels_per_step=sum(c for _, c in kernels.values()) / n,
        paged_attention_ms_per_step=sum(
            ms for k, (ms, _) in kernels.items() if "paged_decode" in k) / n,
        top_kernels_ms_per_step=[[k[:80], ms / n, c / n] for k, (ms, c) in top],
    )
    print("profile", json.dumps(out), flush=True)
    if busy_ms <= 0:
        fail("torch.profiler recorded no device time")
    if len(events) != n_plain:
        fail(f"{len(events)} graph replays in {n_plain} decode steps")
    return out


def wire_phase(torch, serve):
    """The port's ServingServer on 127.0.0.1, port 0, over a serve_forever
    session on the card: phase 4's 8 prompts through a framed
    ServingClient (greedy tokens identical to phase 4's, in process), then
    workload.run_closed_loop_rpc at concurrency 8 and 1."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import ServingClient, ServingServer
    from paddle_tpu_torch.serving.workload import make_prompts, run_closed_loop_rpc

    sess = gpt2_session()
    srv = ServingServer(sess, host="127.0.0.1", port=0).start()
    out = {}
    try:
        pa.LAUNCHES = 0
        client = ServingClient(srv.address, wire="frames")
        got = [client.generate(p, NEW_TOKENS, timeout_s=300.0)["tokens"]
               for p in serve["prompts"]]
        out["framed"] = client.wire_framed
        client.close()
        out["tokens_equal_in_process"] = got == serve["tokens"]
        prompts = make_prompts(16, PROMPT_LENS[:4], GPT2_SMALL["vocab"], 1, seed=3)
        for c in (8, 1):
            r = run_closed_loop_rpc(
                lambda: ServingClient(srv.address, wire="frames"),
                prompts, NEW_TOKENS, concurrency=c)
            r.pop("results")
            out[f"closed_loop_c{c}"] = r
        st = sess.stats()
        out.update(decode_steps=st["decode_steps"], launches=pa.LAUNCHES,
                   decode_graph_captures=st["decode_graph_captures"],
                   pages_in_use=st["pages_in_use"],
                   decode_shape_signatures=st["decode_shape_signatures"])
    finally:
        srv.stop()
    print("wire", json.dumps(out), flush=True)
    if not (out["framed"] and out["tokens_equal_in_process"]):
        fail(f"wire: greedy tokens over the framed wire differ from the "
             f"in-process tokens (framed={out['framed']})")
    if out["pages_in_use"] or out["decode_shape_signatures"] != 1:
        fail(f"wire: {out['pages_in_use']} pages leaked, "
             f"{out['decode_shape_signatures']} decode signatures")
    if out["launches"] != out["decode_steps"] * GPT2_SMALL["n_layers"]:
        fail(f"wire: {out['launches']} decode kernel launches in "
             f"{out['decode_steps']} decode steps")
    del srv, sess
    release(torch)
    return out


def speculation_phase(torch):
    """speculate_k=4 on repetitive prompts, in process: tokens identical to
    speculate_k=0, one verify and one decode signature, no page leak."""
    from paddle_tpu_torch.serving.workload import make_repetitive_prompts

    prompts = make_repetitive_prompts(8, 4, 8, GPT2_SMALL["vocab"], 1, seed=4)
    out = {}
    toks = {}
    for k in (0, 4):
        sess = gpt2_session(speculate_k=k)
        free0 = sess.cache.free_pages
        t0 = time.perf_counter()
        hs = [sess.submit(p, NEW_TOKENS) for p in prompts]
        sess.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = sess.stats()
        toks[k] = [h.tokens for h in hs]
        out[f"k{k}"] = dict(
            wall_s=wall, tokens_per_s=sum(map(len, toks[k])) / wall,
            decode_steps=st["decode_steps"], spec_rounds=st["spec_rounds"],
            spec_acceptance_rate=st["spec_acceptance_rate"],
            spec_effective_k=st["spec_effective_k"],
            spec_pages_trimmed=st["spec_pages_trimmed"],
            verify_shape_signatures=st["verify_shape_signatures"],
            decode_shape_signatures=st["decode_shape_signatures"],
            free_pages_start=free0, free_pages_end=sess.cache.free_pages,
        )
        del sess, hs
        release(torch)
    out["tokens_equal"] = toks[0] == toks[4]
    print("speculation", json.dumps(out), flush=True)
    k4 = out["k4"]
    if not out["tokens_equal"]:
        fail("speculation: speculate_k=4 tokens differ from speculate_k=0")
    if k4["spec_rounds"] < 1 or k4["verify_shape_signatures"] != 1:
        fail(f"speculation: {k4['spec_rounds']} rounds, "
             f"{k4['verify_shape_signatures']} verify signatures")
    for k in ("k0", "k4"):
        if out[k]["decode_shape_signatures"] != 1:
            fail(f"speculation {k}: {out[k]['decode_shape_signatures']} "
                 "decode signatures")
        if out[k]["free_pages_end"] != out[k]["free_pages_start"]:
            fail(f"speculation {k}: pages leaked")
    return out


def recovery_phase(torch, serve):
    """The supervised engine on the card under seeded faults: decode_raise
    mid-run, then an engine_stall past engine_stall_timeout_s. Every request
    completes with tokens bitwise equal to phase 4's fault-free run, one
    restart each, and the decode graph re-captured after it."""
    from paddle_tpu_torch.core import faults

    os.environ["PADDLE_TPU_SERVING_STALL_S"] = "3"
    out = {}
    for site, spec in (("decode_raise", "decode_raise:step=8"),
                       ("engine_stall", "engine_stall:step=6")):
        sess = gpt2_session(engine_restart_max=2, engine_stall_timeout_s=1.0)
        free0 = sess.cache.free_pages
        t0 = time.perf_counter()
        with faults.inject(spec) as inj:
            sess.serve_forever()
            hs = [sess.submit(p, NEW_TOKENS) for p in serve["prompts"]]
            done = all(h._event.wait(300) for h in hs)
            fired = dict(inj.fired)
        sess.stop()
        st = sess.stats()
        row = dict(
            spec=spec, fired=fired.get(site, 0), wall_s=time.perf_counter() - t0,
            engine_restarts=st["engine_restarts"],
            decode_graph_captures=st["decode_graph_captures"],
            finish=[h.finish_reason for h in hs],
            tokens_equal=done and [h.tokens for h in hs] == serve["tokens"],
            pages_leaked=free0 - sess.cache.free_pages,
        )
        out[site] = row
        print("recovery", json.dumps(row), flush=True)
        if not done or not row["tokens_equal"]:
            fail(f"recovery {site}: tokens differ from the fault-free run: {row}")
        if row["fired"] != 1 or row["engine_restarts"] != 1:
            fail(f"recovery {site}: fired {row['fired']}, "
                 f"{row['engine_restarts']} restarts")
        if row["decode_graph_captures"] != 2 or row["pages_leaked"]:
            fail(f"recovery {site}: {row['decode_graph_captures']} captures "
                 f"(want 2: the first and the re-capture), "
                 f"{row['pages_leaked']} pages leaked")
        del sess, hs
        release(torch)
    return out


def small_tokens_phase(torch):
    """A small model's greedy tokens, card vs CPU (same seeded weights)."""
    from paddle_tpu_torch.serving import make_demo_session

    prompts = [[1, 5, 9, 11], [1, 7], list(range(1, 19)), [1] + list(range(40, 47))]
    out = {}
    for dev in ("cuda", "cpu"):
        s = make_demo_session(vocab=96, n_layers=2, d_model=32, n_heads=2,
                              max_len=96, max_slots=4, page_size=8,
                              prefill_buckets=(8, 16, 32), max_new_limit=16,
                              prefill_chunk=8, device=dev)
        hs = [s.submit(p, 8) for p in prompts]
        s.run_until_idle()
        out[dev] = [h.tokens for h in hs]
    print("small_tokens", json.dumps(out), flush=True)
    if out["cuda"] != out["cpu"]:
        fail("small model: greedy tokens on the card differ from the CPU")


def s2s_batch(np, seed, b, ragged):
    """A seq2seq batch drawn as bench.py:234-242 draws it (full lengths), or
    with ragged lengths (first row full)."""
    vocab, src_len, trg_len = S2S["vocab"], S2S["src_len"], S2S["trg_len"]
    rs = np.random.RandomState(seed)
    batch = {
        "source_ids": rs.randint(2, vocab, (b, src_len)).astype(np.int32),
        "source_ids.lengths": np.full(b, src_len, np.int32),
        "target_ids": rs.randint(2, vocab, (b, trg_len)).astype(np.int32),
        "target_ids.lengths": np.full(b, trg_len, np.int32),
        "label_ids": rs.randint(2, vocab, (b, trg_len)).astype(np.int32),
        "label_ids.lengths": np.full(b, trg_len, np.int32),
    }
    if ragged:
        src_l = rs.randint(1, src_len + 1, b).astype(np.int32)
        trg_l = rs.randint(1, trg_len + 1, b).astype(np.int32)
        src_l[0], trg_l[0] = src_len, trg_len
        batch["source_ids.lengths"] = src_l
        batch["target_ids.lengths"] = batch["label_ids.lengths"] = trg_l
    return batch


def s2s_trainer(device):
    from paddle_tpu_torch.models import Seq2SeqModel
    from paddle_tpu_torch.nn.graph import reset_name_scope
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.trainer import SGDTrainer

    reset_name_scope()
    model = Seq2SeqModel(S2S["vocab"], S2S["vocab"], embed_dim=S2S["embed"],
                         hidden_dim=S2S["hidden"])
    return SGDTrainer(model.cost, Adam(learning_rate=1e-3), seed=0, device=device)


def train_phase(torch):
    """The seq2seq training step at the reference's headline widths on the
    card: SGDTrainer + Adam(1e-3), the port's own init from seed 0, one
    bench.py batch, 2 warm-up + 10 timed steps. GRU launch counts are set
    to 0 just before these steps and read just after."""
    import numpy as np

    from paddle_tpu_torch.ops import rnn_kernels as K

    t0 = time.perf_counter()
    trainer = s2s_trainer("cuda")
    batch = s2s_batch(np, 0, S2S["batch"], ragged=False)
    trainer.init_state(batch)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trainer.state["params"].values())

    torch.cuda.reset_peak_memory_stats()
    K.FWD_LAUNCHES = K.BWD_LAUNCHES = 0
    costs, step_ms = [], []
    for _ in range(TRAIN_WARMUP + TRAIN_STEPS):
        t = time.perf_counter()
        costs.append(float(trainer.step(batch)))  # the fetch synchronises
        step_ms.append((time.perf_counter() - t) * 1e3)
    fwd, bwd = K.FWD_LAUNCHES, K.BWD_LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    steps = TRAIN_WARMUP + TRAIN_STEPS
    timed = step_ms[TRAIN_WARMUP:]
    med = statistics.median(timed)
    tokens = S2S["batch"] * S2S["trg_len"]
    result = dict(
        config=dict(S2S, optimizer="Adam(1e-3)", precision="f32, TF32 off",
                    params=n_params),
        setup_s=setup_s, steps=steps, costs=costs, step_ms=step_ms,
        step_ms_median=med, step_ms_min=min(timed),
        tokens_per_s=tokens / (med / 1e3), peak_memory_bytes=peak,
        gru_fwd_launches=fwd, gru_bwd_launches=bwd,
    )
    print("train", json.dumps(result), flush=True)
    if fwd != 2 * steps or bwd != 2 * steps:
        fail(f"GRU kernels launched fwd {fwd} / bwd {bwd} times in {steps} "
             f"steps, want 2 + 2 per step (encoder fw and bw)")
    if not all(np.isfinite(costs)):
        fail(f"non-finite training cost: {costs}")
    if not costs[-1] < costs[0]:
        fail(f"training cost did not fall: first {costs[0]}, last {costs[-1]}")
    result["profile"] = profile_train(torch, trainer, batch)
    return result


def profile_train(torch, trainer, batch, tag: str = "gru", steps: int = 2):
    """Where a training step's time goes: torch.profiler over `steps`
    steps. Device busy = summed kernel time over the window's wall time;
    the `<tag>_` kernels (the recurrence's) are summed apart."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            ms, n = kernels.get(e.key, (0.0, 0))
            kernels[e.key] = (ms + e.self_device_time_total / 1e3, n + e.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    ours = {k: v for k, v in kernels.items() if f"{tag}_" in k}
    rnn_ms = sum(ms for ms, _ in ours.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    out = {
        "steps": steps, "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_busy_share": busy_ms / wall_ms,
        "kernel_launches_per_step": sum(c for _, c in kernels.values()) / steps,
        f"{tag}_kernels_ms_per_step": rnn_ms / steps,
        f"{tag}_kernels_share_of_busy": rnn_ms / busy_ms if busy_ms else 0.0,
        f"{tag}_kernels": {k[:60]: [ms / steps, c / steps] for k, (ms, c) in ours.items()},
        "top_kernels_ms_per_step": [[k[:80], ms / steps, c / steps] for k, (ms, c) in top],
    }
    print("train_profile" if tag == "gru" else f"{tag}_train_profile", json.dumps(out),
          flush=True)
    if busy_ms <= 0:
        fail("torch.profiler recorded no device time in the training steps")
    return out


def train_vs_cpu_phase(torch):
    """Step-1 cost and all 22 gradients at the same widths, batch 8 with
    ragged lengths, on the card (kernels) and on the CPU (plain versions),
    from the same parameters."""
    import numpy as np

    batch = s2s_batch(np, 1, CPU_BATCH, ragged=True)
    cpu = s2s_trainer("cpu")
    cpu.init_state(batch)
    card = s2s_trainer("cuda")
    card.init_state(batch)
    card.load_params(cpu.state["params"])
    t0 = time.perf_counter()
    c_card, g_card = card.cost_and_grads(batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    c_cpu, g_cpu = cpu.cost_and_grads(batch)
    cpu_s = time.perf_counter() - t0
    c_card, c_cpu = float(c_card), float(c_cpu)
    grads = {}
    bad = []
    for k in sorted(g_cpu):
        a, w = g_card[k].cpu(), g_cpu[k]
        excess = float(((a - w).abs() - CPU_GRAD_TOL["rtol"] * w.abs()).max())
        grads[k] = dict(max_abs_err=float((a - w).abs().max()),
                        max_abs_grad=float(w.abs().max()), worst_excess=excess)
        if not torch.allclose(a, w, **CPU_GRAD_TOL):
            bad.append(k)
    rel = abs(c_card - c_cpu) / abs(c_cpu)
    out = dict(batch=CPU_BATCH, cost_card=c_card, cost_cpu=c_cpu, cost_rel_err=rel,
               n_grads=len(grads), grads=grads, card_s=card_s, cpu_s=cpu_s,
               src_lengths=batch["source_ids.lengths"].tolist(),
               trg_lengths=batch["target_ids.lengths"].tolist())
    print("train_vs_cpu", json.dumps(out), flush=True)
    if len(grads) != 22:
        fail(f"{len(grads)} gradients, want the model's 22 parameters")
    if not rel <= CPU_COST_RTOL:
        fail(f"step-1 cost card {c_card} vs CPU {c_cpu}: rel err {rel} > {CPU_COST_RTOL}")
    if bad:
        fail(f"gradients differ card vs CPU beyond {CPU_GRAD_TOL}: {bad}")
    return out


def lstm_trainer(device):
    """SGDTrainer + SGD(0.01) over the text classifier's graph built from
    the port's public layers with peephole-free LSTMs (the graph
    `models.text_lstm` builds, minus the peepholes, which would take the
    plain step loop)."""
    from paddle_tpu_torch.nn import costs as C
    from paddle_tpu_torch.nn import layers as L
    from paddle_tpu_torch.nn.graph import reset_name_scope
    from paddle_tpu_torch.nn.recurrent import simple_lstm
    from paddle_tpu_torch.nn.seq_layers import SeqPool
    from paddle_tpu_torch.optim import SGD
    from paddle_tpu_torch.trainer import SGDTrainer

    reset_name_scope()
    ids = L.Data("word_ids", shape=(LSTM["vocab"],), is_seq=True)
    label = L.Data("label", shape=())
    x = L.Embedding(ids, LSTM["embed"], vocab_size=LSTM["vocab"], name="emb")
    for i in range(LSTM["layers"]):
        x = simple_lstm(x, LSTM["hidden"], name=f"lstm{i}", use_peephole=False)
    pooled = SeqPool(x, "max", name="pool")
    logits = L.Fc(pooled, LSTM["classes"], act=None, name="logits")
    cost = C.ClassificationCost(logits, label, name="cost")
    return SGDTrainer(cost, SGD(learning_rate=0.01), seed=0, device=device)


def lstm_batch(np, seed, b, ragged):
    """A batch drawn as rnn_bench.py:31-36 draws it (full lengths), or with
    ragged lengths (first row full)."""
    rs = np.random.RandomState(seed)
    t, vocab = LSTM["seq_len"], LSTM["vocab"]
    batch = {
        "word_ids": rs.randint(0, vocab, (b, t)).astype(np.int32),
        "word_ids.lengths": np.full(b, t, np.int32),
        "label": rs.randint(0, 2, b),
    }
    if ragged:
        lens = rs.randint(1, t + 1, b).astype(np.int32)
        lens[0] = t
        batch["word_ids.lengths"] = lens
    return batch


def lstm_train_phase(torch):
    """The LSTM text classifier's training step at rnn_bench.py's widths and
    BASELINE's middle row on the card: SGD(0.01), the port's own init from
    seed 0, one rnn_bench batch, 2 warm-up + 10 timed steps. LSTM launch
    counts are set to 0 just before these steps and read just after."""
    import numpy as np

    from paddle_tpu_torch.ops import rnn_kernels as K

    t0 = time.perf_counter()
    trainer = lstm_trainer("cuda")
    batch = lstm_batch(np, 0, LSTM["batch"], ragged=False)
    trainer.init_state(batch)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trainer.state["params"].values())

    torch.cuda.reset_peak_memory_stats()
    K.LSTM_FWD_LAUNCHES = K.LSTM_BWD_LAUNCHES = 0
    costs, step_ms = [], []
    for _ in range(TRAIN_WARMUP + TRAIN_STEPS):
        t = time.perf_counter()
        costs.append(float(trainer.step(batch)))  # the fetch synchronises
        step_ms.append((time.perf_counter() - t) * 1e3)
    fwd, bwd = K.LSTM_FWD_LAUNCHES, K.LSTM_BWD_LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    steps = TRAIN_WARMUP + TRAIN_STEPS
    med = statistics.median(step_ms[TRAIN_WARMUP:])
    result = dict(
        config=dict(LSTM, optimizer="SGD(0.01)", precision="f32, TF32 off",
                    peepholes=False, params=n_params),
        setup_s=setup_s, steps=steps, costs=costs, step_ms=step_ms,
        step_ms_median=med, step_ms_min=min(step_ms[TRAIN_WARMUP:]),
        samples_per_s=LSTM["batch"] / (med / 1e3),
        tokens_per_s=LSTM["batch"] * LSTM["seq_len"] / (med / 1e3),
        peak_memory_bytes=peak, lstm_fwd_launches=fwd, lstm_bwd_launches=bwd,
    )
    print("lstm_train", json.dumps(result), flush=True)
    want = LSTM["layers"] * steps
    if fwd != want or bwd != want:
        fail(f"LSTM kernels launched fwd {fwd} / bwd {bwd} times in {steps} steps, "
             f"want {LSTM['layers']} + {LSTM['layers']} per step")
    if not all(np.isfinite(costs)):
        fail(f"non-finite LSTM training cost: {costs}")
    if not costs[-1] < costs[0]:
        fail(f"LSTM training cost did not fall: first {costs[0]}, last {costs[-1]}")
    result["profile"] = profile_train(torch, trainer, batch, tag="lstm")
    return result


def lstm_vs_cpu_phase(torch):
    """Step-1 cost and all gradients of the LSTM text classifier at the same
    widths, batch 8 with ragged lengths, on the card (kernels) and on the
    CPU (plain versions), from the same parameters."""
    import numpy as np

    batch = lstm_batch(np, 1, CPU_BATCH, ragged=True)
    cpu = lstm_trainer("cpu")
    cpu.init_state(batch)
    card = lstm_trainer("cuda")
    card.init_state(batch)
    card.load_params(cpu.state["params"])
    c_card, g_card = card.cost_and_grads(batch)
    c_cpu, g_cpu = cpu.cost_and_grads(batch)
    c_card, c_cpu = float(c_card), float(c_cpu)
    grads, bad = {}, []
    for k in sorted(g_cpu):
        a, w = g_card[k].cpu(), g_cpu[k]
        grads[k] = dict(max_abs_err=float((a - w).abs().max()),
                        max_abs_grad=float(w.abs().max()))
        if not torch.allclose(a, w, **CPU_GRAD_TOL):
            bad.append(k)
    rel = abs(c_card - c_cpu) / abs(c_cpu)
    n_want = 3 + 4 * LSTM["layers"]
    out = dict(batch=CPU_BATCH, cost_card=c_card, cost_cpu=c_cpu, cost_rel_err=rel,
               n_grads=len(grads), grads=grads,
               lengths=batch["word_ids.lengths"].tolist())
    print("lstm_vs_cpu", json.dumps(out), flush=True)
    if len(grads) != n_want:
        fail(f"{len(grads)} LSTM-model gradients, want its {n_want} parameters")
    if not rel <= CPU_COST_RTOL:
        fail(f"LSTM step-1 cost card {c_card} vs CPU {c_cpu}: rel err {rel} > "
             f"{CPU_COST_RTOL}")
    if bad:
        fail(f"LSTM-model gradients differ card vs CPU beyond {CPU_GRAD_TOL}: {bad}")
    return out


def resnet_batches(np, size, b, k, classes):
    """One batch and K stacked ones, drawn as bench.py:706-710 and :764-775
    draw them (one RandomState(0): randn images, randint labels)."""
    rs = np.random.RandomState(0)
    batch = {"image": rs.randn(b, size, size, 3).astype(np.float32),
             "label": rs.randint(0, classes, b)}
    stacked = {"image": rs.randn(k, b, size, size, 3).astype(np.float32),
               "label": rs.randint(0, classes, (k, b))}
    return batch, stacked


def resnet_trainer(device, precision, size, classes, lr=0.1):
    from paddle_tpu_torch.models import resnet50
    from paddle_tpu_torch.nn.graph import reset_name_scope
    from paddle_tpu_torch.optim import SGD
    from paddle_tpu_torch.trainer import SGDTrainer

    reset_name_scope()
    cost = resnet50(num_classes=classes, image_size=size)[3]
    return SGDTrainer(cost, SGD(learning_rate=lr, momentum=0.9), seed=0, device=device,
                      precision=precision)


# kernel-name fragments of each group in the ResNet-50 profile
_GROUPS = (
    ("conv", ("conv", "xmma", "cudnn", "implicit", "dgrad", "wgrad", "fprop",
              "sm90_", "sm80_", "cutlass", "gemm")),
    ("layout_transpose", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("pool", ("pool",)),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def kernel_group(name: str) -> str:
    low = name.lower()
    for group, keys in _GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def resnet_phase(torch):
    """ResNet-50 training as bench.py's run_bench drives the reference:
    224x224, batch 256, 1000 classes, bf16, SGD(0.1, momentum 0.9), 8
    stacked batches a `multi_step` call; 1 warm-up and 2 timed calls, each
    ending in the fetch of its 8 costs. Then torch.profiler over one call."""
    import numpy as np

    cfg = RESNET
    k = cfg["scan_k"]
    t0 = time.perf_counter()
    batch, stacked = resnet_batches(np, cfg["image_size"], cfg["batch"], k, cfg["classes"])
    draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer = resnet_trainer("cuda", "bf16", cfg["image_size"], cfg["classes"])
    trainer.init_state(batch)
    stacked = {key: torch.as_tensor(v).to("cuda") for key, v in stacked.items()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trainer.state["params"].values())

    torch.cuda.reset_peak_memory_stats()
    costs, dispatch_ms = [], []
    for _ in range(cfg["warmup"] + cfg["dispatches"]):
        t = time.perf_counter()
        costs.extend(trainer.multi_step(stacked).tolist())  # the fetch synchronises
        dispatch_ms.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    timed = dispatch_ms[cfg["warmup"]:]
    ms_per_step = statistics.median(timed) / k
    images_per_s = cfg["batch"] / (ms_per_step / 1e3)
    name = torch.cuda.get_device_name(0)
    peak_flops = bf16_peak(name)
    flops_per_image = RESNET_FLOPS_PER_IMAGE * (cfg["image_size"] / 224.0) ** 2
    states = trainer.state["states"]
    unmoved = [key for key, v in states.items()
               if bool((v == (0.0 if key.endswith("moving_mean") else 1.0)).all())]
    result = dict(
        metric="resnet50_images_per_sec_per_chip",
        resnet50_images_per_sec_per_chip=images_per_s,
        ms_per_step=ms_per_step,
        mfu=images_per_s * flops_per_image / peak_flops,
        peak_tflops_bf16=peak_flops / 1e12,
        platform="gpu", device_kind=name, precision=trainer.precision,
        batch_size=cfg["batch"], image_size=cfg["image_size"], scan_k=k,
        classes=cfg["classes"], optimizer="SGD(0.1, momentum 0.9)", params=n_params,
        n_params=len(trainer.state["params"]), n_states=len(states),
        draw_s=draw_s, setup_s=setup_s, dispatch_ms=dispatch_ms,
        ms_per_step_min=min(timed) / k, costs=costs, peak_memory_bytes=peak,
        states_unmoved=unmoved,
    )
    print("resnet", json.dumps(result), flush=True)
    if not all(np.isfinite(costs)):
        fail(f"non-finite ResNet-50 training cost: {costs}")
    if unmoved:
        fail(f"batch-norm moving statistics never moved from their start: {unmoved[:5]}")
    result["profile"] = profile_resnet(torch, trainer, stacked)
    return result


def profile_resnet(torch, trainer, stacked):
    """Where a ResNet-50 step's time goes: torch.profiler over one
    `multi_step` call. Device busy = summed kernel time over the window's
    wall time; kernels grouped by name (`kernel_group`). Fails if layout
    transposes run once a conv or more: cuDNN is to read the NHWC
    activations as channels_last, not copy them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    k = next(iter(stacked.values())).shape[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        trainer.multi_step(stacked)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            ms, n = kernels.get(e.key, (0.0, 0))
            kernels[e.key] = (ms + e.self_device_time_total / 1e3, n + e.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    groups = {}
    for key, (ms, n) in kernels.items():
        g = groups.setdefault(kernel_group(key), [0.0, 0])
        g[0] += ms / k
        g[1] += n / k
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    n_convs = sum(1 for l in trainer.network.layer_order if l.type_name == "conv")
    transposes = groups.get("layout_transpose", [0.0, 0])[1]
    out = {
        "steps": k, "wall_ms_per_step": wall_ms / k,
        "device_busy_ms_per_step": busy_ms / k,
        "device_busy_share": busy_ms / wall_ms,
        "kernel_launches_per_step": sum(c for _, c in kernels.values()) / k,
        "groups_ms_and_launches_per_step": groups,
        "layout_transposes_per_step": transposes, "convs": n_convs,
        "top_kernels_ms_per_step": [[key[:90], ms / k, c / k] for key, (ms, c) in top],
    }
    print("resnet_profile", json.dumps(out), flush=True)
    if busy_ms <= 0:
        fail("torch.profiler recorded no device time in the ResNet-50 steps")
    if transposes >= n_convs:
        fail(f"{transposes} layout-transpose kernels a step for {n_convs} convs: the "
             f"convs copy their activations")
    return out


def rel_l2(torch, got, want) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def resnet_vs_cpu_phase(torch):
    """ResNet-50 at 64x64, batch 4, 10 classes from the same parameters on
    the card and on the CPU. f32 (TF32 off): the step-1 cost, all 161
    gradients and all 106 new states. bf16: every layer fed the CPU's
    input to it, and the whole step's cost finite (printed beside the
    CPU's, not held: the whole graph's bf16 cost is not reproducible across
    rounding orders at this size)."""
    import numpy as np

    from paddle_tpu_torch.core import dtypes
    from paddle_tpu_torch.nn import graph as G

    cfg = RESNET_CPU
    batch, _ = resnet_batches(np, cfg["image_size"], cfg["batch"], 1, cfg["classes"])
    out = {}
    for precision in ("f32", "bf16"):
        cpu = resnet_trainer("cpu", precision, cfg["image_size"], cfg["classes"])
        cpu.init_state(batch)
        card = resnet_trainer("cuda", precision, cfg["image_size"], cfg["classes"])
        card.init_state(batch)
        card.load_params(cpu.state["params"])
        c_card, g_card, s_card = card.cost_grads_and_states(batch)
        c_cpu, g_cpu, s_cpu = cpu.cost_grads_and_states(batch)
        c_card, c_cpu = float(c_card), float(c_cpu)
        row = dict(cost_card=c_card, cost_cpu=c_cpu,
                   cost_rel_err=abs(c_card - c_cpu) / abs(c_cpu),
                   n_grads=len(g_card), n_states=len(s_card))
        if precision == "f32":
            grads = {key: rel_l2(torch, g_card[key], g) for key, g in g_cpu.items()}
            names = sorted(g_cpu)
            row["grads_all_rel_l2"] = rel_l2(
                torch, torch.cat([g_card[key].flatten().cpu() for key in names]),
                torch.cat([g_cpu[key].flatten() for key in names]))
            row["grad_rel_l2_max"] = max(grads.values())
            row["grad_rel_l2_median"] = statistics.median(grads.values())
            row["state_err_max"] = max(
                float((s_card[key].cpu() - v).abs().max() / v.abs().max())
                for key, v in s_cpu.items())
        else:
            every = G.Network([l for l in cpu.network.layer_order if l.type_name != "data"])
            values, _ = every.apply(cpu.state["params"], batch, cpu.state["states"],
                                    train=True, policy=dtypes.bf16_policy())
            ctx = G.Context("apply", card.state["params"], device=torch.device("cuda"),
                            states=card.state["states"], train=True,
                            policy=dtypes.bf16_policy())
            errs = {}
            for layer in every.outputs:
                ins = [G.Argument(torch.as_tensor(batch[i.name]).to("cuda"))
                       if i.type_name == "data" else
                       G.Argument(values[i.name].value.detach().to("cuda"))
                       for i in layer.inputs]
                errs[layer.name] = rel_l2(torch, layer.forward(ctx, ins).value,
                                          values[layer.name].value)
            row["layers"] = len(errs)
            row["layer_rel_l2_max"] = max(errs.values())
            row["layer_rel_l2_median"] = statistics.median(errs.values())
            row["layers_above_tight"] = sorted(
                key for key, e in errs.items() if e > RESNET_BF16_LAYER_TIGHT)
        out[precision] = row
    print("resnet_vs_cpu", json.dumps(out), flush=True)
    f32, bf16 = out["f32"], out["bf16"]
    if f32["n_grads"] != 161 or f32["n_states"] != 106:
        fail(f"{f32['n_grads']} gradients / {f32['n_states']} states, want 161 / 106")
    if not f32["cost_rel_err"] <= RESNET_COST_RTOL:
        fail(f"ResNet-50 f32 cost card vs CPU: rel err {f32['cost_rel_err']}")
    if not (f32["grad_rel_l2_max"] <= RESNET_GRAD_REL_L2
            and f32["grads_all_rel_l2"] <= RESNET_ALL_GRADS_REL_L2):
        fail(f"ResNet-50 f32 gradients card vs CPU: {f32['grad_rel_l2_max']} / "
             f"{f32['grads_all_rel_l2']}")
    if not f32["state_err_max"] <= RESNET_STATE_RTOL:
        fail(f"ResNet-50 f32 states card vs CPU: {f32['state_err_max']}")
    if not np.isfinite(bf16["cost_card"]):
        fail(f"ResNet-50 bf16 cost on the card is {bf16['cost_card']}")
    if not (bf16["layer_rel_l2_max"] <= RESNET_BF16_LAYER_REL_L2
            and len(bf16["layers_above_tight"]) <= RESNET_BF16_RELU_FLIPS):
        fail(f"ResNet-50 bf16 layers card vs CPU: max {bf16['layer_rel_l2_max']}, "
             f"above {RESNET_BF16_LAYER_TIGHT}: {bf16['layers_above_tight']}")
    return out


def lenet_phase(torch):
    """LeNet (BASELINE config #1) at 28x28, batch 8, f32 with TF32 off, on
    the card and on the CPU from the same parameters: the step-1 cost
    (1e-5 relative), every gradient (rtol 1e-3, atol 1e-4 x max(1,
    max|g|)), and the parameters after two SGD(0.05, momentum 0.9) steps
    (atol 1e-5)."""
    import numpy as np

    from paddle_tpu_torch.models import lenet
    from paddle_tpu_torch.nn.graph import reset_name_scope
    from paddle_tpu_torch.optim import SGD
    from paddle_tpu_torch.trainer import SGDTrainer

    batches = []
    for seed in (0, 1):
        rs = np.random.RandomState(seed)
        batches.append({"pixel": rs.randn(LENET_BATCH, 28, 28, 1).astype(np.float32),
                        "label": rs.randint(0, 10, LENET_BATCH)})
    trainers = {}
    for dev in ("cpu", "cuda"):
        reset_name_scope()
        trainers[dev] = SGDTrainer(lenet()[3], SGD(learning_rate=0.05, momentum=0.9),
                                   seed=0, device=dev)
        trainers[dev].init_state(batches[0])
    cpu, card = trainers["cpu"], trainers["cuda"]
    card.load_params(cpu.state["params"])
    c_card, g_card = card.cost_and_grads(batches[0])
    c_cpu, g_cpu = cpu.cost_and_grads(batches[0])
    bad = [key for key, g in g_cpu.items() if not torch.allclose(
        g_card[key].cpu(), g, rtol=1e-3, atol=1e-4 * max(1.0, float(g.abs().max())))]
    grads = {key: dict(max_abs_err=float((g_card[key].cpu() - g).abs().max()),
                       max_abs_grad=float(g.abs().max()),
                       rel_l2=rel_l2(torch, g_card[key], g)) for key, g in g_cpu.items()}
    for b in batches:
        card.step(b)
        cpu.step(b)
    param_err = max(float((card.state["params"][key].cpu() - v).abs().max())
                    for key, v in cpu.state["params"].items())
    rel = abs(float(c_card) - float(c_cpu)) / abs(float(c_cpu))
    out = dict(batch=LENET_BATCH, cost_card=float(c_card), cost_cpu=float(c_cpu),
               cost_rel_err=rel, n_grads=len(g_cpu), grads_outside_tol=bad, grads=grads,
               params_max_abs_err_after_2_steps=param_err)
    print("lenet", json.dumps(out), flush=True)
    if not rel <= CPU_COST_RTOL:
        fail(f"LeNet cost card vs CPU: rel err {rel}")
    if bad:
        fail(f"LeNet gradients differ card vs CPU: {bad}")
    if not param_err <= 1e-5:
        fail(f"LeNet parameters after two steps differ card vs CPU by {param_err}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from paddle_tpu_torch.ops import build

    # 1. card
    smi = nvidia_smi_line()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    bw, f32_flops, tf32_flops = peaks(name)
    print(json.dumps({
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0], "device": name,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "peak_bytes_per_s": bw, "peak_f32_flops": f32_flops,
        "peak_tf32_flops": tf32_flops,
    }), flush=True)

    # 2. build
    t0 = time.perf_counter()
    libs = build.build()
    build_s = time.perf_counter() - t0
    print(json.dumps({"build_s": build_s, "libraries": {
        k: os.path.relpath(v, REPO) for k, v in libs.items()}}), flush=True)
    for k in libs:
        for line in build.build_log(k).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{k}] {line.strip()}", flush=True)

    # 3. kernels vs plain versions
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    rows = kernel_phase(torch, flush, bw, f32_flops)
    gru_rows = gru_kernel_phase(torch, flush, bw, f32_flops)
    lstm_rows = lstm_kernel_phase(torch, flush, bw, f32_flops)
    attn_rows = attn_kernel_phase(torch, flush, bw, f32_flops, tf32_flops)
    del flush
    torch.cuda.empty_cache()

    # 4. the serving engine end to end (launches counted from 0 here), the
    # decode graph against the eager step, then 4b-4d: the server and its
    # wire, speculation, recovery
    serve = serve_phase(torch)
    small_tokens_phase(torch)
    wire = wire_phase(torch, serve)
    speculation = speculation_phase(torch)
    recovery = recovery_phase(torch, serve)

    # 5. seq2seq training at the reference's widths (GRU launches from 0)
    torch.cuda.empty_cache()
    train = train_phase(torch)
    # 6. the training step's cost and gradients, card vs CPU
    train_vs_cpu = train_vs_cpu_phase(torch)

    # 7. LSTM text classification training (LSTM launches from 0), then its
    # cost and gradients card vs CPU
    torch.cuda.empty_cache()
    lstm_train = lstm_train_phase(torch)
    lstm_vs_cpu = lstm_vs_cpu_phase(torch)
    # 8. dot_product_attention, the fused op's own path (launches from 0)
    attn_path = attn_path_phase(torch)
    # 9. the plain routes where the kernels have no layout or no fit
    route = route_phase(torch)

    # 10. ResNet-50 training at bench.py's headline shape (bf16, 8 steps a
    # call), 11. its cost, gradients and states card vs CPU, 12. LeNet
    torch.cuda.empty_cache()
    resnet = resnet_phase(torch)
    torch.cuda.empty_cache()
    resnet_vs_cpu = resnet_vs_cpu_phase(torch)
    lenet = lenet_phase(torch)

    # 13. lines
    from paddle_tpu_torch.ops import paged_attention as pa

    main_row = next(r for r in rows if r["shape"] == "gpt2_small_s8")
    kernels = [{
        "name": "paged_attention_decode",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/paged_attention.py:108",
        "launches": serve["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["kernel_ms"],
        "kernel_ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "graph_ms": main_row["graph_ms"],
        "achieved_tb_s": main_row["achieved_tb_s"],
        "plan": pa.split_plan(
            *(main_row[k] for k in ("S", "H", "hd", "PS", "P")),
            torch.cuda.get_device_properties(0).multi_processor_count)._asdict(),
        "shape": main_row["shape"],
        "shapes": rows,
    }]
    g_main = next(r for r in gru_rows if r["shape"] == "s2s_encoder")
    no_library = ("none: no single PyTorch call computes this GRU (torch.nn.GRU "
                  "applies the reset gate after the recurrent product and takes "
                  "no step mask)")
    for leg, replaces, launches, errs in (
        ("fwd", "paddle_tpu/ops/pallas/rnn_kernels.py:378", train["gru_fwd_launches"],
         [e[k] for r in gru_rows for d in ("fwd", "rev")
          for e in [r[f"fwd_err_{d}"]] for k in e]),
        ("bwd", "paddle_tpu/ops/pallas/rnn_kernels.py:391", train["gru_bwd_launches"],
         [v["max_abs_err"] for r in gru_rows for d in ("fwd", "rev")
          for v in r[f"bwd_err_{d}"].values()]),
    ):
        kernels.append({
            "name": f"gru_seq_fused_{leg}",
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/gru_seq.cu",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(errs),
            "ms": g_main[f"{leg}_kernel_ms"],
            "kernel_ms": g_main[f"{leg}_kernel_ms"],
            "plain_ms": g_main[f"{leg}_plain_ms"],
            "bound_ms": g_main[f"{leg}_bound_ms"],
            "bound_by": g_main[f"{leg}_bound_by"],
            "library_ms": None,
            "library_note": no_library,
            **({"bwd_parts_ms": g_main["bwd_parts_ms"],
                "note_cublas_dw_ms": g_main["note_cublas_dw_ms"]} if leg == "bwd" else
               {"us_per_step": g_main["fwd_us_per_step"],
                "sync_us_per_step": g_main["fwd_sync_us_per_step"],
                "bound_ms_all_rows": g_main["fwd_all_rows_bound_ms"],
                "bound_ms_valid_steps": g_main["fwd_valid_steps_bound_ms"]}),
            "plan": g_main["plan"],
            "shape": g_main["shape"],
            "shapes": gru_rows,
        })
    l_main = next(r for r in lstm_rows if r["shape"] == "text_cls")
    no_lstm_library = ("none: no single PyTorch call computes this LSTM (torch.nn.LSTM "
                       "has an input projection of its own, two biases and no step "
                       "mask)")
    for leg, replaces, launches, errs in (
        ("fwd", "paddle_tpu/ops/pallas/rnn_kernels.py:175",
         lstm_train["lstm_fwd_launches"],
         [e[k] for r in lstm_rows for d in ("fwd", "rev")
          for e in [r[f"fwd_err_{d}"]] for k in e]),
        ("bwd", "paddle_tpu/ops/pallas/rnn_kernels.py:191",
         lstm_train["lstm_bwd_launches"],
         [v["max_abs_err"] for r in lstm_rows for d in ("fwd", "rev")
          for v in r[f"bwd_err_{d}"].values()]),
    ):
        kernels.append({
            "name": f"lstm_seq_fused_{leg}",
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/lstm_seq.cu",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(errs),
            "ms": l_main[f"{leg}_kernel_ms"],
            "kernel_ms": l_main[f"{leg}_kernel_ms"],
            "plain_ms": l_main[f"{leg}_plain_ms"],
            "bound_ms": l_main[f"{leg}_bound_ms"],
            "bound_by": l_main[f"{leg}_bound_by"],
            "library_ms": None,
            "library_note": no_lstm_library,
            **({"bwd_parts_ms": l_main["bwd_parts_ms"],
                "note_cublas_dw_ms": l_main["note_cublas_dw_ms"]} if leg == "bwd" else
               {"us_per_step": l_main["fwd_us_per_step"],
                "sync_us_per_step": l_main["fwd_sync_us_per_step"],
                "bound_ms_all_rows": l_main["fwd_all_rows_bound_ms"],
                "bound_ms_valid_steps": l_main["fwd_valid_steps_bound_ms"]}),
            "plan": l_main["plan"],
            "shape": l_main["shape"],
            "shapes": lstm_rows,
        })
    a_main = next(r for r in attn_rows if r["shape"] == "b32_t512")
    kernels.append({
        "name": "attention_seq_fused",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/attention_seq.cu",
        "replaces": "paddle_tpu/ops/pallas/rnn_kernels.py:534",
        "launches": attn_path["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in attn_rows),
        "ms": a_main["kernel_ms"],
        "kernel_ms": a_main["kernel_ms"],
        "plain_ms": a_main["plain_ms"],
        "bound_ms": a_main["bound_ms"],
        "bound_by": a_main["bound_by"],
        "library_ms": a_main["library_ms"],
        "library_note": "F.scaled_dot_product_attention with the additive mask",
        "tensor_core": "3xTF32",
        "bound_ms_f32_simt": a_main["bound_ms_f32_simt"],
        "shape": a_main["shape"],
        "shapes": attn_rows,
    })
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "chip_smoke.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "build_s": build_s, "kernels": kernels,
                   "serve": serve, "wire": wire, "speculation": speculation,
                   "recovery": recovery, "train": train, "train_vs_cpu": train_vs_cpu,
                   "lstm_train": lstm_train, "lstm_vs_cpu": lstm_vs_cpu,
                   "attn_path": attn_path, "route": route, "resnet": resnet,
                   "resnet_vs_cpu": resnet_vs_cpu, "lenet": lenet},
                  f, indent=1)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
