#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paddle_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases (any failure exits non-zero and prints no result line):
  1. card    — nvidia-smi name + power limit; TF32 off for matmul and cuDNN.
  2. build   — nvcc builds every CUDA source of the port from this checkout.
  3. kernels — each kernel's wrapper on card tensors vs its plain PyTorch
               version on the same tensors (max_abs_err <= 1e-4), at a small
               odd shape and at GPT-2-small decode shapes; kernel, plain
               version and one PyTorch library call timed with CUDA events
               (L2 flushed before each launch), beside the least time the
               card could take (bytes or f32 operations over its peaks).
  4. serve   — the serving engine at GPT-2 small's widths (12 layers,
               d_model 768, 12 heads, vocab 50257, max_len 1024; random
               weights from seed 0) answers 8 greedy requests of mixed prompt
               length, one chunked past the largest bucket. Checks: every
               request finished, no page leaked, one decode signature, the
               decode kernel launched n_layers times per decode step, and the
               first decode step's logits agree with the CPU plain path at
               the same weights and pool (atol 1e-3). Then torch.profiler
               over 16 decode-only steps: device busy time and share,
               launches and the top kernels per step. A small model's greedy
               tokens on the card must equal its tokens on the CPU.
  5. lines   — nvidia-smi line, {"kernels": [...]}, then the last line
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

# H100/H200 data-sheet peaks (SXM parts unless named): memory bytes/s and
# f32 FLOP/s outside the tensor cores
_PEAKS = (
    ("H200", 4.8e12, 67e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100", 3.35e12, 67e12),
)

GPT2_SMALL = dict(vocab=50257, n_layers=12, d_model=768, n_heads=12)
PROMPT_LENS = (16, 40, 100, 128, 200, 350, 500, 700)
NEW_TOKENS = 32
KERNEL_TOL = 1e-4
LOGITS_TOL = 1e-3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def peaks(name: str):
    for key, bw, flops in _PEAKS:
        if key in name:
            return bw, flops
    fail(f"no data-sheet peaks for {name!r}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, iters: int = 30) -> float:
    """Mean device ms per call: CUDA events around each call, with L2
    flushed (a 64 MiB write) before it, as a decode step that has read the
    other layers' pages in between finds it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def paged_inputs(torch, seed, s, h, hd, ps, pmax, max_pos, dump_slot):
    """Random ragged decode inputs on the card: shuffled physical pages,
    partly filled last pages, unused table entries on dump page 0, and
    (when `dump_slot`) a last slot at position 0 with an all-dump row."""
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
        p = int(torch.randint(0, max_pos + 1, (1,), generator=g))
        n = p // ps + 1
        bt[i, :n] = torch.tensor([free.pop() for _ in range(n)], dtype=torch.int32)
        pos[i] = p
    return [t.cuda() for t in (q, kp, vp, bt, pos)]


def kernel_phase(torch, flush, bw, f32_flops):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import paged_attention as pa

    shapes = (
        # name, seed, S, H, hd, PS, P, max position, dump slot
        ("small_odd", 0, 5, 2, 8, 4, 7, 27, True),
        ("gpt2_small_s8", 1, 8, 12, 64, 16, 64, 1023, False),
        ("gpt2_small_s32", 2, 32, 12, 64, 16, 64, 1023, False),
    )
    rows = []
    for name, seed, s, h, hd, ps, pmax, max_pos, dump in shapes:
        q, kp, vp, bt, pos = paged_inputs(torch, seed, s, h, hd, ps, pmax,
                                          max_pos, dump)
        scale = 1.0 / hd ** 0.5
        kw = dict(scale=scale, n_heads=h)
        got = pa.paged_attention_decode(q, kp, vp, bt, pos, **kw)
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
            kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=nbytes, operations=ops,
        )
        print("kernel", json.dumps(row), flush=True)
        if not err <= KERNEL_TOL:
            fail(f"paged_attention_decode vs plain at {name}: max_abs_err "
                 f"{err} > {KERNEL_TOL}")
        rows.append(row)
    return rows


def serve_phase(torch):
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import make_demo_session
    from paddle_tpu_torch.serving.model import ServableLM

    t0 = time.perf_counter()
    sess = make_demo_session(
        **GPT2_SMALL, max_len=1024, max_slots=8, page_size=16,
        prefill_buckets=(64, 128, 256, 512), max_new_limit=64,
        prefill_chunk=128, seed=0, device="cuda",
    )
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    model = sess.model
    rng = torch.Generator().manual_seed(1)
    prompts = [
        [model.cfg.bos_id]
        + torch.randint(3, model.cfg.vocab, (n - 1,), generator=rng).tolist()
        for n in PROMPT_LENS
    ]

    # the first decode step's inputs and logits, for the CPU reference
    first = {}
    orig_logits = model.decode_logits

    def spy(k_pages, v_pages, *args):
        if first:
            return orig_logits(k_pages, v_pages, *args)
        # copies: the step and the later ones update the pools in place
        first["pools"] = tuple(t.to("cpu", copy=True) for t in (k_pages, v_pages))
        first["args"] = [a.to("cpu", copy=True) for a in args]
        out = orig_logits(k_pages, v_pages, *args)
        first["logits"] = out.to("cpu", copy=True)
        return out

    model.decode_logits = spy
    step_ms = []
    orig_decode = sess._decode_once

    def timed_decode():
        before = sess.decode_steps
        t = time.perf_counter()
        orig_decode()  # ends in the step's token fetch: synchronised
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
    del model.decode_logits
    del sess._decode_once

    n_tok = sum(len(h.tokens) for h in handles)
    st = sess.stats()
    result = dict(
        config=dict(GPT2_SMALL, max_len=1024, max_slots=8, page_size=16,
                    prefill_buckets=[64, 128, 256, 512], prefill_chunk=128,
                    prompt_lens=list(PROMPT_LENS), new_tokens=NEW_TOKENS),
        setup_s=setup_s, wall_s=wall_s, tokens=n_tok,
        tokens_per_s=n_tok / wall_s,
        decode_steps=sess.decode_steps,
        decode_step_ms_median=statistics.median(step_ms),
        decode_step_ms_min=min(step_ms),
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

    # the first decode step again on the CPU: plain paged attention, same
    # weights, same pool and inputs
    cpu_model = ServableLM(model.cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    kp, vp = first["pools"]
    ref = cpu_model.decode_logits(kp, vp, *first["args"])
    err = float((ref - first["logits"]).abs().max())
    result["first_step_logits_max_abs_err_vs_cpu"] = err
    print("serve", json.dumps(result), flush=True)
    if not err <= LOGITS_TOL:
        fail(f"first decode step logits differ from the CPU path by {err}")
    result["decode_profile"] = profile_decode(torch, sess, prompts)
    return result


def profile_decode(torch, sess, prompts, steps: int = 16):
    """Where a steady decode step's time goes: torch.profiler over `steps`
    decode-only engine steps of 8 slots (admission and prefill run before
    the window). Device busy = summed kernel time over the window's wall
    time; the rest is the card idle while the host launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    hs = [sess.submit(p[:16], steps + 2) for p in prompts]
    sess.step()  # admit + prefill + first decode, outside the window
    before = sess.decode_steps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            sess.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n = sess.decode_steps - before
    sess.run_until_idle()
    if not all(h.done for h in hs) or sess.cache.pages_in_use:
        fail("profiled requests did not finish cleanly")
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels[e.key] = (kernels.get(e.key, (0.0, 0))[0]
                              + e.self_device_time_total / 1e3,
                              kernels.get(e.key, (0.0, 0))[1] + e.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    out = dict(
        decode_steps=n, wall_ms_per_step=wall_ms / n,
        device_busy_ms_per_step=busy_ms / n,
        device_busy_share=busy_ms / wall_ms,
        kernel_launches_per_step=sum(c for _, c in kernels.values()) / n,
        paged_attention_ms_per_step=sum(
            ms for k, (ms, _) in kernels.items() if "paged_decode" in k) / n,
        top_kernels_ms_per_step=[[k[:80], ms / n, c / n] for k, (ms, c) in top],
    )
    print("profile", json.dumps(out), flush=True)
    if busy_ms <= 0:
        fail("torch.profiler recorded no device time")
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
    bw, f32_flops = peaks(name)
    print(json.dumps({
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0], "device": name,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "peak_bytes_per_s": bw, "peak_f32_flops": f32_flops,
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
    del flush

    # 4. the serving engine end to end (launches counted from 0 here)
    serve = serve_phase(torch)
    small_tokens_phase(torch)

    # 5. lines
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
        "shape": main_row["shape"],
        "shapes": rows,
    }]
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "chip_smoke.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "build_s": build_s, "kernels": kernels,
                   "serve": serve}, f, indent=1)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
