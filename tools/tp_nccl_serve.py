"""Tensor-parallel serving over NCCL on two cards: `serve --tp 2` (two rank
processes, cuda:0 and cuda:1, the decode step captured with its
collectives) against `serve --tp 0` on one card, GPT-2-small widths with
vocab 50 304; greedy and one seeded sampled request, ms a decoded token."""
import json, os, signal, subprocess, sys, time
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from paddle_tpu_torch.serving import ServingClient

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip(), flush=True)
ARGS = ["serve", "--demo", "--device", "cuda", "--vocab", "50304", "--n_layers", "12",
        "--d_model", "768", "--n_heads", "12", "--max_len", "1024", "--max_slots", "8",
        "--page_size", "16", "--prefill_buckets", "64,128,256,512", "--max_new_limit", "64",
        "--prefill_chunk", "128"]
import numpy as np
rs = np.random.RandomState(1)
prompts = [[1] + [int(t) for t in rs.randint(3, 50304, n - 1)] for n in (16, 40, 100, 128, 200, 350, 500, 700)]
out = {}
for tp in ("0", "2"):
    t0 = time.time()
    proc = subprocess.Popen([sys.executable, "-m", "paddle_tpu_torch", *ARGS, "--tp", tp],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
    try:
        line = proc.stdout.readline()
        if not line:
            print("no address line", proc.stderr.read()[-3000:], flush=True)
            continue
        host, port = json.loads(line)["address"]
        c = ServingClient((host, int(port)))
        ready = time.time() - t0
        c.generate(prompts[0], max_new_tokens=4, timeout_s=120.0)  # warm: build + capture
        import threading
        res = [None] * len(prompts)
        t1 = time.time()
        def one(i):
            cc = ServingClient((host, int(port)))
            res[i] = cc.generate(prompts[i], max_new_tokens=32, timeout_s=300.0)["tokens"]
            cc.close()
        ths = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
        [t.start() for t in ths]; [t.join() for t in ths]
        wall = time.time() - t1
        sampled = c.generate(prompts[0], max_new_tokens=32, timeout_s=120.0, temperature=0.8,
                             top_k=40, seed=2 ** 31 + 7)["tokens"]
        st = c.stats()
        c.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            so, se = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill(); so, se = proc.communicate()
    final = so.strip().splitlines()[-1] if so.strip() else ""
    out[tp] = dict(tokens=res, sampled=sampled, wall_s=wall, ready_s=ready,
                   ms_per_token=wall * 1e3 / sum(len(r) for r in res),
                   stats={k: st.get(k) for k in ("tp", "decode_graph", "decode_graph_captures",
                                                  "decode_steps", "param_bytes_per_chip",
                                                  "pool_bytes_per_chip")},
                   rc=proc.returncode, final=final[:400], err=se[-1500:] if proc.returncode else "")
    print(tp, json.dumps({k: v for k, v in out[tp].items() if k not in ("tokens", "sampled")}), flush=True)
if "0" in out and "2" in out:
    print(json.dumps({"tokens_equal": out["0"]["tokens"] == out["2"]["tokens"],
                      "sampled_equal": out["0"]["sampled"] == out["2"]["sampled"]}), flush=True)
