"""Which collectives a gloo group takes on CUDA tensors: two rank threads on
cuda:0 over one gloo group, each op in a subprocess of its own (a refused op
can abort the process), then the time of an all-reduce of [8, 768] f32 and
an all-gather of [8, 25 152] (tensor-parallel serving's decode-step shapes
at GPT-2-small widths).

    python3 tools/probe_gloo_cuda.py"""
import datetime, json, threading, time, traceback, sys
import torch, torch.distributed as dist
from torch.distributed import HashStore, PrefixStore

ONLY = sys.argv[1] if len(sys.argv) > 1 else None
if ONLY is None:
    import subprocess
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    for op in ["allreduce", "_allgather_base", "allgather", "alltoall_base",
               "_reduce_scatter_base", "broadcast_cuda", "broadcast_cpu", "send_recv", "timing"]:
        p = subprocess.run([sys.executable, __file__, op], capture_output=True, text=True, timeout=90)
        print(op, "rc", p.returncode, p.stdout.strip()[-600:], p.stderr.strip()[-300:], flush=True)
    sys.exit(0)
store = HashStore()
res = {}

def group(r):
    o = dist.ProcessGroupGloo._Options()
    o._timeout = datetime.timedelta(seconds=30)
    o._devices = [dist.ProcessGroupGloo.create_device(hostname="127.0.0.1")]
    return dist.ProcessGroupGloo(PrefixStore("p", store), r, 2, o)

def main(r):
    torch.cuda.set_device(0)
    g = group(r)
    dev = torch.device("cuda", 0)
    out = {}
    def tryit(name, fn):
        try:
            v = fn()
            out[name] = "ok " + str(v)
        except Exception as e:
            out[name] = "ERR " + type(e).__name__ + ": " + str(e).splitlines()[0][:300]
    def ar():
        t = torch.full((4,), float(r + 1), device=dev); g.allreduce([t]).wait(); return t.tolist()
    def agb():
        t = torch.full((1, 3), float(r), device=dev); o = torch.empty(2, 3, device=dev)
        g._allgather_base(o, t).wait(); return o.tolist()
    def agl():
        t = torch.full((3,), float(r), device=dev); o = [torch.empty(3, device=dev) for _ in range(2)]
        g.allgather([o], [t]).wait(); return [x.tolist() for x in o]
    def a2a():
        t = torch.arange(4, device=dev, dtype=torch.float32) + 10 * r; o = torch.empty_like(t)
        g.alltoall_base(o, t, [], []).wait(); return o.tolist()
    def rsb():
        t = torch.full((2, 3), float(r + 1), device=dev); o = torch.empty(1, 3, device=dev)
        g._reduce_scatter_base(o, t).wait(); return o.tolist()
    def bc():
        t = torch.full((3,), float(r), device=dev); g.broadcast([t]).wait(); return t.tolist()
    def bc_cpu():
        t = torch.full((3,), float(r)); g.broadcast([t]).wait(); return t.tolist()
    def sr():
        t = torch.full((3,), float(r), device=dev)
        if r == 0:
            g.send([t], 1, 0).wait(); return "sent"
        o = torch.empty(3, device=dev); g.recv([o], 0, 0).wait(); return o.tolist()
    ops = {"allreduce": ar, "_allgather_base": agb, "allgather": agl,
           "alltoall_base": a2a, "_reduce_scatter_base": rsb,
           "broadcast_cuda": bc, "broadcast_cpu": bc_cpu, "send_recv": sr}
    if ONLY != "timing":
        tryit(ONLY, ops[ONLY])
        res[r] = out
        return
    # timings: allreduce of [8, 768] f32 on CUDA, 200 times
    t = torch.zeros(8, 768, device=dev)
    for _ in range(10): g.allreduce([t]).wait()
    torch.cuda.synchronize(); t0 = time.perf_counter()
    for _ in range(200): g.allreduce([t]).wait()
    torch.cuda.synchronize(); out["allreduce_8x768_ms"] = (time.perf_counter() - t0) / 200 * 1e3
    t = torch.zeros(1, 8 * 25152, device=dev); o = torch.empty(2, 8 * 25152, device=dev)
    try:
        for _ in range(5): g._allgather_base(o, t).wait()
        torch.cuda.synchronize(); t0 = time.perf_counter()
        for _ in range(100): g._allgather_base(o, t).wait()
        torch.cuda.synchronize(); out["allgather_8x25152_ms"] = (time.perf_counter() - t0) / 100 * 1e3
    except Exception as e:
        out["allgather_timing"] = "ERR " + str(e)[:200]
    res[r] = out

ths = [threading.Thread(target=main, args=(r,)) for r in range(2)]
[t.start() for t in ths]; [t.join(120) for t in ths]
print(json.dumps(res, indent=1), flush=True)
