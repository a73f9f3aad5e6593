"""Elastic data-parallel training over NCCL on four cards: phase 21's v1
bi-GRU config (vocab 30 000, width 512, batch 128, 24 batches a pass) through
`python -m paddle_tpu_torch train --trainer_count=2 --elastic=1
--master_endpoints=...` (one rank process a card), with a master process
that grows the job to 4 ranks after a few batches of pass 0 and shrinks it
back to 2 a few batches after that epoch completed; beside it the fixed
2-rank and 4-rank runs of the same command without `--elastic`. Prints, as
JSON lines: each run's pass costs, ms a step at each world (the arrival
spacing of the trainer's per-batch log lines, medians), the two epochs'
drain / reshard / resume split and the boundary agreement's cost on rank 0
(the trainer's log), and rank 0's last-pass parameters against the fixed
runs'.

    python3 tools/elastic_nccl_train.py      # on a machine with four cards
    python3 tools/elastic_nccl_train.py --cpu  # the same flow at width 16 on gloo

It writes its config and checkpoints under a temporary directory."""
import json, os, re, signal, subprocess, sys, threading, time
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import numpy as np
import chip_smoke as cs
from paddle_tpu_torch.runtime.master import MasterClient
from paddle_tpu_torch.trainer import checkpoint as ckpt

PASSES, GROW_AT, SHRINK_AFTER = 6, 4, 8  # batches of the log before each announce
CPU = "--cpu" in sys.argv[1:]
if not CPU:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip(), flush=True)
DEVICE = ["--device=cpu", "--config_args=vocab=64,size=16,batch=8"] if CPU else ["--device=cuda"]
conf = cs.v1_config_dir("bigru", cs.V1_BIGRU_CONFIG, cs.V1_BIGRU_PROVIDER)
env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, conf]))
BATCH_RE = re.compile(r"pass (\d+) batch (\d+) cost=")
EPOCH_RE = re.compile(r"resize epoch (\d+) complete: world=(\d+) drain=([\d.]+)s "
                      r"reshard=([\d.]+)s resume=([\d.]+)s")
AGREE_RE = re.compile(r"boundary agreement on rank 0: (\d+) boundaries, ([\d.]+) us each")


def train(name, extra, on_line=None, timeout=200):
    """One `train` command -> its pass lines, stamped batch log lines,
    stderr tail and exit code."""
    save = os.path.join(conf, f"out_{name}")
    argv = [sys.executable, "-m", "paddle_tpu_torch", "train", "--config=conf.py",
            *DEVICE, f"--num_passes={PASSES}", "--log_period=1",
            f"--save_dir={save}", *extra]
    proc = subprocess.Popen(argv, cwd=conf, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    # a run past its time is killed with its rank processes (rc -9)
    killer = threading.Timer(timeout, lambda: os.killpg(proc.pid, signal.SIGKILL))
    killer.start()
    batches, err = [], []

    def read_err():
        for line in proc.stderr:
            t = time.perf_counter()
            err.append(line)
            m = BATCH_RE.search(line)
            if m:
                batches.append((t, int(m.group(1)), int(m.group(2))))
            if on_line is not None:
                on_line(line, len(batches))

    th = threading.Thread(target=read_err, daemon=True)
    th.start()
    out = proc.stdout.read()  # stderr is the thread's alone
    proc.wait()
    killer.cancel()
    th.join(30)
    return dict(save=save, passes=cs.pass_lines(out.splitlines()), batches=batches,
                err="".join(err), rc=proc.returncode)


def step_ms(batches, lo=None, hi=None):
    """Median spacing of consecutive batch lines inside one pass, in ms,
    between the stamps lo and hi (the first two lines after lo skipped:
    the eager step and the capture)."""
    sel = [b for b in batches if (lo is None or b[0] > lo) and (hi is None or b[0] < hi)]
    gaps = [(b[0] - a[0]) * 1e3 for a, b in zip(sel[2:], sel[3:]) if a[1] == b[1]]
    return float(np.median(gaps)) if gaps else None


results = {}
for n in (2, 4):
    r = train(f"fixed{n}", [f"--trainer_count={n}"])
    results[f"fixed{n}"] = r
    print(f"fixed{n}", json.dumps(dict(rc=r["rc"], passes=r["passes"],
                                       step_ms=step_ms(r["batches"]),
                                       err=r["err"][-1500:] if r["rc"] else "")), flush=True)

port = cs.free_port()
master = subprocess.Popen([sys.executable, "-m", "paddle_tpu_torch.runtime.master", "serve",
                           "--port", str(port), "--lease_s", "1"], cwd=REPO, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
master.stdout.readline()
boot = MasterClient(("127.0.0.1", port))
marks, lock = {}, threading.Lock()


def on_line(line, n):
    # announce from the log's progress; the master's count of completed
    # epochs gates the second
    with lock:
        if "grow" not in marks and n >= GROW_AT:
            marks["grow"] = (time.perf_counter(), boot.call("resize", world=4))
        elif ("grow" in marks and "grown_at" not in marks and BATCH_RE.search(line)
              and boot.call("stats")["resize"]["completed"] >= 1):
            marks["grown_at"] = (time.perf_counter(), n)
        elif ("grown_at" in marks and "shrink" not in marks
              and n >= marks["grown_at"][1] + SHRINK_AFTER):
            marks["shrink"] = (time.perf_counter(), boot.call("resize", world=2))


try:
    r = train("elastic", ["--trainer_count=2", "--elastic=1",
                          f"--master_endpoints=127.0.0.1:{port}"], on_line)
    state = boot.call("stats")["resize"]
finally:
    boot.close()
    master.terminate()
    master.wait(30)
results["elastic"] = r
epochs = [dict(epoch=int(m[0]), world=int(m[1]), drain_s=float(m[2]), reshard_s=float(m[3]),
               resume_s=float(m[4])) for m in EPOCH_RE.findall(r["err"])]
agree = AGREE_RE.findall(r["err"])
t_grow = marks.get("grown_at", (None,))[0]
t_shrink = marks.get("shrink", (None,))[0]
seg = dict(world2_before=step_ms(r["batches"], hi=marks.get("grow", (None,))[0]),
           world4=step_ms(r["batches"], lo=t_grow, hi=t_shrink),
           world2_after=step_ms(r["batches"], lo=t_shrink))


def last_params(save):
    return ckpt.load_pass(save)[0]


par = {}
if all(results[k]["rc"] == 0 for k in ("fixed2", "fixed4")) and r["rc"] == 0:
    got = last_params(r["save"])
    for k in ("fixed2", "fixed4"):
        want = last_params(results[k]["save"])
        par[k] = dict(max_abs=max(float(np.abs(got[n] - want[n]).max()) for n in want),
                      max_rel_l2=max(float(np.linalg.norm(got[n] - want[n])
                                           / max(np.linalg.norm(want[n]), 1e-30))
                                     for n in want),
                      bitwise=all(np.array_equal(got[n], want[n]) for n in want))
print("elastic", json.dumps(dict(
    rc=r["rc"], passes=r["passes"], epochs=epochs, master=state, step_ms=seg,
    fixed_step_ms={k: step_ms(results[k]["batches"]) for k in ("fixed2", "fixed4")},
    agreement_rank0=dict(boundaries=int(agree[-1][0]), us_each=float(agree[-1][1]))
    if agree else None,
    pass_cost_vs_fixed={k: {p: r["passes"].get(p, {}).get("avg_cost", 0.0)
                            - results[k]["passes"].get(p, {}).get("avg_cost", 0.0)
                            for p in r["passes"]} for k in ("fixed2", "fixed4")},
    params_vs_fixed=par,
    resize_log=[l.strip()[-200:] for l in r["err"].splitlines() if "resize" in l][-20:],
    err=r["err"][-3000:] if r["rc"] else "")), flush=True)
