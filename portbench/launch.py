"""The multi-rank launcher: one process a card, each running
`python -m portbench.rank`, all meeting at a TCP store this process hosts
on 127.0.0.1 (the ranks build their NCCL group over it, as
`paddle_tpu_torch.parallel.distributed.initialize` does for the CLI's
`--trainer_count` ranks). Rank 0 leaves its result in the store. The
ranks' output goes to this process's stderr; a rank that fails ends the
others; every rank is waited for."""

from __future__ import annotations

import datetime
import json
import os
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

from portbench.manifest import ROOT

RESULT_KEY = "portbench/result"


def launch(world: int, args: List[str], timeout_s: float) -> Optional[Dict[str, Any]]:
    """Start `world` ranks with `args` (the rank module's arguments, which
    it completes with --rank and the store's address) -> rank 0's result,
    or None when a rank failed or the time ran out."""
    import torch.distributed as dist

    store = dist.TCPStore("127.0.0.1", 0, None, True,
                          timeout=datetime.timedelta(seconds=timeout_s),
                          wait_for_workers=False)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "portbench.rank", *args, "--rank", str(r),
         "--world", str(world), "--store", f"127.0.0.1:{store.port}"],
        cwd=str(ROOT), env=env, stdout=sys.stderr, stderr=sys.stderr)
        for r in range(world)]
    deadline = time.monotonic() + timeout_s
    failed = False
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                failed = True
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    if failed or any(p.returncode != 0 for p in procs):
        print(f"portbench: rank exit codes {[p.returncode for p in procs]}", file=sys.stderr)
        return None
    if not store.check([RESULT_KEY]):
        return None
    return json.loads(store.get(RESULT_KEY))
