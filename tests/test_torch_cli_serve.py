"""`python -m paddle_tpu_torch serve` as a real OS process, on the CPU.

  * it prints its `{"role": "serve", "address": [host, port]}` line;
  * a `ServingClient.generate` gets the tokens the same seeded demo session
    gives in process;
  * SIGTERM ends it with exit code 0 after a `{"final_stats": ...}` line;
  * the two quota-flag warnings of the reference CLI;
  * `--tp 2` raises NotImplementedError naming ROADMAP.md's item, with or
    without `--config` (serving a v1 config is ported:
    tests/test_torch_generation_serving.py).

Each subprocess serves on 127.0.0.1 port 0 and is killed if a test fails."""

import json
import os
import signal
import subprocess
import sys

import pytest

from paddle_tpu_torch import cli
from paddle_tpu_torch.serving import ServingClient, make_demo_session

pytestmark = [pytest.mark.serving, pytest.mark.timeout(60)]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE = ["serve", "--demo", "--device", "cpu", "--max_slots=2",
         "--page_size=8", "--prefill_buckets=8,16", "--max_new_limit=8"]


def _start(*extra):
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", *SERVE, *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
    )


def _stop(proc):
    """SIGTERM, wait, and return the rest of (stdout, stderr)."""
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.communicate(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise


def test_cli_serve_subprocess_answers_and_drains():
    want = make_demo_session(max_slots=2, page_size=8, prefill_buckets=(8, 16),
                             max_new_limit=8, device="cpu")
    h = want.submit([1, 5, 9], 6)
    want.run_until_idle()
    proc = _start()
    try:
        line = json.loads(proc.stdout.readline())
        assert line["role"] == "serve"
        host, port = line["address"]
        assert host == "127.0.0.1" and int(port) > 0
        c = ServingClient((host, int(port)))
        r = c.generate([1, 5, 9], max_new_tokens=6, timeout_s=30.0)
        assert r["done"] and r["tokens"] == h.tokens
        assert c.stats()["device"] == "cpu"
        c.close()
    finally:
        out, _ = _stop(proc)
    assert proc.returncode == 0
    final = json.loads(out.strip().splitlines()[-1])["final_stats"]
    assert final["completed"] == 1 and final["pages_in_use"] == 0
    assert final["decode_graph_captures"] == 0  # eager on the CPU


@pytest.mark.parametrize("flags,warning", [
    (["--tenant_tokens_per_s=5"], "needs --tenant_tokens"),
    (["--tenant_tokens=40"], "never refills"),
])
def test_cli_serve_quota_flag_warnings(flags, warning):
    proc = _start(*flags)
    try:
        json.loads(proc.stdout.readline())  # serving despite the warning
    finally:
        _, err = _stop(proc)
    assert proc.returncode == 0
    assert warning in err


@pytest.mark.parametrize("argv,item", [
    (["--tp", "2"], "§1 item 8"),
    (["--config", "conf.py", "--tp", "2"], "§1 item 8"),
])
def test_cli_serve_unported_flags_raise_named(argv, item):
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as ei:
        cli.main(SERVE + argv)
    assert item in str(ei.value)


def test_cli_serve_without_a_model_exits_2():
    assert cli.main(["serve", "--device", "cpu"]) == 2
