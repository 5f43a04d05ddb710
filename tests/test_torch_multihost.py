"""The port's multi-host smoke: OS processes, the mp axis spanning them
(`python -m malio_tpu_torch.distributed.multihost`, the counterpart of
tests/test_multihost.py). Each process checks its shards of one sharded
step against a single-process step and prints its place in the mesh.

On the CPU: two and four processes over gloo (`--cpu`). On a host with
two or more cards: a process a card over NCCL (`--local-devices`, no
torchrun environment, so the ranks' host names are exchanged over NCCL
before the mesh exists)."""
import os
import pathlib
import re
import socket
import subprocess
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEADLINE_S = 180


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _smoke(nprocs, *extra):
    """The smoke in `nprocs` processes of this host; every process's exit
    code and output, within DEADLINE_S."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "RANK", "WORLD_SIZE")}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "malio_tpu_torch.distributed.multihost", "--coordinator",
         f"127.0.0.1:{port}", "--nprocs", str(nprocs), "--pid", str(pid), "--timeout",
         str(DEADLINE_S), *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(nprocs)]
    end = time.monotonic() + DEADLINE_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, end - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def _check(results, backend):
    n = len(results)
    for pid, (rc, out) in enumerate(results):
        assert rc == 0, f"pid {pid} failed:\n{out[-3000:]}"
        assert "multihost smoke ok" in out, out[-2000:]
        assert f"pid {pid}/{n}" in out, out[-2000:]
        assert f"dp={n // 2} mp=2" in out, out[-2000:]
        assert f"backend {backend}" in out, out[-2000:]
        m = re.search(r"map shard rows (\d+)/(\d+)", out)
        assert m and int(m.group(1)) * 2 <= int(m.group(2)) + 2, out[-2000:]


@pytest.mark.parametrize("nprocs", [2, 4])
def test_smoke_over_gloo(nprocs):
    _check(_smoke(nprocs, "--cpu"), "gloo")


@pytest.mark.cuda
def test_smoke_over_nccl_a_card_a_process():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two or more CUDA devices (NCCL takes one rank a card)")
    n -= n % 2
    _check(_smoke(n, "--local-devices", str(n)), "nccl")
