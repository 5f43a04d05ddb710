"""Worlds of OS processes for the port's distributed tests, on the CPU over
gloo and on the cards over NCCL.

`spawn(target, nprocs, payload)` runs `target(mesh_args)` (a function of
this module, by name) in `nprocs` processes of this host, each joined to
one torch.distributed world over `backend` (multihost.initialize, one
thread a process); process i logs to DIR/<target>.rank<i>.log and leaves
its result, a torch.save'd dict, in DIR/<target>.rank<i>.pt. A process
that fails, or a world past `deadline_s`, ends the world: every process
still running is killed. This module imports torch and the port alone,
never JAX, so the children start fast.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
TESTS = pathlib.Path(__file__).resolve().parent


def spawn(target, nprocs, payload, backend="gloo", deadline_s=120.0):
    """`target` in `nprocs` processes; returns ([(exit code, log)] by
    process, [result or None] by process, seconds until the world ended)."""
    d = pathlib.Path(payload["dir"])
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(TESTS)!r}]; "
            "import dist_worlds; dist_worlds._child()")
    env = {k: v for k, v in os.environ.items()
           if k not in ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "RANK", "WORLD_SIZE")}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    logs = [d / f"{target}.rank{i}.log" for i in range(nprocs)]
    t0 = time.monotonic()
    procs = []
    try:
        for i in range(nprocs):
            with open(logs[i], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code, target, str(nprocs), str(i), str(port), backend,
                     str(deadline_s), json.dumps(payload)],
                    cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT))
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() - t0 > deadline_s:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    elapsed = time.monotonic() - t0
    results = []
    for i in range(nprocs):
        f = d / f"{target}.rank{i}.pt"
        results.append(torch.load(f, weights_only=False) if f.exists() else None)
    return [(p.returncode, logs[i].read_text()) for i, p in enumerate(procs)], results, elapsed


def check(runs):
    """Every process of a world exited 0."""
    for i, (rc, log) in enumerate(runs):
        assert rc == 0, f"process {i} exited {rc}:\n{log[-4000:]}"


def _child():
    import traceback

    import torch.distributed as dist

    from malio_tpu_torch.distributed import multihost

    target, n, pid, port, backend, deadline, payload = sys.argv[1:8]
    n, pid = int(n), int(pid)
    torch.set_num_threads(1)
    try:
        multihost.initialize(f"127.0.0.1:{port}", n, pid, local_device_count=n, backend=backend,
                             timeout_s=float(deadline))
        payload = json.loads(payload)
        res = globals()[target](payload)
        torch.save(res, pathlib.Path(payload["dir"]) / f"{target}.rank{pid}.pt")
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)  # a peer may wait in a collective: leave without the teardown
    from malio_tpu_torch import graph

    graph.release()
    dist.destroy_process_group()


# ---- inputs ----

def small_config():
    """The flagship config at 256 raw points a LiDAR and 2^15 slots: mp = 2
    and 4 divide its raw points, its 624 measurement lanes and its rows."""
    from malio_tpu_torch.config import flagship_config

    return flagship_config(points_per_lidar=256, map_slots=1 << 15)


def make_inputs(path, seeds, rounds, duration=2.0, device="cpu"):
    """The sharding worker's inputs (sharding.save_inputs) for flagship
    sequences of `seeds` at `small_config`: each IMU-initialised and its
    first `rounds` rounds, as chip_smoke.dist_inputs makes them."""
    import chip_smoke

    cfg = small_config()
    seqs = [chip_smoke.flagship_groups(cfg, duration, seed=s)[0] for s in seeds]
    chip_smoke.dist_inputs(cfg, path, seqs, device, rounds=rounds)
    return cfg


def _load(path):
    """(cfg, global batched carry, the stream of global batched groups) of
    the worker's inputs at `path`, on the CPU, as the worker loads them."""
    from malio_tpu_torch import checkpoint, interop, tree
    from malio_tpu_torch.distributed import sharding

    with np.load(path) as f:
        cfg = sharding._config(str(f["cfg"]))
        groups = {k[len("groups/"):]: f[k] for k in f.files if k.startswith("groups/")}
    stacked = interop.group_from_numpy(groups, "cpu")
    carry = checkpoint.load(sharding._carry_path(path),
                            sharding.carry_template(cfg, stacked.pts.shape[1], stacked.pts.dtype))
    return cfg, carry, [tree.index(stacked, k) for k in range(stacked.pts.shape[0])]


# ---- targets: each runs in every process of a world ----

def steady_round(p):
    """Every round of the inputs but the last through the sharded step, the
    last under HostReads: what it saw, the collectives it issued, the
    outputs."""
    from host_reads import HostReads

    from malio_tpu_torch.distributed import sharding

    cfg, carry, stream = _load(p["inputs"])
    mesh = sharding.make_mesh(mp=p["mp"], device=p["device"])
    step = sharding.make_sharded_step(cfg, mesh, carry_template=carry)
    local = sharding.carry_sharding(mesh, carry)
    for g in stream[:-1]:
        local, _ = step(local, sharding.group_sharding(mesh, cfg, g))
    last = sharding.group_sharding(mesh, cfg, stream[-1])
    calls = mesh.mp_group.calls
    with HostReads() as h:
        local, out = step(local, last)
    return dict(seen=h.seen, collectives=h.collectives, calls=mesh.mp_group.calls - calls,
                dp_index=mesh.dp_index, mp_index=mesh.mp_index, mp=mesh.mp,
                pos=out.pos.clone(), map_size=out.map_size.clone())


def whole_table(p):
    """A batch of maps (p["maps"], a torch.save'd dict) with its rows
    sharded over an mp group of every process: voxel_hash.whole_map of
    this rank's rows, and knn_cached over this rank's share of the
    queries on its rows."""
    from malio_tpu_torch.distributed import sharding
    from malio_tpu_torch.map import voxel_hash as vh

    d = torch.load(p["maps"], weights_only=False)
    mesh = sharding.make_mesh(mp=p["mp"], device="cpu")
    m = d["map"]
    local = m._replace(tab=sharding.shard_tensor(mesh, (None, "mp"), m.tab))
    whole = vh.whole_map(local, mesh.mp_group)
    n = d["queries"].shape[1] // mesh.mp
    lanes = slice(mesh.mp_index * n, (mesh.mp_index + 1) * n)
    knn = vh.knn_cached(local, d["queries"][:, lanes], qmask=d["qmask"][:, lanes],
                        shard=mesh.mp_group, **d["kw"])
    return dict(tab=whole.tab, local_rows=local.tab.shape[-3], lanes=(lanes.start, lanes.stop),
                knn=knn)


def iekf(p):
    """esekf.update_iterated on an mp rank: the scenario's map rows and
    measurement lanes sharded over every process, its h_share built with
    the shard (measurement.make_h_share)."""
    from malio_tpu_torch import measurement as meas
    from malio_tpu_torch.distributed import sharding
    from malio_tpu_torch.filter import esekf

    d = torch.load(p["scenario"], weights_only=False)
    mesh = sharding.make_mesh(mp=p["mp"], device="cpu")
    lanes = ("pts_body", "pt_lidar", "pt_epoch", "pt_mask")
    sd = d["data"]._replace(**{f: sharding.shard_tensor(mesh, (None, "mp"), getattr(d["data"], f))
                               for f in lanes})
    m = d["map"]._replace(tab=sharding.shard_tensor(mesh, (None, "mp"), d["map"].tab))
    h, cache0 = meas.make_h_share(d["cfg"], m, sd, d["x"], shard=mesh.mp_group)
    calls = mesh.mp_group.calls
    got = esekf.update_iterated(d["xs"], d["P"], h, cache0, Pi0=d["Pi"], **d["kw"])
    return dict(x=got.x, P=got.P, Pi=got.Pi, iterations=got.iterations, valid=got.valid,
                calls=mesh.mp_group.calls - calls)


def failed_capture(p):
    """The sharded step over NCCL with a host read planted in process 0's
    insert: its capture raises; process 1 captures, replays and waits in
    a collective that process 0 never joins."""
    import torch.distributed as dist

    from malio_tpu_torch.distributed import sharding
    from malio_tpu_torch.map import voxel_hash as vh

    cfg, carry, stream = _load(p["inputs"])
    mesh = sharding.make_mesh(mp=2)
    if dist.get_rank() == 0:
        insert = vh.insert

        def reading_insert(*a, **kw):
            out = insert(*a, **kw)
            float(out.n_dropped.sum())  # a host read: fails a capture
            return out

        vh.insert = reading_insert
    step = sharding.make_sharded_step(cfg, mesh, carry_template=carry)
    local = sharding.carry_sharding(mesh, carry)
    for g in stream:
        local, _ = step(local, sharding.group_sharding(mesh, cfg, g))
    torch.cuda.synchronize()
    return {}
