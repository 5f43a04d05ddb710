"""Multi-host runtime: torch.distributed bring-up and cross-host meshes
(counterpart of malio_tpu/distributed/multihost.py).

One process per rank, each with a card of its own or sharing the host's
cards (or the CPU); a global (dp, mp) mesh over every rank, with the mp
axis laid out to span hosts so that a sequence's exchanges cross the
interconnect.

    # host 0                                            # host 1
    python -m malio_tpu_torch.distributed.multihost \\
        --coordinator 10.0.0.1:9911 --nprocs 2 --pid 0   # ... --pid 1

runs one sharded fusion step of a small synthetic round on every process
and checks each process's shards against a single-process step of the
same inputs (`--cpu` runs on the CPU). Under torchrun, `initialize()`
with no arguments reads MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK.
"""
from __future__ import annotations

import argparse
import datetime
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from . import sharding


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               local_device_count=None, backend=None, timeout_s: float = 300.0):
    """Join the world: torch.distributed.init_process_group over
    tcp://coordinator_address (HOST:PORT of process 0), with a timeout of
    `timeout_s` on every collective, so a rank that never comes fails its
    peers instead of hanging them. Arguments left None come from the
    environment torchrun sets (MASTER_ADDR / MASTER_PORT, WORLD_SIZE,
    RANK).

    The backend is NCCL when each rank has a card of its own (`backend_for`):
    CUDA is there and the host's ranks (LOCAL_WORLD_SIZE, else
    `local_device_count`) are no more than its cards. Otherwise, or when
    `backend="gloo"` asks for it, gloo: ranks that share a card (NCCL
    refuses two ranks on one device) or run on the CPU. Under NCCL the
    rank takes its card (`sharding.local_card`) before the first
    collective, which runs on the current card."""
    env = os.environ
    try:
        if coordinator_address is None:
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        if num_processes is None:
            num_processes = int(env["WORLD_SIZE"])
        if process_id is None:
            process_id = int(env["RANK"])
    except KeyError as e:
        raise ValueError(f"initialize: pass the coordinator, the process count and the "
                         f"process id, or set {e.args[0]}") from None
    if backend is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        backend = backend_for(int(env.get("LOCAL_WORLD_SIZE", 0)) or local_device_count, cards)
    if backend == "nccl":
        torch.cuda.set_device(sharding.local_card(process_id))
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s),
    )


def backend_for(local_ranks, cards: int) -> str:
    """The backend of a host that runs `local_ranks` ranks (None: not
    known) and has `cards` cards: NCCL when each rank has a card of its
    own, else gloo (ranks on the CPU, or sharing a card, which NCCL
    refuses)."""
    return "nccl" if local_ranks and cards and local_ranks <= cards else "gloo"


def _host_of_ranks():
    """Each rank's host: consecutive blocks of LOCAL_WORLD_SIZE ranks
    (torchrun's order), else the ranks' host names."""
    n = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", 0))
    if local:
        return [r // local for r in range(n)]
    names = [None] * n
    dist.all_gather_object(names, socket.gethostname())
    return names


def cross_host_mesh(mp: int | None = None, device="cuda"):
    """Global (dp, mp) mesh with the mp axis spanning hosts.

    When mp equals the number of hosts and every host runs dp ranks, each
    mp group takes one rank from every host: a sequence's reductions then
    cross host boundaries, which is what a multi-host run must exercise
    (dp never communicates). mp defaults to the host count where there
    are several hosts and it divides the ranks, else to make_mesh's rule
    (2 for an even rank count above 1)."""
    n = dist.get_world_size()
    hosts = _host_of_ranks()
    by_host = {}
    for r, h in enumerate(hosts):
        by_host.setdefault(h, []).append(r)
    n_hosts = len(by_host)
    if mp is None:
        mp = n_hosts if n_hosts > 1 and n % n_hosts == 0 else (2 if n % 2 == 0 and n > 1 else 1)
    dp = n // mp
    if mp == n_hosts > 1 and all(len(v) == dp for v in by_host.values()):
        order = [by_host[h] for h in by_host]
        layout = [[order[k][i] for k in range(mp)] for i in range(dp)]
    else:
        layout = [[i * mp + j for j in range(mp)] for i in range(dp)]
    return sharding.mesh_from_layout(layout, device)


def global_from_host(mesh, spec, np_array):
    """This rank's shard of a host array that every process holds whole,
    on its device. `spec` names the mesh axis each array axis splits over
    ("dp", "mp" or None), as a PartitionSpec does."""
    return sharding.shard_tensor(mesh, spec, torch.as_tensor(np_array))


def _tiny_cfg(L=2, pts=256):
    """The port's copy of __graft_entry__._tiny_cfg."""
    from ..config import Config

    ext_t = np.array([[0.2, 0.0, 0.0], [-0.3, 0.3, 0.1], [-0.3, -0.3, 0.1]])[:L]
    return Config(
        num_lidars=L, lid_type=tuple([3] * L), n_scans=tuple([16] * L),
        point_filter_num=tuple([1] * L), extrinsic_T=tuple(ext_t.reshape(-1).tolist()),
        extrinsic_R=tuple(np.tile([1.0, 0, 0, 0], (L, 1)).reshape(-1).tolist()),
        max_raw_points=pts, max_points_per_scan=pts, max_imu_per_group=16, imu_cont_len=8,
        traj_capacity=32, spline_capacity=32, epoch_capacity=16, map_capacity=1 << 14,
        filter_size_surf=0.4, filter_size_map=0.4, cube_len=300.0, det_range=60.0,
    )


def _dummy_inputs(cfg, dtype=torch.float32, device="cuda"):
    """The port's copy of __graft_entry__._dummy_inputs: a carry and a
    round of uniform random points (seed 0) with a resting IMU."""
    from .. import pipeline, propagate as prop, runner, state as st
    from ..filter import dynamics

    L, P = cfg.num_lidars, cfg.max_raw_points
    I, IC = cfg.max_imu_per_group, cfg.imu_cont_len
    rng = np.random.default_rng(0)
    kw = dict(dtype=dtype, device=device)
    carry = pipeline.init_carry(
        cfg, st.identity_state(L, **kw), runner.initial_covariance(cfg, **kw),
        dynamics.process_noise_matrix(1e-4, 1e-4, 1e-5, 1e-5, **kw), **kw,
    )
    carry = carry._replace(last_imu=torch.tensor([0.0, 0, 0, 0, 0, 0, 9.81], **kw),
                           mean_acc_norm=torch.tensor(9.81, **kw))
    imu_t = 0.1 + np.arange(I) * 0.01
    imu = np.concatenate([imu_t[:, None], np.zeros((I, 3)), np.tile([0, 0, 9.81], (I, 1))], 1)
    cont_t = imu_t[-1] + np.arange(IC) * 0.01
    cont = np.concatenate([cont_t[:, None], np.zeros((IC, 3)), np.tile([0, 0, 9.81], (IC, 1))], 1)
    pts = rng.uniform(-10, 10, size=(L, P, 4))
    pts[..., 3] = rng.uniform(0.1, 0.2, size=(L, P))
    t = lambda a: torch.as_tensor(np.asarray(a)).to(**kw)  # noqa: E731
    ones = lambda *s: torch.ones(s, dtype=torch.bool, device=device)  # noqa: E731
    group = prop.MeasureGroup(
        pts=t(pts), pts_mask=ones(L, P), beg_t=t(np.full(L, 0.1)),
        end_t=t(0.2 + 0.01 * np.arange(L)), imu=t(imu), imu_mask=ones(I), imu_cont=t(cont),
        imu_cont_mask=ones(IC), t_shift=t(0.0),
    )
    return carry, group


def _smoke(device="cuda"):
    """One sharded step of a small synthetic round (2 LiDARs x 128 points,
    f64) over a cross-host mesh: the points sharded over mp, the map's
    rows over mp, one sequence per dp row. Every process checks its
    shards against a single-process step of the same inputs and prints
    one line; any mismatch raises."""
    from .. import pipeline

    mesh = cross_host_mesh(device=device)
    dp, mp = mesh.dp, mesh.mp
    n = dist.get_world_size()  # mesh_from_layout probed every group of this rank

    cfg = _tiny_cfg(L=2, pts=128)
    carry, group = _dummy_inputs(cfg, torch.float64, mesh.device)
    ref_carry, ref_out = pipeline.step(cfg, carry, group, device=mesh.device)

    b_carry = sharding.batch_carries([carry] * dp)
    b_group = sharding.batch_groups([group] * dp)
    step = sharding.make_sharded_step(cfg, mesh, carry_template=b_carry)
    new_carry, out = step(sharding.carry_sharding(mesh, b_carry),
                          sharding.group_sharding(mesh, cfg, b_group))

    np.testing.assert_allclose(out.pos[0].cpu().numpy(), ref_out.pos.cpu().numpy(), atol=1e-9)
    np.testing.assert_allclose(new_carry.P[0].cpu().numpy(), ref_carry.P.cpu().numpy(), atol=1e-8)
    if int(out.map_size[0]) != int(ref_out.map_size):
        raise AssertionError(f"map size {int(out.map_size[0])}, want {int(ref_out.map_size)}")
    R = ref_carry.map.tab.shape[0]
    local = new_carry.map.tab[0].cpu().numpy()
    rows = local.shape[0]
    if rows > -(-R // mp):
        raise AssertionError(f"map shard holds {rows} of {R} rows at mp={mp}")
    want = ref_carry.map.tab[mesh.mp_index * rows : (mesh.mp_index + 1) * rows].cpu().numpy()
    np.testing.assert_array_equal(local[..., [0, 4]], want[..., [0, 4]])
    np.testing.assert_allclose(local[..., 1:4], want[..., 1:4], atol=1e-12)
    print(f"multihost smoke ok: pid {dist.get_rank()}/{n} mesh dp={dp} mp={mp} "
          f"map shard rows {rows}/{R} backend {dist.get_backend()}", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Two-or-more-process smoke of the sharded step")
    ap.add_argument("--coordinator", default=None, help="HOST:PORT of process 0")
    ap.add_argument("--nprocs", type=int, default=None)
    ap.add_argument("--pid", type=int, default=None)
    ap.add_argument("--local-devices", type=int, default=None,
                    help="ranks this host runs (each gets a card of its own if it has as many)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a collective may wait before the process fails")
    a = ap.parse_args()
    torch.set_num_threads(1)
    initialize(a.coordinator, a.nprocs, a.pid, a.local_devices,
               backend="gloo" if a.cpu else None, timeout_s=a.timeout)
    try:
        _smoke("cpu" if a.cpu else "cuda")
    finally:
        from .. import graph

        graph.release()  # the graphs that hold NCCL collectives go before their group
        dist.destroy_process_group()
