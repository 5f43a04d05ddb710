"""Multi-rank execution: the (dp, mp) mesh of torch.distributed ranks and
the sharded fusion step (counterpart of malio_tpu/distributed/sharding.py).

One process per rank; a mesh lays dp * mp ranks of one world out as a
grid, with a process group per dp row (its mp ranks) and one per mp
column.

  dp - independent sequences: rank (i, j) steps sequences
       [i B/dp, (i+1) B/dp) of the batch through the batched round
       (pipeline.step with a leading B). No collective runs for dp.
  mp - one sequence over mp ranks: rank j deskews its contiguous slice of
       the raw point axis, holds rows [j R/mp, (j+1) R/mp) of every
       sequence's voxel-hash table, and searches, fits and weights lanes
       [j M/mp, (j+1) M/mp) after the lane compaction. The exchanges GSPMD
       inserts for the JAX mesh are explicit here (collectives.py): the
       gather of the deskewed points, the k-NN window rows (their union,
       filled by their owners), the escalation counts, the weighting
       laws' extremes, the measurement rows (which every rank then sums
       in one process's order for the localization weight and HtH /
       Hth), the insert's lanes and the counts. Every one is exact.

`group_sharding` and `carry_sharding` give a rank its slices of a global
batched group or carry; `gather_carry` and `gather_outputs` put the
global values back together on every rank (in the JAX package, reading a
global jax.Array). mp must divide the raw point count, the measurement
lanes and the table's rows, and dp the batch: a mesh that does not
divide them raises.

    python -m malio_tpu_torch.distributed.sharding --coordinator HOST:PORT \\
        --nprocs N --pid I [--mp M] --inputs IN.npz --out OUT.npz [--cpu]

replays the rounds in IN.npz (a config and groups stacked (K, B, ...))
from the global batched carry in IN.carry.npz (a checkpoint), as
`save_inputs` writes them, over a mesh of N processes; every process
writes OUT.npz.rank<I>.json (its launches, collectives and round times)
and process 0 writes the gathered outputs to OUT.npz and the final
global carry to OUT.carry.npz (`load_outputs` reads both). `run_local`
starts the N processes on one host.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import checkpoint, pipeline, tree
from .. import propagate as prop
from ..device import resolve_device
from .collectives import ShardGroup


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (dp, mp) grid: `layout[i][j]` is the global
    rank at dp index i, mp index j."""

    layout: tuple
    dp_index: int
    mp_index: int
    device: torch.device
    mp_group: ShardGroup  # this rank's dp row: the ranks that share its sequences
    ranks: ShardGroup  # every rank of the mesh

    @property
    def dp(self) -> int:
        return len(self.layout)

    @property
    def mp(self) -> int:
        return len(self.layout[0])

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "mp": self.mp}

    @property
    def shard(self):
        """The shard context `pipeline.step` takes: None without mp."""
        return self.mp_group if self.mp > 1 else None


def local_card(rank: int) -> int:
    """The card of its host that a rank uses: LOCAL_RANK (torchrun sets
    it), else the global rank, modulo the host's cards. Ranks numbered
    one after another on each host get cards of their own while there are
    enough; more ranks than cards share them (over gloo only)."""
    return int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count()


def _rank_device(device) -> torch.device:
    """`device` for this rank: its card by `local_card`."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_card(dist.get_rank()))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def mesh_from_layout(layout, device="cuda"):
    """The Mesh of this rank in `layout` (dp rows of mp global ranks), or
    None for a rank outside it. Every process of the world must call it
    (each creates every group, in one order)."""
    layout = tuple(tuple(int(r) for r in row) for row in layout)
    if len({len(row) for row in layout}) != 1:
        raise ValueError(f"mesh layout rows differ in length: {layout}")
    rows = [dist.new_group(list(row)) for row in layout]
    members = sorted(r for row in layout for r in row)
    everyone = dist.new_group(members)
    rank = dist.get_rank()
    for i, row in enumerate(layout):
        if rank in row:
            j = row.index(rank)
            break
    else:
        return None
    return Mesh(
        layout=layout, dp_index=i, mp_index=j, device=_rank_device(device),
        mp_group=ShardGroup(rows[i], j, len(row)),
        ranks=ShardGroup(everyone, members.index(rank), len(members)),
    )


def make_mesh(n_ranks: int | None = None, mp: int | None = None, device="cuda"):
    """A (dp, mp) mesh over the first n ranks of the world, row-major (the
    ranks of an mp group are consecutive). mp defaults to 2 where the rank
    count is even and above 1, else 1. Ranks past the first n get None."""
    n = dist.get_world_size() if n_ranks is None else n_ranks
    if mp is None:
        mp = 2 if n % 2 == 0 and n > 1 else 1
    dp = n // mp
    return mesh_from_layout([[i * mp + j for j in range(mp)] for i in range(dp)], device)


def batch_carries(carries: Sequence[pipeline.LioCarry]) -> pipeline.LioCarry:
    return tree.stack(list(carries))


def batch_groups(groups: Sequence[prop.MeasureGroup]) -> prop.MeasureGroup:
    return tree.stack(list(groups))


def _block(mesh: Mesh, spec, shape):
    """The index of this rank's block of an array of `shape` whose axes
    split over the mesh axes named in `spec` ("dp", "mp" or None a dim)."""
    idx = []
    for d, name in enumerate(spec):
        if name is None:
            idx.append(slice(None))
            continue
        n, k = (mesh.dp, mesh.dp_index) if name == "dp" else (mesh.mp, mesh.mp_index)
        if shape[d] % n:
            raise ValueError(f"{name}={n} does not divide axis {d} of an array of shape "
                             f"{tuple(shape)}")
        step = shape[d] // n
        idx.append(slice(k * step, (k + 1) * step))
    return tuple(idx)


def shard_tensor(mesh: Mesh, spec, t):
    """This rank's block of a global tensor, contiguous on its device."""
    return t[_block(mesh, spec, t.shape)].to(mesh.device).contiguous()


def _unshard(group: ShardGroup, mesh: Mesh, spec, local, writes: bool):
    """The global tensor from every rank's block: each rank that `writes`
    puts its block into a zero buffer and the group sums them exactly."""
    shape = list(local.shape)
    for d, name in enumerate(spec):
        shape[d] *= 1 if name is None else mesh.shape[name]
    buf = torch.zeros(shape, dtype=local.dtype, device=local.device)
    if writes:
        buf[_block(mesh, spec, shape)] = local
    return group.assemble(buf)


def _group_spec(cfg, a):
    return ("dp", None, "mp") if a.dim() >= 3 and a.shape[2] == cfg.max_raw_points else ("dp",)


def group_sharding(mesh: Mesh, cfg, group: prop.MeasureGroup) -> prop.MeasureGroup:
    """This rank's slices of a batched MeasureGroup: the batch over dp;
    the raw point axis over mp."""
    return tree.map_tensors(lambda a: shard_tensor(mesh, _group_spec(cfg, a), a), group)


def carry_sharding(mesh: Mesh, carry: pipeline.LioCarry) -> pipeline.LioCarry:
    """This rank's slices of a batched carry: the batch over dp; the map
    table's row axis over mp (each mp rank owns a contiguous row range of
    every sequence's table); every other field whole on each mp rank."""
    rest = tree.map_tensors(lambda a: shard_tensor(mesh, ("dp",), a),
                            carry._replace(map=carry.map._replace(tab=None)))
    tab = shard_tensor(mesh, ("dp", "mp"), carry.map.tab)
    return rest._replace(map=rest.map._replace(tab=tab))


def gather_carry(mesh: Mesh, carry: pipeline.LioCarry) -> pipeline.LioCarry:
    """The global batched carry on every rank, from each rank's slices."""
    lead = mesh.mp_index == 0  # one writer of the fields every mp rank holds whole
    rest = tree.map_tensors(lambda a: _unshard(mesh.ranks, mesh, ("dp",), a, lead),
                            carry._replace(map=carry.map._replace(tab=None)))
    tab = _unshard(mesh.ranks, mesh, ("dp", "mp"), carry.map.tab, True)
    return rest._replace(map=rest.map._replace(tab=tab))


def gather_outputs(mesh: Mesh, outs: pipeline.StepOutput) -> pipeline.StepOutput:
    """Stacked outputs (K, B/dp, ...) of `run_batched` as (K, B, ...) on
    every rank; they are the same on every mp rank, so mp rank 0 writes
    them."""
    lead = mesh.mp_index == 0
    return tree.map_tensors(lambda a: _unshard(mesh.ranks, mesh, (None, "dp"), a, lead), outs)


def make_sharded_step(cfg, mesh: Mesh, carry_template=None):
    """step(local carry, local group) -> (local carry, local outputs): one
    fusion round of this rank's sequences over its mp group. With
    `carry_template` (a global batched carry) the mesh is checked against
    its batch and table rows before the first round."""
    M = cfg.max_meas_points or cfg.num_lidars * cfg.max_points_per_scan
    M = min(M, cfg.num_lidars * cfg.max_points_per_scan)
    for n, what in ((cfg.max_raw_points, "raw points a LiDAR"), (M, "measurement lanes")):
        if n % mesh.mp:
            raise ValueError(f"mp={mesh.mp} does not divide the {n} {what}")
    if carry_template is not None:
        _block(mesh, ("dp", "mp"), carry_template.map.tab.shape)
    shard = mesh.shard

    def fn(carry, group):
        return pipeline.step(cfg, carry, group, device=mesh.device, shard=shard)

    return fn


def run_batched(cfg, mesh: Mesh, carries, group_stream, callback=None):
    """Replay a batch of sequences in lockstep over the mesh.

    carries: the global batched carry (B, ...); group_stream: an iterable
    of global batched groups. Each rank steps its slices; returns its
    final local carry and its stacked local outputs (K, B/dp, ...), None
    for an empty stream. `callback(carry, out)` runs after every round."""
    step = make_sharded_step(cfg, mesh, carry_template=carries)
    carry = carry_sharding(mesh, carries)
    outs = []
    for groups in group_stream:
        carry, out = step(carry, group_sharding(mesh, cfg, groups))
        outs.append(out)
        if callback is not None:
            callback(carry, out)
    return carry, (tree.stack(outs) if outs else None)


# ---- the replay worker (tests and chip_smoke.py drive it) ----

def _carry_path(path) -> pathlib.Path:
    """Where the carry beside a worker's npz lies: IN.npz -> IN.carry.npz."""
    path = pathlib.Path(path)
    return path.with_name(path.stem + ".carry.npz")


def save_inputs(path, cfg, carry: pipeline.LioCarry, groups: dict):
    """Write a worker's inputs: the config and the groups stacked (K, B,
    ...) (numpy arrays by MeasureGroup field) to `path`, and the global
    batched carry beside it as a checkpoint (checkpoint.save)."""
    np.savez(path, cfg=np.asarray(json.dumps(dataclasses.asdict(cfg))),
             **{f"groups/{k}": np.asarray(v) for k, v in groups.items()})
    checkpoint.save(_carry_path(path), carry)


def carry_template(cfg, B: int, dtype):
    """A batched carry of B sequences of `cfg` on the CPU: the structure,
    shapes and dtypes checkpoint.load fills."""
    from .. import runner, state as st
    from ..filter import dynamics

    kw = dict(dtype=dtype, device="cpu")
    one = pipeline.init_carry(
        cfg, st.identity_state(cfg.num_lidars, **kw), runner.initial_covariance(cfg, **kw),
        dynamics.process_noise_matrix(0.0, 0.0, 0.0, 0.0, **kw), **kw,
    )
    return batch_carries([one] * B)


def load_outputs(path, template: pipeline.LioCarry):
    """What process 0 of a worker wrote: the outputs stacked (K, B, ...)
    as numpy arrays by StepOutput field, and the final global carry in
    the structure of `template` (checkpoint.load)."""
    with np.load(path) as f:
        outs = {k[len("out/"):]: f[k] for k in f.files}
    return outs, checkpoint.load(_carry_path(path), template)


def _config(text):
    from ..config import Config

    d = json.loads(text)
    return Config(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


def _worker(args):
    from .. import interop, ops
    from .multihost import initialize

    torch.set_num_threads(1)  # ranks share the host's cores
    initialize(args.coordinator, args.nprocs, args.pid, backend="gloo", timeout_s=args.timeout)
    try:
        with np.load(args.inputs) as f:
            cfg = _config(str(f["cfg"]))
            groups = {k[len("groups/"):]: f[k] for k in f.files if k.startswith("groups/")}
        mesh = make_mesh(mp=args.mp, device="cpu" if args.cpu else "cuda")
        stacked = interop.group_from_numpy(groups, "cpu")
        carry = checkpoint.load(_carry_path(args.inputs),
                                carry_template(cfg, stacked.pts.shape[1], stacked.pts.dtype))
        stream = [tree.index(stacked, k) for k in range(stacked.pts.shape[0])]
        sync = torch.cuda.synchronize if mesh.device.type == "cuda" else (lambda: None)
        round_ms, calls = [], []
        marks = []

        def tick(c, out):
            sync()
            now = time.perf_counter()
            round_ms.append((now - marks[0]) * 1e3)
            calls.append(mesh.mp_group.calls - marks[1])
            marks[:] = [now, mesh.mp_group.calls]

        ops.reset_launches()
        sync()
        marks[:] = [time.perf_counter(), mesh.mp_group.calls]
        local, outs = run_batched(cfg, mesh, carry, stream, callback=tick)
        launches = {name: {",".join(map(str, k)): n for k, n in fn.launches_by_shape.items()}
                    for name, fn in ops.wrappers().items()}
        stats = dict(rank=dist.get_rank(), dp=mesh.dp, mp=mesh.mp, dp_index=mesh.dp_index,
                     mp_index=mesh.mp_index, device=str(mesh.device), launches=launches,
                     collectives_per_round=calls, round_ms=round_ms,
                     shard_rows=int(local.map.tab.shape[-3]),
                     rows=int(local.map.tab.shape[-3]) * mesh.mp)
        with open(f"{args.out}.rank{dist.get_rank()}.json", "w") as f:
            json.dump(stats, f)
        whole = gather_carry(mesh, local)
        outs = gather_outputs(mesh, outs)
        if dist.get_rank() == 0:
            np.savez(args.out, **{f"out/{k}": v for k, v in interop.to_numpy(outs).items()})
            checkpoint.save(_carry_path(args.out), whole)
    finally:
        dist.destroy_process_group()


def run_local(inputs, out, nprocs: int, mp: int, device="cuda", deadline_s: float = 300.0):
    """The worker in `nprocs` processes of this host, process 0 the
    coordinator on a free localhost port, process i logging to
    OUT.rank<i>.log (OUT without its suffix). A process that fails, or a
    world past `deadline_s` (also each collective's timeout), fails the
    call and its peers are killed. Returns every process's stats; process
    0's outputs are in OUT (`load_outputs`)."""
    import socket
    import subprocess
    import sys

    out = pathlib.Path(out)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    logs = [out.with_suffix(f".rank{i}.log") for i in range(nprocs)]
    cmd = [sys.executable, "-m", "malio_tpu_torch.distributed.sharding", "--coordinator",
           f"127.0.0.1:{port}", "--nprocs", str(nprocs), "--mp", str(mp), "--inputs",
           str(inputs), "--out", str(out), "--timeout", str(deadline_s)]
    cmd += ["--cpu"] if torch.device(device).type == "cpu" else []
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    root = pathlib.Path(__file__).resolve().parents[2]
    procs = []
    try:
        for i in range(nprocs):
            with open(logs[i], "w") as f:
                procs.append(subprocess.Popen(cmd + ["--pid", str(i)], cwd=root, env=env,
                                              stdout=f, stderr=subprocess.STDOUT))
        end = time.monotonic() + deadline_s
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > end:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for i, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"process {i} of {nprocs} (mp={mp}) exited {p.returncode}:\n"
                               + logs[i].read_text()[-3000:])
    return [json.loads(pathlib.Path(f"{out}.rank{i}.json").read_text()) for i in range(nprocs)]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Replay batched rounds over a dp x mp mesh")
    ap.add_argument("--coordinator", required=True, help="HOST:PORT of process 0")
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--mp", type=int, default=None)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a collective may wait before the process fails")
    _worker(ap.parse_args())
