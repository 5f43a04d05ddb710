"""A cell of the benchmark, found by name: its workload file
(workloads/<cell>.json), the deployment it names (configs/<config>.json),
the metrics BENCHMARK.json asks of it, and the inputs made from the seed."""
from __future__ import annotations

import concurrent.futures
import dataclasses
import importlib.util
import json
import multiprocessing
import os
import sys
import time
import types

import numpy as np

from . import generator, machine
from .env import ROOT

HERE = ROOT / "portbench"


def log(*a):
    """An earlier line of the run's standard output."""
    print(*a, flush=True)


def note(*a):
    """A line of the run's standard error."""
    print(*a, file=sys.stderr, flush=True)


def load_json(path):
    return json.loads(path.read_text())


def load_module(kind, name):
    """portbench/<kind>/<name>.py, loaded by path (a name may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path.relative_to(ROOT)})")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(cell_name, benchmark):
    """The end-to-end and per-layer metrics BENCHMARK.json asks of a cell:
    those whose `workloads` name it; an end-to-end metric without the key
    is every cell's, a per-layer one without it is every cell's that
    reports the end-to-end metric it moves."""
    e2e = [m for m in benchmark["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in benchmark.get("per_layer", [])
                 if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per_layer


def make_sequence(args):
    """(imu, rounds, trajectory) of a deployment (its config file's dict)
    from a seed, for a duration."""
    config, seed, duration = args
    c, s, w = config["config"], config["sensors"], config["world"]
    return generator.generate(
        duration, seed, s["points"], c["extrinsic_T"], c["extrinsic_R"], phase=s["phase"],
        imu_rate=s["imu_rate"], scan_rate=s["scan_rate"], range_max=w["range_max"],
        noise=s["noise"], imu_noise_gyr=s["imu_noise_gyr"], imu_noise_acc=s["imu_noise_acc"],
        traj_kwargs=w["traj_kwargs"], world_kwargs=w["world_kwargs"])


@dataclasses.dataclass
class Cell:
    name: str
    seed: int
    seconds: float
    trace: bool
    workload: dict
    config: dict
    t0: float  # host clock at the run's start: set-up counts from here
    device: str = "cuda"
    window_t0: float | None = None
    sampler: machine.Sampler | None = None

    @classmethod
    def load(cls, name, seed, seconds, trace, t0, device="cuda"):
        workload = load_json(HERE / "workloads" / f"{name}.json")
        config = load_json(HERE / "configs" / f"{workload['config']}.json")
        return cls(name, int(seed), float(seconds), bool(trace), workload, config, t0, device)

    @property
    def params(self):
        return self.workload["params"]

    def program_config(self, **overrides):
        """The deployment as the program's Config (lists as tuples)."""
        from malio_tpu_torch.config import Config

        kw = {k: tuple(v) if isinstance(v, list) else v for k, v in self.config["config"].items()}
        kw.update(overrides)
        return Config(**kw)

    def reference_config(self, **overrides):
        """The same deployment for the reference: a plain namespace of the
        file's keyword arguments, built without the program."""
        kw = {k: tuple(v) if isinstance(v, list) else v for k, v in self.config["config"].items()}
        kw.update(overrides)
        return types.SimpleNamespace(**kw)

    def sequence(self, seed, duration):
        """(imu, rounds, trajectory) of the deployment's sensors in its world
        for `duration` seconds, from `seed`."""
        return make_sequence((self.config, seed, duration))

    def sequences(self, seeds, duration):
        """Several sequences, made in parallel processes (spawned, at most
        one a core and eight), as sequence() makes each."""
        ctx = multiprocessing.get_context("spawn")
        n = max(1, min(len(seeds), os.cpu_count() or 1, 8))
        with concurrent.futures.ProcessPoolExecutor(n, mp_context=ctx) as ex:
            return list(ex.map(make_sequence, [(self.config, s, duration) for s in seeds]))

    def groups(self, imu, rounds):
        """The measure groups of a sequence at the deployment's capacities."""
        c = self.config["config"]
        return generator.assemble_groups(c["num_lidars"], c["max_raw_points"],
                                         c["max_imu_per_group"], c["imu_cont_len"],
                                         c["sync_lookahead"], imu, rounds)

    def start_window(self):
        """The end of set-up: returns set-up seconds. The card and the host
        are sampled from here to end_window()."""
        self.sampler = machine.Sampler(card=self.device == "cuda")
        self.sampler.start()
        self.window_t0 = time.perf_counter()
        return self.window_t0 - self.t0

    def end_window(self):
        """The window's close: returns its seconds and logs what the card
        and the host did in it."""
        window_s = time.perf_counter() - self.window_t0
        if self.sampler is not None:
            log("machine: " + json.dumps(self.sampler.stop()))
            self.sampler = None
        return window_s

    def sync(self):
        """Wait for the card's queue (nothing to wait for on the CPU)."""
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()

    def memory_peak(self):
        """The card's peak allocated bytes so far (0 on the CPU)."""
        if self.device != "cuda":
            return 0
        import torch

        return int(torch.cuda.max_memory_allocated())

    def release(self, graph):
        """Free the program's captures and cached blocks before the
        reference runs."""
        graph.release()
        if self.device == "cuda":
            import torch

            torch.cuda.empty_cache()

    def rng(self, salt=0):
        """A numpy generator for the harness's own draws (samples to check)."""
        return np.random.default_rng([self.seed, salt])
