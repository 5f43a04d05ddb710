"""The reference's replay: sequences IMU-initialised as the program's
runner initialises them, then round by round through the frozen eager
round (reference/lio), several sequences in lockstep as one batch. It
imports nothing of the program and takes only the generated groups.

On a card the round is captured once as a CUDA graph (torch.cuda.graphs)
and replayed round after round: the same operations in the same order
as the eager round, launched at once, so that a whole drive's replay
takes seconds and not minutes."""
from __future__ import annotations

import numpy as np
import torch

from .lio import pipeline, runner, tree
from .lio import propagate as prop
from .lio.device import set_carry_dtype

# the per-round outputs the check compares
FIELDS = ("pos", "quat", "pose_cov", "end_time", "iterations", "n_effective", "map_size",
          "map_dropped", "nn_miss", "n_meas_dropped")


def _init_seq(cfg, groups, dtype, device):
    """(carry, the groups after the IMU initialisation, their time base)."""
    init = runner.ImuInitializer()
    start = 0
    prev_last = np.zeros(7)
    for gi, g in enumerate(groups):
        m = np.asarray(g["imu_mask"])
        last = np.asarray(g["imu"], np.float64)[m.nonzero()[0][-1]] if m.any() else prev_last
        if gi > 0 and init.done:
            start = gi
            break
        init.update(np.asarray(g["imu"], np.float64), g["imu_mask"])
        prev_last = last
    b0 = runner.group_base(groups[start])
    return runner.seed_carry(cfg, init, prev_last, b0, dtype, device), groups[start:], b0


# the controls: the reference computed in the nearest precision below the
# one the configurations state (README.md)
CONTROLS = {
    "f32_carry": dict(carry=torch.float32),  # P and Pi kept in f32 between rounds
    "tf32": dict(tf32=True),  # the points' float32 matmuls in TF32
}


class _Captured:
    """`fn(carry, group) -> (carry, out)` captured on the card at the shapes
    of (carry, group): a warm-up call on a side stream, then the capture.
    step(group) copies the group in, replays, and threads the carry on."""

    def __init__(self, fn, carry, group):
        self.carry = tree.map_tensors(torch.clone, carry)
        self.group = tree.map_tensors(torch.clone, group)
        inputs = {t.untyped_storage().data_ptr() for t in tree.leaves((self.carry, self.group))}

        def body(c, g):  # an input passed through comes out in storage of its own
            return tree.map_tensors(
                lambda t: t.clone() if t.untyped_storage().data_ptr() in inputs else t, fn(c, g))

        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            body(self.carry, self.group)
        torch.cuda.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            self.carry_out, self.out = body(self.carry, self.group)

    def step(self, group):
        for d, s in zip(tree.leaves(self.group), tree.leaves(group)):
            d.copy_(s)
        self.graph.replay()
        for d, s in zip(tree.leaves(self.carry), tree.leaves(self.carry_out)):
            d.copy_(s)
        return self.out


def replay(cfg, sequences, rounds, device="cuda", control=None, dtype=torch.float32):
    """The first `rounds` fused rounds of each sequence (a list of group
    lists) through the reference round, all sequences as one batch.
    Returns {field: array (S, rounds, ...)} on the host, end_time absolute
    (f64). `control` names one of CONTROLS; None is the reference itself:
    P and Pi in float64, float32 matmuls in float32 (TF32 off). `dtype`
    is the points' (float32 as the configurations state; float64 for the
    parity test with the JAX package). On a card the round is replayed as
    one CUDA graph, on the CPU launched op by op."""
    prec = dict(CONTROLS[control]) if control else {}
    tf32 = prec.pop("tf32", False)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    set_carry_dtype(prec.get("carry", torch.float64))
    graph = None
    try:
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        carries, streams, bases = [], [], []
        for groups in sequences:
            c, s, b0 = _init_seq(cfg, groups, dtype, device)
            carries.append(c)
            streams.append(s)
            bases.append(b0)
        rounds = min([rounds] + [len(s) for s in streams])
        carry = tree.stack(carries)
        captured = torch.device(device).type == "cuda"
        out = {f: [] for f in FIELDS}
        for k in range(rounds):
            arrays = []
            for b, s in enumerate(streams):
                a, bs = runner._chunk_arrays([s[k]], np_dtype, bases[b])
                bases[b] = float(bs[0])
                arrays.append(a)
            group = prop.MeasureGroup(**{
                f: torch.as_tensor(np.stack([a[f][0] for a in arrays])).to(device)
                for f in prop.MeasureGroup._fields})
            if captured:
                if graph is None:
                    graph = _Captured(
                        lambda c, g: pipeline.step_eager(cfg, c, g, device=device), carry, group)
                o = graph.step(group)
            else:
                carry, o = pipeline.step_eager(cfg, carry, group, device=device)
            for f in FIELDS:
                v = getattr(o, f).detach().cpu().numpy()
                out[f].append(v.astype(np.float64) + np.asarray(bases) if f == "end_time" else v)
        return {f: np.stack(v, axis=1) if v else np.zeros((len(sequences), 0)) for f, v in out.items()}
    finally:
        del graph
        set_carry_dtype(torch.float64)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
