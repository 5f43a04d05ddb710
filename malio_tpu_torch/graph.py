"""One fusion round as a captured CUDA graph: the port's `jax.jit` of
`pipeline.step` (malio_tpu/pipeline.py:175) and, replayed K times with
the carry threaded through on the device, its `lax.scan`
(`scan_steps`, malio_tpu/pipeline.py:163-172).

`CompiledRound(fn, carry, group)` captures a functional round
`fn(carry, group) -> (carry, out)` over NamedTuples of tensors on one card
once. Static buffers (`carry_in`, `group_in`) hold its inputs; a warm-up
round on a side stream first makes what a capture cannot (the kernels'
builds, cuBLAS's handle and workspace on that stream, the merge kernel's
scratch, device constants cached on first use); the capture then records
the round into a graph with a memory pool of its own. A call copies its
inputs in, replays and hands out clones, so a carry a caller keeps is
never overwritten by a later round, as JAX arrays are immutable. A
capture or launch that fails raises; there is no eager fall-back.

The kernels' wrappers count a launch recorded into the graph apart from
the launches they make (`ops.count_launch`); each replay adds the round's
recorded launches to their counts (`ops.add_launches`). A round over an
mp group (`shard`, a distributed.collectives.ShardGroup over NCCL) holds
its collectives in the graph too, and the group counts them the same way.

The same capture serves the back end's iterative programs (posegraph's
LM solvers and ICP, ba.optimize_window): `repeat` replays one iteration n
times on the same inputs, the counterpart of their lax.scan. `compiled`
keeps every capture by program, static arguments and shapes (`run` picks
the capture or the eager loop), as jax.jit caches by static arguments and
shapes.
"""
from __future__ import annotations

import ctypes
import gc
import time

import torch

from . import ops, tree


def _graph_nodes(g) -> int:
    """Nodes of a captured graph, as libcuda (cuGraphGetNodes) counts them."""
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(ctypes.c_void_p(g.raw_cuda_graph()), None,
                                                       ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes: CUDA error {err}")
    return n.value


def _copy(dst, src):
    for d, s in zip(tree.leaves(dst), tree.leaves(src)):
        d.copy_(s)


def _clone(t):
    return tree.map_tensors(torch.clone, t)


class CompiledRound:
    """`fn` captured on the card of `carry` at the shapes of (carry, group).

    Attributes: `launches` (kernel -> shape -> launches a replay),
    `collectives` (the collectives a replay makes over `shard`: "calls"
    and output bytes by kind; {} without), `nodes` (graph nodes),
    `warmup_s` and `capture_s` (host seconds of the warm-up round and of
    the capture with instantiation), `pool_bytes` (the card memory the
    capture reserved: its pool, with the outputs), `replays`. Every rank
    of `shard` must capture its round at the same call: the warm-up's
    first collective creates the group's communicator, and the ranks'
    graphs hold the same collectives in the same order."""

    def __init__(self, fn, carry, group, shard=None):
        dev = tree.leaves(carry)[0].device
        self.carry_in = _clone(carry)
        self.group_in = _clone(group)
        inputs = {t.untyped_storage().data_ptr() for t in tree.leaves((self.carry_in, self.group_in))}

        def body(c, g):  # outputs in storage of their own: an input passed through is copied
            return tree.map_tensors(
                lambda t: t.clone() if t.untyped_storage().data_ptr() in inputs else t, fn(c, g))

        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            body(self.carry_in, self.group_in)
        torch.cuda.synchronize(dev)
        self.warmup_s = time.perf_counter() - t0

        self.graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept to count its nodes
        before = ops.captured()
        before_coll = dict(shard.captured) if shard is not None else {}
        torch.cuda.empty_cache()  # as the capture does: what it reserves after is its pool
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph, stream=stream, capture_error_mode="thread_local"):
            self.carry_out, self.out = body(self.carry_in, self.group_in)
        self.nodes = _graph_nodes(self.graph)
        self.graph.instantiate()
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        after = ops.captured()
        self.launches = {
            name: {s: n - before[name].get(s, 0) for s, n in rec.items()
                   if n != before[name].get(s, 0)}
            for name, rec in after.items()
        }
        self.shard = shard
        self.collectives = {} if shard is None else {
            k: n - before_coll.get(k, 0) for k, n in shard.captured.items()
            if n != before_coll.get(k, 0)}
        self.replays = 0

    def _replay(self):
        self.graph.replay()
        self.replays += 1
        ops.add_launches(self.launches, 1)
        if self.shard is not None:
            self.shard.add(self.collectives)

    def __call__(self, carry, group):
        """One round: (new carry, out), both fresh tensors."""
        _copy(self.carry_in, carry)
        _copy(self.group_in, group)
        self._replay()
        return _clone(self.carry_out), _clone(self.out)

    def _loop(self, carry, n, group_at):
        """n replays from `carry`, the group of replay k from group_at(k)
        (None: the group already in place), the carry going from replay to
        replay through the static buffers: one clone of it comes out, and
        the outputs stacked on n."""
        outs = tree.map_tensors(
            lambda a: torch.empty((n,) + tuple(a.shape), dtype=a.dtype, device=a.device),
            self.out)
        if n == 0:
            return _clone(carry), outs
        _copy(self.carry_in, carry)
        for k in range(n):
            g = group_at(k)
            if g is not None:
                _copy(self.group_in, g)
            if k:
                _copy(self.carry_in, self.carry_out)
            self._replay()
            _copy(tree.index(outs, k), self.out)
        return _clone(self.carry_out), outs

    def scan(self, carry, groups):
        """K rounds over groups stacked on a leading K axis: the carry after
        the last, and the outputs stacked on K (a lax.scan over groups)."""
        return self._loop(carry, tree.leaves(groups)[0].shape[0],
                          lambda k: tree.index(groups, k))

    def repeat(self, carry, group, n: int):
        """n rounds on one group: the carry after the last, and the outputs
        stacked on n (a lax.scan whose body sees the same inputs every
        step, as an iterative solver's)."""
        return self._loop(carry, n, lambda k: None if k else group)


def signature(*trees):
    """Shapes, dtypes and devices of the tensor leaves: what a capture is
    specific to."""
    return tuple((tuple(t.shape), t.dtype, t.device) for t in tree.leaves(trees))


# every capture, by its key: (program name, static arguments, signature)
_programs = {}


def compiled(key, fn, carry, group, shard=None) -> CompiledRound:
    """`fn` captured for `key` (at the first call with that key), the
    port's counterpart of a jax.jit cache entry."""
    r = _programs.get(key)
    if r is None:
        r = _programs[key] = CompiledRound(fn, carry, group, shard)
    return r


def release():
    """Drop every capture, its graph and its pool. A process group whose
    collectives a graph holds (NCCL) is destroyed only after its graphs:
    NCCL's teardown waits until no graph refers to the communicator."""
    _programs.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def captures(program=None):
    """The captures so far, in capture order, as (key, CompiledRound): all,
    or those of one program (a key's first entry)."""
    return [(k, r) for k, r in _programs.items() if program is None or k[0] == program]


def run(key, fn, carry, group, n: int, eager: bool):
    """n steps of fn(carry, group) -> (carry, out) on one group, the carry
    threaded through: the carry after the last and the outputs stacked on
    a leading n. eager=True launches fn op by op (the CPU's way); else the
    capture of fn for `key` replays n times."""
    if not eager:
        return compiled(key, fn, carry, group).repeat(carry, group, n)
    outs = []
    for _ in range(n):
        carry, out = fn(carry, group)
        outs.append(out)
    return carry, tree.stack(outs)
