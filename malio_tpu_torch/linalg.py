"""Matrix products of the filter's covariance algebra over a batch of
sequences.

On the CPU, MKL's gemm result depends on where an operand sits in memory
(its alignment picks the kernel's peel loop), so a sequence's product
would change with its place in the batch. There `mm` multiplies each
sequence's slab on its own freshly allocated (aligned) copy, and a
sequence of a batch gets the bits it gets alone. On the card it is one
cuBLAS call for the whole batch.
"""
from __future__ import annotations

import torch


def mm(a, b):
    """a @ b with leading batch axes, the first of them the sequence."""
    if a.device.type != "cpu" or (a.dim() < 3 and b.dim() < 3):
        return a @ b
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a = a.expand(*lead, *a.shape[-2:])
    b = b.expand(*lead, *b.shape[-2:])
    return torch.stack([x.clone() @ y.clone() for x, y in zip(a, b)])
