"""Batched multi-sequence replay (counterpart of the JAX package's
scripts/run_batched.py; BASELINE config 5): `batched.
synthetic_batched_benchmark`, B sequences in lockstep. Runs on the card
unless --cpu is given.

Usage:
  python -m malio_tpu_torch.run_batched [--batch B] [--duration S]
      [--points P] [--cpu] [--single-search]

`main(argv)` returns the benchmark's result dict (aggregate scans/s,
per-sequence scans/s, each sequence's aligned ATE, rounds).
"""
from __future__ import annotations

import argparse


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--duration", type=float, default=6.0)
    ap.add_argument("--points", type=int, default=2048)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--single-search", action="store_true")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)

    from .batched import synthetic_batched_benchmark

    r = synthetic_batched_benchmark(
        batch=args.batch, duration=args.duration, points=args.points,
        single_search=args.single_search, device="cpu" if args.cpu else "cuda",
    )
    print("batch=%d rounds=%d aggregate %.2f scans/s (%.2f per sequence)"
          % (args.batch, r["rounds"], r["aggregate_scans_per_sec"], r["per_seq"]))
    for b, a in enumerate(r["ates"]):
        print(f"  seq {b}: ATE aligned {a:.4f} m")
    return r


if __name__ == "__main__":
    main()
