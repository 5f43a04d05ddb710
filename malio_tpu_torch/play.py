"""Interactive dataset player (counterpart of the JAX package's
scripts/player.py): the file_player GUI analog as a terminal TUI (the
MainWindow controls, mainwindow.cpp:20-53, without Qt) over
`io/player.DatasetPlayer`. Runs on the card unless --cpu is given.

  python -m malio_tpu_torch.play /path/to/City01 --config city [--rate 1.0]
      [--loop] [--skip-gap 3.0] [--cpu] [--f64] [--out trajectory.txt]
      [--headless] [--max-points N] [--map-capacity N]

Keys while playing:
  space  play/pause            +/-  double/halve the play rate
  f      seek +10 s            0-9  scrub to N*10% of the sequence
  l      toggle loop           q    quit (writes the trajectory so far)

--headless (or a non-TTY stdin) replays at full speed with no keyboard.
`main(argv)` returns the player's result (first lap's t, pos, quat,
n_rounds, laps), with `ate_m` where the tree has a Groundtruth.txt.
"""
from __future__ import annotations

import argparse
import pathlib
import select
import sys
import time

import numpy as np
import torch

from .run_dataset import CONFIGS


class _Keyboard:
    """Raw non-blocking single-key reader (restores the tty on exit)."""

    def __init__(self):
        self.enabled = sys.stdin.isatty()
        self._old = None

    def __enter__(self):
        if self.enabled:
            import termios
            import tty

            self._old = termios.tcgetattr(sys.stdin.fileno())
            tty.setcbreak(sys.stdin.fileno())
        return self

    def __exit__(self, *exc):
        if self._old is not None:
            import termios

            termios.tcsetattr(sys.stdin.fileno(), termios.TCSADRAIN, self._old)

    def poll(self):
        if not self.enabled:
            return None
        r, _, _ = select.select([sys.stdin], [], [], 0)
        if r:
            return sys.stdin.read(1)
        return None


def apply_key(p, key):
    """One key on player `p` (its clock, loop flag and seek_fraction).
    Returns False for quit, True otherwise (None: no key)."""
    if key == "q":
        return False
    if key == " ":
        p.clock.toggle()
    elif key == "+" or key == "=":
        p.clock.set_rate(p.clock.rate * 2)
    elif key == "-":
        p.clock.set_rate(p.clock.rate / 2)
    elif key == "f":
        p.clock.seek(p.clock.now() + 10.0)
    elif key == "l":
        p.loop = not p.loop
    elif key is not None and key.isdigit():
        p.seek_fraction(int(key) / 10.0)
    return True


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root")
    ap.add_argument("--config", choices=CONFIGS, default="city")
    ap.add_argument("--rate", type=float, default=1.0)
    ap.add_argument("--loop", action="store_true")
    ap.add_argument("--skip-gap", type=float, default=0.0,
                    help="skip idle stretches longer than this many data seconds (functional "
                         "skip-stop)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--out", default="trajectory.txt")
    ap.add_argument("--headless", action="store_true",
                    help="full-speed replay, no keyboard/no pacing")
    ap.add_argument("--max-points", type=int, default=0)
    ap.add_argument("--map-capacity", type=int, default=0)
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)

    from . import config as cfg_mod
    from .device import resolve_device
    from .eval import ate
    from .io.player import DatasetPlayer

    device = resolve_device("cpu" if args.cpu else "cuda")
    spec = CONFIGS[args.config]
    overrides = {}
    if args.max_points:
        overrides["max_raw_points"] = args.max_points
        overrides["max_points_per_scan"] = args.max_points
    if args.map_capacity:
        overrides["map_capacity"] = args.map_capacity
    cfg = getattr(cfg_mod, spec["factory"])(**overrides)

    realtime = not args.headless and sys.stdin.isatty()
    player = DatasetPlayer(
        args.root, cfg, spec["sensors"], dtype=torch.float64 if args.f64 else torch.float32,
        device=device, realtime=realtime, rate=args.rate, loop=args.loop,
        skip_gap=args.skip_gap or None,
    )
    print(f"{args.root}: {player.span:.1f} s of data, {len(player.entries)} stamps, "
          f"{cfg.num_lidars} LiDARs")

    last_ui = [0.0]
    latest = [None]

    def render(p):
        s = p.status()
        r = latest[0]
        pos = np.round(r["pos"], 2).tolist() if r else "-"
        state = "PLAYING" if s["playing"] else "PAUSED "
        sys.stdout.write(
            f"\r[{state} x{s['rate']:.2g}] t={s['playhead']:7.2f}/{s['span']:.1f}s round "
            f"{s['rounds']:5d} lap {s['lap']} pos={pos} drop={s['dropped_scans']}   ")
        sys.stdout.flush()

    def on_round(rec):
        latest[0] = rec

    with _Keyboard() as kb:

        def control(p):
            if not apply_key(p, kb.poll()):
                return False
            now = time.monotonic()
            if now - last_ui[0] > 0.25:
                last_ui[0] = now
                render(p)
            return True

        t0 = time.time()
        try:
            res = player.run(control=control if realtime else None, on_round=on_round)
        finally:
            player.close()
        dt = time.time() - t0

    n = res["n_rounds"]
    print(f"\n{n} rounds over {res['n_laps']} lap(s) in {dt:.1f}s")
    if n:
        ate.write_tum(args.out, res["t"], res["pos"], res["quat"])
        print(f"trajectory written to {args.out}")
        gt = pathlib.Path(args.root) / "Groundtruth.txt"
        if gt.exists():
            tg, pg, qg = ate.read_tum(gt)
            ia, ib = ate.associate(res["t"], tg - tg[0])
            if len(ia) > 10:
                err = ate.ate_rmse(res["pos"][ia], pg[ib], align=True)
                rot_err = ate.rot_ate_rmse(res["quat"][ia], qg[ib], res["pos"][ia], pg[ib],
                                           align=True)
                print(f"ATE RMSE (aligned) vs groundtruth: {err:.4f} m / "
                      f"{np.degrees(rot_err):.3f} deg")
                rpe = ate.se3_rpe(res["pos"][ia], res["quat"][ia], pg[ib], qg[ib])
                print(f"RPE RMSE (delta=10 frames) vs groundtruth: {rpe['trans_rmse']:.4f} m / "
                      f"{np.degrees(rpe['rot_rmse']):.3f} deg")
                res["ate_m"] = err
    return res


if __name__ == "__main__":
    main()
