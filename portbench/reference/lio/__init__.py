"""The benchmark's reference round: a frozen copy of the fusion round of
malio_tpu_torch (pipeline.step_eager and the modules it runs, the IMU
initialisation of runner.py), taken once, never imported from the
program, and held still while the program changes. Being a copy, it shares any fault
the program had when it was taken; tests/test_portbench_reference_parity.py
holds it to the JAX package's round (the original the program was ported
from) on the CPU, and every run holds the program's poses to the drive
its inputs were made from (core/check.ate).

What was taken out: the captured CUDA graph (pipeline.step,
scan_steps), the hand-written kernels (ops/ keeps the plain PyTorch
version of each: the k-NN window, the spline deskew, the merge), the
world correction and the replay loop (reference/replay.py drives the
round here). What was added: the dtype that P and Pi are carried in
is a switch (device.set_carry_dtype), float64 as the configurations
state, float32 for the f32_carry control.
"""
