"""malio_tpu_torch: the multi-LiDAR inertial odometry pipeline in PyTorch,
with hand-written CUDA kernels for Hopper (sm_90a).

A port of the JAX package `malio_tpu`, module for module. It imports
`torch` and numpy only. Entry points (`runner.run_sequence`,
`pipeline.init_carry`, `pipeline.step`) run on the card unless the caller
passes `device="cpu"`.
"""
import torch

# full-precision f32 matmuls and convolutions, as the JAX package pins
# "highest" matmul precision: TF32 would corrupt the covariance algebra
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
