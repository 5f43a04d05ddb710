"""Multi-rank execution over torch.distributed (counterpart of
malio_tpu/distributed/): `sharding` (the dp x mp mesh and the sharded
step), `multihost` (bring-up and cross-host meshes) and `collectives`
(the exact exchanges the sharded round makes)."""
