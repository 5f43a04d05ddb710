"""Configuration for the LIO pipeline (the port's own copy).

Field for field the same dataclass as the JAX package's `config.Config`,
so one kwargs dict builds both. The one difference is the pair of kernel
switches: the tri-state `knn_kernel` / `deskew_kernel` select the
hand-written CUDA kernels (ops/knn.py, ops/deskew.py). `None` means on
for float32 CUDA tensors and off otherwise; `True` forces the wrapper
(which still runs the plain version on CPU tensors); `False` forces the
plain PyTorch version.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class Config:
    # --- sensors ---
    num_lidars: int = 1
    lid_type: Sequence[int] = (3,)  # 1=Livox 2=Velodyne 3=Ouster
    n_scans: Sequence[int] = (128,)
    point_filter_num: Sequence[int] = (8,)
    blind: float = 0.01
    timestamp_unit: int = 0  # 0 s, 1 ms, 2 us, 3 ns (preprocess.h:16)
    time_offset_lidar_to_imu: float = 0.0

    # --- extrinsics (flattened like the YAML: 3L trans, 4L quat wxyz) ---
    extrinsic_T: Sequence[float] = (0.0, 0.0, 0.0)
    extrinsic_R: Sequence[float] = (1.0, 0.0, 0.0, 0.0)
    extrinsic_est_en: bool = True
    ext_cov_init: float = 1e-6  # initial extrinsic covariance diagonal

    # --- filter ---
    max_iteration: int = 4
    gyr_cov: float = 0.1
    acc_cov: float = 0.1
    b_gyr_cov: float = 0.0001
    b_acc_cov: float = 0.0001
    imu_noise_source: str = "measured"  # "measured" | "config"
    converge_limit: float = 0.001
    laser_point_cov: float = 0.001
    single_search: bool = False
    deskew_kernel: bool | None = None  # CUDA spline-deskew kernel
    knn_kernel: bool | None = None  # CUDA k-NN select kernel

    # --- map ---
    filter_size_surf: float = 0.5
    filter_size_map: float = 0.5
    cube_len: float = 200.0
    det_range: float = 300.0
    mov_threshold: float = 1.5

    # --- correspondence / weighting laws ---
    plane_th: float = 0.1
    range_min: float = 0.0
    range_max: float = 1.0
    cov_threshold: float = 0.3
    point_cov_max: float = 0.002
    point_cov_min: float = 0.0005
    plane_cov_max: float = 1.0
    plane_cov_min: float = 0.7
    localize_cov_max: float = 2.0
    localize_cov_min: float = 0.4
    localize_thresh_max: float = 0.8
    localize_thresh_min: float = 0.3

    # --- static capacities ---
    max_points_per_scan: int = 16384  # downsampled, per LiDAR
    max_meas_points: int | None = None  # measurement-lane compaction cap
    max_raw_points: int = 65536  # per LiDAR before downsampling
    max_imu_per_group: int = 64
    imu_cont_len: int = 16
    traj_capacity: int = 128
    spline_capacity: int = 96
    epoch_capacity: int = 64
    map_capacity: int = 1 << 21
    knn_radius: int = 1
    knn_wide_radius: int = 0
    knn_wide_budget: int = 0

    # --- replay / misc ---
    init_time: float = 0.1
    imu_init_count: int = 10
    sync_lookahead: float = 0.2
    gravity: float = 9.81

    def __post_init__(self):
        L = self.num_lidars
        assert len(self.lid_type) == L
        assert len(self.extrinsic_T) == 3 * L
        assert len(self.extrinsic_R) == 4 * L


def city_config(**overrides) -> Config:
    """3-LiDAR City dataset configuration (config/City.yaml:1-50 +
    launch/mapping_city.launch:9-15)."""
    base = dict(
        num_lidars=3,
        lid_type=(3, 1, 1),
        n_scans=(128, 8, 8),
        point_filter_num=(8, 4, 4),
        blind=0.0,
        timestamp_unit=0,
        acc_cov=0.011197412605492375,
        gyr_cov=0.010270904839480961,
        b_acc_cov=0.00011751767903346351,
        b_gyr_cov=0.000091355383994881894,
        det_range=100.0,
        extrinsic_T=(0.215, 0.0, 0.018, -1.2574, 0.413, 0.0324, -1.306, -0.361, 0.042),
        extrinsic_R=(
            1, 0, 0, 0,
            0.6965018, -0.0037329, -0.0038405, 0.717535,
            0.0074645, 0.0000044, -0.0005919, -0.999972,
        ),
        max_iteration=3,
        filter_size_surf=0.5,
        filter_size_map=0.5,
        cube_len=1000.0,
        plane_th=0.4,
        cov_threshold=0.5,
        point_cov_max=0.00125,
        point_cov_min=0.00075,
        plane_cov_max=1.0,
        plane_cov_min=0.8,
        localize_cov_max=2.0,
        localize_cov_min=0.3,
        localize_thresh_max=0.7,
        localize_thresh_min=0.2,
        # reference-reach k-NN: ceil(sqrt(5)/0.5) = 5 voxels
        knn_wide_radius=5,
        knn_wide_budget=1024,
    )
    base.update(overrides)
    return Config(**base)


def flagship_config(points_per_lidar: int = 4096, map_slots: int = 1 << 21,
                    single_search: bool = False, **overrides) -> Config:
    """City 3-LiDAR flagship shape: the City estimator parameters with the
    benchmark capacities of the JAX package's batched._flagship_config —
    a 100 Hz IMU against 10 Hz rounds (16 IMU slots), 64-entry history and
    spline, 32 epochs, and the measurement-lane cap at 13/16 of the
    downsampled lanes (9984 at 4096 points per LiDAR)."""
    base = dict(
        max_raw_points=points_per_lidar,
        max_points_per_scan=points_per_lidar,
        max_imu_per_group=16,
        traj_capacity=64,
        spline_capacity=64,
        epoch_capacity=32,
        map_capacity=map_slots,
        single_search=single_search,
        max_meas_points=(3 * points_per_lidar) * 13 // 16,
    )
    base.update(overrides)
    return city_config(**base)


# The flagship synthetic world (batched.flagship_benchmark): a dense
# urban-like field of ~100k plane anchors seen out to 35 m.
FLAGSHIP_RANGE_MAX = 35.0
FLAGSHIP_WORLD = dict(n_planes=96, extent=40.0, patch=10.0, grid=0.3)
