"""The run's environment, set before torch is imported: every cache the
program or a library may write goes to a fixed directory inside the
checkout, and no library is let load JAX. The guard that no JAX module
is loaded compares whole top-level module names."""
from __future__ import annotations

import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
CACHE = ROOT / ".bench_cache"
# top-level module names the benchmark's process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "malio_tpu")


def prepare():
    """Cache directories inside the checkout (fixed paths, so the second
    run of a cell finds the first's builds) and the switches that keep
    libraries from loading JAX. The program builds its kernels into
    malio_tpu_torch/_build/, inside the checkout too."""
    dirs = {"CUDA_CACHE_PATH": CACHE / "nv", "TRITON_CACHE_DIR": CACHE / "triton",
            "TORCHINDUCTOR_CACHE_DIR": CACHE / "inductor",
            "TORCH_EXTENSIONS_DIR": CACHE / "torch_extensions"}
    for key, path in dirs.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[key] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is one of FORBIDDEN, compared
    whole: malio_tpu_torch is not malio_tpu."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)
