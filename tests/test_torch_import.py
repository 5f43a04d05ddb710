"""The port stands alone: importing every module of `malio_tpu_torch` (its
`distributed` package too) loads neither JAX nor the JAX package, no
source of the port or of `chip_smoke.py` imports them, and
`chip_smoke.py` refuses to run (non-zero exit, no result line) where no
CUDA device is present."""
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|malio_tpu)(?:[.\s,]|$)", re.M)

_PROBE = """
import importlib, pkgutil, sys
import malio_tpu_torch
for m in pkgutil.walk_packages(malio_tpu_torch.__path__, "malio_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "malio_tpu"))
print(len(sys.modules), bad)
sys.exit(1 if bad else 0)
"""


def test_import_loads_no_jax():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_import_no_jax():
    files = sorted((ROOT / "malio_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    names = {f.relative_to(ROOT).as_posix() for f in files}
    for mod in ("online", "checkpoint", "ba", "smoother", "posegraph", "segment", "batched",
                "tree", "linalg", "metrics", "run_dataset", "ops/merge", "eval/ate", "io/pcd",
                "io/dataset", "io/export", "io/native", "io/player", "distributed/__init__",
                "distributed/sharding", "distributed/multihost", "distributed/collectives",
                "soak", "run_synthetic", "run_batched", "play", "debug_pipeline", "trace"):
        assert f"malio_tpu_torch/{mod}.py" in names, mod
    bad = [str(f.relative_to(ROOT)) for f in files if FORBIDDEN.search(f.read_text())]
    assert not bad, bad


def test_chip_smoke_refuses_without_a_card():
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    for line in res.stdout.splitlines():
        if line.startswith("{"):
            assert "ok" not in json.loads(line), line
