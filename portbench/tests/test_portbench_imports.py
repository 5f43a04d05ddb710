"""No module that a run loads is JAX or the JAX package, compared by whole
top-level name (malio_tpu_torch begins with malio_tpu), and the reference
loads nothing of the program."""
from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
HERE = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "malio_tpu"}


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint('\\n'.join(sys.modules))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return {m.split(".")[0] for m in out.stdout.split()}


def test_a_run_loads_no_jax():
    """run.py, every mode, every metric reader, the reference, the tools
    and the program modules the modes call."""
    code = "\n".join([
        "import runpy, pathlib, sys",
        "sys.path.insert(0, '.')",
        "runpy.run_path('portbench/run.py', run_name='portbench_run')",
        "from portbench.core import bench",
        *[f"bench.load_module('{k}', '{p.stem}')" for k in ("modes", "metrics")
          for p in sorted((HERE / k).glob("*.py")) if p.stem != "__init__"],
        "import portbench.reference.replay, portbench.tools.readings",
        "import malio_tpu_torch.runner, malio_tpu_torch.online, malio_tpu_torch.batched",
        "import malio_tpu_torch.graph, malio_tpu_torch.ops.knn, malio_tpu_torch.ops.merge",
        "import malio_tpu_torch.ops.deskew",
    ])
    top = _loaded(code)
    assert "malio_tpu_torch" in top and "portbench" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded("import sys; sys.path.insert(0, '.')\nimport portbench.reference.replay")
    assert not top & (FORBIDDEN | {"malio_tpu_torch"}), top
    for path in (HERE / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"malio_tpu_torch"}, (path, n)


def test_the_whole_name_is_compared():
    from portbench.core.env import forbidden_modules

    assert forbidden_modules(["malio_tpu_torch", "malio_tpu_torch.ops", "jaxtyping"]) == []
    assert forbidden_modules(["malio_tpu.pipeline", "jax", "flax.core"]) == [
        "flax.core", "jax", "malio_tpu.pipeline"]
