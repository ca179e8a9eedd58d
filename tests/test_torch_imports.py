"""The PyTorch port stands alone: importing ``repro_torch`` and every one
of its modules loads neither ``jax`` nor any module of the JAX package."""
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(names))
print(",".join(bad))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.splitlines()
    # one imported name per source file: every module was reached
    assert int(n_modules) == len(list((SRC / "repro_torch").rglob("*.py")))
    assert bad == "", f"the port loaded {bad}"


def test_chip_smoke_stands_alone():
    """chip_smoke.py imports nothing of JAX or the JAX package, and without
    a CUDA device it exits non-zero before printing any result."""
    import ast
    path = SRC.parent / "chip_smoke.py"
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module)
    roots = {m.split(".")[0] for m in mods}
    assert not roots & {"jax", "repro"}, roots
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(path)], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
