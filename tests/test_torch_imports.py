"""The port stands alone: no module of ``src/repro_torch`` and none of
the scripts ``chip_smoke.py``, ``chip_kernels.py`` and ``chip_lm_tf.py``
imports ``jax`` or the reference package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_kernels.py", ROOT / "chip_lm_tf.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    names = list(_imported(ast.parse(path.read_text(), str(path))))
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.serve, repro_torch.convert, "
            "repro_torch.core.mapping, repro_torch.core.composite, "
            "repro_torch.core.exact, repro_torch.core.multilevel, "
            "repro_torch.core.sparse, repro_torch.kernels.ops, "
            "repro_torch.models.transformer, repro_torch.serve.engine, "
            "repro_torch.configs, repro_torch.launch.serve, "
            "repro_torch.serve.cluster, repro_torch.serve.transport, "
            "repro_torch.serve.fleet, repro_torch.serve.rm, "
            "repro_torch.serve.trace, repro_torch.launch.placement; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_subprocess_worker_child_runs_the_port():
    """The code ``SubprocessWorker.start`` hands ``python -c``: its import
    part, run in a fresh interpreter, loads the port's transport module as
    the worker, and neither JAX nor the reference package."""
    from repro_torch.serve import transport
    imports, call = transport.WORKER_COMMAND.rsplit("; ", 1)
    assert call == "sys.exit(worker_main())"
    code = (imports + "; import sys; "
            "print(worker_main.__module__); "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.split("\n")[0] == "repro_torch.serve.transport"
