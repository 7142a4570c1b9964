"""The port stands alone: nothing under src/repro_torch/ and nothing in
chip_smoke.py or the card scripts (scripts/torch_*.py) imports jax or the
repro package, not even lazily inside a function, and the port's serve path
imports with jax made unimportable."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("torch_*.py"))


def _imported_modules(source):
    """Every module an import statement, ``__import__`` or
    ``importlib.import_module`` names in ``source``, at any depth."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call):
            fn = getattr(node.func, "id", None) or getattr(
                node.func, "attr", None)
            if (fn in ("__import__", "import_module") and node.args
                    and isinstance(node.args[0], ast.Constant)):
                yield str(node.args[0].value)


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imported_modules(path.read_text()) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("name", ["_torch_ranks.py", "_torch_tp_cases.py"])
def test_rank_helpers_import_neither_jax_nor_repro(name):
    """The tensor-parallel tests' rank functions run in spawned ranks,
    which must start without JAX."""
    path = ROOT / "tests" / name
    bad = [m for m in _imported_modules(path.read_text()) if _forbidden(m)]
    assert not bad, f"tests/{name} imports {bad}"


def test_guard_sees_lazy_and_dotted_imports():
    src = ("def f():\n    import jax.numpy as jnp\n"
           "    from repro.kernels import ops\n"
           "    importlib.import_module('repro.models')\n")
    assert [m for m in _imported_modules(src) if _forbidden(m)] == [
        "jax.numpy", "repro.kernels", "repro.models"]
    assert not _forbidden("repro_torch.kernels")


def test_serve_path_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.launch.serve, repro_torch.bridge\n"
        "import repro_torch.runtime.engine, repro_torch.kernels.ops\n"
        "import repro_torch.models.jamba, repro_torch.models.moe\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.models.xlstm, repro_torch.kernels.fast_exp\n"
        "import repro_torch.kernels.piecewise_silu\n"
        "import repro_torch.runtime.spec_decode\n"
        "import repro_torch.core.selective_scan\n"
        "import repro_torch.runtime.prefix_cache, repro_torch.runtime.disagg\n"
        "import repro_torch.runtime.scheduler, repro_torch.runtime.frontend\n"
        "import repro_torch.models.transformer, repro_torch.configs.shapes\n"
        "import repro_torch.core.marca_model, repro_torch.core.op_graph\n"
        "import repro_torch.core.buffer_manager\n"
        "import repro_torch.launch.train, repro_torch.runtime.train_loop\n"
        "import repro_torch.optim, repro_torch.checkpoint\n"
        "import repro_torch.parallel.sharding, repro_torch.parallel.sp_scan\n"
        "import repro_torch.launch.mesh\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
