"""The PyTorch port imports no JAX and nothing of the JAX package.

An AST scan of every ``.py`` file of the port and of ``chip_smoke.py``:
a ``sys.modules`` check would prove nothing here, because the test
environment imports JAX before any test runs.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = "actor_critic_algs_on_tensorflow_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex",
             "actor_critic_algs_on_tensorflow_tpu")

_FILES = sorted((ROOT / PORT).rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call):
            # importlib.import_module("...") / __import__("...")
            name = getattr(node.func, "attr", getattr(node.func, "id", ""))
            if name in ("import_module", "__import__") and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield node.lineno, arg.value


def _forbidden(module):
    top = module.split(".")[0]
    return top != PORT and top in FORBIDDEN


def test_the_scan_covers_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in _FILES}
    assert f"{PORT}/ops/linear_scan.py" in names
    assert f"{PORT}/algos/ppo.py" in names
    assert "chip_smoke.py" in names


@pytest.mark.parametrize("path", _FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_file_imports_no_jax(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    bad = [f"{path.name}:{line} imports {mod}"
           for line, mod in _imported_modules(tree) if _forbidden(mod)]
    assert not bad, bad


def test_the_scan_catches_a_jax_import():
    src = "import jax.numpy as jnp\nfrom actor_critic_algs_on_tensorflow_tpu.ops import gae\n"
    found = [m for _, m in _imported_modules(ast.parse(src)) if _forbidden(m)]
    assert found == ["jax.numpy", "actor_critic_algs_on_tensorflow_tpu.ops"]
    ok = f"from {PORT}.ops import gae\nimport torch\n"
    assert not [m for _, m in _imported_modules(ast.parse(ok)) if _forbidden(m)]
