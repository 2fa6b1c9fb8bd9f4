"""The port stands alone: no module of ``src/repro_torch`` and not the
chip smoke script imports JAX or anything of the JAX package."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _banned(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BANNED)


def imported_modules(path: pathlib.Path) -> list[str]:
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module or "")
            if node.module in BANNED:       # ``from repro import x``
                out += [f"{node.module}.{a.name}" for a in node.names]
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [m for m in imported_modules(path) if _banned(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_catches_each_banned_form(tmp_path):
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro.core import engine", "from repro import compat",
                 "import repro.models", "def f():\n    import jax\n"):
        p = tmp_path / "m.py"
        p.write_text(line + "\n")
        assert any(_banned(m) for m in imported_modules(p)), line
    p = tmp_path / "ok.py"
    p.write_text("import repro_torch.core\nfrom repro_torch import bridge\n"
                 "import torch\n")
    assert not any(_banned(m) for m in imported_modules(p))
