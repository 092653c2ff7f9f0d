"""The port stands alone: neither regcn_torch nor chip_smoke.py imports jax
or anything of regcn_tpu."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "regcn_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "regcn_tpu")


def imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_regcn_tpu_import(path):
    bad = [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a process where jax and
    regcn_tpu cannot be imported at all."""
    modules = [".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
               for p in PORT_FILES if p.parent != ROOT]
    code = (
        "import sys, importlib\n"
        f"for name in {FORBIDDEN!r}: sys.modules[name] = None\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in ('jax', 'regcn_tpu') and sys.modules[k] is not None"
        " for k in sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_the_hyperbolic_slice_is_covered():
    """The modules of the hyperbolic slice are among the files checked above."""
    checked = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for name in ("ops", "decoders", "layers", "model", "optim", "train"):
        assert f"regcn_torch/hyperbolic/{name}.py" in checked
    assert "regcn_torch/ops/streaming_ce.py" in checked
