"""The port and its chip scripts import no JAX, no flax and nothing of the JAX
package, not even its pure-Python modules, and no OpenCV: the card's machine
has none, so the port decodes PNG and JPEG itself.

An AST scan of the sources: a check of ``sys.modules`` cannot work here,
where the interpreter may import jax at start-up.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "torch_detection_tpu", "cv2")
SOURCES = sorted((ROOT / "torch_detection_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                      ROOT / "conv_precision.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_port():
    assert len(SOURCES) > 20
    assert _forbidden("torch_detection_tpu.ops") and not _forbidden("torch_detection_tpu_torch.ops")
    assert _forbidden("cv2") and ROOT / "torch_detection_tpu_torch/data/ops/jpeg.py" in SOURCES
