"""The PyTorch port runs where JAX is not installed: no module of
cwfa_tpu_torch, nor chip_smoke.py, nor a script that drives the port, imports
JAX, the JAX package, Triton, msgpack or PIL."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# msgpack and PIL are not installed beside the card either: the port reads
# the JAX checkpoints with its own codec and TIFFs with the native runtime
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "cwfa_tpu", "triton",
             "msgpack", "PIL"}
FILES = (sorted((ROOT / "cwfa_tpu_torch").rglob("*.py"))
         + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "scripts").glob("torch_*.py"))
         + [ROOT / "scripts" / "profile_torch_port.py",
            ROOT / "scripts" / "profile_torch_serving.py"])


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_files_found():
    assert len(FILES) > 15
    names = {str(p.relative_to(ROOT)) for p in FILES}
    # the training slice's modules are among them
    assert {"cwfa_tpu_torch/engine/trainer.py", "cwfa_tpu_torch/engine/optim.py",
            "cwfa_tpu_torch/engine/losses.py",
            "cwfa_tpu_torch/data/dataset.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_cwfa_tpu_or_triton(path):
    assert not set(_imported_roots(path)) & FORBIDDEN
