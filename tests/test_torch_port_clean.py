"""The PyTorch port runs where JAX is not installed: no module of
cwfa_tpu_torch, nor chip_smoke.py, nor a script that drives the port, imports
JAX, the JAX package, Triton, msgpack or PIL, and none imports matplotlib or
h5py when it is imported (only inside the function that plots or reads an
HDF5 PSF, as the card's host has neither)."""

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


def _import_time_roots(path: Path):
    """The roots imported when the module is imported: every import
    statement outside a function body."""
    todo = list(ast.parse(path.read_text(), str(path)).body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        todo.extend(ast.iter_child_nodes(node))


def test_port_files_found():
    assert len(FILES) > 15
    names = {str(p.relative_to(ROOT)) for p in FILES}
    # the training slice's modules are among them
    assert {"cwfa_tpu_torch/engine/trainer.py", "cwfa_tpu_torch/engine/optim.py",
            "cwfa_tpu_torch/engine/losses.py",
            "cwfa_tpu_torch/data/dataset.py"} <= names
    # and the training CLI's
    assert {"cwfa_tpu_torch/cli/train.py", "cwfa_tpu_torch/engine/metrics.py",
            "cwfa_tpu_torch/data/splits.py",
            "cwfa_tpu_torch/utils/projections.py",
            "cwfa_tpu_torch/utils/seeding.py", "cwfa_tpu_torch/utils/plots.py",
            "cwfa_tpu_torch/utils/png.py",
            "cwfa_tpu_torch/utils/tb_writer.py"} <= names
    # and those of the OOD and deconvolution CLIs
    assert {"cwfa_tpu_torch/cli/ood.py", "cwfa_tpu_torch/cli/deconvolve.py",
            "cwfa_tpu_torch/engine/ood.py", "cwfa_tpu_torch/ops/fft_conv.py",
            "cwfa_tpu_torch/ops/deconv.py", "cwfa_tpu_torch/data/psf.py",
            "cwfa_tpu_torch/data/synthetic.py"} <= names
    # and more than one device, and the profiling helpers
    assert {"cwfa_tpu_torch/parallel/__init__.py",
            "cwfa_tpu_torch/parallel/distributed.py",
            "cwfa_tpu_torch/parallel/mesh.py",
            "cwfa_tpu_torch/utils/profiling.py"} <= names


def test_import_time_scan_sees_nested_imports(tmp_path):
    path = tmp_path / "probe.py"
    path.write_text("import a\nif x:\n    import b\n"
                    "def f():\n    import c\n")
    assert set(_imported_roots(path)) == {"a", "b", "c"}
    assert set(_import_time_roots(path)) == {"a", "b"}


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_matplotlib_at_import_time(path):
    assert "matplotlib" not in set(_import_time_roots(path))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_h5py_at_import_time(path):
    assert "h5py" not in set(_import_time_roots(path))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_cwfa_tpu_or_triton(path):
    assert not set(_imported_roots(path)) & FORBIDDEN
