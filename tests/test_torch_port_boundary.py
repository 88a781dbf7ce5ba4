"""The port's boundary: ``apex_tpu_torch`` and ``chip_smoke.py`` never
import JAX, flax or the JAX package, and the package imports without
``triton``, ``nvcc`` or a card.

A static AST scan, not ``sys.modules``: the process may have imported jax
for unrelated reasons (tests, a sitecustomize)."""

import ast
import importlib
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "apex_tpu")


def _port_files():
    files = sorted((ROOT / "apex_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.append(node.args[0].value)
    return {n.split(".")[0] for n in names if n}


def test_scan_covers_the_port():
    files = _port_files()
    assert len(files) >= 15
    assert ROOT / "apex_tpu_torch" / "serving" / "scheduler.py" in files


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_scanner_sees_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom apex_tpu.ops import x\n"
                 "importlib.import_module('flax.linen')\n")
    assert _imported_roots(f) >= {"jax", "apex_tpu", "flax"}


def test_package_imports_without_triton_or_nvcc():
    """In a fresh interpreter every module imports, no CUDA library is
    built or loaded, and neither triton nor jax is pulled in."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import apex_tpu_torch\n"
        "for m in pkgutil.walk_packages(apex_tpu_torch.__path__, "
        "'apex_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from apex_tpu_torch.ops import _build\n"
        "assert not _build._libs\n"
        "bad = [m for m in ('triton', 'apex_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-S", "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT) + ":" + ":".join(
                             p for p in sys.path if p)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_lazy_subpackages():
    pkg = importlib.import_module("apex_tpu_torch")
    assert pkg.serving.PagedDecodeEngine.__name__ == "PagedDecodeEngine"
    with pytest.raises(AttributeError):
        pkg.no_such_thing  # noqa: B018


def test_cuda_tensor_without_nvcc_raises_not_falls_back(monkeypatch):
    """No CUDA here: a kernel launch must raise, never run the twin, for
    every kernel of the port."""
    from apex_tpu_torch.ops import _build

    monkeypatch.setattr(_build.shutil, "which", lambda _n: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_library_path",
                        lambda n: pathlib.Path("/nonexistent") / f"{n}.so")
    assert {"xentropy_fwd", "xentropy_bwd", "segment_stats", "lamb_phase1",
            "lamb_phase2"} <= set(_build.KERNELS)
    before = dict(_build.launches)
    for name in _build.KERNELS:
        assert _build.source_path(name).exists(), name
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.library(name)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.launch(name, "apex_never_called", ())
    assert _build.launches == before
