"""The port stands on its own: no module of `barretenberg_tpu_torch`, nor
`chip_smoke.py`, imports JAX or the JAX package, and the whole package
imports on a machine without CUDA, nvcc or triton."""

import ast
import importlib
import pathlib
import pkgutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "barretenberg_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "barretenberg_tpu")


def _sources():
    return sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_sources_exist():
    names = {p.name for p in _sources()}
    assert {"chip_smoke.py", "convert.py", "prover.py", "field_kernels.py"} <= names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_jax_package(path):
    assert not (_imported_roots(path) & set(FORBIDDEN))


def test_every_module_imports_without_a_gpu_toolchain():
    import barretenberg_tpu_torch

    names = [
        m.name
        for m in pkgutil.walk_packages(barretenberg_tpu_torch.__path__, "barretenberg_tpu_torch.")
    ]
    assert len(names) > 30
    for name in names:
        importlib.import_module(name)


def test_kernel_build_watches_every_source_and_header():
    """Each CUDA source is built, and rebuilt when it or any header it
    includes (directly or through another header) changes."""
    from barretenberg_tpu_torch.kernels import build

    csrc = PACKAGE / "csrc"
    assert set(build.SOURCES) == {p.stem for p in csrc.glob("*.cu")}
    assert set(build.SOURCES) == set(build._SIGNATURES)
    deps = {name: {pathlib.Path(d).name for d in build._deps(name)} for name in build.SOURCES}
    assert deps["msm_kernels"] == {"msm_kernels.cu", "point.cuh", "field.cuh"}
    assert deps["point_kernels"] == {"point_kernels.cu", "point.cuh", "field.cuh"}
    assert deps["field_kernels"] == {"field_kernels.cu", "field.cuh"}
    assert set().union(*deps.values()) == {p.name for p in csrc.glob("*.cu*")}


def test_package_import_pulls_in_no_jax():
    code = (
        "import sys, pkgutil, importlib, barretenberg_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'barretenberg_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'barretenberg_tpu', 'triton')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


def test_cuda_request_without_a_card_raises():
    import torch

    from barretenberg_tpu_torch.config import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device(None)


def test_chip_smoke_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True, text=True, cwd=ROOT
    )
    assert res.returncode != 0 and res.stdout.strip() == ""
