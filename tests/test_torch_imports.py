"""Import guard of the port: strive_tpu_torch and chip_smoke.py stand alone.

Every module of ``strive_tpu_torch/``, ``tools/`` and ``chip_smoke.py`` is
scanned (AST, so imports inside functions count too) for imports of jax,
flax, optax, strive_tpu, yaml or sklearn; matplotlib and the nuScenes
devkit may be imported only inside a function (the card's machine has none
of matplotlib, sklearn and the devkit; the devkit is needed only by the
preprocessing of the raw download). The package must import on a
machine without nvcc, triton or matplotlib, and a call on CPU tensors must
take the plain versions without launching (or building) a kernel.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from strive_tpu_torch.maps import crop_kernel, queries
from strive_tpu_torch.maps.store import DEFAULT_BOUNDS, synthetic_map_store
from strive_tpu_torch.utils import build

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "strive_tpu_torch"
# yaml too: the card's machine has no PyYAML (utils/config.py reads the
# config files itself); nor sklearn (kmeans.py)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "strive_tpu", "yaml",
             "sklearn"}
# imported only inside the functions that draw or read the raw download
FUNCTION_ONLY = {"matplotlib", "nuscenes"}
SOURCES = sorted(p.relative_to(ROOT).as_posix()
                 for p in [*PACKAGE.rglob("*.py"), *ROOT.glob("tools/*.py")]
                 ) + ["chip_smoke.py"]


def _imported_roots(path):
    """Top-level names of every absolute import in a Python file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def _module_level_roots(path):
    """Top-level names of the imports that run when the file is imported
    (outside every function body)."""
    tree = ast.parse(path.read_text(), filename=str(path))

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                yield from (a.name.split(".")[0] for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child.module.split(".")[0]
            yield from walk(child)

    yield from walk(tree)


@pytest.mark.parametrize("source", SOURCES)
def test_matplotlib_and_devkit_only_inside_functions(source):
    bad = sorted(set(_module_level_roots(ROOT / source)) & FUNCTION_ONLY)
    assert not bad, f"{source} imports {bad} when imported"


def test_scan_sees_module_level_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import matplotlib\nif True:\n    import matplotlib.pyplot\n"
                 "def g():\n    import numpy\nclass C:\n    import os\n")
    assert sorted(_module_level_roots(f)) == ["matplotlib", "matplotlib",
                                              "os"]


@pytest.mark.parametrize("source", SOURCES)
def test_no_jax_or_reference_imports(source):
    bad = sorted(set(_imported_roots(ROOT / source)) & FORBIDDEN)
    assert not bad, f"{source} imports {bad}"


def test_scan_sees_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom strive_tpu.maps import x\n"
                 "def g():\n    import optax\n"
                 "from strive_tpu_torch import maps\nfrom . import y\n")
    assert set(_imported_roots(f)) & FORBIDDEN == {"jax", "strive_tpu",
                                                    "optax"}


def test_package_imports_without_nvcc_or_triton(tmp_path):
    """Every module imports with no nvcc on PATH, no CUDA_HOME and triton,
    matplotlib and sklearn unimportable; importing builds nothing and loads
    no JAX."""
    modules = [".".join(Path(s).with_suffix("").parts) for s in SOURCES
               if s.startswith("strive_tpu_torch/")]
    modules = [m[:-len(".__init__")] if m.endswith(".__init__") else m
               for m in modules]
    code = "\n".join([
        "import importlib, sys",
        "for m in ('triton', 'matplotlib', 'sklearn', 'nuscenes'):",
        "    sys.modules[m] = None",
        f"for m in {modules!r}:",
        "    importlib.import_module(m)",
        "from strive_tpu_torch.utils import build",
        "assert not build._LIBS, build._LIBS",
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r}]",
        "assert not bad, bad",
        "assert sys.modules['triton'] is None",
        "print('ok')",
    ])
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = str(tmp_path)  # an empty directory: no nvcc
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cpu_calls_launch_nothing():
    """CPU tensors take the plain versions: no launch, no build."""
    store = synthetic_map_store(num_maps=2, size_px=256, channels=4,
                                device="cpu")
    rng = np.random.default_rng(0)
    th = rng.uniform(-np.pi, np.pi, 4)
    pos = torch.from_numpy(np.concatenate(
        [rng.uniform(10, 50, (4, 2)), np.stack([np.cos(th), np.sin(th)], 1)],
        1).astype(np.float32))
    mapix = torch.tensor([0, 1, 0, 1])
    before = dict(crop_kernel.LAUNCHES)
    libs = dict(build._LIBS)
    crop = queries.get_map_crop(store.packed, store.dx, pos, mapix,
                                DEFAULT_BOUNDS, store.C, L=32, W=32,
                                layout="nhwc")
    coll = queries.get_coll_point(store.packed, store.dx, pos,
                                  torch.full((4, 2), 3.0), mapix)
    assert crop.shape == (4, 32, 32, 4) and coll[0].shape == (4, 2)
    assert crop_kernel.LAUNCHES == before
    assert build._LIBS == libs
