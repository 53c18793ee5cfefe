"""The port stands alone: nothing in `fedml_tpu_torch/` or `chip_smoke.py`
imports JAX, flax, optax or the JAX package, names a file path into the
JAX package (a `ctypes` load of its native library by path would pass the
import check), and the package imports in a process where `jax` cannot be
imported at all."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fedml_tpu")
FILES = sorted((ROOT / "fedml_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imports(tree)
           if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# a `file:line` reference to a TPU kernel (the `kernels` line's "replaces")
# names the reference without opening it; any other path into the JAX
# package, its bare directory name as a path component, or its native
# library is refused
_FILE_LINE_REF = re.compile(r"^fedml_tpu/[\w/]+\.py:\d*$")
_INTO_JAX = re.compile(r"(^|[^\w])fedml_tpu[/\\]")


def _code_strings(tree):
    """(line, text) of every string constant that is not a docstring (the
    literal pieces of f-strings included)."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant):
                docs.add(id(first.value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            yield node.lineno, node.value


def path_into_jax_package(text: str) -> bool:
    if "fedml_native" in text or text.strip("/\\") == "fedml_tpu":
        return True
    return bool(_INTO_JAX.search(text)) and not _FILE_LINE_REF.match(text)


def test_path_rule_catches_a_native_load_by_path():
    src = ("import ctypes, os\n"
           "ctypes.CDLL('fedml_tpu/native/libfedml_native.so')\n"
           "os.path.join(ROOT, 'fedml_tpu', 'native')\n"
           "open(f'{ROOT}/fedml_tpu/comm/base.py')\n"
           "ROW = {'replaces': 'fedml_tpu/ops/paged_attention.py:84'}\n")
    flagged = [ln for ln, t in _code_strings(ast.parse(src))
               if path_into_jax_package(t)]
    assert flagged == [2, 3, 4]


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_path_into_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(ln, t[:80]) for ln, t in _code_strings(tree)
           if path_into_jax_package(t)]
    assert not bad, f"{path.relative_to(ROOT)} names paths into the JAX " \
        f"package: {bad}"


def test_package_imports_without_jax():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'fedml_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil, fedml_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    fedml_tpu_torch.__path__, 'fedml_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 10


NATIVE = sorted((ROOT / "fedml_tpu_torch" / "native").glob("*.cpp"))


def test_every_subpackage_is_checked():
    """The import and path checks above cover every module of the port,
    the SecAgg, cross-cloud and cross-device subpackages included."""
    checked = {p.relative_to(ROOT).parts[1] for p in FILES
               if p.parent != ROOT and p.parent.name != "fedml_tpu_torch"}
    for sub in ("mpc", "cross_cloud", "cross_device", "cross_silo", "comm",
                "native"):
        assert sub in checked, sub
    assert {p.name for p in NATIVE} >= {"crc32c.cpp", "finite_field.cpp"}


@pytest.mark.parametrize("path", NATIVE,
                         ids=[str(p.relative_to(ROOT)) for p in NATIVE])
def test_native_sources_stand_alone(path):
    """The port's host C++ includes only system headers and names no path
    into the JAX package (its native source or library)."""
    text = path.read_text()
    includes = re.findall(r'#include\s*[<"]([^>"]+)[>"]', text)
    assert includes and all("/" not in i and not i.startswith("fedml")
                            for i in includes), includes
    bad = [(n, ln) for n, ln in enumerate(text.splitlines(), 1)
           if path_into_jax_package(ln)]
    assert not bad, bad
