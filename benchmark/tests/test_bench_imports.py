"""Nothing the benchmark runs imports JAX or the JAX package: the
top-level name of every module, compared whole (the port's name begins
with the JAX package's)."""
import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "localexpstereo_tpu"}


def _sources():
    return [p for p in (ROOT / "benchmark").rglob("*.py")
            if "tests" not in p.parts]


def test_no_source_imports_jax():
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_loaded_modules_hold_no_jax():
    """Imports every module of the benchmark and what they import of the
    port (its clients' imports included) in a fresh interpreter."""
    code = """
import importlib, pathlib, sys
sys.path.insert(0, {root!r})
root = pathlib.Path({root!r})
for p in sorted((root / "benchmark").rglob("*.py")):
    rel = p.relative_to(root).with_suffix("")
    if "tests" in rel.parts or "metrics" in rel.parts:
        continue
    importlib.import_module(".".join(rel.parts).removesuffix(".__init__"))
from benchmark import run
for name in ("setup_s", "frame_s", "device_idle.frame"):
    run.reader(name)
import localexpstereo_tpu_torch.cli.main, localexpstereo_tpu_torch.serving
import localexpstereo_tpu_torch.models.mccnn
print(sorted({{m.split(".")[0] for m in sys.modules}}))
""".format(root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN
    assert "localexpstereo_tpu_torch" in loaded
