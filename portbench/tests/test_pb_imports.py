"""No module of the benchmark imports JAX, the JAX package or the JAX
benchmarks: top-level module names compared whole, so that
``ganreverser_tpu_torch`` passes and ``ganreverser_tpu`` does not."""
import ast
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ganreverser_tpu", "benchmarks"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_no_jax_imports():
    files = sorted(BENCH_DIR.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        bad = top_level_imports(path) & FORBIDDEN
        assert not bad, f"{path}: {bad}"


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "weights.py", "work.py", "tracing.py"):
        names = top_level_imports(BENCH_DIR / name)
        assert "ganreverser_tpu_torch" not in names, name


def test_the_check_tells_the_packages_apart():
    assert "ganreverser_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "ganreverser_tpu.models".split(".")[0] in FORBIDDEN
