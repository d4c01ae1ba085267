"""The import check, and the reference's independence of the program."""
import ast
import subprocess
import sys

from benchmark import core


def test_forbidden_by_top_level_name():
    assert core.forbidden_modules(["jax.numpy"]) == ["jax.numpy"]
    assert core.forbidden_modules(["rtow_tpu.ops"]) == ["rtow_tpu.ops"]
    assert core.forbidden_modules(["jaxlib", "flax.linen"]) == [
        "flax.linen", "jaxlib"]
    assert core.forbidden_modules(["rtow_tpu_torch.ops", "rtow_tpu_torch",
                                   "torch", "jaxtyping"]) == []


def test_reference_imports_nothing_of_the_program():
    banned = ("rtow_tpu_torch", "rtow_tpu", "jax", "jaxlib", "flax",
              "benchmark.program", "benchmark.drivers")
    for path in (core.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert not name.startswith(banned), (path.name, name)


def test_reference_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.render, benchmark.reference.train; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('rtow_tpu_torch', 'rtow_tpu', 'jax', 'jaxlib', 'flax')))"
            % str(core.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
