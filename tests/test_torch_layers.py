"""The port's modules import one way, down the layers:

    utils, config, ops/_cuda  <-  models  <-  ops/lights, ops/volumes
    <-  ops/tables  <-  ops/bounce  <-  the kernel wrappers {ops/megakernel
    (K1), ops/flat_bounce (K3), ops/grad (K4/K5), ops/keys}  <-
    {ops/wavefront, pipeline, diff}  <-  cli  <-  the timers and tools

Each module of ``rtow_tpu_torch`` is parsed with ``ast`` (nothing is
imported) and is one case: it may import a module of its own layer or a
lower one, never a higher one, and no chain of imports leads back to it.
A module of ``ops/`` imports no ``rtow_tpu_torch`` module inside a
function, where an import would hide a cycle.  A new module must be given
a layer here.
"""
import ast
import os
from functools import lru_cache

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "rtow_tpu_torch"

#: (layer, module names, or prefixes ending in "." or "_"), lowest first;
#: "" is the package's own ``__init__``.
LAYERS = [
    (0, ["utils", "utils.", "config", "ops._cuda", "ops", "tools"]),
    (1, ["models", "models.", ""]),
    (2, ["ops.lights", "ops.volumes"]),
    (3, ["ops.tables"]),
    (4, ["ops.bounce"]),
    (5, ["ops.megakernel", "ops.flat_bounce", "ops.grad", "ops.keys"]),
    (6, ["ops.wavefront", "pipeline", "diff"]),
    (7, ["cli"]),
    (8, ["time_", "ptxas_report", "tools.", "__main__"]),
]


def _modules():
    """{dotted name under the package ("" for its __init__): path}."""
    out = {}
    base = os.path.join(ROOT, PKG)
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for f in sorted(filenames):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), base)[:-3]
            parts = rel.split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            out[".".join(parts)] = os.path.join(dirpath, f)
    return out


MODULES = _modules()


def layer(name: str):
    """The layer of module ``name``, or None where none is given."""
    for n, names in LAYERS:
        for pat in names:
            if name == pat or (pat[-1:] in (".", "_")
                               and name.startswith(pat)):
                return n
    return None


def _in_function(node, parents) -> bool:
    p = parents.get(node)
    while p is not None:
        if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            return True
        p = parents.get(p)
    return False


@lru_cache(maxsize=None)
def imports(name: str):
    """[(imported module name under the package, line, inside a
    function)] of module ``name``."""
    path = MODULES[name]
    tree = ast.parse(open(path).read(), path)
    parents = {c: n for n in ast.walk(tree) for c in ast.iter_child_nodes(n)}
    is_pkg = os.path.basename(path) == "__init__.py"
    here = name.split(".") if name else []
    out = []
    for node in ast.walk(tree):
        targets = []
        if isinstance(node, ast.Import):
            targets = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                pkg = here if is_pkg else here[:-1]
                pkg = pkg[:len(pkg) - (node.level - 1)]
                base = [PKG] + pkg + (node.module.split(".")
                                      if node.module else [])
            else:
                base = node.module.split(".")
            base = ".".join(base)
            for a in node.names:
                sub = f"{base}.{a.name}"
                targets.append(sub if sub[len(PKG) + 1:] in MODULES
                               else base)
        for t in targets:
            if t == PKG or t.startswith(PKG + "."):
                out.append((t[len(PKG) + 1:], node.lineno,
                            _in_function(node, parents)))
    return out


def _reaches(start: str, goal: str) -> bool:
    seen, todo = set(), [t for t, _, _ in imports(start)]
    while todo:
        m = todo.pop()
        if m == goal:
            return True
        if m in seen or m not in MODULES:
            continue
        seen.add(m)
        todo.extend(t for t, _, _ in imports(m))
    return False


@pytest.mark.parametrize("name", sorted(MODULES))
def test_imports_follow_the_layers(name):
    mine = layer(name)
    assert mine is not None, f"{name or PKG}: give the module a layer"
    for target, line, _ in imports(name):
        assert target in MODULES, f"{name}:{line}: no module {target}"
        theirs = layer(target)
        assert theirs is not None and theirs <= mine, (
            f"{name} (layer {mine}):{line} imports {target} "
            f"(layer {theirs}), a higher layer")
    assert not _reaches(name, name), f"{name}: its imports lead back to it"


@pytest.mark.parametrize("name", sorted(m for m in MODULES
                                        if m.startswith("ops.")))
def test_ops_import_nothing_inside_functions(name):
    inside = [(t, line) for t, line, fn in imports(name) if fn]
    assert not inside, f"{name} imports inside a function: {inside}"
