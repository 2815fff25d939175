"""What a run executes loads neither JAX nor the JAX package, and the
plain reference loads nothing of the program: a static walk of the
imports of ``portbench/run.py``, the harness's modules and
``portbench/reference/``, into the port's own modules, each module's
top-level name compared whole."""
import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "radmmm_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module
            for a in node.names:
                yield f"{node.module}.{a.name}"


def _file_of(module: str):
    parts = module.split(".")
    for n in range(len(parts), 0, -1):
        base = ROOT.joinpath(*parts[:n])
        if base.with_suffix(".py").exists():
            return base.with_suffix(".py")
        if (base / "__init__.py").exists() and n == len(parts):
            return base / "__init__.py"
    return None


def _walk(start):
    seen, todo, tops = set(), list(start), set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for mod in _imports(path):
            tops.add(mod.split(".")[0])
            if mod.split(".")[0] in ("portbench", "radmmm_torch"):
                f = _file_of(mod)
                if f is not None:
                    todo.append(f)
    return tops, seen


def _harness_files():
    pb = ROOT / "portbench"
    return [p for p in pb.rglob("*.py") if "tests" not in p.parts]


def test_a_run_loads_no_jax():
    tops, seen = _walk(_harness_files())
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    # the walk reached the port's modules through the harness
    assert any("radmmm_torch" in p.parts for p in seen)


def test_the_reference_loads_nothing_of_the_program():
    ref = ROOT / "portbench" / "reference"
    tops, seen = _walk(list(ref.rglob("*.py")))
    assert not tops & (FORBIDDEN | {"radmmm_torch"}), tops
    assert all("radmmm_torch" not in p.parts for p in seen)


def test_the_names_are_compared_whole():
    # the port's name begins with the JAX package's stem, and is allowed
    assert "radmmm_torch".split(".")[0] not in FORBIDDEN
