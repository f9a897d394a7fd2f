"""What the harness and the reference import: no top-level name (the part
before the first dot, compared whole) of the JAX package or JAX, and for the
reference nothing of the program either."""
import ast
import subprocess
import sys
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "egnn_tpu"}


def _imported_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_sources_import_nothing_of_jax():
    for path in PORTBENCH.rglob("*.py"):
        assert not _imported_names(path) & FORBIDDEN, path


def test_reference_sources_import_nothing_of_the_program():
    for path in (PORTBENCH / "reference").glob("*.py"):
        assert not _imported_names(path) & (FORBIDDEN | {"egnn_tpu_torch", "portbench"}), path


def test_a_run_loads_nothing_of_jax():
    # everything a run imports: the harness, every family and every reader
    code = (
        "import sys\n"
        "from portbench import run, spec, harness, loops\n"
        "for w in spec.benchmark()['workloads']:\n"
        "    c = spec.cell(w['name'])\n"
        "    [spec.reader(m['name']) for m in c.per_layer]\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    loaded = _loaded(code)
    assert "egnn_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys\n"
            "import portbench.reference.dense_knn, portbench.reference.sparse_qm9\n"
            "print(' '.join(sorted(m for m in sys.modules)))\n")
    loaded = _loaded(code)
    assert not {m.split(".")[0] for m in loaded} & (FORBIDDEN | {"egnn_tpu_torch"})
    assert not {m for m in loaded if m.startswith("portbench.") and
                not m.startswith("portbench.reference")}
