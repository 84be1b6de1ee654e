"""What a run loads: nothing whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``repro`` (the JAX package; ``repro_torch`` is the program),
and the plain reference loads nothing of the program either."""
import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "perfbench"
BANNED = {"jax", "jaxlib", "flax", "repro"}


def _fresh(code: str) -> str:
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_run_loads_no_jax_nor_the_jax_package():
    code = ("import sys\n"
            "from perfbench import run, harness, control, readers, "
            "probes, devtrace, counts, traffic, weights, spec\n"
            "from perfbench.reference import gqa\n"
            "harness._modules()\n"
            "import repro_torch.serving.api, repro_torch.serving.engine\n"
            "for w in spec.benchmark()['per_layer']:\n"
            "    spec.reader(w['name'])\n"
            "print(harness.forbidden_modules())")
    assert _fresh(code) == "[]"


def test_reference_loads_nothing_of_the_program():
    code = ("import sys\n"
            "from perfbench.reference import gqa\n"
            "print(sorted({n.split('.')[0] for n in sys.modules} & "
            "{'repro_torch', 'repro', 'jax'}))")
    assert _fresh(code) == "[]"


def test_forbidden_names_compare_whole():
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import harness
    before = dict(sys.modules)
    try:
        sys.modules.setdefault("repro_torch_like", sys)
        assert "repro" not in harness.forbidden_modules() or \
            "repro" in {n.split(".")[0] for n in before}
    finally:
        sys.modules.pop("repro_torch_like", None)


def test_no_source_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in BANNED, (path, n)
