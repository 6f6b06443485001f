"""Nothing the harness runs imports JAX or the JAX package, compared by
whole top-level module names, and the reference imports nothing of the
program."""

import ast
import subprocess
import sys

import perfbench_testing as PT

FORBIDDEN = {"jax", "jaxlib", "flax", "montecarlopathtracer_tpu"}
PORT = "montecarlopathtracer_tpu_torch"
HARNESS = PT.ROOT / "perfbench"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_file_of_the_harness_imports_jax():
    files = [p for p in HARNESS.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        assert not set(_imports(p)) & FORBIDDEN, p


def test_the_reference_and_the_counts_import_nothing_of_the_program():
    files = list((HARNESS / "reference").glob("*.py")) + [HARNESS / "counts.py"]
    files += list((HARNESS / "scenes").glob("*.py"))
    for p in files:
        assert PORT not in set(_imports(p)), p


def test_a_run_loads_no_jax_module():
    code = ("import sys, perfbench.run as r, perfbench.drivers.progressive, "
            "perfbench.control, montecarlopathtracer_tpu_torch; "
            "import montecarlopathtracer_tpu_torch.render.renderer; "
            "print(','.join(r.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=PT.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_the_forbidden_names_are_whole_top_level_names():
    from perfbench import run

    sys.modules.setdefault("montecarlopathtracer_tpu_torch", __import__(PORT))
    assert "montecarlopathtracer_tpu" not in [
        m.split(".")[0] for m in sys.modules if m.startswith(PORT)]
    assert set(run.FORBIDDEN) == FORBIDDEN
