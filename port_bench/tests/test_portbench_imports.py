"""What the command and the reference import: no top-level module named
``jax``, ``jaxlib``, ``flax`` or ``figbird_tpu`` (compared whole, so
``figbird_tpu_torch`` is not ``figbird_tpu``), and the reference nothing
of ``figbird_tpu_torch`` either."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
REF = ROOT / "port_bench" / "reference"

PROBE = """
import sys
sys.path.insert(0, {root!r})
{body}
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(",".join(tops))
"""


def loaded(body: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(
        root=str(ROOT), body=body)], capture_output=True, text=True,
        check=True, timeout=300)
    return set(out.stdout.strip().split(","))


def test_the_command_imports_no_jax():
    tops = loaded(
        "import runpy, importlib\n"
        "sys.argv = ['run.py', '--help']\n"
        "from port_bench.harness import cell, calls, capture, compare, "
        "tracing\n"
        "for name in ('figbird_tpu_torch.pipeline', "
        "'figbird_tpu_torch.__main__', 'figbird_tpu_torch.io.fasta'):\n"
        "    importlib.import_module(name)\n"
        "capture.package(capture.PORT); capture.package(capture.REFERENCE)\n"
        "try:\n    runpy.run_path('{}', run_name='__main__')\n"
        "except SystemExit:\n    pass\n".format(ROOT / "port_bench" / "run.py"))
    assert "figbird_tpu_torch" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "figbird_tpu"}


def test_the_reference_imports_neither_jax_nor_the_port():
    tops = loaded("import port_bench.reference.fbref.pipeline\n"
                  "import port_bench.reference.fbref.combine\n"
                  "import port_bench.reference.direct\n")
    assert not tops & {"jax", "jaxlib", "flax", "figbird_tpu",
                       "figbird_tpu_torch"}


def test_the_plain_reference_imports_numpy_alone():
    tops = loaded("import port_bench.reference.direct\n")
    assert "numpy" in tops
    assert not tops & {"torch", "jax", "jaxlib", "flax", "figbird_tpu",
                       "figbird_tpu_torch"}


def test_the_reference_sources_name_no_outside_package():
    for path in REF.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in {
                    "torch", "numpy", "__future__", "dataclasses", "typing",
                    "collections", "contextlib", "functools", "logging",
                    "time", "pathlib", "json", "math", "sys", "gc", "io",
                    "itertools", "os", "pickle", "socket", "struct",
                    "datetime", "heapq", "hashlib", "re"}, (path, n)
