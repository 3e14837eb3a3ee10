"""Nothing under benchmark/ imports JAX or the JAX package (whole
top-level names: the port's name begins with the JAX package's), and the
reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "mm_interleaved_tpu"}


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.level if hasattr(
                    node, "level") else 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def test_no_jax_anywhere():
    for path in BENCH.rglob("*.py"):
        for top, level in imported(path):
            if level == 0:
                assert top not in FORBIDDEN, (path, top)


def test_reference_stands_alone():
    for path in (BENCH / "reference").rglob("*.py"):
        for top, level in imported(path):
            if level == 0:
                assert top not in FORBIDDEN | {"mm_interleaved_tpu_torch",
                                               "benchmark"}, (path, top)
        depth = len(path.relative_to(BENCH / "reference").parts)
        for top, level in imported(path):
            assert level <= depth, (path, level)  # stays inside


def test_harness_loads_without_jax():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'mm_interleaved_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {str(BENCH.parent)!r})\n"
        "import benchmark.harness.runner, benchmark.harness.controls\n"
        "import benchmark.yardstick.flops, benchmark.reference.quant\n"
        "import benchmark.reference.models.mm_interleaved\n"
        "import mm_interleaved_tpu_torch.parallel.inference\n"
        "sys.argv = ['run.py']\n"
        "import importlib.util\n"
        f"s = importlib.util.spec_from_file_location('r', {str(BENCH / 'run.py')!r})\n"
        "r = importlib.util.module_from_spec(s); s.loader.exec_module(r)\n"
        "for m in ('jax', 'jaxlib', 'flax', 'mm_interleaved_tpu'):\n"
        "    del sys.modules[m]\n"
        "assert r.forbidden_modules() == [], r.forbidden_modules()\n"
        "sys.modules['mm_interleaved_tpu.configs'] = object()\n"
        "assert r.forbidden_modules() == ['mm_interleaved_tpu']\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "mmi13b.t2i-b24", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
