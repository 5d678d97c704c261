"""What the benchmark runs imports no JAX: no module whose top-level name
(before the first dot, compared whole) is jax, jaxlib, flax or the JAX
package, after every module of the harness is imported and a tiny run has
driven the port; and the reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark.core import FORBIDDEN

HERE = Path(__file__).resolve().parent.parent

RUN = """
import importlib, json, sys, tempfile, torch
from pathlib import Path
for m in ["benchmark.run", "benchmark.readings", "benchmark.sweep", "benchmark.faults",
          "benchmark.drivers.offline", "benchmark.drivers.online", "benchmark.drivers.train",
          "benchmark.serving", "benchmark.readers", "benchmark.work", "benchmark.trace",
          "benchmark.weights", "benchmark.reference.model", "benchmark.reference.detect",
          "benchmark.reference.compare", "benchmark.reference.train"]:
    importlib.import_module(m)
from benchmark import run
from benchmark.core import family, reader
from benchmark.tests.tiny import make_root
root = make_root(Path(tempfile.mkdtemp()))
for p in sorted((root / "benchmark" / "families").glob("*.py")):
    family(p.stem, root)
for p in sorted((root / "benchmark" / "metrics").glob("*.py")):
    reader(p.stem, root)
assert run.main(["--workload", "tiny-offline", "--seed", "1", "--seconds", "0", "--trace", "0"],
                device=torch.device("cpu"), root=root) == 0
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_nothing_the_benchmark_runs_loads_jax():
    out = subprocess.run([sys.executable, "-c", RUN], cwd=HERE.parent, capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[-1]
    names = set(__import__("json").loads(out))
    assert "cerberusdet_tpu_torch" in names  # the port ran
    assert not names & set(FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((HERE / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in set(FORBIDDEN) | {"cerberusdet_tpu_torch"}, (path.name, name)
                assert top in {"__future__", "math", "typing", "numpy", "torch", "benchmark"}, \
                    (path.name, name)
