"""Nothing under `gpubench/` imports JAX or the JAX package, the reference
imports nothing of the program, and a finished run holds no such module.
Top-level module names are compared whole: `ganslate_tpu_torch` is not
`ganslate_tpu`."""

import ast
import json
import subprocess
import sys

from gpubench.harness import FORBIDDEN_MODULES
from gpubench.tests.tiny import BENCH, ROOT


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    found = {(str(p.relative_to(ROOT)), name) for p in BENCH.rglob("*.py")
             for name in _imports(p) if name in FORBIDDEN_MODULES}
    assert not found


def test_the_reference_imports_nothing_of_the_program():
    found = {(str(p.relative_to(ROOT)), name) for p in (BENCH / "reference").rglob("*.py")
             for name in _imports(p) if name.startswith("ganslate")}
    assert not found
    assert {name for name in _imports(BENCH / "counts" / "__init__.py")
            if name.startswith("ganslate")} == set()


def test_a_finished_run_holds_no_jax_module(tiny):
    root, bench = tiny
    code = (
        "import json, sys, time\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from pathlib import Path\n"
        "from gpubench import harness, run\n"
        f"rc = run.main(['--workload', 'brats_cyclegan.infer_volume', '--seed', '1', '--seconds',"
        f" '0.2'], root=Path({str(root)!r}), bench_dir=Path({str(bench)!r}),"
        " require_cuda=False, t0=time.perf_counter())\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(json.dumps({'rc': rc, 'forbidden': harness.loaded_forbidden(),"
        " 'port': 'ganslate_tpu_torch' in tops}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last == {"rc": 0, "forbidden": [], "port": True}, out.stderr[-2000:]
