"""Nothing under portbench/ imports JAX or the JAX package, compared by the
whole top-level name; the reference imports nothing of the program either;
and a CPU rehearsal leaves none of them in ``sys.modules``."""
import ast
import json
import subprocess
import sys

from conftest import ROOT

JAX_SIDE = {"jax", "jaxlib", "flax", "vi_diffusion_processes_tpu"}
PROGRAM = "vi_diffusion_processes_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_imports():
    files = sorted((ROOT / "portbench").rglob("*.py"))
    assert files
    for path in files:
        found = set(_imports(path))
        assert not found & JAX_SIDE, (path, found & JAX_SIDE)
        if "reference" in path.relative_to(ROOT / "portbench").parts:
            assert PROGRAM not in found, path


def test_top_level_names_are_compared_whole():
    # the program's name begins with the JAX package's, and is allowed
    assert PROGRAM.split(".")[0] not in JAX_SIDE


def test_sys_modules_after_a_rehearsal(checkout):
    code = (
        "import json, sys, time, torch\n"
        "from pathlib import Path\n"
        "from portbench import harness\n"
        f"harness.run_cell(Path({str(checkout.root)!r}), 'dw1d.tiny', 3, 0.2, False,"
        " torch.device('cpu'), time.time(), log=lambda m: None,"
        f" bench_dir=Path({str(checkout.bench_dir)!r}))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert PROGRAM in loaded
    assert not loaded & JAX_SIDE
