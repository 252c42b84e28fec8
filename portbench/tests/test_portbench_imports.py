"""No run loads `jax`, `jaxlib`, `flax` or the JAX package: names are
compared whole, in a fresh process, since this test process may hold
them; and the yardstick imports nothing of the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from conftest import REPO


def py(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_the_port_is_not_the_jax_package():
    p = py("import portbench.run as r, jepsen_tpu_torch.checker.linearizable"
           "\nprint(r.forbidden_modules())\nimport jepsen_tpu\n"
           "print(r.forbidden_modules())")
    assert p.returncode == 0, p.stderr
    first, second = p.stdout.strip().splitlines()[-2:]
    assert first == "[]"
    assert "jepsen_tpu" in second


def test_a_run_with_jax_loaded_prints_no_result(tmp_path):
    from conftest import tiny_root

    root = tiny_root(tmp_path)
    p = py("import sys, types\nsys.modules['jax'] = types.ModuleType('jax')"
           "\nfrom portbench import run\n"
           f"run.main(['--workload', 'register_keyed.clean', '--seed', "
           f"'1', '--seconds', '0.2'], root={root!r}, device='cpu')")
    assert p.returncode == 4
    assert "{" not in p.stdout
    assert "jax" in p.stderr.strip().splitlines()[-1]


def test_no_card_no_result(tmp_path):
    p = py("import torch\ntorch.cuda.is_available = lambda: False\n"
           "from portbench import run\nrun.main(['--workload', "
           "'register_keyed.planted', '--seed', '1', '--seconds', '1'])")
    assert p.returncode == 3 and "{" not in p.stdout


def test_without_the_port_no_result(tmp_path):
    import shutil

    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "-c", "import torch\n"
         "torch.cuda.is_available = lambda: True\n"
         "torch.cuda.device_count = lambda: 1\n"
         "torch.cuda.set_device = lambda d: None\n"
         "torch.zeros = lambda *a, **k: None\n"
         "from portbench import run\nrun.main(['--workload', "
         "'register_keyed.planted', '--seed', '1', '--seconds', '1'])"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 5 and "{" not in p.stdout


def test_the_yardstick_imports_nothing_of_the_program():
    for name in ("gen", "reference", "compare", "bounds", "devtrace"):
        with open(os.path.join(REPO, "portbench", name + ".py")) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import)
                    else [node.module or ""]
                    if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert m.split(".")[0] not in (
                    "jax", "jaxlib", "flax", "jepsen_tpu",
                    "jepsen_tpu_torch"), (name, m)
