"""Nothing the benchmark runs imports JAX or the JAX package, comparing
whole top-level module names; the reference imports nothing of the
program."""

import ast
import glob
import os
import subprocess
import sys

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "egotap_tpu"}


def imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_sources_import_no_jax():
    files = glob.glob(os.path.join(harness.HERE, "**", "*.py"),
                      recursive=True)
    assert files
    for path in files:
        assert not imported_roots(path) & FORBIDDEN, path


def test_yardsticks_import_nothing_of_the_program():
    for name in ("reference.py", "weights.py", "flops.py", "bounds.py"):
        roots = imported_roots(os.path.join(harness.HERE, name))
        assert "egotap_tpu_torch" not in roots, name


def test_whole_names_are_compared():
    assert "egotap_tpu_torch".split(".")[0] not in FORBIDDEN
    sys.modules.setdefault("egotap_tpu_torch_probe", sys)
    try:
        assert "egotap_tpu_torch_probe" not in harness.forbidden_modules()
    finally:
        del sys.modules["egotap_tpu_torch_probe"]


def test_a_run_s_modules_hold_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness, common, control, spans\n"
        "from benchmark.drivers import serve, train_lifter\n"
        "import egotap_tpu_torch.serving, egotap_tpu_torch.train.tasks\n"
        "from benchmark.tests.tiny import tiny_cell, run\n"
        "run(tiny_cell('r18.serve-b32'), seconds=0.2)\n"
        "for m in ('setup_s', 'mfu.serve', 'kernels_roofline.serve'):\n"
        "    harness.load_reader(m)\n"
        "print(harness.forbidden_modules())\n" % harness.ROOT)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
