"""What the benchmark loads, in a fresh interpreter: nothing of JAX or of the
JAX package (top-level names compared whole: the port's name begins with
the JAX package's), and the reference nothing of the program either."""

import glob
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_PROBE = """
import importlib.util, json, os, sys
sys.path.insert(0, {root!r})
for i, path in enumerate({files!r}):
    if path.endswith("run.py"):
        sys.argv = [path]
    spec = importlib.util.spec_from_file_location("probe_%d" % i, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
for name in {modules!r}:
    importlib.import_module(name)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def loaded(files=(), modules=()):
    """Top-level names of every module loaded after importing ``files`` (by
    path) and ``modules`` (by name) in a fresh interpreter."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = _PROBE.format(root=ROOT, files=list(files), modules=list(modules))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def bench_files(*parts):
    return sorted(glob.glob(os.path.join(ROOT, "benchmark", *parts)))


def test_a_run_loads_no_jax_and_no_jax_package():
    files = ([os.path.join(ROOT, "benchmark", "run.py")] + bench_files("loops", "*.py")
             + bench_files("metrics", "*.py") + bench_files("rooflines", "*.py"))
    names = loaded(files, ["benchmark.harness", "benchmark.devtrace", "benchmark.program",
                           "torch.profiler"])
    assert "ptre_tpu_torch" in names  # the program is what a run drives
    assert not names & {"jax", "jaxlib", "flax", "ptre_tpu"}, sorted(names)


def test_the_reference_loads_nothing_of_the_program():
    mods = ["benchmark.reference." + os.path.basename(f)[:-3]
            for f in bench_files("reference", "*.py") if not f.endswith("__init__.py")]
    names = loaded(modules=mods)
    assert not names & {"jax", "jaxlib", "flax", "ptre_tpu", "ptre_tpu_torch"}, sorted(names)


def test_harness_refuses_what_no_run_may_load():
    code = ("import sys; sys.path.insert(0, %r); from benchmark import harness; "
            "import types; sys.modules['jax.numpy'] = types.ModuleType('jax.numpy'); "
            "sys.modules['ptre_tpu_torch_x'] = types.ModuleType('x'); "
            "print(harness.forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.stdout.strip() == "['jax.numpy']", out.stdout + out.stderr
