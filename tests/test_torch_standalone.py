"""The port stands alone: importing it loads neither jax nor anything of
the JAX package (dsm_tpu), and its sources name neither in an import.

One subprocess imports every module of dsm_tpu_torch (the package is
walked on disk) and chip_smoke, one after the other, and reports after
each import the modules of `sys.modules` that are `jax`, `dsm_tpu` or
start with `dsm_tpu.`.  A module's case fails when such a module is
loaded once it has been imported (so the first offender and every module
after it fail).  Another subprocess imports each module as the first of
the port (the port's modules are dropped from `sys.modules` before each),
so that an import cycle that only a first import meets shows.
"""

import json
import os
import pkgutil
import re
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PKG = os.path.join(REPO, "dsm_tpu_torch")
IMPORT = re.compile(r"^\s*(from|import) +(dsm_tpu|jax)(\.| |$)", re.M)


def _modules() -> list[str]:
    names = ["dsm_tpu_torch"] + sorted(
        m.name for m in pkgutil.walk_packages([PKG], "dsm_tpu_torch."))
    # importing __main__ would run the CLI
    return [n for n in names if not n.endswith("__main__")] + ["chip_smoke"]


MODULES = _modules()

_PROBE = """
import importlib, json, sys
report = {}
for name in json.loads(sys.argv[1]):
    try:
        importlib.import_module(name)
        error = None
    except Exception as e:   # reported to the test of that module
        error = repr(e)
    report[name] = dict(error=error, foreign=sorted(
        m for m in sys.modules
        if m == "jax" or m == "dsm_tpu" or m.startswith("dsm_tpu.")))
print(json.dumps(report))
"""


_FIRST = """
import importlib, json, sys
report = {}
for name in json.loads(sys.argv[1]):
    for m in [m for m in sys.modules
              if m.split(".")[0] in ("dsm_tpu_torch", "chip_smoke")]:
        del sys.modules[m]
    try:
        importlib.import_module(name)
        report[name] = None
    except Exception as e:   # reported to the test of that module
        report[name] = repr(e)
print(json.dumps(report))
"""


def _probe(code: str) -> dict:
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, "-c", code, json.dumps(MODULES)],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def report():
    return _probe(_PROBE)


@pytest.fixture(scope="module")
def first_report():
    return _probe(_FIRST)


def test_the_walk_finds_the_package():
    for name in ("dsm_tpu_torch.cli.main", "dsm_tpu_torch.post.distance",
                 "dsm_tpu_torch.ops.distance", "dsm_tpu_torch.index.rlcsa",
                 "dsm_tpu_torch.mining.gnulazy",
                 "dsm_tpu_torch.parallel.mesh",
                 "dsm_tpu_torch.parallel.multihost",
                 "dsm_tpu_torch.parallel.engine_sharded",
                 "dsm_tpu_torch.parallel.engine_episode",
                 "dsm_tpu_torch.ops.shardstats",
                 "dsm_tpu_torch.ops.gatherpack",
                 "dsm_tpu_torch.mining.bigindex", "dsm_tpu_torch.net.wire",
                 "dsm_tpu_torch.net.native", "dsm_tpu_torch.net.client",
                 "dsm_tpu_torch.net.server", "dsm_tpu_torch.cli.launch",
                 "chip_smoke"):
        assert name in MODULES


@pytest.mark.parametrize("name", MODULES)
def test_import_loads_no_jax_and_no_dsm_tpu(report, name):
    assert report[name]["error"] is None
    assert report[name]["foreign"] == []


@pytest.mark.parametrize("name", MODULES)
def test_module_imports_as_the_first_of_the_port(first_report, name):
    assert first_report[name] is None


def _sources() -> list[str]:
    found = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PKG):
        found += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(found)


def test_sources_import_neither():
    sources = _sources()
    assert len(sources) > 30
    hits = []
    for path in sources:
        with open(path) as f:
            hits += [f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}"
                     for m in IMPORT.finditer(f.read())]
    assert hits == []
