"""Nothing that gpubench/run.py imports, the program it drives included,
has the top-level name of JAX, its libraries or the JAX package. The check
compares the part of a module's name before its first dot whole:
``models_tpu_torch`` begins with ``models_tpu`` and is not it."""

import json
import subprocess
import sys

from conftest import ROOT
from gpubench import harness

PROBE = """
import json, sys, pkgutil, importlib
sys.path.insert(0, {root!r})
sys.argv = ["run.py"]
import gpubench.run
import models_tpu_torch
for pkg in ("gpubench", "gpubench.entries", "gpubench.kinds"):
    mod = importlib.import_module(pkg)
    for info in pkgutil.walk_packages(mod.__path__, pkg + "."):
        if ".tests" not in info.name:
            importlib.import_module(info.name)
from gpubench import harness
for path in sorted((harness.HERE / "metrics").glob("*.py")):
    harness.metric_module(path.stem)
print(json.dumps(sorted(sys.modules)))
"""


def test_no_jax_in_the_harness_process():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "models_tpu_torch" in loaded and "gpubench.entries.train" in loaded
    found = [m for m in loaded if m.split(".", 1)[0] in harness.FORBIDDEN]
    assert found == []


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "models_tpu_torch_probe", sys)
    assert "models_tpu_torch_probe" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "models_tpu.probe", sys)
    assert "models_tpu.probe" in harness.forbidden_modules()
