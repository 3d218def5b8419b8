"""Nothing the benchmark runs loads JAX or the JAX package ``repro``
(compared by whole top-level module name: ``repro_torch`` is the
program), the plain reference and ``arith`` load nothing of the program,
and a family module (``models/``) loads only its ``ModelConfig``.  Each
check runs in a fresh interpreter."""
import os
import subprocess
import sys
import types

import pytest

from laps_bench import harness

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ENV = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT,
                                                   os.path.join(ROOT, "src")]))

RUN_TINY = """
import sys, time, torch
torch.set_num_threads(1)
from laps_bench import harness, tiny_cell
res = harness.run(tiny_cell.spec(), 3, 1.0, True, time.monotonic(),
                  device="cpu", log=lambda m: None)
assert res["correct"], res["check"]
tops = {m.split(".")[0] for m in sys.modules}
print(sorted(tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}))
print(harness.forbidden_modules())
"""

REFERENCE_ALONE = """
import sys
from laps_bench import harness, tiny_cell
ref = harness.reference_module(tiny_cell.spec()["config"])
print(sorted({m.split(".")[0] for m in sys.modules}
             & {"jax", "repro", "repro_torch"}))
"""


ARITH_ALONE = """
import sys
from laps_bench import arith
print(sorted({m.split(".")[0] for m in sys.modules}
             & {"jax", "repro", "repro_torch"}))
"""

FAMILY_ALONE = """
import json, sys
from laps_bench import harness
bench = json.load(open("BENCHMARK.json"))
for conf in bench["configs"]:
    config = json.load(open(conf["file"]))
    family = harness.family_module(config)
    family.program_config(config)
    family.page_bytes(config, 16)
    family.pool(config, 2**34)
    family.yardstick(config).step_flops([(512, 1536)])
print(sorted(m for m in sys.modules if m.split(".")[0] == "repro_torch"))
"""


def _python(code):
    out = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()


def test_a_run_loads_no_jax_nor_the_jax_package():
    loaded, forbidden = _python(RUN_TINY)[-2:]
    assert loaded == "['repro_torch']"
    assert forbidden == "[]"


def test_the_reference_loads_nothing_of_the_program():
    assert _python(REFERENCE_ALONE)[-1] == "[]"


@pytest.mark.parametrize("name,bad", [("repro", True), ("repro.core", True),
                                      ("jaxlib.xla", True), ("flax", True),
                                      ("repro_torch", False),
                                      ("repro_torch.core", False),
                                      ("jaxtyping", False)])
def test_forbidden_names_are_whole_top_level_names(name, bad, monkeypatch):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name.split(".")[0] in harness.forbidden_modules()) is bad


def test_the_command_needs_the_program_and_a_card(tmp_path):
    """Without a card it prints no result and exits non-zero; in a
    directory of the benchmark's files alone it cannot run either."""
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "laps_bench", "run.py"),
         "--workload", "qwen3-4b.short_burst", "--seed", "1", "--seconds",
         "1", "--trace", "0"], env=dict(ENV, CUDA_VISIBLE_DEVICES=""),
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    bare = tmp_path / "bare"
    bare.mkdir()
    subprocess.run(["cp", "-r", os.path.join(ROOT, "laps_bench"),
                    os.path.join(ROOT, "BENCHMARK.json"), str(bare)],
                   check=True)
    out = subprocess.run(
        [sys.executable, "laps_bench/run.py", "--workload",
         "qwen3-4b.short_burst", "--seed", "1", "--seconds", "1", "--trace",
         "0"], env={k: v for k, v in os.environ.items()
                    if k != "PYTHONPATH"},
        cwd=str(bare), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_arith_loads_nothing_of_the_program():
    assert _python(ARITH_ALONE)[-1] == "[]"


def test_a_family_module_loads_only_the_programs_model_config():
    """No kernel of the port: of the program, only its ``ModelConfig``."""
    assert _python(FAMILY_ALONE)[-1] == str(
        ["repro_torch", "repro_torch.models", "repro_torch.models.config"])
