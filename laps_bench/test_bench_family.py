"""A model family the harness has never seen comes as files alone: a
checkout whose configuration names ``"model": "program_smoke"`` and whose
``models/`` holds ``program_family.py`` under that name runs
``load_spec`` → ``System`` → ``serve`` → every metric reader of
``BENCHMARK.json`` on the CPU, on the port's smoke configs of
qwen3-moe-30b-a3b (routed experts in every layer) and jamba-v0.1-52b
(attention, SSD and MoE layers, a state slot on every page).  The
weights are the program's own initialiser's and the correctness judge is
left out: the benchmark has no plain reference of these models yet.

And for every family: the bytes its ``page_bytes`` counts are the bytes
per page of the pool the engine built."""
import json
import math
import os
import shutil

import pytest
import torch

from laps_bench import harness, tiny_cell
from laps_bench import trace as trace_mod

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SEED = 2**31 + 23
# readers that count on the host: each reads a number from a CPU run
HOST_READ = ("ttft_mean_ms", "ttft_p90_ms", "ttft_p50_ms", "tpot_p90_ms",
             "prompt_tok_s", "queue_wait_p90_ms", "prefill_tokens_per_tick",
             "prefill_tick_ms", "decode_tick_ms", "live_captures",
             "prefix_hit_share")


def _arena_page_bytes(system):
    """The pool's tensors' bytes over their pages (the scratch page
    with them)."""
    arena = system.engine.arena
    total = sum(a.numel() * a.element_size()
                for leaves in arena.arena for a in leaves.values())
    return total / (arena.num_pages + 1)


def _checkout(root, program):
    """A checkout at ``root`` with one cell of the smoke config of
    ``program``, the tiny cell's mix and load, and every metric of the
    repository's ``BENCHMARK.json`` in that cell."""
    bench = os.path.join(root, harness.BENCH)
    for sub in ("configs", "cells", "traffic", "models"):
        os.makedirs(os.path.join(bench, sub))
    shutil.copy(os.path.join(HERE, "program_family.py"),
                os.path.join(bench, "models", "program_smoke.py"))
    tiny = tiny_cell.spec()
    files = {
        "configs/smoke.json": {
            "name": program + "-smoke", "model": "program_smoke",
            "program": program, "vocab_size": 256,
            "serving": tiny["config"]["serving"]},
        "cells/smoke.tiny.json": tiny["cell"],
        "traffic/tiny.json": tiny["mix"]}
    for path, obj in files.items():
        with open(os.path.join(bench, path), "w") as f:
            json.dump(obj, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        real = json.load(f)
    every = lambda ms: [{k: v for k, v in m.items() if k != "workloads"}
                        for m in ms]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump({"configs": [{"name": "smoke", "file": os.path.join(
                       harness.BENCH, "configs", "smoke.json")}],
                   "workloads": [{"name": "smoke.tiny", "config": "smoke",
                                  "traffic": "tiny", "chips": 1}],
                   "end_to_end": every(real["end_to_end"]),
                   "per_layer": every(real["per_layer"])}, f)


@pytest.mark.parametrize("program", ["qwen3-moe-30b-a3b", "jamba-v0.1-52b"])
def test_a_new_family_needs_only_new_files(program, tmp_path):
    from repro_torch.models import transformer as tr
    _checkout(str(tmp_path), program)
    spec = harness.load_spec("smoke.tiny", str(tmp_path))
    family, config = spec["family"], spec["config"]
    assert os.path.dirname(family.__file__) == str(
        tmp_path / harness.BENCH / "models")
    mcfg = family.program_config(config)
    weights = tr.init_params(mcfg, SEED % 2**31, device="cpu")
    system = harness.System(config, weights, "cpu", family)
    assert family.page_bytes(config, 16) == _arena_page_bytes(system)
    harness.warm_up(system, int(config["vocab_size"]), SEED)
    rec = harness.serve(spec, system, SEED, 1.5, spec["cell"]["load"],
                        trace_mod.Tracer(torch.device("cpu")))
    assert sum(1 for t in rec.turns if t.outputs is not None) > 5
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        real = json.load(f)
    assert names == [m["name"] for m in real["end_to_end"]
                     + real["per_layer"]]
    for name in names:
        value = harness.metric_reader(name).read(rec)
        if name.split(".")[0] in HOST_READ:
            assert value is not None and math.isfinite(value), name
        else:
            assert value is None or math.isfinite(value), name
    # the model step's share with a peak, counted by the family's yardstick
    shape = rec.shape
    assert shape.attn_layers == sum(mcfg.layer_kind(i) == "attn"
                                    for i in range(mcfg.num_layers))
    rec.peak = {"bf16_flops_per_s": 1e12, "hbm_bytes_per_s": 1e12}
    mfu = harness.metric_reader("step_mfu").read(rec)
    assert mfu is not None and 0 < mfu < 100


@pytest.mark.parametrize("model_type", ["qwen2", "qwen3"])
def test_dense_page_bytes_are_the_pools(model_type):
    spec = tiny_cell.spec(model_type)
    config, family = spec["config"], spec["family"]
    ref = harness.reference_module(config)
    weights = ref.make_weights(config, config["init"], SEED, "cpu")
    system = harness.System(config, weights, "cpu", family)
    assert family.page_bytes(config, 16) == _arena_page_bytes(system)
    assert system.num_pages == config["serving"]["num_pages"]
