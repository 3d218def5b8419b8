"""A whole run of the harness on the CPU (the look for a card skipped),
on the tiny cell: the result line, its metrics, the check, and
``correct`` turning false with the fp8 control in the program's place
and under each fault a serving cell can have, planted underneath the
timed path."""
import math
import time

import numpy as np
import pytest
import torch

from laps_bench import faults, harness, tiny_cell

torch.set_num_threads(1)
SEED = 2**31 + 11


def _run(model_type="qwen3", trace=False, control=False, seconds=1.5):
    return harness.run(tiny_cell.spec(model_type), SEED, seconds, trace,
                       time.monotonic(), device="cpu", control=control,
                       log=lambda m: None)


@pytest.mark.parametrize("model_type", ["qwen2", "qwen3"])
def test_a_run_is_correct_and_complete(model_type):
    res = _run(model_type)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "check"
    assert res["correct"] is True
    assert res["attempted"] > 10 and res["failed"] == 0
    for name in ("ttft_mean_ms", "ttft_p90_ms", "tpot_p90_ms", "setup_s"):
        value = res["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, name
    chk = res["check"]
    for name in ("widest_logit_gap", "mean_logit_gap"):
        assert chk[name]["value"] <= chk[name]["limit"]
    assert chk["served_tokens_compared"]["value"] >= \
        chk["served_tokens_compared"]["limit"]


@pytest.mark.parametrize("model_type", ["qwen2", "qwen3"])
def test_the_control_in_the_programs_place_is_incorrect(model_type):
    """The reference in fp8, judged as if it had served the tokens it
    puts first, fails the limits the program keeps."""
    res = _run(model_type, control=True)
    assert res["correct"] is False
    for name in ("widest_logit_gap", "mean_logit_gap"):
        gap = res["check"][name]
        assert gap["value"] > 3 * gap["limit"]


def test_the_sample_holds_several_conversations():
    """The longest conversation first, then others drawn from the seed,
    until both the served tokens and the conversations are in."""
    turns = []
    for conv, (n, out) in enumerate([(40, 5), (300, 9), (20, 4), (30, 6),
                                     (25, 3)]):
        turns.append(harness.Turn(conv, 0, 0.0, torch.arange(n).numpy(),
                                  out, outputs=list(range(out))))
    rng = np.random.default_rng(5)
    seqs = harness.pick_sequences(turns, rng, 5, 10000, 3)
    assert [s["conv"] for s in seqs][0] == 1 and len(seqs) == 3
    assert len({s["conv"] for s in seqs}) == 3
    assert len(harness.pick_sequences(turns, rng, 5, 10000, 1)) == 1


def test_a_traced_run_reports_the_per_layer_metrics():
    res = _run(trace=True)
    assert res["correct"] is True
    got = res["metrics"]
    # the device's metrics need a card; every host-side one is here
    for name in ("queue_wait_p90_ms", "prefill_tokens_per_tick",
                 "prefill_tick_ms", "decode_tick_ms", "live_captures",
                 "prefix_hit_share"):
        assert name in got, name
    assert got["live_captures"]["value"] == 0
    assert 0 < got["prefix_hit_share"]["value"] <= 100
    assert "ttft_p90_ms" not in got
    assert "window_s" in res["device"] and "breakdown" in res


# one chip: no exchange between chips to leave out
@pytest.mark.parametrize("plant", [faults.FAULTS[name] for name in
                                   ("token", "state", "half")])
def test_a_fault_underneath_makes_the_run_incorrect(plant, monkeypatch):
    plant(monkeypatch.setattr)
    res = _run()
    assert res["correct"] is False
    for name in ("widest_logit_gap", "mean_logit_gap"):
        gap = res["check"][name]
        assert gap["value"] > gap["limit"]
