"""The yardstick's arithmetic against hand counts at small shapes, and
the published widths it reads from the configuration files."""
import json
import os
import types

import pytest

from laps_bench import arith

HERE = os.path.dirname(os.path.abspath(__file__))
SMALL = arith.Shape(layers=2, d_model=8, heads=4, kv_heads=2, head_dim=2,
                    d_ff=16, vocab=10)


def test_causal_attention_flops():
    # 3 new queries after 2 cached keys see 3, 4 and 5 keys: 12 dot
    # products of width 2 a head for QK^T, as many for PV, 2 FLOPs each
    assert arith.attn_flops(3, 2, heads=4, head_dim=2) == 4 * 12 * 2 * 2 * 2
    assert arith.attn_flops(1, 0, heads=1, head_dim=1) == 4.0


def test_prefill_call_counts_each_byte_once():
    flops, nbytes = arith.prefill_call(SMALL, [(3, 2), (1, 7)])
    assert flops == arith.attn_flops(3, 2, 4, 2) + arith.attn_flops(1, 7, 4, 2)
    # Q in and O out: 4 new tokens x 4 heads x 2 x 2 bytes, each way;
    # K and V in: (5 + 8) keys x 2 kv heads x 2 x 2 bytes, each
    assert nbytes == 2 * 4 * 4 * 2 * 2 + 2 * 13 * 2 * 2 * 2


def test_decode_call():
    flops, nbytes = arith.decode_call(SMALL, [5, 1])
    assert flops == 4 * 4 * 2 * 6
    assert nbytes == 2 * (2 * 4 * 2 * 2) + 2 * 6 * 2 * 2 * 2


def test_step_flops():
    # per token and layer: q and o 2·8·8, k and v 2·8·4, SwiGLU 3·8·16
    assert SMALL.block_matmul_params == 128 + 64 + 384
    f = arith.step_flops(SMALL, [(3, 2)])
    want = (2 * 2 * 576 * 3 + 2 * 8 * 10
            + 2 * arith.attn_flops(3, 2, 4, 2))
    assert f == want
    # a decode row is a one-token segment
    assert arith.step_flops(SMALL, [(1, 4)]) == \
        2 * 2 * 576 + 2 * 8 * 10 + 2 * arith.attn_flops(1, 4, 4, 2)


def test_least_seconds_takes_the_binding_bound():
    peak = {"bf16_flops_per_s": 1e12, "hbm_bytes_per_s": 1e9}
    assert arith.least_seconds(2e12, 1e9, peak) == 2.0
    assert arith.least_seconds(1e12, 3e9, peak) == 3.0


def test_peaks_table():
    p = arith.peaks("NVIDIA H100 80GB HBM3")
    assert p["bf16_flops_per_s"] == 989e12
    assert p["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(KeyError):
        arith.peaks("some other card")


@pytest.mark.parametrize("name,params", [
    # q/k/v/o and SwiGLU weights a layer x layers, from the published widths
    ("qwen3-4b", 36 * (2 * 2560 * 4096 + 2 * 2560 * 1024 + 3 * 2560 * 9728)),
    ("qwen2.5-32b", 64 * (2 * 5120 * 5120 + 2 * 5120 * 1024
                          + 3 * 5120 * 27648)),
])
def test_config_widths(name, params):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        shape = arith.Shape.from_config(json.load(f))
    assert shape.layers * shape.block_matmul_params == params
    assert shape.head_dim == 128


def test_ticks_mfu_counts_the_window_untraced_ticks():
    from laps_bench.harness import Tick
    rec = types.SimpleNamespace(
        peak={"bf16_flops_per_s": 1e6}, shape=SMALL, t_start=0.0, t_end=10.0,
        ticks=[Tick(1.0, 1.5, [[(3, 2)]], []),        # a packed step
               Tick(2.0, 2.25, [], [[5]]),             # a decode step
               Tick(3.0, 4.0, [], [[5]], traced=True),  # traced: left out
               Tick(11.0, 12.0, [[(3, 2)]], [])])       # after the window
    pre = arith.step_flops(SMALL, [(3, 2)])
    dec = arith.step_flops(SMALL, [(1, 4)])
    assert arith.ticks_mfu(rec, ("prefill", "decode")) == \
        pytest.approx(100 * (pre + dec) / (0.75 * 1e6))
    assert arith.ticks_mfu(rec, ("decode",)) == \
        pytest.approx(100 * dec / (0.25 * 1e6))
    assert arith.ticks_mfu(types.SimpleNamespace(peak={}), ("decode",)) is None
