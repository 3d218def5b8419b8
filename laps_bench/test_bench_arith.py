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


def _dense(name):
    from laps_bench import harness
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        config = json.load(f)
    family = harness.family_module(config)
    assert os.path.basename(family.__file__) == "dense.py"
    return config, family


@pytest.mark.parametrize("name,page", [("qwen2.5-32b", 4_194_304),
                                       ("qwen3-4b", 2_359_296)])
def test_dense_family_page_bytes(name, page):
    # K and V, 16 tokens, 8 kv heads of 128, bf16, every layer (64; 36)
    config, family = _dense(name)
    assert family.page_bytes(config, 16) == page
    assert page == 2 * config["num_hidden_layers"] * 16 * 8 * 128 * 2


# the counts of a (512 new, 1536 history) segment and of an 8-row decode
# at 2048 keys, as the benchmark counted them before the family modules
@pytest.mark.parametrize("name,step,prefill,decode_step,decode", [
    ("qwen2.5-32b", 33159040204800.0, (18795724800.0, 18874368.0),
     533221867520.0, (335544320.0, 67272704.0)),
    ("qwen3-4b", 4262610206720.0, (15036579840.0, 16777216.0),
     74020028416.0, (268435456.0, 67239936.0)),
])
def test_dense_yardstick_counts_as_before(name, step, prefill, decode_step,
                                          decode):
    config, family = _dense(name)
    ys = family.yardstick(config)
    assert ys == arith.Shape.from_config(config)
    assert ys.attn_layers == config["num_hidden_layers"]
    assert ys.step_flops([(512, 1536)]) == step
    assert arith.prefill_call(ys, [(512, 1536)]) == prefill
    assert ys.step_flops([(1, 2047)] * 8) == decode_step
    assert arith.decode_call(ys, [2048] * 8) == decode


@pytest.mark.parametrize("name,free,pages", [
    ("qwen2.5-32b", 20 * 2**30, 4736), ("qwen2.5-32b", 17_000_000_000, 3669),
    ("qwen3-4b", 20 * 2**30, 8419), ("qwen3-4b", 17_000_000_000, 6522)])
def test_dense_pool_pages_as_before(name, free, pages):
    """``free`` bytes left on the card after the weights; the harness
    takes ``headroom_gib`` off before it asks the family."""
    config, family = _dense(name)
    left = free - config["serving"]["headroom_gib"] * 2**30
    assert family.pool(config, left) == {"num_pages": pages}
    assert pages == int(left // family.page_bytes(config, 16))
