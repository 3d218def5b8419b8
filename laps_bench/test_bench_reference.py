"""The frozen plain reference against the program's own dense forward on
the CPU (its plain kernels), at a small Qwen2 (q/k/v biases) and Qwen3
(q/k norm, tied head) shape; the seeded weights; the fp8 control."""
import numpy as np
import pytest
import torch

from laps_bench import harness, tiny_cell

torch.set_num_threads(1)


def _setup(model_type, seed=2**31 + 5):
    spec = tiny_cell.spec(model_type)
    cfg = spec["config"]
    ref = harness.reference_module(cfg)
    w = ref.make_weights(cfg, cfg["init"], seed, "cpu")
    return ref, cfg, w


def _program(cfg):
    """The program's ModelConfig, as the cell's family module gives it."""
    return harness.family_module(cfg).program_config(cfg)


@pytest.mark.parametrize("model_type", ["qwen2", "qwen3"])
def test_reference_matches_the_program_forward(model_type):
    from repro_torch.models import transformer as tr
    ref, cfg, w = _setup(model_type)
    toks = torch.as_tensor(np.random.default_rng(0).integers(1, 256, 150))
    with torch.no_grad():
        prog = tr.forward(w, _program(cfg), toks[None])[0]
    got = ref.logits_at(w, cfg, toks, torch.arange(150), q_block=64,
                        row_block=40)
    assert got.shape == (150, 256)
    assert torch.allclose(got, prog[:, :256].float(), atol=2e-5, rtol=1e-4)


def test_weights_are_seeded_and_shaped():
    ref, cfg, w = _setup("qwen2")
    _, _, w2 = _setup("qwen2")
    _, _, w3 = _setup("qwen2", seed=6)
    assert torch.equal(w["blocks"][0]["mixer"]["wq"],
                       w2["blocks"][0]["mixer"]["wq"])
    assert not torch.equal(w["blocks"][0]["mixer"]["wq"],
                           w3["blocks"][0]["mixer"]["wq"])
    from repro_torch.models import transformer as tr
    shapes = tr.param_shapes(_program(cfg))
    flat = lambda t, p="": ({p: tuple(t.shape)} if torch.is_tensor(t) else {
        k: v for i, x in (t.items() if isinstance(t, dict) else enumerate(t))
        for k, v in flat(x, f"{p}/{i}").items()})
    assert flat(w) == flat(shapes)
    assert w["blocks"][0]["mixer"]["bq"].abs().max() > 0


def test_tied_head_is_the_embedding():
    _, _, w = _setup("qwen3")
    assert w["lm_head"].data_ptr() == w["embed"].data_ptr()
    assert torch.equal(w["lm_head"], w["embed"].t())


def test_gaps_and_the_fp8_control():
    ref, cfg, w = _setup("qwen3")
    toks = torch.as_tensor(np.random.default_rng(1).integers(1, 256, 120))
    pos = torch.arange(119)
    best = ref.logits_at(w, cfg, toks, pos).argmax(-1)
    seq = {"tokens": toks, "positions": pos, "served": best}
    out = ref.judge(w, cfg, [seq], "cpu", precision="fp8")
    assert out["gaps"].max() == 0.0
    assert out["control"].max() > 1e-3
    wrong = dict(seq, served=(best + 1) % 256)
    assert ref.judge(w, cfg, [wrong], "cpu")["gaps"].max() > 1e-3


def test_reference_refuses_what_it_does_not_compute():
    ref, cfg, _ = _setup("qwen3")
    for key, value in (("hidden_act", "gelu"), ("use_sliding_window", True),
                       ("model_type", "llama"),
                       ("rope_scaling", {"type": "yarn"})):
        with pytest.raises(ValueError):
            ref.reference_config_check(dict(cfg, **{key: value}))
