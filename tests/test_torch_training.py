"""Training in the PyTorch port (``repro_torch.{optim,checkpoint,
training}``, ``launch.train``, ``forward(remat=)``) against the JAX
package, on the CPU, at smoke configs in fp32, from one seed's numpy
inputs and the JAX params converted with ``params_from_numpy`` (and the
JAX optimizer state with ``opt_state_from_numpy``):

- ``cross_entropy`` with and without a mask, labels -1 masked out;
- ``lr_schedule`` through warmup, the cosine and its end;
- ``adamw_update`` from one converted state and grads (params, m, v,
  master), and clipping of 1e6 grads;
- the grads of ``make_loss_fn`` through ``forward(remat=False / True)``
  against ``jax.grad`` of the reference's loss, for qwen3-4b (qk-norm),
  qwen2.5-32b (qkv bias), mixtral-8x7b (window, dense MoE), qwen3-moe
  with 16 experts (the capacity dispatch and its aux loss), hubert
  (embeddings, encoder-only, no mask), mamba2 and jamba (the plain SSD
  scan; jamba's remat nests a checkpoint per layer in each group);
- one ``make_train_step`` (2 microbatches) against the reference's
  jitted step: loss, metrics and every param and state leaf;
- ``TrainLoop``: the loss falls, a run checkpointed and resumed equals
  the continuous one, checkpoints written by each package load in the
  other exactly (a bf16 leaf too, through its raw bits);
- ``SyntheticLM`` batches equal the reference's; the launcher on
  ``--device cpu`` and its refusals.

Tolerances: grads atol 1e-5 / rtol 1e-4 and the rest 1e-5 or 1e-6 as
stated at each test — both sides compute the same fp32 sums in another
order.  Adam's first update is lr · m̂ / (√v̂ + eps) ≈ lr · sign(g), so
a gradient that is 0 on one side and ~1e-12 on the other would move a
param by up to lr: the train-step test states where that is allowed.
"""
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one torch thread per test process: the suite runs in parallel
# workers, and torch's default of a thread per core in each of them
# oversubscribes the cores many times over
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.data import SyntheticConfig as JDataCfg  # noqa: E402
from repro.data import SyntheticLM as JData  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.configs import get_smoke as tget  # noqa: E402
from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM  # noqa
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.convert import (opt_state_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.training import TrainConfig, TrainLoop  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
# a leaf whose grads exceed 1 (an embedding row sums the grads of every
# position holding its token: jamba's smoke reaches 5.8) gets its atol
# scaled by its largest |grad|: there both packages lie up to ~2e-5 from
# the same grads computed in fp64
# arch, config changes on both sides, whether it takes embeddings
FAMILIES = {
    "qwen3-4b": ({}, False),
    "qwen2.5-32b": ({}, False),
    "mixtral-8x7b": ({}, False),
    "qwen3-moe-30b-a3b": (dict(num_experts=16), False),
    "hubert-xlarge": ({}, True),
    "mamba2-2.7b": ({}, False),
    "jamba-v0.1-52b": ({}, False),
}
B, L = 2, 16


def _cfgs(arch, **repl):
    return get_smoke(arch).replace(**repl), tget(arch).replace(**repl)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    """{path: numpy array} of a nested dict / list tree of arrays or
    tensors."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().float().numpy()
        return {prefix: np.asarray(tree, dtype=np.float32)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def _close(got, want, scaled=False, **tol):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        t = dict(tol)
        if scaled:
            t["atol"] *= max(1.0, float(np.abs(w[k]).max()))
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **t)


def _batch(cfg, seed, embeds, accum=None):
    rng = np.random.default_rng(seed)
    shape = (B, L) if accum is None else (accum, B, L)
    labels = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    if not cfg.is_encoder_only:
        labels[..., :3] = -1                    # masked out of the loss
    if embeds:
        x = rng.standard_normal(shape + (cfg.d_model,)).astype(np.float32)
    else:
        x = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    return x, labels


_JAX_GRADS = {}


def _jax_grads(arch):
    """(params numpy tree, batch, (total, loss), grads numpy tree) of the
    reference's loss at ``arch``'s smoke config, once per worker."""
    if arch not in _JAX_GRADS:
        repl, embeds = FAMILIES[arch]
        jcfg, _ = _cfgs(arch, **repl)
        params, _ = jtr.init_params(jcfg, jax.random.key(7))
        x, labels = _batch(jcfg, 11, embeds)
        loss_fn = jts.make_loss_fn(jcfg, remat=False)
        fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        if embeds:
            (tot, loss), g = fn(params, None, jnp.asarray(labels),
                                jnp.asarray(x))
        else:
            (tot, loss), g = fn(params, jnp.asarray(x), jnp.asarray(labels))
        _JAX_GRADS[arch] = (_np(params), (x, labels),
                            (float(tot), float(loss)), _np(g))
    return _JAX_GRADS[arch]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_loss_grads_match_jax(arch, remat):
    repl, embeds = FAMILIES[arch]
    params_np, (x, labels), (tot_w, loss_w), grads_w = _jax_grads(arch)
    _, tcfg = _cfgs(arch, **repl)
    params = params_from_numpy(params_np, tcfg, "cpu")
    live = tadamw.tree_map(lambda p: p.requires_grad_(), params)
    loss_fn = tts.make_loss_fn(tcfg, remat=remat)
    xt, lt = torch.from_numpy(x), torch.from_numpy(labels)
    if embeds:
        tot, loss = loss_fn(live, None, lt, embeds=xt)
    else:
        tot, loss = loss_fn(live, xt, lt)
    leaves = tadamw.tree_leaves(live)
    grads = torch.autograd.grad(tot, leaves, allow_unused=True)
    grads = tadamw.tree_unflatten(live, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(leaves, grads)])
    assert float(tot.detach()) == pytest.approx(tot_w, rel=1e-5, abs=1e-6)
    assert float(loss) == pytest.approx(loss_w, rel=1e-5, abs=1e-6)
    _close(grads, grads_w, scaled=True, **GRAD_TOL)


def test_moe_aux_enters_the_total():
    """qwen3-moe's total is loss + 0.01 · aux, aux > 0 (the capacity
    dispatch's load-balance loss), on both sides."""
    _, _, (tot, loss), _ = _jax_grads("qwen3-moe-30b-a3b")
    assert tot > loss


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = None
    if masked:
        labels[0, :4] = -1
        labels[2] = -1
        mask = labels >= 0
    want = jts.cross_entropy(jnp.asarray(logits),
                             jnp.maximum(jnp.asarray(labels), 0),
                             None if mask is None else jnp.asarray(mask))
    got = tts.cross_entropy(torch.from_numpy(logits),
                            torch.clamp(torch.from_numpy(labels), min=0),
                            None if mask is None else torch.from_numpy(mask))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_cross_entropy_of_an_all_masked_batch_is_zero():
    logits = torch.zeros(2, 3, 5)
    labels = torch.zeros(2, 3, dtype=torch.int64)
    assert float(tts.cross_entropy(logits, labels,
                                   torch.zeros(2, 3, dtype=torch.bool))) == 0


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 55, 99, 100, 140])
def test_lr_schedule_matches_jax(step):
    cfg = dict(lr=1e-2, warmup_steps=10, total_steps=100)
    want = float(jadamw.lr_schedule(jadamw.AdamWConfig(**cfg),
                                    jnp.asarray(step)))
    got = float(tadamw.lr_schedule(tadamw.AdamWConfig(**cfg), step))
    assert got == pytest.approx(want, rel=1e-6)


def test_adamw_update_matches_jax():
    """From one state (one update already taken, so m and v are not 0)
    and one set of grads: params, m, v and master within 1e-6."""
    jcfg, tcfg = _cfgs("qwen3-4b")
    params, _ = jtr.init_params(jcfg, jax.random.key(3))
    rng = np.random.default_rng(4)

    def grads():
        return jax.tree.map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(
                np.float32) * 1e-2), params)

    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=10, grad_clip=0.5)
    jstate = jadamw.adamw_init(params)
    _, jstate, _ = jadamw.adamw_update(grads(), jstate,
                                       jadamw.AdamWConfig(**ocfg))
    tstate = opt_state_from_numpy(_np(jstate), tcfg, "cpu")
    g = grads()
    jp, jstate2, jm = jadamw.adamw_update(g, jstate,
                                          jadamw.AdamWConfig(**ocfg))
    tp, tstate2, tm = tadamw.adamw_update(
        params_from_numpy(_np(g), tcfg, "cpu"), tstate,
        tadamw.AdamWConfig(**ocfg))
    assert int(tstate2["count"]) == int(jstate2["count"]) == 2
    for k in ("lr", "grad_norm"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
    _close(tp, _np(jp), atol=1e-6, rtol=1e-6)
    for k in ("m", "v", "master"):
        _close(tstate2[k], _np(jstate2[k]), atol=1e-6, rtol=1e-6)
    # the params are a copy of the master, never an alias
    for p, m in zip(tadamw.tree_leaves(tp),
                    tadamw.tree_leaves(tstate2["master"])):
        assert p.data_ptr() != m.data_ptr()


def test_grad_clip_and_schedule():
    """The port's form of the reference's own test: huge grads are
    clipped, the update stays bounded, the norm is reported."""
    cfg = tadamw.AdamWConfig(lr=1e-2, warmup_steps=10, total_steps=100,
                             grad_clip=1.0)
    assert float(tadamw.lr_schedule(cfg, 5)) == pytest.approx(5e-3)
    end = float(tadamw.lr_schedule(cfg, 100))
    assert end == pytest.approx(cfg.lr * cfg.min_lr_ratio, rel=1e-3)
    params = {"w": torch.ones(4)}
    state = tadamw.adamw_init(params)
    p2, _, m = tadamw.adamw_update({"w": torch.full((4,), 1e6)}, state, cfg)
    assert float(m["grad_norm"]) > 1e5
    assert float((p2["w"] - params["w"]).abs().max()) < 0.1


def test_train_step_matches_jax():
    """One step of 2 microbatches from the same params, state and batch
    as the reference's jitted step: loss and metrics within 1e-5, every
    param and state leaf within 1e-5, but where a grad is under 1e-6:
    Adam's first update there amplifies the grad's fp32 rounding."""
    jcfg, tcfg = _cfgs("qwen3-4b")
    params, _ = jtr.init_params(jcfg, jax.random.key(5))
    jstate = jadamw.adamw_init(params)
    x, labels = _batch(jcfg, 6, False, accum=2)
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    step = jax.jit(jts.make_train_step(jcfg, jadamw.AdamWConfig(**ocfg),
                                       accum=2))
    tp0 = params_from_numpy(_np(params), tcfg, "cpu")
    tstate = opt_state_from_numpy(_np(jstate), tcfg, "cpu")
    jp, jstate2, jm = step(params, jstate, {"tokens": jnp.asarray(x),
                                            "labels": jnp.asarray(labels)})
    tstep = tts.make_train_step(tcfg, tadamw.AdamWConfig(**ocfg), accum=2)
    tp, tstate2, tm = tstep(tp0, tstate, {"tokens": x, "labels": labels})
    for k in ("loss", "lr", "grad_norm"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5)
    for k in ("m", "v"):
        _close(tstate2[k], _np(jstate2[k]), atol=1e-5, rtol=1e-4)
    # the first update is lr · g / (|g| + eps) per element: where |g| <
    # 1e-6 (|m| = 0.1 |g| < 1e-7), the fp32 rounding of g moves it by up
    # to 2 lr; everywhere else params and masters agree within 1e-5
    lr = float(jm["lr"])
    m = _flat(_np(jstate2["m"]))
    for got, want in ((_flat(tp), _flat(_np(jp))),
                      (_flat(tstate2["master"]),
                       _flat(_np(jstate2["master"])))):
        assert got.keys() == want.keys()
        for k in want:
            tiny = np.abs(m[k]) < 1e-7
            err = np.abs(got[k] - want[k])
            assert (err[~tiny] <= 1e-5).all(), k
            assert (err[tiny] <= 2 * lr).all(), k


def test_train_loop_loss_decreases():
    cfg = tget("qwen3-4b")
    dcfg = SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=32, batch=8,
                           accum=1, seed=7)
    loop = TrainLoop(cfg, tadamw.AdamWConfig(lr=1e-3, warmup_steps=3,
                                             total_steps=40),
                     SyntheticLM(dcfg), TrainConfig(steps=20, log_every=5),
                     log_fn=lambda s: None, device="cpu")
    loop.run(0)
    losses = [h["loss"] for h in loop.history]
    assert losses[-1] < losses[0] - 0.3


def _loop(cfg, dcfg, ocfg, d, steps, every):
    return TrainLoop(cfg, ocfg, SyntheticLM(dcfg),
                     TrainConfig(steps=steps, ckpt_dir=d, ckpt_every=every,
                                 log_every=100),
                     log_fn=lambda s: None, device="cpu")


def test_checkpoint_restart_exact():
    """A continuous run and a run checkpointed at step 5, stopped and
    resumed to 10 reach the same params and state (within 1e-6; on one
    CPU they are bit for bit the same)."""
    cfg = tget("stablelm-1.6b")
    dcfg = SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=16, batch=4,
                           accum=1, seed=3)
    ocfg = tadamw.AdamWConfig(lr=5e-4, warmup_steps=2, total_steps=20)
    with tempfile.TemporaryDirectory() as d:
        p_cont, s_cont = _loop(cfg, dcfg, ocfg, None, 10, 50).run(1)
        _loop(cfg, dcfg, ocfg, d, 5, 5).run(1)
        assert tckpt.latest_step(d) == 5
        p_res, s_res = _loop(cfg, dcfg, ocfg, d, 10, 100).run(1)
    _close(p_res, p_cont, atol=1e-6, rtol=0)
    _close(s_res, s_cont, atol=1e-6, rtol=0)


def test_checkpoints_move_between_the_packages():
    """The reference's checkpoint loads into the port's trees exactly,
    and the port's into the reference's: the same npz keys."""
    jcfg, tcfg = _cfgs("qwen3-4b")
    params, _ = jtr.init_params(jcfg, jax.random.key(9))
    rng = np.random.default_rng(9)
    g = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape)
                                           .astype(np.float32)), params)
    _, jstate, _ = jadamw.adamw_update(g, jadamw.adamw_init(params),
                                       jadamw.AdamWConfig())
    tparams = params_from_numpy(_np(params), tcfg, "cpu")
    tstate = opt_state_from_numpy(_np(jstate), tcfg, "cpu")
    with tempfile.TemporaryDirectory() as d:
        jckpt.save_checkpoint(d, 4, params, jstate, {"data": {"step": 4}})
        tp, ts, meta = tckpt.load_checkpoint(
            d, 4, ttr.init_params(tcfg, seed=1, device="cpu"),
            tadamw.adamw_init(tparams))
        assert meta == {"step": 4, "data": {"step": 4}}
        _close(tp, _np(params), atol=0, rtol=0)
        _close(ts, _np(jstate), atol=0, rtol=0)
        assert int(ts["count"]) == 1 and ts["count"].dtype == torch.int32

        tckpt.save_checkpoint(d, 6, tparams, tstate)
        with np.load(os.path.join(d, "step_6", "params.npz")) as z, \
                np.load(os.path.join(d, "step_4", "params.npz")) as zj:
            assert sorted(z.files) == sorted(zj.files)
        assert tckpt.latest_step(d) == jckpt.latest_step(d) == 6
        jp, js, _ = jckpt.load_checkpoint(d, 6, params, jstate)
        _close(_np(jp), tparams, atol=0, rtol=0)
        _close(_np(js), tstate, atol=0, rtol=0)


def test_bf16_checkpoint_round_trips_bit_for_bit():
    """A bfloat16 leaf is written as its raw 16-bit patterns (``|V2``,
    the bytes the reference's numpy writes for bf16) and loads back
    bit for bit."""
    cfg = tget("qwen3-4b").replace(dtype="bfloat16")
    params = ttr.init_params(cfg, seed=2, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        tckpt.save_checkpoint(d, 1, params)
        with np.load(os.path.join(d, "step_1", "params.npz")) as z:
            assert z["embed"].dtype == np.dtype("V2")
        back, _, _ = tckpt.load_checkpoint(
            d, 1, ttr.init_params(cfg, seed=3, device="cpu"))
    for a, b in zip(tadamw.tree_leaves(params), tadamw.tree_leaves(back)):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b)
    # the reference writes the same bytes for the same bf16 values
    jb = jnp.asarray(params["embed"].float().numpy(), jnp.bfloat16)
    np.testing.assert_array_equal(
        np.asarray(jb).view(np.uint16),
        tckpt._to_numpy(params["embed"]).view(np.uint16))


def test_synthetic_batches_equal_the_references():
    kw = dict(vocab_size=100, seq_len=16, batch=2, accum=2, seed=5)
    a, b = SyntheticLM(SyntheticConfig(**kw)), JData(JDataCfg(**kw))
    for _ in range(3):
        x, y = a.next_batch(), b.next_batch()
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(x[k], y[k])
    a.restore({"step": 1})
    b.restore({"step": 1})
    np.testing.assert_array_equal(a.next_batch()["tokens"],
                                  b.next_batch()["tokens"])


def test_launcher_on_cpu_trains_and_checkpoints():
    with tempfile.TemporaryDirectory() as d:
        loop = tlaunch.main(["--device", "cpu", "--steps", "4", "--batch",
                             "4", "--seq-len", "16", "--ckpt-dir", d,
                             "--ckpt-every", "2"])
        assert sorted(os.listdir(d)) == ["step_2", "step_4"]
        assert np.isfinite(loop.history[-1]["loss"])
        # resumed at its last step, nothing left to run
        again = tlaunch.main(["--device", "cpu", "--steps", "4", "--batch",
                              "4", "--seq-len", "16", "--ckpt-dir", d])
        assert again.history == [] or again.history[-1]["step"] == 4


def test_launcher_trains_the_ssm_family_on_the_cpu():
    loop = tlaunch.main(["--arch", "mamba2-2.7b", "--device", "cpu",
                         "--steps", "2", "--batch", "2", "--seq-len", "16"])
    assert np.isfinite(loop.history[-1]["loss"])


@pytest.mark.parametrize("argv", [[], ["--full", "--layers", "8"]],
                         ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-v0.1-52b"])
def test_launcher_takes_the_ssm_family_on_the_card(arch, argv, monkeypatch):
    """mamba2 and jamba train on the default device, the card, through
    ``ssd_scan``'s backward kernel: the launcher no longer refuses them
    and hands their config to the loop on "cuda" (the loop is stubbed
    here, so nothing is allocated)."""
    seen = {}

    class Loop:
        def __init__(self, cfg, ocfg, data, tcfg, device):
            seen.update(cfg=cfg, device=device)
            self.history = []

        def run(self, seed):
            seen["ran"] = seed

    monkeypatch.setattr(tlaunch, "TrainLoop", Loop)
    tlaunch.main(["--arch", arch, "--steps", "1", *argv])
    assert seen["device"] == "cuda" and seen["ran"] == 0
    assert seen["cfg"].family in ("ssm", "hybrid")
    if argv:
        assert seen["cfg"].num_layers == 8


def test_launcher_refuses_a_layer_count_off_the_pattern():
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", "jamba-v0.1-52b", "--device", "cpu",
                      "--layers", "3"])


def test_forward_remat_refuses_caches():
    cfg = tget("qwen3-4b")
    params = ttr.init_params(cfg, seed=0, device="cpu")
    caches = ttr.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="remat"):
        ttr.forward(params, cfg, torch.zeros(1, 2, dtype=torch.int64),
                    caches=caches, remat=True)
