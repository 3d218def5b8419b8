"""Card-only tests of the PyTorch port: each CUDA kernel against its plain
PyTorch version at qwen3-4b's head shapes (fp32 with TF32 off, and
bf16), and the serving engine on the card against the same engine on
the CPU.  Without a card every test skips inside its fixture.

Run on the card:  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances, element by element against the plain version computed in
fp32 from the same inputs: fp32 |out - ref| ≤ 1e-4 (summation order).
bf16: the kernels round p to bf16 before the PV product, as the TPU
kernels do, and round the output once, each a relative error of at most
u = 2^-8, so |out - ref| ≤ u·(Σ p|v| / l + |ref|) + 1e-4, where the first
term is the plain version on |v|; and the max abs error ≤ 2e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import decode_attn as dec  # noqa: E402
from repro_torch.kernels import ragged_prefill as rp  # noqa: E402
from repro_torch.kernels.ref import kernel_error_bound  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402

pytestmark = pytest.mark.gpu
HQ, HKV, D, PS, NPAGES, PMAX = 32, 8, 128, 16, 320, 160
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _assert_held(out, plain, q, k, v, *index):
    ref, bound = kernel_error_bound(plain, out.dtype, q, k, v, *index)
    err = (out.float() - ref).abs()
    assert err.max().item() <= TOL[out.dtype]
    assert (err <= bound).all()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _table(rng, kv_lens, share=None):
    t = np.zeros((len(kv_lens), PMAX), np.int32)
    free = list(rng.permutation(NPAGES))
    for i, n in enumerate(kv_lens):
        need = -(-n // PS)
        t[i, :need] = [free.pop() for _ in range(need)]
    if share is not None:
        a, b, k = share
        t[b, :k] = t[a, :k]
    return t


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _i32(x, dev):
    return torch.as_tensor(np.asarray(x, np.int32), device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lens,hists,share", [
    ([37, 5, 1, 64], [0, 21, 40, 3], None),
    ([9, 17, 1], [48, 48, 70], (0, 1, 3)),
    ([256, 3, 1], [1800, 40, 900], None),
])
def test_ragged_prefill_paged_kernel_matches_plain(card, dtype, lens, hists,
                                                   share):
    rng = np.random.default_rng(0)
    g = torch.Generator(device=card).manual_seed(0)
    kvl = [h + n for h, n in zip(hists, lens)]
    table = _table(rng, kvl, share)
    cu = np.concatenate([[0], np.cumsum(lens)])
    q = torch.randn((int(cu[-1]) + 7, HQ, D), generator=g,
                    device=card).to(dtype)
    k = torch.randn((NPAGES, PS, HKV, D), generator=g, device=card).to(dtype)
    v = torch.randn((NPAGES, PS, HKV, D), generator=g, device=card).to(dtype)
    idx = [_i32(x, card) for x in (table, cu, hists, kvl)]
    n0 = rp.ragged_prefill_paged.launches
    out = rp.ragged_prefill_paged(q, k, v, *idx)
    torch.cuda.synchronize()
    assert rp.ragged_prefill_paged.launches == n0 + 1
    _assert_held(out, rp.ragged_prefill_paged_plain, q, k, v, *idx)
    assert (out[int(cu[-1]):] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_paged_kernel_matches_plain(card, dtype):
    rng = np.random.default_rng(1)
    g = torch.Generator(device=card).manual_seed(1)
    lengths = [0, 1, 17, 2053, 129, 64]
    table = _table(rng, lengths, (4, 5, 4))
    q = torch.randn((len(lengths), HQ, D), generator=g,
                    device=card).to(dtype)
    k = torch.randn((NPAGES, PS, HKV, D), generator=g, device=card).to(dtype)
    v = torch.randn((NPAGES, PS, HKV, D), generator=g, device=card).to(dtype)
    idx = [_i32(table, card), _i32(lengths, card)]
    out = dec.decode_attn_paged(q, k, v, *idx)
    torch.cuda.synchronize()
    _assert_held(out, dec.decode_attn_paged_plain, q, k, v, *idx)
    assert (out[0] == 0).all()


def test_kernel_refuses_what_it_does_not_take(card):
    q = torch.zeros((4, HQ, 96), device=card)
    k = torch.zeros((NPAGES, PS, HKV, 96), device=card)
    with pytest.raises(ValueError, match="head_dim"):
        dec.decode_attn_paged(q, k, k, _i32(np.zeros((4, PMAX)), card),
                              _i32([1] * 4, card))


def test_engine_on_card_matches_engine_on_cpu(card):
    """The same schedule through the CUDA kernels and through the plain
    versions: the same greedy tokens, logits within 1e-4 (fp32)."""
    cfg = get_smoke("qwen3-4b").replace(head_dim=128)
    params = tr.init_params(cfg, seed=0, device="cpu")
    on_card = _to(params, card)
    ecfg = dict(num_slots=4, max_len=256, chunk_tokens=32, measure=False)
    engines = [Engine(cfg, params, EngineConfig(**ecfg), device="cpu"),
               Engine(cfg, on_card, EngineConfig(**ecfg), device=card)]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (70, 9, 33)]
    outs = []
    n_rp, n_dec = rp.ragged_prefill_paged.launches, \
        dec.decode_attn_paged.launches
    for e in engines:
        r = e.step_mixed([(i, p) for i, p in enumerate(prompts)], [])
        d = e.decode_batch([0, 1, 2], [r.tokens[i] for i in range(3)], 4)
        outs.append((r.tokens, d))
    assert outs[0] == outs[1]
    assert rp.ragged_prefill_paged.launches > n_rp
    assert dec.decode_attn_paged.launches > n_dec
    for s in range(3):
        np.testing.assert_allclose(engines[1].last_logits[s],
                                   engines[0].last_logits[s], atol=1e-4,
                                   rtol=0)
