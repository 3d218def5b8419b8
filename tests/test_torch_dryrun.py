"""The port's dry run (``repro_torch.launch.dryrun``): its collective
counter on hand-written steps over a fake world of 4 against the
reference parser's figures (``tests/test_dryrun_tools.py``), the shape
registry and accumulation rule, the kernels' meta branches (outputs and
workspace by shape, nothing launched), and every dry-run shape of the
qwen3-4b and mamba2-2.7b smoke configs through ``run_cell`` on the
16 x 16 and 2 x 16 x 16 production meshes."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed._functional_collectives as funcol  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import flash_attn as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.kernels.decode_attn import H100_SMS, split_plan  # noqa
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.specs import train_accum  # noqa: E402
from repro_torch.models.config import SHAPES, shape_by_name  # noqa: E402


@pytest.fixture
def group4():
    """A fake world of 4 and its flat mesh."""
    with dryrun.fake_world(4):
        yield init_device_mesh("cpu", (4,), mesh_dim_names=("model",))


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_collective_counter_structural_attribution(group4):
    """One bf16 all-gather whose result is (16, 256) counts 16·256·2
    bytes; an fp32 (8, 128) all-reduce run in a loop of 10 counts
    8·128·4 bytes, wire x2, x10 — every executed call, as the reference
    parser attributes its while-body to 10 trips."""
    w = dryrun.Watch()
    with w:
        funcol.all_gather_single(_meta(4, 256, dtype=torch.bfloat16), 0,
                                 (group4, 0))
        for _ in range(10):
            funcol.all_reduce(_meta(8, 128), "sum", (group4, 0))
    out = dryrun.collective_bytes(w.collectives)
    assert out["all-gather"] == 16 * 256 * 2
    assert out["all-reduce"] == 8 * 128 * 4 * 2 * 10
    assert out["total"] == out["all-gather"] + out["all-reduce"]


def test_collective_counter_nested_loops(group4):
    """A reduce-scatter with an fp32 (4, 4) result in a 10 x 7 loop nest
    counts 4·4·4·70 bytes."""
    w = dryrun.Watch()
    with w:
        for _ in range(10):
            for _ in range(7):
                funcol.reduce_scatter_single(_meta(16, 4), "sum", 0,
                                             (group4, 0))
    assert dryrun.collective_bytes(w.collectives)["reduce-scatter"] == \
        4 * 4 * 4 * 10 * 7


def test_watch_peak_follows_live_storages():
    """The peak is the most live bytes at once: a freed storage leaves
    the count, a view adds nothing."""
    w = dryrun.Watch()
    a = _meta(1024)
    w.hold(a)
    with w:
        b = a * 2                    # +4 KiB
        del b
        c = a + 1                    # +4 KiB, b's gone
        v = c[:10]                   # a view: no new storage
        assert v.untyped_storage().nbytes() == 4096
    assert w.peak == 2 * 4096 and w.live == 2 * 4096
    del c, v
    assert w.live == 4096


def test_shapes_registry():
    assert {s.name for s in SHAPES} == {"train_4k", "prefill_32k",
                                        "decode_32k", "long_500k"}
    assert shape_by_name("train_4k").tokens == 4096 * 256
    with pytest.raises(KeyError):
        shape_by_name("nope")


def test_train_accum_scales_with_model_size():
    small = get_config("qwen3-4b")
    big = get_config("jamba-v0.1-52b")
    a_small, mb_small = train_accum(shape_by_name("train_4k"), small)
    a_big, mb_big = train_accum(shape_by_name("train_4k"), big)
    assert a_small == 4 and mb_small == 64
    assert a_big == 8 and mb_big == 32


def _launches():
    return {k: v.launches for k, v in ops.LAUNCHERS.items()}


def test_meta_branches_allocate_and_launch_nothing():
    """On meta tensors each dispatcher and training form takes its CUDA
    branch: the launcher allocates its outputs and workspace by shape
    and launches nothing, and no count moves."""
    before = _launches()
    b, lq, s, hq, hkv, d = 2, 64, 256, 8, 2, 128
    q, k, v = _meta(b, lq, hq, d), _meta(b, s, hkv, d), _meta(b, s, hkv, d)
    i32 = torch.int32
    assert ops.mha(q, k, v).shape == q.shape
    qd = _meta(b, hq, d)
    assert ops.decode(qd, k, v, _meta(b, dtype=i32)).shape == qd.shape
    assert ops.decode_arena(qd, k, v, _meta(b, dtype=i32),
                            _meta(b, dtype=i32)).shape == qd.shape
    pages = _meta(16, 16, hkv, d)
    table = _meta(b, 4, dtype=i32)
    assert ops.decode_paged(qd, pages, pages, table,
                            _meta(b, dtype=i32)).shape == qd.shape
    qt = _meta(96, hq, d)
    cu, vec = _meta(b + 1, dtype=i32), _meta(b, dtype=i32)
    assert ops.ragged_mha(qt, k, v, cu, vec, vec).shape == qt.shape
    assert ops.ragged_mha_arena(qt, k, v, vec, cu, vec, vec).shape == \
        qt.shape
    assert ops.ragged_mha_paged(qt, pages, pages, table, cu, vec,
                                vec).shape == qt.shape
    tok, p_d, alt = ops.fused_sample(_meta(3, 1000), *[_meta(3)] * 3,
                                     _meta(3, ops.MAX_BIAS, dtype=i32),
                                     _meta(3, ops.MAX_BIAS), _meta(3),
                                     _meta(3, dtype=i32))
    assert tok.shape == (3,) and tok.dtype == torch.int32
    x = _meta(b, 300, 16, 64)
    y, st = ops.ssd_grouped(x, _meta(b, 300, 16), _meta(16),
                            _meta(b, 300, 2, 128), _meta(b, 300, 2, 128))
    assert y.shape == x.shape and st.shape == (b, 16, 64, 128)
    # the training forms: forward with its lse / chunk states, backward
    qg = q.requires_grad_()
    fa.FlashAttnFn.apply(qg, k, v, vec, vec, True, None).sum().backward()
    assert qg.grad.shape == q.shape
    xg = x.requires_grad_()
    yy, _ = ss.SSDScanFn.apply(xg, _meta(b, 300, 16), _meta(16),
                               _meta(b, 300, 2, 128), _meta(b, 300, 2, 128),
                               _meta(b, 16, 64, 128), 128)
    yy.sum().backward()
    assert xg.grad.shape == x.shape
    assert _launches() == before


def test_meta_branches_count_the_kernels_workspace():
    """The watch counts a launcher's workspace: the decode split plan's
    fp32 partials (at an H100's 132 SMs), ``flash_attn_bwd``'s delta and
    ``ssd_scan_bwd``'s fp32 partials."""
    b, s, hq, hkv, d = 2, 4096, 32, 8, 128
    plan = split_plan(b, hq, hkv, d, s, H100_SMS)
    assert plan.workspace
    q, k = _meta(b, hq, d, dtype=torch.bfloat16), \
        _meta(b, s, hkv, d, dtype=torch.bfloat16)
    lens = _meta(b, dtype=torch.int32)
    w = dryrun.Watch()
    with w:
        ops.decode(q, k, k, lens)
    ws = 4 * torch.Size(plan.workspace).numel()
    assert w.peak == ws + q.nbytes
    qq = _meta(b, 64, hq, d, dtype=torch.bfloat16)
    kv = _meta(b, 64, hkv, d, dtype=torch.bfloat16)
    vec = _meta(b, dtype=torch.int32)
    o, lse = fa.flash_attn(qq, kv, kv, vec, vec, return_lse=True)
    w = dryrun.Watch()
    with w:
        fa.flash_attn_bwd(qq, kv, kv, o, lse, o, vec, vec)
    delta = b * hq * 64 * 4
    assert w.peak == qq.nbytes + 2 * kv.nbytes + delta
    x = _meta(b, 256, 16, 64)
    args = (x, _meta(b, 256, 16), _meta(16), _meta(b, 256, 1, 128),
            _meta(b, 256, 1, 128))
    _, _, states = ss.ssd_scan(*args, _meta(b, 16, 64, 128),
                               return_states=True)
    w = dryrun.Watch()
    with w:
        ss.ssd_scan_bwd(*args, states, x)
    work = 4 * ss.bwd_workspace_floats(b, 256, 16, 64, 128, 1, 128)
    outs = x.nbytes + 4 * (b * 256 * 16 + 16 + b * 16 * 64 * 128) \
        + 2 * 4 * b * 256 * 128
    assert w.peak == outs + work


def _smoke_cells(arch, meshes, names):
    """Dry-run shapes ``names`` of ``arch``'s smoke config (head_dim
    raised to 64, a width the kernels take) through ``run_cell`` on each
    of ``meshes`` (multi-pod or not): {(multi, shape): the record's
    checked fields}."""
    cfg = get_smoke(arch).replace(dtype="bfloat16")
    if cfg.num_heads:
        cfg = cfg.replace(head_dim=64)
    out = {}
    for multi in meshes:
        for name in names:
            # two microbatches (``--opt accum2``) keep train cells short
            opts = ("accum2",) if name == "train_4k" else ()
            rec = dryrun.run_cell(arch, name, multi, verbose=False,
                                  opts=opts, cfg=cfg)
            out[multi, name] = {k: rec.get(k) for k in (
                "skipped", "devices", "memory", "bottleneck", "roofline",
                "collectives", "model_flops")}
    return out


def test_dry_run_smoke_configs_every_cell():
    """Every dry-run shape of the qwen3-4b and mamba2-2.7b smoke configs
    on both production meshes through ``run_cell`` (in six processes,
    each over its own fake worlds): positive bytes and a named
    bottleneck; ``long_500k`` skipped for full attention, for the
    reference's reason, and run for the SSM family."""
    import concurrent.futures as cf
    import multiprocessing as mp
    names = [s.name for s in SHAPES]
    rest = [n for n in names if n != "train_4k"]
    # the 2 x 16 x 16 cells cost the most (DTensor's strategy search
    # over a 3-D mesh), its train cells most of all
    jobs = [(a, m, n) for a in ("qwen3-4b", "mamba2-2.7b")
            for m, n in (((True,), ["train_4k"]), ((True,), rest),
                         ((False,), names))]
    with cf.ProcessPoolExecutor(len(jobs),
                                mp_context=mp.get_context("spawn")) as ex:
        results = list(ex.map(_smoke_cells, *zip(*jobs)))
    cells = {}
    for (arch, _, _), got in zip(jobs, results):
        for (multi, name), rec in got.items():
            cells[arch, multi, name] = rec
    assert len(cells) == 2 * 2 * len(SHAPES)
    for (arch, multi, name), rec in cells.items():
        if arch == "qwen3-4b" and name == "long_500k":
            assert rec["skipped"] == ("full quadratic attention cannot "
                                      "serve 500k context")
            continue
        assert rec["devices"] == (512 if multi else 256)
        mem = rec["memory"]
        assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
        assert mem["peak_device_bytes"] >= mem["argument_bytes"]
        assert rec["bottleneck"] in rec["roofline"]
        assert rec["collectives"]["total"] >= 0
        assert rec["model_flops"] > 0


def test_int8_options_halve_the_stored_bytes():
    """``--opt int8w,int8kv``: weights of two or more dims and the bf16
    KV cache stored int8 (dequantized at use, requantized on write) —
    the decode cell's argument bytes fall to about half."""
    cfg = get_smoke("qwen3-4b").replace(dtype="bfloat16", head_dim=64)
    base = dryrun.run_cell("qwen3-4b", "decode_32k", False, verbose=False,
                           cfg=cfg)
    q = dryrun.run_cell("qwen3-4b", "decode_32k", False, verbose=False,
                        opts=("int8kv", "int8w"), cfg=cfg)
    ratio = q["memory"]["argument_bytes"] / base["memory"]["argument_bytes"]
    assert 0.49 < ratio < 0.55, ratio
    assert q["opts"] == ["int8kv", "int8w"]
