"""The port's one differentiable row gather `take_rows` and the rule of its
backward: each cell of d(table) the float64 sum of its cotangents, rounded
once, the row ``pad_row`` names zero.

On the CPU: `csrc/host_take_rows.cpp`, built with g++, runs the backward
kernels' summing code (`take_rows.cuh`): the shared instantiation block by
block and warp by warp with the kernel's own span and cross-block order,
the global one's float64 atomics in row order. Both are held against torch's
float64 ``index_add_`` at the shapes the port gathers (BASELINE config 4:
16,256 rows from 2 drawcall transforms or materials, the Morton and raster
permutations), on each side of the shared cap, on a replay table padded
with its zero row, and with a 2-D index of heavy duplicates. Tolerance: one float32 ulp of the float64
sum. Both round a float64 sum once, and their float64 sums differ from
index_add_'s only in the order of the adds, far below that.

The card's implementation is a function of the table's cells N * F and the
gathered rows M alone, split at the cap the header sets (the largest table
whose per-warp float64 slices fit a block's 48 KB of shared memory; the
CUDA library exports the same constant). `take_rows` on CPU tensors
gathers ``table[idx]``'s values, and its backward is float64
``embedding_dense_backward`` cast once, bit for bit; a CPU training step
holds to the same step through ``table[idx]``, and the config-4 training
steps give the same bits on 1 and on 8 threads; the tables the kernels read
and the staged and replay routes' gathers hold no ``IndexBackward0`` or
``EmbeddingBackward0``; a pad row's d(table) is zero and every other row
the same bits as without it, and the replay route's gather drops the
cotangents of its -1 selections.

Marked ``cuda`` (skip without a card): the card's backward against float64
``index_add_`` (same tolerance) and bit for bit against the host build
(the shared instantiation, and the global one on a permutation), d(table)
bit-equal across runs (the same), a pad row zero and the other rows
unchanged, the library's cap the host build's, the
launch counters, no ``indexing_backward`` kernel in a config-4 ``mse_step``
or ``dual_train_step``, and those two steps at 1920x1080 against the same
steps through ``table[idx]``: the loss the same bits, each of the ten
gradient leaves within GRAD_ULPS float32 ulps of its largest entry.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from ptre_tpu_torch.models import demo
from ptre_tpu_torch.models import scene as scene_mod
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops import integrator, intersect, path_replay
from ptre_tpu_torch.ops import rng
from ptre_tpu_torch.ops.cuda import build
from ptre_tpu_torch.ops.cuda import fused_grad as fg
from ptre_tpu_torch.ops.cuda import raster_kernel as rk
from ptre_tpu_torch.ops.cuda import take_rows as tr
from ptre_tpu_torch.parallel import sharding as sh
from ptre_tpu_torch.render import rasterizer as ras
from ptre_tpu_torch.render import train
from ptre_tpu_torch.utils.config import RasterConfig, RenderConfig

#: the modules whose gathers go through `take_rows`
SITES = (scene_mod, path_replay, fg, ras, rk, intersect, integrator)


def _dup_index(m, n_other, seed):
    """(m,) int64: row 0 everywhere but ``n_other`` rows that name row 1,
    as config 4's drawcall and material indices (the ball and its padding,
    and the cube)."""
    idx = torch.zeros(m, dtype=torch.int64)
    idx[torch.randperm(m, generator=torch.Generator().manual_seed(seed))[:n_other]] = 1
    return idx


def _perm(m, seed):
    return torch.randperm(m, generator=torch.Generator().manual_seed(seed))


def _random(m, n, seed):
    return torch.randint(0, n, (m,), generator=torch.Generator().manual_seed(seed))


def _hot_2d(b, r, n, seed):
    """(b, r) int64 into n rows, three in four naming row 7: a ray gather's
    heavy duplicates (the staged triangle gather, the replay route's
    winner rows), one leading slice a bounce."""
    return torch.where(_random(b * r, 4, seed) > 0, 7, _random(b * r, n, seed + 1)).reshape(b, r)


#: (name, N, F, index): the port's gathers at config 4's shapes, the cap's
#: two sides, an index that never names half the rows, a small replay table
#: of 8 rows and its zero row, and a 2-D index of heavy duplicates
CASES = [
    ("drawcall_transforms", 2, 16, lambda: _dup_index(16256, 12, 1)),
    ("materials", 2, 5, lambda: _dup_index(16256, 12, 2)),
    ("raster_transforms", 4, 16, lambda: torch.cat([_dup_index(16256, 0, 0),
                                                    torch.tensor([1] * 12 + [2, 3] * 160)])),
    ("morton_perm_27", 16256, 27, lambda: _perm(16256, 3)),
    ("raster_perm_32", 16640, 32, lambda: _perm(16640, 4)),
    ("at_cap", 47, 16, lambda: _random(5000, 47, 5)),
    ("past_cap", 48, 16, lambda: _random(5000, 48, 6)),
    ("unnamed_rows", 40, 7, lambda: _random(3000, 20, 7)),
    ("padded_replay_table", 9, 27, lambda: _random(12000, 9, 8)),
    ("hot_rows_2d", 64, 18, lambda: _hot_2d(3, 4000, 64, 9)),
]


def _case(case, seed=11):
    """(N, F, idx, g (*idx.shape, F)) of a case."""
    name, n, f, make = case
    idx = make()
    g = torch.randn((*idx.shape, f), generator=torch.Generator().manual_seed(seed))
    return n, f, idx, g


def _float64_sum(g, idx, n):
    """The float64 sum of each row's cotangents."""
    idx, g = idx.cpu().reshape(-1), g.cpu().reshape(idx.numel(), -1).double()
    return torch.zeros((n, g.shape[1]), dtype=torch.float64).index_add_(0, idx, g)


def _assert_within_an_ulp(got, want64):
    """Every cell of the float32 ``got`` within one float32 ulp of the
    float64 sum ``want64``."""
    got = got.cpu()
    want = want64.to(torch.float32).abs()
    ulp = (torch.nextafter(want, torch.tensor(float("inf"))) - want).double()
    assert bool(((got.double() - want64).abs() <= ulp).all())


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.fail("no C++ compiler (g++) to build csrc/host_take_rows.cpp")
    out = str(tmp_path_factory.mktemp("take_rows") / "libptre_host_take_rows.so")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall", "-Werror", "-o",
                    out, os.path.join(build.CSRC_DIR, "host_take_rows.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    ptr = ctypes.c_void_p
    lib.ptre_take_rows_max_cells_host.restype = ctypes.c_int
    lib.ptre_take_rows_blocks_host.restype = ctypes.c_longlong
    lib.ptre_take_rows_blocks_host.argtypes = [ctypes.c_longlong]
    for fn in (lib.ptre_take_rows_shared_host, lib.ptre_take_rows_global_host):
        fn.restype = None
        fn.argtypes = [ptr, ptr, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ptr]
    return lib


def _host_sum(host, kind, g, idx, n):
    idx = idx.cpu().reshape(-1).contiguous()
    g = g.cpu().reshape(idx.numel(), -1).contiguous()
    out = torch.empty((n, g.shape[1]), dtype=torch.float32)
    fn = host.ptre_take_rows_shared_host if kind == "shared" else host.ptre_take_rows_global_host
    fn(g.data_ptr(), idx.data_ptr(), g.shape[0], n, g.shape[1], out.data_ptr())
    return out


# ---- on the CPU ----------------------------------------------------------------------


def _kind(host, n, f, m):
    return tr.instantiation(n, f, m, host.ptre_take_rows_max_cells_host())


def _host_kind(host, n, f, m):
    """The kernel the host build runs for a case: the card's, and the
    global one where the card sums by segments (``embedding``'s backward,
    no kernel of the unit)."""
    kind = _kind(host, n, f, m)
    return "global" if kind == "segments" else kind


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_host_build_within_an_ulp_of_float64(host, case):
    n, f, idx, g = _case(case)
    got = _host_sum(host, _host_kind(host, n, f, idx.numel()), g, idx, n)
    _assert_within_an_ulp(got, _float64_sum(g, idx, n))
    if case[0] == "unnamed_rows":
        assert bool((got[20:] == 0).all())


@pytest.mark.parametrize("case", [c for c in CASES if c[1] * c[2] <= 4096],
                         ids=[c[0] for c in CASES if c[1] * c[2] <= 4096])
def test_both_host_instantiations_agree_with_float64(host, case):
    """The shared body past its cap (the host has no shared memory) and the
    global one below it: each within an ulp of float64."""
    n, f, idx, g = _case(case, seed=12)
    want = _float64_sum(g, idx, n)
    for kind in ("shared", "global"):
        _assert_within_an_ulp(_host_sum(host, kind, g, idx, n), want)


def test_host_constants_are_the_wrapper_s(host):
    """The cap is the most cells whose 8 per-warp float64 slices and the
    block's 256 int32 row indices fit 48 KB of shared memory; a block takes
    256 rows."""
    cap = host.ptre_take_rows_max_cells_host()
    assert cap * 8 * 8 + 256 * 4 <= 48 * 1024 < (cap + 1) * 8 * 8 + 256 * 4
    for m in (1, 255, 256, 257, 16256):
        assert host.ptre_take_rows_blocks_host(m) == -(-m // 256)


def test_instantiation_is_a_function_of_the_cells_alone(host):
    """The card's implementation from N * F and M alone: "shared" up to the
    cap whatever M; past it "global" where M <= N, else "segments"."""
    cap = host.ptre_take_rows_max_cells_host()
    for cells in (1, 32, 10, cap - 1, cap, cap + 1, 16256 * 27):
        for n in (n for n in range(1, 17) if cells % n == 0):
            for m in (1, n, n + 1, 2073600):
                want = "shared" if cells <= cap else "global" if m <= n else "segments"
                assert _kind(host, n, cells // n, m) == want, (cells, n, m)
    # the port's sites at config 4's shapes: the drawcall transforms, the
    # materials, the Morton and raster permutations, the staged sphere and
    # triangle gathers at 1080p, the replay route's rows of a small table
    assert _kind(host, 2, 16, 16256) == "shared" and _kind(host, 2, 5, 16256) == "shared"
    assert _kind(host, 16256, 27, 16256) == "global"
    assert _kind(host, 16640, 32, 16640) == "global"
    assert _kind(host, 2, 4, 2073600) == "shared"
    assert _kind(host, 16256, 18, 2073600) == "segments"
    assert _kind(host, 27, 27, 5 * 2073600) == "shared"
    assert _kind(host, 28, 27, 5 * 2073600) == "segments"


def _embedding64(g, idx, n):
    """float64 ``embedding_dense_backward`` of each leading slice of a
    multi-dimensional index, the slices summed in float64: the rule's CPU
    sums, before the rounding."""
    if idx.dim() > 1:
        return sum(_embedding64(g[b], idx[b], n) for b in range(idx.shape[0]))
    return torch.ops.aten.embedding_dense_backward(g.double(), idx, n, -1, False)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_cpu_backward_equals_index_autograd(case):
    """On CPU tensors: the forward ``table[idx]``'s values; d(table) float64
    ``embedding_dense_backward`` cast once, bit for bit, and within a
    float32 ulp of float64 ``index_add_``."""
    n, f, idx, g = _case(case, seed=13)
    table = torch.randn((n, f), generator=torch.Generator().manual_seed(14))
    leaf = table.clone().requires_grad_(True)
    out = tr.take_rows(leaf, idx)
    assert torch.equal(out, table[idx])
    (d,) = torch.autograd.grad(out, leaf, g)
    assert d.dtype == torch.float32
    assert torch.equal(d, _embedding64(g, idx, n).to(torch.float32))
    _assert_within_an_ulp(d, _float64_sum(g, idx, n))


def _pad_of(idx):
    """The pad row of a case: the row its first index names."""
    return int(idx.reshape(-1)[0])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_cpu_pad_row_is_zero_and_the_rest_unchanged(case):
    """``pad_row`` (``embedding``'s ``padding_idx``): the forward
    ``table[idx]``'s values; d(table) zero in that row, every other row the
    same bits as without a pad row."""
    n, f, idx, g = _case(case, seed=18)
    pad = _pad_of(idx)
    table = torch.randn((n, f), generator=torch.Generator().manual_seed(19))
    leaf = table.clone().requires_grad_(True)
    out = tr.take_rows(leaf, idx, pad)
    assert torch.equal(out, table[idx])
    (d,) = torch.autograd.grad(out, leaf, g)
    (d0,) = torch.autograd.grad(tr.take_rows(leaf, idx), leaf, g)
    assert bool((d[pad] == 0).all())
    keep = torch.arange(n) != pad
    assert torch.equal(d[keep], d0[keep])


def test_replay_gather_drops_the_cotangents_of_unselected_rows():
    """`path_replay.gather_rows` of a (P, 27) table by a (B, R) selection
    with -1 where a ray has no winner: zeros there, and d(table) the float64
    sum of the selected rows' cotangents alone, cast once."""
    P, B, R = 8, 3, 4000
    table = torch.randn((P, 27), generator=torch.Generator().manual_seed(15))
    sel = _random(B * R, P + 1, 16).reshape(B, R) - 1
    g = torch.randn((B, R, 27), generator=torch.Generator().manual_seed(17))
    leaf = table.clone().requires_grad_(True)
    out = path_replay.gather_rows(leaf, sel)
    kept = sel >= 0
    assert bool((out[~kept] == 0).all()) and torch.equal(out[kept], table[sel[kept]])
    (d,) = torch.autograd.grad(out, leaf, g)
    assert torch.equal(d, _embedding64(g, torch.where(kept, sel, P), P + 1)[:P].float())
    _assert_within_an_ulp(d, _float64_sum(g[kept], sel[kept], P))


def test_any_index_and_row_shape():
    table = torch.randn((5, 3), requires_grad=True)
    idx = torch.tensor([[0, 4, 4], [2, 0, 0]], dtype=torch.int32)
    out = tr.take_rows(table, idx)
    assert out.shape == (2, 3, 3) and torch.equal(out, table[idx.long()])
    (d,) = torch.autograd.grad(out.sum(), table)
    assert torch.equal(d[:, 0], torch.tensor([3.0, 0.0, 1.0, 0.0, 2.0]))
    transforms = torch.randn((2, 4, 4), requires_grad=True)
    g = torch.randn((7, 4, 4))
    dc = torch.tensor([0, 1, 1, 0, 0, 0, 1])
    out = tr.take_rows(transforms, dc)
    assert out.shape == (7, 4, 4) and torch.equal(out, transforms[dc])
    (d,) = torch.autograd.grad(out, transforms, g)
    want = _float64_sum(g.reshape(7, 16), dc, 2).reshape(2, 4, 4)
    assert torch.equal(d, want.to(torch.float32))


def test_backward_runs_inside_its_span():
    table = torch.randn((4, 16), requires_grad=True)
    out = tr.take_rows(table, torch.tensor([0, 0, 3]))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out.sum().backward()
    assert "ptre.rows.backward" in {e.name for e in prof.events()}


def _graph_names(t):
    seen, stack, names = set(), [t.grad_fn], set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    return names


def _leaves(pkt, cam):
    return {k: v.detach().requires_grad_(True)
            for k, v in sh.differentiable_params(pkt, cam).items()}


def _small_config4():
    pkt = demo.config4_mixed_scene(12, 6).build_packet(device="cpu")
    cam = cam_ops.Camera.create(width=16, height=8, device="cpu")
    return pkt, cam, RenderConfig(width=16, height=8, max_depth=3)


def _other_gathers(names):
    """The graph nodes of a row gather that is not `take_rows`: indexing,
    ``embedding`` or any other gather op's."""
    return {n for n in names if n.startswith(("Index", "Embedding")) or "Gather" in n}


def test_kernels_tables_hold_no_index_backward():
    """The path tracer's unified table (drawcall transforms, materials, the
    Morton permutation), the raster table, and the staged route's
    (closest-hit and material) and replay route's (winner rows) gathers are
    `take_rows`: their graphs hold its node and no other gather's."""
    pkt, cam, cfg = _small_config4()
    color = train.sample_color(_leaves(pkt, cam), pkt, cam, cfg, 2, 0)
    names = _graph_names(color)
    assert not _other_gathers(names) and "_TakeRowsBackward" in names
    rpkt = demo.config4_mixed_scene(12, 6).build_packet(spheres_as_triangles=True, device="cpu")
    rp, rc = sh.apply_params(_leaves(rpkt, cam), rpkt, cam)
    cols, _ = rk.pack_raster_tris(rp, rc, RasterConfig(width=16, height=8, supersample=2))
    names = _graph_names(cols)
    assert not _other_gathers(names) and "_TakeRowsBackward" in names
    dpkt = demo.reference_demo_scene(8, 4).build_packet(device="cpu")
    for sweep, p in (("staged", pkt), ("replay", dpkt)):
        c = dataclasses.replace(cfg, grad_sweep=sweep)
        assert integrator.grad_route(c, p) == sweep
        names = _graph_names(train.sample_color(_leaves(p, cam), p, cam, c, 2, 0))
        assert not _other_gathers(names) and "_TakeRowsBackward" in names, sweep


def test_cpu_mse_step_equals_the_plain_gather_bit_for_bit(monkeypatch):
    """A CPU training step against the same step through ``table[idx]``,
    whose backward adds float32 in sequence: the loss the same bits, each
    gradient leaf within GRAD_ULPS float32 ulps of its largest entry."""
    pkt, cam, cfg = _small_config4()
    target = torch.full((cam.height * cam.width, 3), 0.25)

    def step():
        return train.mse_step(sh.differentiable_params(pkt, cam), pkt, cam, target, cfg,
                              seed=5, spp=2)

    loss, grads = step()
    plain_gathers(monkeypatch)
    loss0, grads0 = step()
    assert float(loss) == float(loss0) and set(grads) == set(grads0)
    for k in grads:
        apart = ulps_apart(grads[k], grads0[k])
        assert apart <= GRAD_ULPS, f"d({k}) {apart:.1f} ulps from table[idx]'s"


@pytest.fixture
def world_cpu():
    """A gloo world of one, left as it was found."""
    started = not dist.is_initialized()
    yield sh.make_mesh((1, 1), device_type="cpu")
    if started:
        dist.destroy_process_group()


@pytest.mark.parametrize("step", ["mse_step", "raster_mse_step", "dual_train_step"])
def test_cpu_training_steps_are_the_same_bits_on_any_thread_count(world_cpu, step):
    """A config-4 scene of 2,304 triangle rows (2,688 as raster rows): the
    drawcall transforms' gather alone sums 36,864 cotangents, past the
    32,768 from which ``table[idx]``'s backward adds across threads by
    atomics. The loss and every gradient leaf are the same bits on 1 thread
    and on 8."""
    W, H = 16, 8
    pkt = demo.config4_mixed_scene(48, 24).build_packet(device="cpu")
    rpkt = demo.config4_mixed_scene(48, 24).build_packet(spheres_as_triangles=True,
                                                         device="cpu")
    cam = cam_ops.Camera.create(width=W, height=H, device="cpu")
    cfg = RenderConfig(width=W, height=H, max_depth=3)
    rcfg = RasterConfig(width=W, height=H, supersample=2)
    target = torch.full((H, W, 3), 0.25)
    run = {
        "mse_step": lambda: train.mse_step(sh.differentiable_params(pkt, cam), pkt, cam,
                                           target.reshape(-1, 3), cfg, seed=5, spp=2),
        "raster_mse_step": lambda: train.raster_mse_step(sh.differentiable_params(rpkt, cam),
                                                         rpkt, cam, target, rcfg),
        "dual_train_step": lambda: sh.dual_train_step(
            world_cpu, sh.differentiable_params(pkt, cam), pkt, rpkt, cam, target,
            rng.key_for(5), cfg, rcfg, spp=1),
    }[step]
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        loss1, grads1 = run()
        torch.set_num_threads(8)
        loss8, grads8 = run()
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(loss1, loss8) and set(grads1) == set(grads8)
    for k in grads1:
        assert torch.equal(grads1[k], grads8[k]), k


# ---- on the card -----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _card_sum(g, idx, n):
    return tr.rows_backward(g.cuda(), idx.cuda(), n)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_within_an_ulp_of_float64_and_equal_to_the_host_build(cuda, host, case):
    n, f, idx, g = _case(case, seed=21)
    kind = tr.instantiation(n, f, idx.numel(), build.load_library().ptre_take_rows_max_cells())
    got = _card_sum(g, idx, n)
    _assert_within_an_ulp(got, _float64_sum(g, idx, n))
    if kind == "shared" or case[0].endswith(("perm_27", "perm_32")):
        assert torch.equal(got.cpu(), _host_sum(host, kind, g, idx, n))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_pad_row_is_zero_and_the_rest_unchanged(cuda, case):
    n, f, idx, g = _case(case, seed=23)
    pad = _pad_of(idx)
    got = tr.rows_backward(g.cuda(), idx.cuda(), n, pad)
    want = _card_sum(g, idx, n)
    assert bool((got[pad] == 0).all())
    keep = torch.arange(n, device=cuda) != pad
    assert torch.equal(got[keep], want[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[2], CASES[3]],
                         ids=["drawcall_transforms", "materials", "raster_transforms",
                              "morton_perm_27"])
def test_kernel_is_the_same_bits_on_every_run(cuda, case):
    n, f, idx, g = _case(case, seed=22)
    first = _card_sum(g, idx, n)
    for _ in range(3):
        assert torch.equal(_card_sum(g, idx, n), first)


@pytest.mark.cuda
def test_library_cap_is_the_host_build_s(cuda, host):
    assert build.load_library().ptre_take_rows_max_cells() == \
        host.ptre_take_rows_max_cells_host()


@pytest.mark.cuda
def test_counters_count_each_instantiation(cuda):
    before = (tr.launches_shared, tr.launches_global)
    table = torch.randn((2, 16), device=cuda, requires_grad=True)
    big = torch.randn((1000, 27), device=cuda, requires_grad=True)
    loss = tr.take_rows(table, torch.zeros(500, dtype=torch.int64, device=cuda)).sum() + \
        tr.take_rows(big, torch.randperm(1000, device=cuda)).sum()
    loss.backward()
    assert (tr.launches_shared, tr.launches_global) == (before[0] + 1, before[1] + 1)
    assert torch.equal(table.grad, torch.tensor([[500.0] * 16, [0.0] * 16], device=cuda))
    assert bool((big.grad == 1).all())


def _device_kernels(fn):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.fixture
def world(cuda):
    started = not dist.is_initialized()
    yield sh.make_mesh((1, 1))
    if started:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_training_steps_launch_no_index_backward_kernel(cuda, world):
    W, H = 64, 32
    pkt = demo.config4_mixed_scene(128, 64).build_packet(device=cuda)
    cam = cam_ops.Camera.create(width=W, height=H)
    cfg = RenderConfig(width=W, height=H)
    rpkt = demo.config4_mixed_scene(128, 64).build_packet(spheres_as_triangles=True,
                                                          device=cuda)
    rcfg = RasterConfig(width=W, height=H, supersample=2)

    def mse():
        target = torch.full((H * W, 3), 0.25, device=cuda)
        train.mse_step(sh.differentiable_params(pkt, cam), pkt, cam, target, cfg, seed=3,
                       spp=1)

    def dual():
        target = torch.full((H, W, 3), 0.25, device=cuda)
        sh.dual_train_step(world, sh.differentiable_params(pkt, cam), pkt, rpkt, cam, target,
                           rng.key_for(3), cfg, rcfg, spp=1)

    for fn in (mse, dual):
        fn()  # builds and warms the kernels
        before = (tr.launches_shared, tr.launches_global)
        names = _device_kernels(fn)
        assert not [n for n in names if "indexing_backward" in n], fn.__name__
        assert any("rows_partial_kernel" in n for n in names), fn.__name__
        assert any("rows_atomic_kernel" in n for n in names), fn.__name__
        # a path-traced sample: transforms, two material gathers (shared) and
        # the Morton permutation (global); the dual step adds the raster
        # transforms (shared) and the raster permutation (global)
        want = (3, 1) if fn is mse else (4, 2)
        assert (tr.launches_shared - before[0], tr.launches_global - before[1]) == want


#: the most a training step's gradient leaf may sit from the same step's
#: through ``table[idx]``, in float32 ulps of the leaf's largest entry. The
#: two steps differ in how the tables' row gathers sum their cotangents:
#: PyTorch adds a row's ~16,000 duplicates one after another in float32,
#: `take_rows` in float64. On an H100 over 5 seeds: d(transforms) up to
#: 24 ulps apart, and the dual step's d(cam_forward) up to 40 ulps from
#: itself run to run (the float atomics of the backward kernels), as far
#: from the plain gather's.
GRAD_ULPS = 100


def ulps_apart(a, b):
    """max |a - b| in float32 ulps of max |b|."""
    top = b.abs().max().to(torch.float32)
    ulp = float(torch.nextafter(top, torch.tensor(float("inf"), device=top.device)) - top)
    return float((a.double() - b.double()).abs().max()) / max(ulp, 1e-45)


def plain_gathers(monkeypatch):
    """Every site's `take_rows` as ``table[idx]``, whose backward adds
    float32 in sequence. A pad row is kept: the sites pad with a zero row
    that is no leaf, so its cotangents reach nothing either way."""
    for mod in SITES:
        monkeypatch.setattr(mod, "take_rows", lambda t, i, pad_row=-1: t[i.long()])


def config4_steps(dev, mesh, seed=3, W=1920, H=1080):
    """{name: () -> (loss, grads)}: a config-4 `mse_step` at spp 2 and a
    `dual_train_step` at spp 1, at W x H, on fixed seeds and targets."""
    pkt = demo.config4_mixed_scene(128, 64).build_packet(device=dev)
    rpkt = demo.config4_mixed_scene(128, 64).build_packet(spheres_as_triangles=True,
                                                          device=dev)
    cam = cam_ops.Camera.create(width=W, height=H)
    cfg = RenderConfig(width=W, height=H)
    rcfg = RasterConfig(width=W, height=H, supersample=2)
    flat = torch.full((H * W, 3), 0.25, device=dev)
    return {
        "mse_step": lambda: train.mse_step(sh.differentiable_params(pkt, cam), pkt, cam, flat,
                                           cfg, seed=seed, spp=2),
        "dual_train_step": lambda: sh.dual_train_step(
            mesh, sh.differentiable_params(pkt, cam), pkt, rpkt, cam, flat.reshape(H, W, 3),
            rng.key_for(seed), cfg, rcfg, spp=1),
    }


@pytest.mark.cuda
def test_training_gradients_hold_to_the_plain_gather(cuda, world, monkeypatch):
    ours = {name: step() for name, step in config4_steps(cuda, world).items()}
    plain_gathers(monkeypatch)
    for name, step in config4_steps(cuda, world).items():
        (loss, grads), (loss0, grads0) = ours[name], step()
        assert float(loss) == float(loss0), name
        assert set(grads) == set(grads0) and len(grads) == 10, name
        for k in grads:
            assert bool(torch.isfinite(grads[k]).all()), (name, k)
            apart = ulps_apart(grads[k], grads0[k])
            assert apart <= GRAD_ULPS, f"{name}: d({k}) {apart:.1f} ulps from table[idx]'s"
