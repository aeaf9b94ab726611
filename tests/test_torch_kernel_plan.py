"""The plans that route K1 and K3 (``mxnet_tpu_torch/ops/fused_bn_conv.py``:
``_k1_plan``, ``_k3_plan``) and the build hash of their CUDA sources
(``mxnet_tpu_torch/kernels/build.py``), on the CPU.

The wgmma core (``kernels/csrc/bn_gemm_wgmma.cuh``) runs only on the
card, where ``chip_smoke.py`` holds it against the plain versions. Its
route is chosen before the launch from shapes, dtype and alignment, so
the choice itself is pinned here: every bf16 K1 site of ResNet-50
(serving ``stem="std"`` at batches 1, 8 and 64, training ``stem="s2d"``
at 128, the sites found by the port's own rewrite passes with both
forced on) takes the wgmma core within the block's shared memory and
with copies of whole 16-byte units; every ragged or misaligned shape
``chip_smoke.py`` uses takes the WMMA kernel, except the ragged shapes
it runs on the wgmma core to reach each of the core's instantiations,
which take the route it expects; K3's bench shape and ResNet-50's 1x1
shapes in NHWC take the wgmma core.
"""
import functools
import os
import re
import shutil

import pytest
import torch

from mxnet_tpu_torch import config
from mxnet_tpu_torch.kernels import build
from mxnet_tpu_torch.model_zoo.symbols import resnet
from mxnet_tpu_torch.ops import fused_bn_conv as tfb
from mxnet_tpu_torch.symbol import passes
from torch_threads import one_torch_thread  # noqa: F401

BF16 = torch.bfloat16
SMEM = 232448          # shared memory one H100 block can use
H100_SMS = 132
WGMMA = ("wgmma_tma", "wgmma_bulk")

# (stem, batch, graph mode) of the served and the trained ResNet-50
CONFIGS = [("std", 1, "serving"), ("std", 8, "serving"),
           ("std", 64, "serving"), ("s2d", 128, "train")]
# ResNet-50's 1x1 K1 sites: (C, H = W, O)
SITES = [(64, 56, 256), (128, 28, 512), (256, 14, 1024), (256, 56, 64),
         (512, 7, 2048), (512, 28, 128), (1024, 14, 256), (2048, 7, 512)]
# chip_smoke.py's ragged K1 shapes (B, C, H, W, O) and its misaligned one
K1_RAGGED = [(2, 3, 1, 7, 5), (3, 33, 9, 13, 65), (1, 100, 7, 7, 130),
             (3, 33, 4, 6, 65), (2, 17, 4, 5, 9), (5, 40, 1, 2, 70)]
K1_MISALIGNED = (3, 16, 4, 8, 24)
# K3: the bench tool's default shape and the 1x1 sites in NHWC at 128
K3_SHAPES = [(401408, 64, 256)] + [(128 * h * h, c, o) for c, h, o in SITES]
K3_RAGGED = [(5, 3, 7), (130, 33, 65), (1000, 24, 40), (257, 63, 255)]
# chip_smoke.py's ragged shapes on the wgmma core: K1 ((B, C, H, W, O),
# route, tile, samples a tile), K3 ((M, K, N), tile)
K1_WGMMA_RAGGED = [((3, 64, 3, 3, 72), "wgmma_bulk", (256, 128), 28),
                   ((2, 64, 4, 4, 8), "wgmma_bulk", (256, 128), 16),
                   ((7, 128, 5, 5, 264), "wgmma_bulk", (128, 256), 5),
                   ((3, 64, 7, 7, 128), "wgmma_bulk", (256, 128), 5),
                   ((1, 64, 8, 12, 72), "wgmma_tma", (256, 128), 1),
                   ((2, 128, 20, 20, 264), "wgmma_tma", (128, 256), 1)]
K3_WGMMA_RAGGED = [((1000, 64, 40), (256, 128)),
                   ((257, 128, 72), (256, 128)),
                   ((300, 128, 264), (128, 256))]


@functools.lru_cache(maxsize=None)
def _k1_sites(stem, batch, mode):
    """[(x shape, w shape)] of every _FusedBNReLUConv (K1) site."""
    sym = resnet.get_symbol(1000, 50, "3,224,224", stem=stem)
    a, _, x = sym.infer_shape(data=(batch, 3, 224, 224))
    shapes = dict(zip(sym.list_arguments(), a))
    shapes.update(zip(sym.list_auxiliary_states(), x))
    with config.override("MXTPU_PALLAS_FUSION", "1"), \
            config.override("MXTPU_PASS_RESIDUAL_FUSION", "1"):
        fused, _ = passes.apply_pipeline(sym, shapes, tag="plan_test",
                                         mode=mode,
                                         device=torch.device("cpu"))
    _, node_shapes = fused._propagate_shapes(shapes)
    return [(tuple(node_shapes[(id(n.inputs[0][0]), n.inputs[0][1])]),
             tuple(node_shapes[(id(n.inputs[5][0]), n.inputs[5][1])]))
            for n in fused._topo_nodes() if n.op == "_FusedBNReLUConv"]


def _copies(plan, c=0, o=0, s=0):
    """Bytes of each copy the core makes for ``plan``, and of the global
    strides its tensor maps take: K1 (c channels, o outputs, s
    positions) or K3 (c = K, o = N)."""
    bm, bn, bk = plan.bm, plan.bn, 64
    w_box = bn * bk * 2
    if plan.route == "wgmma_bulk":
        # one 64-channel chunk of each sample in, one (tile x s) block of
        # each sample out; W's tensor map strides by C
        return [bk * s * 2, w_box, 2 * s * min(o, bn), 2 * c]
    if s:
        # K1 by tensor maps over (S, C, B) and (S, O, B): boxes of 64 x 64
        return [64 * 64 * 2, w_box, 2 * s, 2 * s * c, 2 * s * o, 2 * c]
    # K3: x box (bm rows x 64), W and out boxes of 64 x 64, row strides
    return [bm * bk * 2, 64 * 64 * 2, 2 * c, 2 * o]


def _assert_wgmma_plan(plan, c=0, o=0, s=0):
    assert plan.route in WGMMA, plan
    assert plan.smem_bytes <= SMEM
    assert plan.stages >= 3
    assert (plan.bm, plan.bn) in ((256, 128), (128, 256))
    assert 1 <= plan.grid[0] <= H100_SMS and plan.grid[1:] == (1, 1)
    assert all(b > 0 and b % 16 == 0 for b in _copies(plan, c, o, s))


@pytest.mark.parametrize("stem,batch,mode", CONFIGS)
def test_k1_plan_takes_every_resnet50_site(stem, batch, mode):
    sites = _k1_sites(stem, batch, mode)
    assert len(sites) == 28
    for (b, c, h, w), (o, c_w, kh, kw) in sites:
        assert (c_w, kh, kw) == (c, 1, 1)
        _assert_wgmma_plan(tfb._k1_plan(b, c, o, h * w, BF16), c, o, h * w)


@pytest.mark.parametrize("batch", [1, 128])
@pytest.mark.parametrize("c,hw,o", SITES)
def test_k1_plan_site_shape(c, hw, o, batch):
    """TMA where the channel stride is whole 16-byte units (56x56, 28x28),
    one bulk copy per sample at 14x14 and 7x7, with whole samples a
    tile."""
    s = hw * hw
    plan = tfb._k1_plan(batch, c, o, s, BF16)
    _assert_wgmma_plan(plan, c, o, s)
    if s % 8 == 0:
        assert plan.route == "wgmma_tma" and plan.per_tile == 1
    else:
        assert plan.route == "wgmma_bulk"
        assert plan.per_tile == plan.bm // s and plan.per_tile >= 1


@pytest.mark.parametrize("shape,route,tile,per_tile", K1_WGMMA_RAGGED)
def test_k1_plan_ragged_on_the_wgmma_core(shape, route, tile, per_tile):
    """The ragged shapes that reach the core's other instantiations: S
    at run time, partial sample, output and position tiles."""
    b, c, h, w, o = shape
    plan = tfb._k1_plan(b, c, o, h * w, BF16)
    _assert_wgmma_plan(plan, c, o, h * w)
    assert (plan.route, (plan.bm, plan.bn), plan.per_tile) == (
        route, tile, per_tile)


@pytest.mark.parametrize("shape,tile", K3_WGMMA_RAGGED)
def test_k3_plan_ragged_on_the_wgmma_core(shape, tile):
    m, k, n = shape
    plan = tfb._k3_plan(m, k, n, BF16)
    _assert_wgmma_plan(plan, k, n)
    assert (plan.route, (plan.bm, plan.bn)) == ("wgmma_tma", tile)


@pytest.mark.parametrize("shape", K1_RAGGED + [K1_MISALIGNED])
def test_k1_plan_ragged_and_misaligned_take_wmma(shape):
    b, c, h, w, o = shape
    align = 2 if shape == K1_MISALIGNED else 256
    assert tfb._k1_plan(b, c, o, h * w, BF16, align).route == "wmma"


def test_k1_plan_alignment_decides():
    """The same site shape takes WMMA once a pointer is only 8-byte
    aligned, and fp32 always takes the fp32 kernel."""
    assert tfb._k1_plan(128, 512, 2048, 49, BF16, 8).route == "wmma"
    assert tfb._k1_plan(128, 512, 2048, 49, BF16, 16).route == "wgmma_bulk"
    assert tfb._k1_plan(128, 64, 256, 3136, torch.float32).route == "fp32"


@pytest.mark.parametrize("m,k,n", sorted(set(K3_SHAPES)))
def test_k3_plan_takes_bench_and_nhwc_shapes(m, k, n):
    plan = tfb._k3_plan(m, k, n, BF16)
    _assert_wgmma_plan(plan, k, n)
    assert plan.route == "wgmma_tma"


@pytest.mark.parametrize("shape", K3_RAGGED)
def test_k3_plan_ragged_takes_wmma(shape):
    assert tfb._k3_plan(*shape, BF16).route == "wmma"
    assert tfb._k3_plan(*shape, torch.float32).route == "fp32"


def test_k3_plan_misaligned_takes_wmma():
    assert tfb._k3_plan(401408, 64, 256, BF16, 2).route == "wmma"


def test_route_counts_stay_zero_on_cpu():
    """CPU tensors take the plain versions: no launch, no route counted;
    launch_counts keeps its five keys."""
    tfb.reset_launch_counts()
    x = torch.randn(2, 64, 7, 7, dtype=BF16)
    w = torch.randn(128, 64, dtype=BF16)
    sc, sh = torch.ones(64, dtype=BF16), torch.zeros(64, dtype=BF16)
    tfb.bn_relu_conv_nchw(x, w, sc, sh)
    tfb.bn_relu_matmul_fwd(x.permute(0, 2, 3, 1).reshape(98, 64), w.t(),
                           sc, sh)
    counts = tfb.route_counts()
    assert set(counts) == {"bn_relu_conv_nchw", "bn_relu_matmul_fwd"}
    assert all(v == 0 for r in counts.values() for v in r.values())
    assert set(counts["bn_relu_conv_nchw"]) == {"wgmma_tma", "wgmma_bulk",
                                                "wmma", "fp32"}
    assert sorted(tfb.launch_counts()) == sorted(
        ["bn_relu_conv_nchw", "bn_act_prologue", "bn_relu_matmul_fwd",
         "bn_backward_reduce", "bn_backward_dx"])


def test_plan_constants_match_the_kernel_header():
    """The host plan mirrors the header's tile sizes and shared-memory
    layout; the C entry refuses a plan that disagrees, so a drift would
    raise on the card."""
    with open(os.path.join(build._CSRC, "bn_gemm_wgmma.cuh")) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))

    assert "constexpr int BM = 128 * MW, BN = 256 / MW;" in src
    assert tfb._WG_TILES == tuple((128 * mw, 256 // mw) for mw in (2, 1))
    assert const("BK") == tfb._WG_BK
    assert const("SMEM_MAX") == tfb.SMEM_PER_BLOCK == SMEM
    assert const("MAX_STAGES") == tfb._WG_MAX_STAGES
    assert const("SLACK") == 1024


def test_csrc_files_follow_includes():
    for name in build.SOURCES:
        files = [os.path.basename(p) for p in
                 build._csrc_files(os.path.join(build._CSRC, name + ".cu"))]
        assert files == [name + ".cu", "bn_gemm_wgmma.cuh"]


def test_lib_path_covers_included_headers(tmp_path, monkeypatch):
    """An edit to an included csrc/ header changes the library path (so
    the library rebuilds); an edit to a file no source includes does
    not."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build._CSRC, csrc)
    (csrc / "notes.txt").write_text("not included\n")
    monkeypatch.setattr(build, "_CSRC", str(csrc))
    paths = {name: build._lib_path(name)[1] for name in build.SOURCES}
    assert paths == {name: build._lib_path(name)[1]
                     for name in build.SOURCES}
    (csrc / "notes.txt").write_text("edited\n")
    assert paths == {name: build._lib_path(name)[1]
                     for name in build.SOURCES}
    header = csrc / "bn_gemm_wgmma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for name in build.SOURCES:
        assert build._lib_path(name)[1] != paths[name]


def test_ragged_lists_match_chip_smoke():
    """The shapes pinned here are the ones ``chip_smoke.py`` runs on the
    card, with the routes it expects."""
    import chip_smoke
    assert [(s, r) for s, r, _, _ in K1_WGMMA_RAGGED] == [
        tuple(e) for e in chip_smoke.K1_WGMMA_RAGGED]
    assert [s for s, _ in K3_WGMMA_RAGGED] == list(
        chip_smoke.K3_WGMMA_RAGGED)
