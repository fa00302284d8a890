"""The CUDA kernels against their plain versions on the card, at small and
ragged shapes (N, H, W, Ci and Co off every tile size). Marked ``cuda``:
they need an NVIDIA GPU and nvcc and skip elsewhere. Run on the card with
``python -m pytest tests/test_torch_port_cuda.py -m cuda``.

Tolerances: f32 1e-4 (f32 sums in another order); bf16 3e-2 relative to
the output's scale (one bf16 rounding per layer, taken at the same places
by both versions, can still land on neighbouring bf16 values)."""
import json

import numpy as np
import pytest
import torch

from ganreverser_tpu_torch.ops import (approx_topk_kernel, conv_block_kernel,
                                       conv_kernel,
                                       conv_stats_kernel, cuda_lib,
                                       dropout_kernel, fir_kernel,
                                       kmeans_kernel,
                                       probe_kernels, topk_kernel,
                                       upsample_conv_kernel,
                                       upsample_v2_kernel)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref, dtype):
    ref = ref.float()
    err = (out.float() - ref).abs().max().item()
    assert err <= TOL[dtype] * max(1.0, ref.abs().max().item()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool", [False, True])
def test_conv_block_kernel(dev, dtype, pool):
    g = torch.Generator(device=dev).manual_seed(0)
    chans = [3, 70, 5]
    x = torch.randn(5, 10, 6, 3, device=dev, generator=g).to(dtype)
    ks = [(0.3 * torch.randn(3, 3, ci, co, device=dev, generator=g))
          for ci, co in zip(chans[:-1], chans[1:])]
    sc = [torch.rand(co, device=dev, generator=g) + 0.5 for co in chans[1:]]
    sh = [0.1 * torch.randn(co, device=dev, generator=g) for co in chans[1:]]
    before = conv_block_kernel.conv_block.launches
    out = conv_block_kernel.conv_block(x, ks, sc, sh, act="elu", pool=pool)
    torch.cuda.synchronize()
    assert conv_block_kernel.conv_block.launches == before + 2
    ref = conv_block_kernel.conv_block_plain(x, ks, sc, sh, act="elu",
                                             pool=pool)
    assert out.shape == ref.shape and out.dtype == dtype
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["relu", "none", "sigmoid"])
def test_upsample_kernel(dev, dtype, act):
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(3, 5, 7, 20, device=dev, generator=g).to(dtype)
    k = 0.3 * torch.randn(3, 3, 20, 72, device=dev, generator=g)
    sc = torch.rand(72, device=dev, generator=g) + 0.5
    sh = torch.randn(72, device=dev, generator=g)
    before = upsample_conv_kernel.upsample2_conv3x3_bn_act.launches
    out = upsample_conv_kernel.upsample2_conv3x3_bn_act(x, k, sc, sh, act=act)
    torch.cuda.synchronize()
    assert upsample_conv_kernel.upsample2_conv3x3_bn_act.launches == before + 1
    ref = upsample_conv_kernel.upsample2_conv3x3_bn_act_plain(x, k, sc, sh,
                                                              act=act)
    assert out.shape == ref.shape == (3, 10, 14, 72)
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,q", [(77, 100, 3), (300, 1000, 18)])
def test_cosine_scores_kernel(dev, dtype, n, d, q):
    g = torch.Generator(device=dev).manual_seed(2)
    emb = torch.randn(n, d, device=dev, generator=g).to(dtype)
    emb[5] = 0  # a degenerate row: the clamp, not a NaN
    idx = torch.randint(0, n, (q,), device=dev, generator=g)
    before = topk_kernel.cosine_scores.launches
    out = topk_kernel.cosine_scores(emb, idx)
    torch.cuda.synchronize()
    assert topk_kernel.cosine_scores.launches == before + 1
    ref = topk_kernel.cosine_scores_plain(emb, idx)
    assert out.shape == (q, n) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=0, atol=1e-5)


def test_kernels_refuse_bad_arguments(dev):
    x = torch.zeros(1, 4, 4, 2, device=dev, dtype=torch.float16)
    k = torch.zeros(3, 3, 2, 2, device=dev)
    s = torch.zeros(2, device=dev)
    with pytest.raises(TypeError):
        conv_block_kernel.conv_block(x, [k], [s], [s])
    xt = torch.zeros(1, 4, 4, 2, device=dev).transpose(1, 2)
    with pytest.raises(ValueError):
        upsample_conv_kernel.upsample2_conv3x3_bn_act(xt, k, s, s)


@pytest.mark.parametrize("n,d,k", [(10_000, 100, 20), (777, 37, 5),
                                   (64, 100, 20), (1, 3, 2),
                                   (10_000, 100, 256), (10_000, 512, 64),
                                   (10_000, 100, 1000), (300, 4096, 64)])
def test_kmeans_kernel(dev, n, d, k):
    """chip_smoke.kmeans_case on more shapes: against the plain step on the
    same centroids (assignment beyond the near-tie margin, counts, sums to
    1e-4 relative, centroids = sums / counts) and bitwise equal over two
    runs (no float atomics); it raises SmokeFailure otherwise. (K, D) =
    (256, 100), (64, 512) and (1000, 100) are what apply_r --clusters takes
    at noise 100 and 512; (64, 4096) streams 8 centroids at a time past 4
    rows per block."""
    import chip_smoke
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(n, d, device=dev, generator=g)
    c = x[torch.randperm(n, device=dev, generator=g)[:k]]
    c = torch.cat([c, torch.randn(k - c.shape[0], d, device=dev,
                                  generator=g)])
    c[-1] = 0.0
    # no row comes near (|c|^2 beats every row's other distances, about D):
    # an empty cluster
    c[-1, 0] = max(50.0, 2 * d ** 0.5 + 10)
    before = kmeans_kernel.kmeans_step.launches
    chip_smoke.kmeans_case(x, c)
    assert kmeans_kernel.kmeans_step.launches == before + 2
    new_c, counts = kmeans_kernel.kmeans_step(x, c)
    assert counts[-1].item() == 0.0 and torch.equal(new_c[-1], c[-1])
    assert counts.sum().item() == n


def test_kmeans_kernel_refuses_bad_arguments(dev):
    x = torch.zeros(10, 4, device=dev)
    with pytest.raises(ValueError):  # D differs
        kmeans_kernel.kmeans_step(x, torch.zeros(2, 5, device=dev))
    with pytest.raises(ValueError):  # one row and one centroid over 227 KB
        kmeans_kernel.kmeans_step(torch.zeros(10, 40_000, device=dev),
                                  torch.zeros(2, 40_000, device=dev))
    with pytest.raises(ValueError):  # mixed devices
        kmeans_kernel.kmeans_step(x, torch.zeros(2, 4))


@pytest.mark.parametrize("n,d,k,iters", [(10_000, 100, 20, 15),
                                         (10_000, 100, 256, 15),
                                         (777, 100, 20, 15),
                                         (1_000, 4096, 64, 3)])
def test_kmeans_lloyd_kernel(dev, n, d, k, iters):
    """chip_smoke.lloyd_case: the whole run in one launch, bitwise equal
    over two runs, each iteration held against the plain step from the
    kernel's centroids (assignment beyond the near-tie margin, counts, sums
    to TOL_SUMS and bitwise the segment order's), and the final centroids
    within TOL_SUMS of kmeans_lloyd_plain when no near-tie row went
    otherwise; it raises SmokeFailure otherwise. The last centroid is far
    from every row, so its cluster stays empty and keeps its place."""
    import chip_smoke
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(n, d, device=dev, generator=g)
    c = x[torch.randperm(n, device=dev, generator=g)[:k]].clone()
    c[-1] = 0.0
    c[-1, 0] = max(50.0, 2 * d ** 0.5 + 10)
    before = kmeans_kernel.kmeans_lloyd.launches
    chip_smoke.lloyd_case(x, c, iters)
    assert kmeans_kernel.kmeans_lloyd.launches == before + 2 + iters - 1
    new_c, counts = kmeans_kernel.kmeans_lloyd(x, c, iters)
    assert counts[-1].item() == 0.0 and torch.equal(new_c[-1], c[-1])
    assert counts.sum().item() == n


def test_kmeans_lloyd_refuses_a_grid_over_the_resident_blocks(dev,
                                                             monkeypatch):
    """A plan whose grid the card cannot hold at once (one block per tile
    of 4 rows, 1,000 blocks of about 200 KB of shared memory) is refused
    by the cooperative launch: the wrapper raises with the plan, launches
    no loop of steps instead, and leaves no error behind for the next
    launch."""
    n, d, k = 4_000, 4096, 64
    x = torch.randn(n, d, device=dev)
    c = x[:k].clone()
    plan = kmeans_kernel.lloyd_plan(n, d, k, 10 ** 6)
    resident = kmeans_kernel.resident_blocks(plan.smem_bytes,
                                             torch.cuda.current_device())
    assert 0 < resident < plan.grid == 1_000
    before = kmeans_kernel.kmeans_lloyd.launches
    with monkeypatch.context() as m:
        m.setattr(kmeans_kernel, "card_plan", lambda *args: plan)
        with pytest.raises(RuntimeError, match="LloydPlan"):
            kmeans_kernel.kmeans_lloyd(x, c, 2)
    assert kmeans_kernel.kmeans_lloyd.launches == before
    ref = kmeans_kernel.kmeans_step_plain(x, c)[1]
    out = kmeans_kernel.kmeans_lloyd(x, c, 1)[1]
    torch.cuda.synchronize()
    assert out.sum().item() == n and ref.sum().item() == n


def _models(dev, dims, nd):
    from ganreverser_tpu_torch.models import bridge, modules, zoo
    gen = torch.Generator().manual_seed(0)
    G = modules.init_parameters(zoo.create_G3(dims, nd), gen)
    R = modules.init_parameters(zoo.create_R(dims, nd, "normal", fixer=True),
                                gen)
    return (G.to(dev), R.to(dev), bridge.to_torch(bridge.export_variables(G),
                                                  dev),
            bridge.to_torch(bridge.export_variables(R), dev))


def test_fast_fixer_matches_module_fixer(dev):
    from ganreverser_tpu_torch.models import fastpath
    dims, nd = (3, 16, 16), 8
    _, R, _, rv = _models(dev, dims, nd)
    x = torch.rand(33, 16, 16, 3, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(1))
    fast = fastpath.make_fast_fixer(dims, nd, "normal", torch.float32)(
        rv, x, torch.Generator(device=dev).manual_seed(9))
    R.l0.generator = torch.Generator(device=dev).manual_seed(9)
    with torch.no_grad():
        ref = R(x)
    _close(fast, ref, torch.float32)


def test_fast_path_f32_ignores_global_tf32_flags(dev):
    """G's f32 head (cuDNN) and the dense layers (cuBLAS) are pinned to IEEE
    f32: the fast G and R give the same result with the process-wide TF32
    flags on and off, and the flags come back as they were."""
    from ganreverser_tpu_torch.models import fastpath
    dims, nd = (3, 32, 32), 100
    _, _, gv, rv = _models(dev, dims, nd)
    z = torch.randn(64, nd, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2))
    gen = fastpath.make_fast_generator(dims, nd, torch.float32)
    inv = fastpath.make_fast_fixer(dims, nd, "normal", torch.float32)
    outs = []
    for tf32 in (True, False):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        images = gen(gv, z)
        outs.append((images, inv(rv, images,
                                 torch.Generator(device=dev).manual_seed(4))))
        assert torch.backends.cudnn.allow_tf32 == tf32
        assert torch.backends.cuda.matmul.allow_tf32 == tf32
    for a, b in zip(*outs):
        err = (a - b).abs().max().item()
        assert err <= 1e-5 * max(1.0, b.abs().max().item()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(256, 512), (3, 37, 5, 64), (1_000_003,),
                                   (8, 16, 16, 3), (256, 64, 64, 64),
                                   (256, 32, 32, 128), (33_554_437,)])
@pytest.mark.parametrize("seed", [42, -7, -2 ** 31])
def test_dropout_kernel_bitwise(dev, dtype, shape, seed):
    """Kernel B5 forward and backward against the plain version, bitwise,
    and a second forward bitwise the first (chip_smoke.dropout_case raises
    SmokeFailure otherwise): at sizes that are no multiple of the 16-byte
    pack (a ragged tail), at R's step shapes (many unrolled batches a
    thread) and at a size whose packs are no multiple of the unrolled
    batch; three launches per case."""
    import chip_smoke
    x = torch.randn(shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5))
    before = dropout_kernel.fused_dropout.launches
    assert chip_smoke.dropout_case(x.to(dtype), seed, 0.25) == 0.0
    assert dropout_kernel.fused_dropout.launches == before + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_kernel_unaligned_and_strided(dev, dtype):
    """A view one element into its storage (not 16-byte aligned: the
    one-element kernel), a view eight elements in (aligned in both dtypes:
    the packs, with a ragged tail) and a transposed view (made contiguous)
    all drop in their logical order, as the plain version does."""
    base = torch.randn(1_000_037, device=dev).to(dtype)
    s = torch.tensor([9], dtype=torch.int32, device=dev)
    for x in (base[1:], base[8:], base[3:4099].reshape(64, 64).t()):
        out = dropout_kernel.fused_dropout(x, s, 0.5)
        torch.cuda.synchronize()
        assert torch.equal(out, dropout_kernel.fused_dropout_plain(x, s, 0.5))


def test_dropout_kernel_refuses_bad_arguments(dev):
    s = torch.tensor([1], dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        dropout_kernel.fused_dropout(torch.zeros(8, device=dev,
                                                 dtype=torch.float16), s, 0.5)
    with pytest.raises(ValueError):  # the seed on the CPU
        dropout_kernel.fused_dropout(torch.zeros(8, device=dev), s.cpu(), 0.5)


def _train_models(dev, dims, nd, fixer=False, impl="kernel"):
    import chip_smoke
    from ganreverser_tpu_torch.models import modules, zoo
    G = chip_smoke.make_calibrated_g(dev, dims, nd, 32, 5)
    R = modules.init_parameters(
        zoo.create_R(dims, nd, "normal", fixer=fixer, dtype=torch.bfloat16,
                     dropout_impl=impl),
        torch.Generator().manual_seed(1)).to(dev)
    modules.set_dropout_generator(R, torch.Generator(device=dev).manual_seed(2))
    return G, R


@pytest.mark.parametrize("fixer", [False, True])
def test_train_step_launches_dropout_kernel(dev, fixer):
    """One bf16 R step with --dropout kernel: 6 forward + 6 backward
    launches of B5, 7 + 6 for the fixer-R (its input needs no gradient)."""
    from ganreverser_tpu_torch.optim import adam
    from ganreverser_tpu_torch.train.r_loop import make_r_train_step
    from ganreverser_tpu_torch.train.state import TrainState
    G, R = _train_models(dev, (3, 16, 16), 8, fixer)
    step = make_r_train_step(G, dtype=torch.bfloat16)
    ts = TrainState.create(R, adam())
    before = dropout_kernel.fused_dropout.launches
    loss = step(ts, torch.randn(16, 8, device=dev))
    torch.cuda.synchronize()
    assert dropout_kernel.fused_dropout.launches - before == (13 if fixer
                                                              else 12)
    assert torch.isfinite(loss) and ts.step == 1


def test_train_step_f32_ignores_global_tf32_flags(dev):
    """The f32 train step's backward runs under the precision pin: the
    same step with the process-wide TF32 flags on and off gives the same
    parameters within 1e-5 of scale (chip_smoke.precision_pin_error)."""
    import chip_smoke
    G, _ = _train_models(dev, (3, 32, 32), 100)
    err = chip_smoke.precision_pin_error(G, dev, (3, 32, 32), 100, 32)
    assert err <= chip_smoke.TOL_PIN, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,pool,alpha", [("prelu", True, 0.25),
                                            ("prelu", False, -0.1),
                                            ("elu", True, 0.0),
                                            ("relu", False, 0.0)])
def test_conv3x3_bn_act_kernel(dev, dtype, act, pool, alpha):
    """Kernel B6 against its plain version at a ragged shape (N, H, W, Ci,
    Co off every tile size), the PReLU slope read from device memory; one
    launch on its own counter, none on kernel B's."""
    from ganreverser_tpu_torch.ops import conv_kernel
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(5, 10, 6, 3, device=dev, generator=g).to(dtype)
    k = 0.3 * torch.randn(3, 3, 3, 70, device=dev, generator=g)
    sc = torch.rand(70, device=dev, generator=g) + 0.5
    sh = 0.1 * torch.randn(70, device=dev, generator=g)
    a = torch.tensor([alpha], device=dev)
    before = (conv_kernel.conv3x3_bn_act.launches,
              conv_block_kernel.conv_block.launches)
    out = conv_kernel.conv3x3_bn_act(x, k, sc, sh, act=act, prelu_alpha=a,
                                     pool=pool)
    torch.cuda.synchronize()
    assert (conv_kernel.conv3x3_bn_act.launches,
            conv_block_kernel.conv_block.launches) == (before[0] + 1,
                                                       before[1])
    ref = conv_kernel.conv3x3_bn_act_plain(x, k, sc, sh, act=act,
                                           prelu_alpha=a, pool=pool)
    assert out.shape == ref.shape and out.dtype == dtype
    _close(out, ref, dtype)
    as_float = conv_kernel.conv3x3_bn_act(x, k, sc, sh, act=act,
                                          prelu_alpha=alpha, pool=pool)
    assert torch.equal(as_float, out)


def test_conv3x3_bn_act_refuses_bad_arguments(dev):
    from ganreverser_tpu_torch.ops import conv_kernel
    x = torch.zeros(1, 5, 4, 2, device=dev)
    k = torch.zeros(3, 3, 2, 2, device=dev)
    s = torch.zeros(2, device=dev)
    with pytest.raises(ValueError):  # odd H with the pool
        conv_kernel.conv3x3_bn_act(x, k, s, s, pool=True)
    with pytest.raises(ValueError):  # the slope on the CPU
        conv_kernel.conv3x3_bn_act(x, k, s, s, act="prelu",
                                   prelu_alpha=torch.tensor([0.1]))
    with pytest.raises(TypeError):
        conv_kernel.conv3x3_bn_act(x.half(), k, s, s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fast_discriminator_matches_module_d(dev, dtype):
    """D2 in evaluation on kernel B6 (5 launches) against the module D on
    the same weights, kernels amplified x3 so that the probabilities spread
    away from 0.5: f32 within 1e-4, bf16 within 2e-2 (B6 rounds once where
    the module rounds after the bias and multiplies by a bf16 slope)."""
    import chip_smoke
    from ganreverser_tpu_torch.ops import conv_kernel
    err = chip_smoke.fast_d_error(dev, dtype, n=64, dims=(3, 16, 16),
                                  launches=5 * 1)
    assert err <= chip_smoke.TOL_FAST_D[str(dtype).split(".")[-1]], err
    assert conv_kernel.conv3x3_bn_act.launches >= 5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,ci,co,cf", [(3, 5, 7, 20, 72, 3),
                                            (2, 8, 8, 16, 64, 1),
                                            (1, 9, 4, 33, 130, 4)])
def test_upsample_head_kernel(dev, dtype, n, h, w, ci, co, cf):
    """U's fused head against its plain version: ragged output tiles
    (2H, 2W off multiples of 14), Co off multiples of 64, Cf 1 to 4, a ReLU
    stage and a sigmoid head; one launch on the head's own counter, none on
    U's."""
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(n, h, w, ci, device=dev, generator=g).to(dtype)
    k = 0.3 * torch.randn(3, 3, ci, co, device=dev, generator=g)
    sc = torch.rand(co, device=dev, generator=g) + 0.5
    sh = torch.randn(co, device=dev, generator=g)
    fk = 0.1 * torch.randn(3, 3, co, cf, device=dev, generator=g)
    fb = torch.randn(cf, device=dev, generator=g)
    u_before = upsample_conv_kernel.upsample2_conv3x3_bn_act.launches
    before = upsample_conv_kernel.upsample2_conv3x3_head.launches
    out = upsample_conv_kernel.upsample2_conv3x3_bn_act(
        x, k, sc, sh, act="relu", final_kernel=fk, final_bias=fb)
    torch.cuda.synchronize()
    assert upsample_conv_kernel.upsample2_conv3x3_head.launches == before + 1
    assert upsample_conv_kernel.upsample2_conv3x3_bn_act.launches == u_before
    ref = upsample_conv_kernel.upsample2_conv3x3_bn_act_plain(
        x, k, sc, sh, act="relu", final_kernel=fk, final_bias=fb)
    assert out.shape == ref.shape == (n, 2 * h, 2 * w, cf)
    assert out.dtype == dtype
    _close(out, ref, dtype)
    lin = upsample_conv_kernel.upsample2_conv3x3_head(
        x, k, sc, sh, fk, fb, act="none", final_act="none")
    _close(lin, upsample_conv_kernel.upsample2_conv3x3_bn_act_plain(
        x, k, sc, sh, act="none", final_kernel=fk, final_bias=fb,
        final_act="none"), dtype)


def test_upsample_head_refuses_bad_arguments(dev):
    x = torch.zeros(1, 4, 4, 8, device=dev)
    k = torch.zeros(3, 3, 8, 8, device=dev)
    s = torch.zeros(8, device=dev)
    with pytest.raises(ValueError):  # Cf = 5
        upsample_conv_kernel.upsample2_conv3x3_head(
            x, k, s, s, torch.zeros(3, 3, 8, 5, device=dev),
            torch.zeros(5, device=dev))
    with pytest.raises(ValueError):  # the head's Co is not U's
        upsample_conv_kernel.upsample2_conv3x3_head(
            x, k, s, s, torch.zeros(3, 3, 7, 3, device=dev),
            torch.zeros(3, device=dev))
    with pytest.raises(ValueError):
        upsample_conv_kernel.upsample2_conv3x3_head(
            x, k, s, s, torch.zeros(3, 3, 8, 3, device=dev),
            torch.zeros(3, device=dev), final_act="elu")


def test_fast_generator_launches_u_and_the_head(dev):
    """The fast G on the card: U once for stage 1, U's fused head once for
    stage 2 and the output conv, within the tolerance of the same G's
    plain versions on the CPU."""
    from ganreverser_tpu_torch.models import bridge, fastpath, modules, zoo
    dims, nd = (3, 16, 16), 8
    G = modules.init_parameters(zoo.create_G3(dims, nd),
                                torch.Generator().manual_seed(3))
    v_cpu = bridge.to_torch(bridge.export_variables(G), "cpu")
    v = bridge.module_variables(G.to(dev))
    z = torch.randn(5, nd, generator=torch.Generator().manual_seed(4))
    for dtype in (torch.float32, torch.bfloat16):
        before = (upsample_conv_kernel.upsample2_conv3x3_bn_act.launches,
                  upsample_conv_kernel.upsample2_conv3x3_head.launches)
        fused = fastpath.make_fast_generator(dims, nd, dtype)(v, z.to(dev))
        torch.cuda.synchronize()
        assert (upsample_conv_kernel.upsample2_conv3x3_bn_act.launches,
                upsample_conv_kernel.upsample2_conv3x3_head.launches) == (
                    before[0] + 1, before[1] + 1)
        plain = fastpath.make_fast_generator(dims, nd, dtype)(v_cpu, z)
        _close(fused.cpu(), plain, dtype)


def test_stage2_and_sample_launch_the_head(dev, tmp_path):
    """apply_r's stage ② (pipeline.generate_and_invert) and cli.sample run
    the fast G's second stage and output conv as U's fused head: one
    launch of the head and one of U per chunk of G's forward, none of U's
    for a separate head."""
    from ganreverser_tpu_torch.analysis import pipeline
    from ganreverser_tpu_torch.cli import sample
    from ganreverser_tpu_torch.io import checkpoint as ckpt
    from ganreverser_tpu_torch.models import bridge, modules, zoo
    dims, nd = (3, 16, 16), 8
    gen = torch.Generator().manual_seed(5)
    G, R, D = (modules.init_parameters(m, gen).to(dev) for m in (
        zoo.create_G3(dims, nd), zoo.create_R(dims, nd, "normal"),
        zoo.create_D(dims)))
    counters = (upsample_conv_kernel.upsample2_conv3x3_bn_act,
                upsample_conv_kernel.upsample2_conv3x3_head)
    before = [fn.launches for fn in counters]
    pipeline.generate_and_invert(
        bridge.module_variables(G), bridge.module_variables(R), dims=dims,
        n=40, noise_dim=nd, noise_method="normal",
        generator=torch.Generator(device=dev).manual_seed(6), batch_size=16,
        dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counters, before)] == [3, 3]
    network = str(tmp_path / "gd")
    ckpt.save_checkpoint(network, {"G": bridge.export_variables(G),
                                   "D": bridge.export_variables(D)},
                         config={"noiseDim": nd, "noiseMethod": "normal",
                                 "colorSpace": "rgb", "height": 16,
                                 "width": 16})
    before = [fn.launches for fn in counters]
    sample.main(["--network", network, "--writeto", str(tmp_path / "out"),
                 "--dataset", "synthetic", "--compute_dtype", "bfloat16"])
    torch.cuda.synchronize()
    chunks = sample.N_SAMPLES // sample.CHUNK
    assert [fn.launches - b for fn, b in zip(counters, before)] == [
        chunks, chunks]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,ci,co", [(4, 8, 8, 16, 32), (3, 7, 5, 20, 70),
                                         (16, 64, 64, 256, 128)])
def test_conv_stats_kernel(dev, dtype, n, h, w, ci, co):
    """y against the plain conv, the sums within 1e-4 of the summed
    magnitudes, and a second run bitwise equal (no float atomics). The
    ragged (3,7,5,20,70) leaves pixels of every tile outside the image,
    whose sums the bf16 epilogue must mask; (16,64,64,256)->128 is the
    probe's shape at N = 16."""
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(n, h, w, ci, device=dev, generator=g).to(dtype)
    k = 0.2 * torch.randn(3, 3, ci, co, device=dev, generator=g)
    before = conv_stats_kernel.conv_stats.launches
    y, s, q = conv_stats_kernel.conv_stats(x, k)
    torch.cuda.synchronize()
    assert conv_stats_kernel.conv_stats.launches == before + 1
    again = conv_stats_kernel.conv_stats(x, k)
    assert all(torch.equal(a, b) for a, b in zip((y, s, q), again))
    ry, rs, rq = conv_stats_kernel.conv_stats_plain(x, k)
    assert y.dtype == s.dtype == q.dtype == torch.float32
    _close(y, ry, torch.float32)
    scale = (ry.abs().sum(dim=(0, 1, 2)).max().item(), rq.max().item())
    assert (s - rs).abs().max().item() <= 1e-4 * max(1.0, scale[0])
    assert (q - rq).abs().max().item() <= 1e-4 * max(1.0, scale[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,ci,co", [(3, 5, 7, 16, 72), (3, 5, 7, 20, 72),
                                         (3, 5, 7, 3, 72),
                                         (16, 16, 16, 512, 256),
                                         (16, 32, 32, 256, 128)])
def test_upsample_v2_kernel(dev, dtype, n, h, w, ci, co):
    """B8 against its plain version and against kernel U within the
    probe's tolerance (f32 1e-4, bf16 3e-2: U rounds the phase kernels from
    the rounded kernel, B8 sums them in f32 first); a second run bitwise
    equal. Ci = 20 and 3 pad each tap block of the stacked weights (and
    make the f32 route's BK chunks straddle taps); the last two are the
    probe's shapes, G3's two stages, at N = 16."""
    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn(n, h, w, ci, device=dev, generator=g).to(dtype)
    k = 0.3 * torch.randn(3, 3, ci, co, device=dev, generator=g)
    sc = torch.rand(co, device=dev, generator=g) + 0.5
    sh = torch.randn(co, device=dev, generator=g)
    before = upsample_v2_kernel.upsample_v2.launches
    out = upsample_v2_kernel.upsample_v2(x, k, sc, sh)
    torch.cuda.synchronize()
    assert upsample_v2_kernel.upsample_v2.launches == before + 1
    assert out.shape == (n, 2 * h, 2 * w, co) and out.dtype == dtype
    assert torch.equal(upsample_v2_kernel.upsample_v2(x, k, sc, sh), out)
    _close(out, upsample_v2_kernel.upsample_v2_plain(x, k, sc, sh), dtype)
    _close(out, upsample_conv_kernel.upsample2_conv3x3_bn_act(
        x, k, sc, sh, act="relu"), dtype)


def test_probe_kernels_exact(dev):
    """B9: +1, x2 and the wmma bf16 product, exactly their plain versions
    (small-integer operands make every f32 sum exact in any order)."""
    g = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn(8, 128, device=dev, generator=g)
    assert torch.equal(probe_kernels.add_one(x), x + 1)
    x3 = torch.randn(4, 256, 128, device=dev, generator=g)
    assert torch.equal(probe_kernels.times_two(x3), x3 * 2)
    a = torch.randint(-3, 4, (128, 128), device=dev,
                      generator=g).to(torch.bfloat16)
    b = torch.randint(-3, 4, (128, 64), device=dev,
                      generator=g).to(torch.bfloat16)
    c = probe_kernels.dot_bf16(a, b)
    torch.cuda.synchronize()
    assert c.dtype == torch.float32
    assert torch.equal(c, probe_kernels.dot_bf16_plain(a, b))
    with pytest.raises(ValueError):
        probe_kernels.dot_bf16(a[:, :120], b[:120])


# the main path's tensor-core layers, N cut to 16: kernel B's two R blocks
# (chain, pool), U's two G stages (input resolution), B6's five D2 layers
MAIN_B = [((16, 64, 64, 3), [3, 64, 64, 64]),
          ((16, 32, 32, 64), [64, 128, 128, 128])]
MAIN_U = [((16, 16, 16, 512), 256), ((16, 32, 32, 256), 128)]
MAIN_B6 = [((16, 64, 64, 3), 128, False), ((16, 64, 64, 128), 128, True),
           ((16, 32, 32, 128), 128, True), ((16, 16, 16, 128), 256, False),
           ((16, 16, 16, 256), 256, True)]
# U's fused head at G3's stage 2 (Cf = 3, a grayscale G_prev's 1); kernel
# C's two searches of apply_r (pixels of sigmoid outputs, latents), 10
# needles at (i + 1) * 100 - 1
MAIN_H = [((16, 32, 32, 256), 128, 3), ((16, 32, 32, 256), 128, 1)]
MAIN_C = [(10_000, 12_288, True), (10_000, 100, False)]
TOL_SCORES = 1e-4   # C against its plain version, absolute (chip_smoke's)


def _main_path_case(dev, kind, i):
    """(call, plain, launches per call, counter) of one main-path layer in
    bf16, on seeded inputs of the main path's scale."""
    import chip_smoke
    g = torch.Generator(device=dev).manual_seed(20 + i)
    bf16 = torch.bfloat16
    if kind == "B":
        shape, chans = MAIN_B[i]
        x = torch.rand(shape, device=dev, generator=g).to(bf16)
        ks, sc, sh = chip_smoke._conv_chain(g, dev, chans)
        return (lambda: conv_block_kernel.conv_block(x, ks, sc, sh, act="elu",
                                                     pool=True),
                lambda: conv_block_kernel.conv_block_plain(
                    x, ks, sc, sh, act="elu", pool=True),
                len(ks), conv_block_kernel.conv_block)
    if kind == "U":
        shape, co = MAIN_U[i]
        x = torch.rand(shape, device=dev, generator=g).to(bf16)
        (k,), (sc,), (sh,) = chip_smoke._conv_chain(g, dev, [shape[-1], co])
        uc = upsample_conv_kernel
        return (lambda: uc.upsample2_conv3x3_bn_act(x, k, sc, sh),
                lambda: uc.upsample2_conv3x3_bn_act_plain(x, k, sc, sh),
                1, uc.upsample2_conv3x3_bn_act)
    if kind == "B7":  # the probe's shape at N = 16
        x = (0.5 * torch.randn(16, 64, 64, 256, device=dev, generator=g)).to(
            bf16)
        k = 0.05 * torch.randn(3, 3, 256, 128, device=dev, generator=g)
        return (lambda: conv_stats_kernel.conv_stats(x, k),
                lambda: conv_stats_kernel.conv_stats_plain(x, k), 1,
                conv_stats_kernel.conv_stats)
    if kind == "H":
        shape, co, cf = MAIN_H[i]
        x = torch.rand(shape, device=dev, generator=g).to(bf16)
        (k, fk), (sc, _), (sh, fb) = chip_smoke._conv_chain(
            g, dev, [shape[-1], co, cf])
        uc = upsample_conv_kernel
        return (lambda: uc.upsample2_conv3x3_head(x, k, sc, sh, fk, fb),
                lambda: uc.upsample2_conv3x3_bn_act_plain(
                    x, k, sc, sh, final_kernel=fk, final_bias=fb),
                1, uc.upsample2_conv3x3_head)
    if kind == "C":
        n, d, positive = MAIN_C[i]
        e = torch.randn(n, d, device=dev, generator=g)
        e = (torch.sigmoid(e) if positive else e).to(bf16)
        idx = torch.arange(1, 11, device=dev) * 100 - 1
        return (lambda: topk_kernel.cosine_scores(e, idx),
                lambda: topk_kernel.cosine_scores_plain(e, idx), 1,
                topk_kernel.cosine_scores)
    if kind == "B8":  # U's shape, stage 1
        shape, co = MAIN_U[i]
        x = torch.rand(shape, device=dev, generator=g).to(bf16)
        (k,), (sc,), (sh,) = chip_smoke._conv_chain(g, dev, [shape[-1], co])
        v2 = upsample_v2_kernel
        return (lambda: v2.upsample_v2(x, k, sc, sh),
                lambda: v2.upsample_v2_plain(x, k, sc, sh), 1, v2.upsample_v2)
    shape, co, pool = MAIN_B6[i]
    x = torch.rand(shape, device=dev, generator=g).to(bf16)
    (k,), _, (b,) = chip_smoke._conv_chain(g, dev, [shape[-1], co])
    ones = torch.ones(co, device=dev)
    a = torch.tensor([0.25], device=dev)
    return (lambda: conv_kernel.conv3x3_bn_act(x, k, ones, b, act="prelu",
                                               prelu_alpha=a, pool=pool),
            lambda: conv_kernel.conv3x3_bn_act_plain(
                x, k, ones, b, act="prelu", prelu_alpha=a, pool=pool),
            1, conv_kernel.conv3x3_bn_act)


MAIN_CASES = ([("B", i) for i in range(len(MAIN_B))]
              + [("U", i) for i in range(len(MAIN_U))]
              + [("B6", i) for i in range(len(MAIN_B6))]
              + [("H", i) for i in range(len(MAIN_H))]
              + [("C", i) for i in range(len(MAIN_C))])


@pytest.mark.parametrize("kind,i", MAIN_CASES,
                         ids=[f"{k}{i}" for k, i in MAIN_CASES])
def test_tensor_core_kernels_at_main_path_shapes(dev, kind, i):
    """B, U, B6, U's fused head (H) and C in bf16 at the main path's
    shapes against their plain versions (C's scores within 1e-4); the
    counter moves by one per call; two calls are bitwise equal (each
    output element is one block's sum in a fixed order, and the head's and
    C's partials are added in a fixed order by their second launch: no
    atomics)."""
    call, plain, per_call, counter = _main_path_case(dev, kind, i)
    before = counter.launches
    out = call()
    torch.cuda.synchronize()
    assert counter.launches == before + per_call
    assert torch.equal(call(), out)
    if kind == "C":
        err = (out - plain()).abs().max().item()
        assert err <= TOL_SCORES, err
    else:
        _close(out, plain(), torch.bfloat16)


def _device_kernels(fn, tmp_path) -> set:
    """Names of the kernels the card ran during ``fn()``, from a
    torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return {e["name"] for e in events
            if e.get("ph") == "X" and str(e.get("cat", "")).lower() == "kernel"}


@pytest.mark.parametrize("kind,wgmma,cuda_core",
                         [("B", "conv3x3_wgmma_kernel", "conv3x3_bn_act_kernel"),
                          ("B6", "conv3x3_wgmma_kernel",
                           "conv3x3_bn_act_kernel"),
                          ("U", "upsample2_wgmma_kernel",
                           "upsample2_conv3x3_bn_act_kernel"),
                          ("B7", "conv_stats_wgmma_kernel",
                           "conv_stats_kernel"),
                          ("B8", "upsample_v2_wgmma_kernel",
                           "upsample_v2_kernel"),
                          ("H", "upsample2_head_wgmma_kernel",
                           "upsample2_conv3x3_head_kernel"),
                          ("C", "cosine_wgmma_kernel",
                           "cosine_scores_kernel")])
def test_bf16_runs_no_cuda_core_kernel(dev, tmp_path, kind, wgmma,
                                       cuda_core):
    """A bf16 call runs the tensor-core kernel and never the CUDA-core
    loop (conv_tile.cuh), which stays the f32 path."""
    call = _main_path_case(dev, kind, 0)[0]
    names = _device_kernels(call, tmp_path)
    assert any(wgmma in n for n in names), names
    assert not any(cuda_core in n for n in names), names


def test_tensor_core_kernels_have_hgmma(dev):
    """chip_smoke's SASS guard: every instance of the six bf16 kernels
    holds HGMMA instructions (the tensor cores), as many as before Q1 and
    Q2 moved onto their mainloop: four conv kernels and C for BN 16 to 256,
    U's fused head for BN 16 to 128; so does every instance of kernel D's
    two (BN 16 to 256, split and unsplit), whose sum kernel holds none;
    every instance of Q1's, Q2's and Q3's
    s8 kernels holds IGMMA (the int8 tensor cores), Q3's sum kernel and
    Q4's kernels neither, and no kernel holds DP4A (check_hgmma raises
    otherwise); the CUDA-core f32 kernels and the finish launches hold no
    HGMMA."""
    import chip_smoke
    counts = chip_smoke.check_hgmma(cuda_lib.build())
    assert sum(map(len, counts.values())) == 4 * 5 + 4 + 5 + 4 * 5 + 2 * 5
    for stem in ("dense_bf16_wgmma_kernel", "dense_bf16_split_wgmma_kernel"):
        assert sorted(counts[stem]) == [16, 32, 64, 128, 256]
        assert all(counts[stem].values()), (stem, counts[stem])
    assert {"quant_dense_s8_kernel", "quant_dense_split_s8_kernel"} <= set(
        chip_smoke.S8_KERNELS)
    assert counts["conv3x3_wgmma_kernel"] == dict.fromkeys(
        (16, 32, 64, 128, 256), chip_smoke.HGMMA_COUNTS[
            "conv3x3_wgmma_kernel"])
    for stem in chip_smoke.S8_KERNELS:
        assert sorted(counts[stem]) == [16, 32, 64, 128, 256]
        assert all(counts[stem].values()), (stem, counts[stem])
    for name, n in chip_smoke.sass_hgmma(cuda_lib.build()).items():
        if any(s in name for s in ("bn_act_kernel", "conv_stats_kernel",
                                   "upsample_v2_kernel", "head_kernel",
                                   "cosine_scores_kernel", "finish_kernel",
                                   "dense_bf16_sum_kernel")):
            assert n == 0, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,q", [(600, 100, 300), (1000, 1030, 40),
                                   (5, 8, 1)])
def test_cosine_scores_kernel_groups_and_pad(dev, dtype, n, d, q):
    """C beyond apply_r's shapes: more needles than one group of 256 (grid
    y), D off a multiple of 8 (bf16 pads it) and of 64, N below one tile;
    a zero row; two calls bitwise equal."""
    g = torch.Generator(device=dev).manual_seed(5)
    emb = torch.randn(n, d, device=dev, generator=g).to(dtype)
    emb[n // 2] = 0
    idx = torch.randint(0, n, (q,), device=dev, generator=g)
    out = topk_kernel.cosine_scores(emb, idx)
    torch.cuda.synchronize()
    assert torch.equal(topk_kernel.cosine_scores(emb, idx), out)
    ref = topk_kernel.cosine_scores_plain(emb, idx)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,h,w,ci,co,cf", [(2, 6, 5, 24, 300, 3),
                                            (3, 4, 9, 8, 16, 2)])
def test_upsample_head_kernel_channel_blocks(dev, n, h, w, ci, co, cf):
    """The bf16 head with Co over three channel blocks of 128 and with one
    block of 16, ragged tiles; against the plain version, and against its
    own two-stage plain order; two calls bitwise equal."""
    import chip_smoke
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(n, h, w, ci, device=dev, generator=g).to(torch.bfloat16)
    (k, fk), (sc, _), (sh, fb) = chip_smoke._conv_chain(g, dev, [ci, co, cf])
    uc = upsample_conv_kernel
    out = uc.upsample2_conv3x3_head(x, k, sc, sh, fk, fb)
    torch.cuda.synchronize()
    assert torch.equal(uc.upsample2_conv3x3_head(x, k, sc, sh, fk, fb), out)
    _close(out, uc.upsample2_conv3x3_bn_act_plain(
        x, k, sc, sh, final_kernel=fk, final_bias=fb), torch.bfloat16)
    _close(out, uc.head_finish_plain(
        uc.head_tap_partials_plain(x, k, sc, sh, fk), fb,
        dtype=torch.bfloat16), torch.bfloat16)


@pytest.mark.parametrize("shape,offset", [((4, 256, 128), 0),
                                          ((3, 1001), 0), ((2, 5, 4099), 0),
                                          ((5, 64), 1), ((1, 3), 0)])
def test_probe_times_two_grid(dev, shape, offset):
    """B9's times_two on its grid over (slice, leading index): 16-byte
    packs where the rows allow, scalars on ragged rows and on a view one
    element off the 16-byte boundary; exactly the plain version."""
    g = torch.Generator(device=dev).manual_seed(13)
    numel = int(np.prod(shape))
    x = torch.randn(numel + offset, device=dev, generator=g)[offset:]
    x = x.view(shape)
    assert torch.equal(probe_kernels.times_two(x),
                       probe_kernels.times_two_plain(x))


def test_cosine_padded_corpus_bitwise(dev):
    """Kernel C on a corpus padded once beforehand (padded_corpus, what
    topk_all hands it) gives bitwise the scores of C padding it itself;
    an f32 or already aligned corpus is handed over as it is."""
    g = torch.Generator(device=dev).manual_seed(14)
    emb = torch.randn(300, 100, device=dev, generator=g).to(torch.bfloat16)
    idx = torch.arange(40, 80, device=dev)
    padded = topk_kernel.padded_corpus(emb)
    assert padded.shape == (300, 104) and torch.equal(padded[:, :100], emb)
    assert torch.equal(topk_kernel.cosine_scores(padded, idx),
                       topk_kernel.cosine_scores(emb, idx))
    f32 = emb.float()
    assert topk_kernel.padded_corpus(f32) is f32
    assert topk_kernel.padded_corpus(padded) is padded


def _e2e_case(dev, dims=(3, 16, 16), nd=16, n=40):
    """A random G3 and R at a small size, their variable trees on the card,
    a second R's, and latents."""
    from torch.utils import _pytree as pytree
    from ganreverser_tpu_torch.models import bridge, modules, zoo
    gen = torch.Generator().manual_seed(15)
    G = modules.init_parameters(zoo.create_G3(dims, nd), gen).to(dev)
    R = modules.init_parameters(zoo.create_R(dims, nd, "normal"), gen).to(dev)
    rv = bridge.module_variables(R)
    g = torch.Generator(device=dev).manual_seed(16)
    # positive factors keep the BatchNorm variances positive
    rv2 = pytree.tree_map(lambda t: t * (1.0 + 0.2 * torch.rand(
        t.shape, device=dev, generator=g)), rv)
    z = torch.randn(n, nd, device=dev, generator=g)
    return G, R, bridge.module_variables(G), rv, rv2, z, dims, nd


def _e2e(G, R, dims, nd, pixel_k=0, capture=True):
    from ganreverser_tpu_torch.analysis import e2e
    return e2e.make_e2e_program(
        G, R, batch_size=16, k=5, needle_chunk=16, pixel_k=pixel_k,
        capture=capture, **e2e.fast_legs(dims, nd, "normal"))


@pytest.mark.parametrize("pixel_k", [0, 7])
def test_e2e_graph_matches_eager(dev, pixel_k):
    """The fused program as one CUDA graph: a replay is bitwise the eager
    program, and each replay adds the kernels' launches of one run to
    their counts (three chunks of 16: U and the head once a chunk; B six
    times a chunk; C once per needle chunk and search)."""
    G, R, gv, rv, _, z, dims, nd = _e2e_case(dev)
    graph = _e2e(G, R, dims, nd, pixel_k)
    eager = _e2e(G, R, dims, nd, pixel_k, capture=False)
    out = graph(gv, rv, z)
    ref = eager(gv, rv, z)
    assert len(out) == (5 if pixel_k else 3)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    counters = {"U": upsample_conv_kernel.upsample2_conv3x3_bn_act,
                "head": upsample_conv_kernel.upsample2_conv3x3_head,
                "B": conv_block_kernel.conv_block,
                "C": topk_kernel.cosine_scores}
    before = {k: fn.launches for k, fn in counters.items()}
    again = graph(gv, rv, z)
    torch.cuda.synchronize()
    per_replay = {k: fn.launches - before[k] for k, fn in counters.items()}
    assert per_replay == {"U": 3, "head": 3, "B": 18,
                          "C": 6 if pixel_k else 3}
    for a, b in zip(again, out):
        assert torch.equal(a, b)
    assert len(graph.graphs) == 1


def test_e2e_graph_takes_each_calls_weights(dev):
    """A call with other weights gives those weights' result (the graph
    reads static copies, filled on every call), and the first weights
    give the first result again."""
    G, R, gv, rv, rv2, z, dims, nd = _e2e_case(dev)
    graph = _e2e(G, R, dims, nd)
    eager = _e2e(G, R, dims, nd, capture=False)
    first = graph(gv, rv, z)
    other = graph(gv, rv2, z)
    assert not torch.equal(other[0], first[0])
    for a, b in zip(other, eager(gv, rv2, z)):
        assert torch.equal(a, b)
    for a, b in zip(graph(gv, rv, z), first):
        assert torch.equal(a, b)
    assert len(graph.graphs) == 1


def test_serial_programs_graphs_match_fused(dev):
    """generate-all, invert-all, search-all, each a CUDA graph on the same
    fast legs, give the fused graph's embeddings and rankings bitwise."""
    from ganreverser_tpu_torch.analysis import e2e
    G, R, gv, rv, _, z, dims, nd = _e2e_case(dev)
    generate, invert, search = e2e.make_serial_programs(
        G, R, batch_size=16, k=5, needle_chunk=16,
        **e2e.fast_legs(dims, nd, "normal"))
    emb = invert(rv, generate(gv, z))
    v, i = search(emb)
    fused = _e2e(G, R, dims, nd)(gv, rv, z)
    for a, b in zip((emb, v, i), fused):
        assert torch.equal(a, b)


def _chip_smoke():
    """chip_smoke.py beside the tests' directory: its Torch7 writer and
    NCHW reference networks (the card's machine has no jax, so the test
    writer of tests/test_torch7.py is not at hand there)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_imported_g3_and_r_fast_paths_on_card(dev, tmp_path):
    """A small G3 and R (3x16x16, noise 8, random BN statistics) written as
    the reference's t7 files, imported, then the fast G (U, and U's fused
    head), the fast R (B) and the fast D (B6) on the card in f32 against
    the NCHW reference forwards: 1e-4 of the output's scale."""
    from ganreverser_tpu_torch.io import checkpoint as ckpt
    from ganreverser_tpu_torch.io.import_t7 import import_t7
    from ganreverser_tpu_torch.models import bridge, fastpath
    cs = _chip_smoke()
    dims, nd = (3, 16, 16), 8
    G, R, RF = cs.make_models(dev, dims, nd)
    D = cs.make_d2(dev, dims)
    vis = np.random.default_rng(0).normal(size=(100, nd)).astype(np.float32)
    paths, refs, _ = cs.write_t7_files(G, D, R, RF, str(tmp_path), vis,
                                       dims, nd)
    save = str(tmp_path / "logs")
    tree = ckpt.load_checkpoint(import_t7(paths["adversarial.net"], save,
                                          verbose=False))[0]
    r_tree = ckpt.load_checkpoint(import_t7(paths["r.net"], save,
                                            verbose=False))[0]["R"]

    def variables(t):
        return bridge.to_torch({"params": t["params"], "state": t["state"]},
                               dev)

    z = torch.randn(64, nd, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    ref = cs.nchw_forward(refs["G"], z)
    x = ref.permute(0, 2, 3, 1).contiguous()
    counters = (upsample_conv_kernel.upsample2_conv3x3_bn_act,
                upsample_conv_kernel.upsample2_conv3x3_head,
                conv_block_kernel.conv_block, conv_kernel.conv3x3_bn_act)
    before = [fn.launches for fn in counters]
    with torch.no_grad():
        _close(fastpath.make_fast_generator(dims, nd, torch.float32)(
            variables(tree["G"]), z), x, torch.float32)
        _close(fastpath.make_fast_inverter(dims, nd, "normal",
                                           torch.float32)(
            variables(r_tree), x), cs.nchw_forward(refs["R"], ref),
            torch.float32)
        _close(fastpath.make_fast_discriminator(dims, torch.float32)(
            variables(tree["D"]), x), cs.nchw_forward(refs["D"], ref),
            torch.float32)
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counters, before)] == \
        [1, 1, 6, 5]


# -- the int8 kernels Q1-Q4 and serving artifacts -------------------------

@pytest.mark.parametrize("shape", [(5, 3, 7), (37,), (2, 9, 6, 64)])
def test_quant_act_kernel_bitwise(dev, shape):
    """Q4: q and the scale bitwise the plain version's, ragged sizes (no
    16-byte packs) included; one launch counted."""
    from ganreverser_tpu_torch.ops import quant
    x = torch.randn(shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2))
    before = quant.quant_act.launches
    q, s = quant.quant_act(x)
    torch.cuda.synchronize()
    qp, sp = quant.quantize_plain(x)
    assert quant.quant_act.launches == before + 1
    assert torch.equal(q, qp) and torch.equal(s, sp) and s.shape == ()


def test_weight_scales_are_the_ieee_quotient(dev):
    """The weights' per-channel scales (``quantize_plain`` over axes) on
    the card are max / 127 in IEEE division, as JAX and the CPU compute
    them: the f64 quotient rounded to f32. 182.19724 is a maximum where a
    multiply by the reciprocal of 127 is 1 ulp off."""
    from ganreverser_tpu_torch.ops import quant
    maxima = torch.tensor([182.19724, 1.0, 0.3, 127.0, 1e-3, 3.7, 2.0 ** -9,
                           65504.0])
    g = torch.Generator().manual_seed(3)
    w = (2 * torch.rand(3, 3, 4, 8, generator=g) - 1) * 0.9 * maxima
    w[1, 2, 3] = -maxima
    q, scale = quant.quantize_plain(w.to(dev), axis=(0, 1, 2))
    ieee = (maxima.double() / 127).float().reshape(1, 1, 1, -1)
    assert torch.equal(scale.cpu(), ieee)
    q_cpu, scale_cpu = quant.quantize_plain(w, axis=(0, 1, 2))
    assert torch.equal(scale.cpu(), scale_cpu) and torch.equal(q.cpu(), q_cpu)


@pytest.mark.parametrize("n,h,w,ci,co,act,pool", [
    (3, 10, 6, 5, 70, "none", False), (2, 8, 12, 8, 2, "relu", True),
    (1, 17, 33, 4, 3, "sigmoid", False), (2, 6, 6, 12, 130, "elu", True)])
def test_quant_conv3x3_kernel_bitwise(dev, n, h, w, ci, co, act, pool):
    """Q1 at ragged shapes (Ci off the word, Co off both tiles, H and W off
    the patch): bitwise the plain version (one FMA rounding on both sides;
    expm1f and expf against PyTorch's, equal on these inputs)."""
    from ganreverser_tpu_torch.ops import quant
    g = torch.Generator(device=dev).manual_seed(3)
    xq, xs = quant.quantize_plain(torch.randn(n, h, w, ci, device=dev,
                                              generator=g))
    wq, ws = quant.quantize_plain(torch.randn(3, 3, ci, co, device=dev,
                                              generator=g), axis=(0, 1, 2))
    b = torch.randn(co, device=dev, generator=g)
    out = quant.quant_conv3x3_same(xq, xs, wq, ws, b, act=act, pool=pool)
    torch.cuda.synchronize()
    ref = quant.quant_conv3x3_plain(xq, xs, wq, ws, b, act=act, pool=pool)
    assert out.shape == ref.shape
    _close(out, ref, torch.float32)
    assert (out - ref).abs().max().item() <= 1e-6 * max(
        1.0, ref.abs().max().item())


@pytest.mark.parametrize("n,h,w,ci,co", [(2, 5, 3, 6, 9), (1, 9, 17, 16, 64)])
def test_quant_upsample_kernel_bitwise(dev, n, h, w, ci, co):
    from ganreverser_tpu_torch.ops import quant
    g = torch.Generator(device=dev).manual_seed(4)
    xq, xs = quant.quantize_plain(torch.randn(n, h, w, ci, device=dev,
                                              generator=g).relu())
    wq16, ws = quant.quant_phase_weights(
        torch.randn(3, 3, ci, co, device=dev, generator=g),
        torch.rand(co, device=dev, generator=g) + 0.5)
    sh = torch.randn(co, device=dev, generator=g)
    out = quant.quant_upsample2_conv3x3(xq, xs, wq16, ws, sh)
    torch.cuda.synchronize()
    assert torch.equal(out, quant.quant_upsample2_conv3x3_plain(
        xq, xs, wq16, ws, sh))


# the int8 legs' Q1 and Q2 shapes with N cut to 16 (R's six convs, G's
# output conv, G's two stages), and Ci 40 with Co 130 and 300 (two channel
# blocks of 256); (kind, N, H, W, Ci, Co, act, pool)
S8_MAIN_CASES = [
    ("conv", 16, 64, 64, 3, 64, "elu", False),
    ("conv", 16, 64, 64, 64, 64, "elu", False),
    ("conv", 16, 64, 64, 64, 64, "elu", True),
    ("conv", 16, 32, 32, 64, 128, "elu", False),
    ("conv", 16, 32, 32, 128, 128, "elu", False),
    ("conv", 16, 32, 32, 128, 128, "elu", True),
    ("conv", 16, 64, 64, 128, 3, "sigmoid", False),
    ("conv", 2, 9, 13, 40, 130, "relu", False),
    ("conv", 2, 10, 14, 40, 300, "none", True),
    ("phase", 16, 16, 16, 512, 256, "relu", False),
    ("phase", 16, 32, 32, 256, 128, "relu", False),
    ("phase", 2, 5, 7, 40, 130, "relu", False),
    ("phase", 2, 5, 7, 40, 300, "none", False)]


@pytest.mark.parametrize("kind,n,h,w,ci,co,act,pool", S8_MAIN_CASES)
def test_quant_s8_kernels_at_main_path_shapes(dev, kind, n, h, w, ci, co,
                                              act, pool):
    """Q1 and Q2 on the int8 tensor cores at the main path's shapes: one
    launch counted; bitwise the plain version with none or relu, within
    1e-6 of scale with ELU or the sigmoid (CUDA's expm1f and expf) and
    then bitwise with none; a second call bitwise the first."""
    from ganreverser_tpu_torch.ops import quant
    g = torch.Generator(device=dev).manual_seed(6)
    xq, xs = quant.quantize_plain(torch.randn(n, h, w, ci, device=dev,
                                              generator=g))
    k = torch.randn(3, 3, ci, co, device=dev, generator=g)
    b = torch.randn(co, device=dev, generator=g)
    if kind == "conv":
        wq, ws = quant.quantize_plain(k, axis=(0, 1, 2))
        wrapper, op = quant.quant_conv3x3_same, quant.conv_operand(wq)

        def run(a, plain=False):
            if plain:
                return quant.quant_conv3x3_plain(xq, xs, wq, ws, b, act=a,
                                                 pool=pool)
            return wrapper(xq, xs, wq, ws, b, act=a, pool=pool, operand=op)
    else:
        wq, ws = quant.quant_phase_weights(k, torch.rand(
            co, device=dev, generator=g) + 0.5)
        wrapper, op = (quant.quant_upsample2_conv3x3,
                       quant.phase_operand(wq))

        def run(a, plain=False):
            if plain:
                return quant.quant_upsample2_conv3x3_plain(xq, xs, wq, ws, b,
                                                           act=a)
            return wrapper(xq, xs, wq, ws, b, act=a, operand=op)
    before = wrapper.launches
    out = run(act)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    ref = run(act, plain=True)
    assert out.shape == ref.shape and out.dtype == torch.float32
    if act in ("none", "relu"):
        assert torch.equal(out, ref)
    else:
        assert (out - ref).abs().max().item() <= 1e-6 * max(
            1.0, ref.abs().max().item())
        assert torch.equal(run("none"), run("none", plain=True))
    assert torch.equal(run(act), out)


def test_quant_s8_kernels_refuse_bad_operands(dev):
    """A CUDA tensor launches the kernel or raises: an operand in the old
    word layout (int32) or of the wrong width is refused."""
    from ganreverser_tpu_torch.ops import quant
    xq = torch.ones(1, 4, 4, 8, dtype=torch.int8, device=dev)
    xs = torch.ones((), device=dev)
    wq = torch.ones(3, 3, 8, 5, dtype=torch.int8, device=dev)
    ws, b = torch.ones(5, device=dev), torch.zeros(5, device=dev)
    with pytest.raises(TypeError):
        quant.quant_conv3x3_same(xq, xs, wq, ws, b, operand=torch.ones(
            9, 2, 5, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        quant.quant_conv3x3_same(xq, xs, wq, ws, b, operand=torch.ones(
            9, 5, 64, dtype=torch.int8, device=dev))


# Q3's shapes: ragged ones, one split over 8 (70 x 4096 . 4096 x 130), and
# the int8 legs' G l0, R l27 (split 16) and R l31; (N, K, M, act)
DENSE_CASES = [(7, 10, 13, "elu"), (70, 4096, 130, "elu"),
               (256, 32768, 512, "elu"), (256, 100, 131072, "relu"),
               (256, 512, 100, "none"), (1, 40, 300, "sigmoid")]


@pytest.mark.parametrize("n,k,m,act", DENSE_CASES)
def test_quant_dense_kernel_bitwise(dev, n, k, m, act):
    """Q3 on the int8 tensor cores, with one K split and with K split over
    blocks (s32 partials added in order by the sum kernel): bitwise the
    plain version, the max bitwise max |y| of the output, a second call
    bitwise the first; the operand (M, K') K-major int8."""
    from ganreverser_tpu_torch.ops import quant
    g = torch.Generator(device=dev).manual_seed(5)
    xq, xs = quant.quantize_plain(torch.randn(n, k, device=dev, generator=g))
    wq, ws = quant.quantize_plain(torch.randn(k, m, device=dev, generator=g),
                                  axis=(0,))
    b = torch.randn(m, device=dev, generator=g)
    op = quant.dense_operand(wq)
    assert op.shape == (m, quant.conv_operands.padded_channels(k, 1))
    before = quant.quant_dense.launches
    out, mx = quant.quant_dense(xq, xs, wq, ws, b, act=act, operand=op,
                                with_max=True)
    torch.cuda.synchronize()
    assert quant.quant_dense.launches == before + 1
    ref, ref_max = quant.quant_dense_plain(xq, xs, wq, ws, b, act=act,
                                           with_max=True)
    assert torch.equal(out, ref) and torch.equal(mx, ref_max)
    assert torch.equal(quant.quant_dense(xq, xs, wq, ws, b, act=act), out)


# Kernel D (csrc/dense.cu): every dense layer of the fast G, R and D at
# configs 3x64x64 z 100, 3x128x128 z 256 and 1x32x32 z 32, batch 128, with
# the activation each layer takes (R l31's tanh for uniform noise), and
# ragged rows, a K of 40 (padded to 64 in one stage) and M = 1; (label, N,
# K, M, act). G l0 runs unsplit, R l27 and R l31 with K split over blocks.
BF16_DENSE_CASES = [
    ("G l0 64", 128, 100, 131_072, "relu"),
    ("R l27 64", 128, 32_768, 512, "elu"),
    ("R l31 64", 128, 512, 100, "none"),
    ("G l0 128", 128, 256, 524_288, "relu"),
    ("R l27 128", 128, 131_072, 512, "elu"),
    ("R l31 128", 128, 512, 256, "tanh"),
    ("G l0 32", 128, 32, 32_768, "relu"),
    ("R l27 32", 128, 8192, 512, "elu"),
    ("R l31 32", 128, 512, 32, "none"),
    ("D left 64", 256, 16_384, 512, "none"),
    ("D left 128", 256, 65_536, 512, "none"),
    ("D l4", 256, 1024, 256, "none"),
    ("D l7", 256, 256, 1, "none"),
    ("ragged", 130, 40, 37, "elu"),
    ("ragged split", 5, 4096, 300, "relu")]


@pytest.mark.parametrize("label,n,k,m,act", BF16_DENSE_CASES,
                         ids=[c[0] for c in BF16_DENSE_CASES])
def test_dense_bf16_kernel(dev, label, n, k, m, act):
    """Kernel D against its plain version (the f32 product of the rounded
    operands, + shift, the activation, one rounding) at every shape the
    fast forwards run it, split and unsplit plans, within chip_smoke's
    dense_close: one bf16 step of the larger value plus 2^-14 of the sum
    of |x w| (the same exact products summed in f32 in other orders); one
    launch counted a call; a second call bitwise the first (fixed sum
    orders: the split sums in split order)."""
    import chip_smoke
    from ganreverser_tpu_torch.ops import dense_kernel
    g = torch.Generator(device=dev).manual_seed(k % 1000 + m % 1000)
    x = torch.randn(n, k, device=dev, generator=g).to(torch.bfloat16)
    w = torch.randn(k, m, device=dev, generator=g) / k ** 0.5
    shift = 0.1 * torch.randn(m, device=dev, generator=g)
    op = dense_kernel.dense_operand(w)
    if label.startswith("R l27"):
        assert dense_kernel.dense_plan(n, k, m)[1] > 1
    before = dense_kernel.dense_act.launches
    out = dense_kernel.dense_act(x, op, shift, act)
    torch.cuda.synchronize()
    assert dense_kernel.dense_act.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (n, m)
    ref = dense_kernel.dense_act_plain(
        x, dense_kernel.operand_kernel(op, k), shift, act)
    assert chip_smoke.dense_close(out, ref, x, w) <= 1.0
    assert torch.equal(dense_kernel.dense_act(x, op, shift, act), out)


def test_dense_bf16_kernel_refuses_bad_operands(dev):
    """A CUDA tensor launches kernel D or raises, with no fallback: an f32
    or unpadded operand, the (K, M) kernel itself, an activation the
    epilogue does not take, a shift of the wrong length."""
    from ganreverser_tpu_torch.ops import dense_kernel
    x = torch.ones(4, 100, device=dev)
    w = torch.ones(100, 24, device=dev)
    op, sh = dense_kernel.dense_operand(w), torch.zeros(24, device=dev)
    before = dense_kernel.dense_act.launches
    for args, kw, err in (((x, op.float(), sh), {}, ValueError),
                          ((x, op[:, :100].contiguous(), sh), {}, ValueError),
                          ((x, w.to(torch.bfloat16), sh), {}, ValueError),
                          ((x, op, sh), {"act": "sigmoid"}, ValueError),
                          ((x, op, sh[:20]), {}, ValueError)):
        with pytest.raises(err):
            dense_kernel.dense_act(*args, **kw)
    assert dense_kernel.dense_act.launches == before


def test_fast_forwards_run_dense_on_kernel_d(dev):
    """The fast G, R and D in bf16 on the card call kernel D once per
    dense layer (1, 2, 4) and stay within the bf16 tolerance of their
    plain versions on the CPU; in f32 they call it not at all."""
    from ganreverser_tpu_torch.models import bridge, fastpath, modules, zoo
    from ganreverser_tpu_torch.ops import dense_kernel
    dims, nd = (3, 16, 16), 8
    gen = torch.Generator().manual_seed(26)
    trees = [bridge.export_variables(modules.init_parameters(m, gen))
             for m in (zoo.create_G3(dims, nd),
                       zoo.create_R(dims, nd, "uniform"),
                       zoo.create_D(dims))]
    z = torch.randn(5, nd, generator=gen)
    x = torch.rand(5, 16, 16, 3, generator=gen)
    for dtype, calls in ((torch.bfloat16, (1, 2, 4)),
                         (torch.float32, (0, 0, 0))):
        legs = (fastpath.make_fast_generator(dims, nd, dtype),
                fastpath.make_fast_inverter(dims, nd, "uniform", dtype),
                fastpath.make_fast_discriminator(dims, dtype))
        for leg, tree, inp, want in zip(legs, trees, (z, x, x), calls):
            before = dense_kernel.dense_act.launches
            out = leg(bridge.to_torch(tree, dev), inp.to(dev))
            torch.cuda.synchronize()
            assert dense_kernel.dense_act.launches == before + want
            _close(out.cpu(), leg(bridge.to_torch(tree, "cpu"), inp), dtype)


@pytest.mark.parametrize("kind,n,h,w,ci,co,act,pool", [
    ("conv", 1, 13, 21, 40, 70, "none", False),
    ("conv", 1, 10, 18, 5, 3, "relu", True),
    ("conv", 2, 6, 6, 12, 130, "elu", True),
    ("phase", 1, 9, 17, 130, 300, "none", False),
    ("phase", 2, 5, 3, 6, 9, "relu", False)])
def test_quant_producers_max_bitwise(dev, kind, n, h, w, ci, co, act, pool):
    """Q1 (with and without the pool) and Q2 off every tile edge with
    ``with_max``: y bitwise the call without the max, the max bitwise
    max |y| (what each block stored, ragged pixels and channels left out),
    and Q4's one pass from it bitwise quantize_plain(y)."""
    from ganreverser_tpu_torch.ops import quant
    g = torch.Generator(device=dev).manual_seed(8)
    xq, xs = quant.quantize_plain(torch.randn(n, h, w, ci, device=dev,
                                              generator=g))
    k = torch.randn(3, 3, ci, co, device=dev, generator=g)
    b = torch.randn(co, device=dev, generator=g)
    if kind == "conv":
        wq, ws = quant.quantize_plain(k, axis=(0, 1, 2))

        def run(**kw):
            return quant.quant_conv3x3_same(xq, xs, wq, ws, b, act=act,
                                            pool=pool, **kw)
    else:
        wq, ws = quant.quant_phase_weights(k, torch.rand(
            co, device=dev, generator=g) + 0.5)

        def run(**kw):
            return quant.quant_upsample2_conv3x3(xq, xs, wq, ws, b, act=act,
                                                 **kw)
    y, mx = run(with_max=True)
    torch.cuda.synchronize()
    assert mx.shape == () and torch.equal(y, run())
    assert torch.equal(mx, y.abs().amax())
    before = quant.quant_act_max.launches
    q, s = quant.quant_act_max(y, mx)
    torch.cuda.synchronize()
    assert quant.quant_act_max.launches == before + 1
    qp, sp = quant.quantize_plain(y)
    assert torch.equal(q, qp) and torch.equal(s, sp)


def test_quantize_plain_scale_is_ieee_division(dev):
    """The per-tensor scale max / 127 in IEEE division on the card, in
    the plain version as in Q4's kernels: at max 182.19724, where CUDA's
    division by the number 127 (a multiply by its reciprocal) gives
    1.4346238, all three give the correctly rounded 1.4346240."""
    from ganreverser_tpu_torch.ops import quant
    m = np.float32(182.19723510742188)
    x = torch.tensor([m, -3.0, 50.92914581298828, 27.97516441345215],
                     device=dev)
    want = np.float32(np.float64(m) / 127.0)
    _, sp = quant.quantize_plain(x)
    _, s2 = quant.quant_act(x)
    _, s1 = quant.quant_act_max(x, x.abs().amax())
    assert sp.item() == s2.item() == s1.item() == want
    assert torch.equal(quant.quantize_plain(x)[0], quant.quant_act(x)[0])


def test_quant_act_max_nan(dev):
    """A NaN in a producer's output: the kernels' max leaves it out (fmaxf
    from 0) and Q4 quantises it to -127, in one pass as in two launches;
    quantize_plain's max is NaN instead (ROADMAP queue C)."""
    from ganreverser_tpu_torch.ops import quant
    y = torch.randn(4096, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(9))
    y[5] = float("nan")
    finite = torch.nan_to_num(y, nan=0.0)
    q2, s2 = quant.quant_act(y)
    q1, s1 = quant.quant_act_max(y, finite.abs().amax())
    torch.cuda.synchronize()
    qf, sf = quant.quantize_plain(finite)
    assert torch.equal(s1, sf) and torch.equal(s2, sf)
    assert q1[5].item() == q2[5].item() == -127
    keep = torch.arange(4096, device=dev) != 5
    assert torch.equal(q1[keep], qf[keep]) and torch.equal(q2[keep], qf[keep])
    assert torch.isnan(quant.quantize_plain(y)[1])


def test_int8_forwards_quantise_in_one_pass(dev):
    """The int8 G and R on the card: two Q4s of two launches (z and the
    images) and ten in one pass a forward pair, the outputs those of the
    same forwards on the CPU's plain versions within two int8 levels."""
    from torch.utils import _pytree as pytree
    from ganreverser_tpu_torch.models import bridge, fastpath, modules, zoo
    from ganreverser_tpu_torch.ops import quant
    dims, nd = (3, 16, 16), 8
    g = torch.Generator().manual_seed(10)
    G = modules.init_parameters(zoo.create_G3(dims, nd), g)
    R = modules.init_parameters(zoo.create_R(dims, nd, "normal"), g)
    gv, rv = bridge.module_variables(G), bridge.module_variables(R)
    gen = fastpath.make_fast_generator_int8(dims, nd, torch.float32)
    inv = fastpath.make_fast_inverter_int8(dims, nd, "normal", torch.float32)
    z = torch.randn(6, nd, generator=g)
    counters = (quant.quant_act, quant.quant_act_max)
    before = [fn.launches for fn in counters]
    images = gen(pytree.tree_map(lambda t: t.to(dev), gv), z.to(dev))
    zhat = inv(pytree.tree_map(lambda t: t.to(dev), rv), images)
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counters, before)] == [2, 10]
    cpu_images = gen(gv, z)
    cpu_zhat = inv(rv, images.cpu())
    for got, want in ((images, cpu_images), (zhat, cpu_zhat)):
        lev = (got.cpu() - want).abs().max() / (want.abs().max() / 127)
        assert lev <= 2.0, lev


@pytest.mark.parametrize("int8", [False, True])
def test_exported_programs_on_card(dev, tmp_path, int8):
    """export (invert, generate, e2e) on the card from seeded checkpoints:
    --check passes, the loaded artifacts give the live legs' outputs, run
    as one CUDA graph each, and the CPU loads the invert artifact."""
    from ganreverser_tpu_torch.cli import export
    from ganreverser_tpu_torch.io import serving
    cs = _chip_smoke()
    dims, nd = (3, 16, 16), 8
    G, R, RF = cs.make_models(dev, dims, nd)
    save = str(tmp_path / "logs")
    g_path = cs.save_models(G, R, RF, save, dims, nd)
    for what in ("invert", "generate", "e2e"):
        out = str(tmp_path / what)
        res = export.main(["--G", g_path, "--save", save, "--out", out,
                           "--what", what, "--batch", "16", "--N", "48",
                           "--k", "5", "--compute_dtype", "bfloat16",
                           "--check", *(["--int8"] if int8 else [])])
        assert res["check_err"] <= (0.05 if int8 else 1e-3) * max(
            1.0, res["check_scale"])
        call, meta = serving.load_serving_program(out)
        assert meta["platforms"] == ["cuda", "cpu"]
        x = (torch.rand(16, 16, 16, 3, device=dev).to(torch.bfloat16)
             if what == "invert" else torch.randn(
                 48 if what == "e2e" else 16, nd, device=dev))
        first = call(x)
        second = call(x)
        for a, b in zip(first if isinstance(first, tuple) else (first,),
                        second if isinstance(second, tuple) else (second,)):
            assert torch.equal(a, b)
    cpu_call, _ = serving.load_serving_program(str(tmp_path / "invert"),
                                               "cpu")
    got = cpu_call(torch.rand(16, 16, 16, 3).to(torch.bfloat16))
    assert got.shape == (16, nd) and got.device.type == "cpu"


def _planted(dev, q, n, seed):
    """(q, n) f32 scores with planted ties: repeated values in and across
    bins, -0.0 beside +0.0, -inf."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(q, n, device=dev, generator=g)
    x[:, ::7] = x[:, 3:4]
    x[:, 1::11] = 2.5
    x[0, :4] = torch.tensor([-0.0, 0.0, -float("inf"), 0.0], device=dev)
    x[-1, ::2] = -float("inf")
    return x


@pytest.mark.parametrize("q,n,k,r", [
    (10, 10_000, 100, 0.95), (256, 10_240, 100, 0.99), (7, 777, 5, 1.0),
    (3, 300, 7, 0.5), (2, 16_384, 100, 1.0),
    # past 16,384 bins: a cluster of 8 with a k spanning its blocks
    (3, 20_000, 10, 1.0), (2, 20_000, 17_000, 1.0),
    # one row; k = 1 with rows off 16 bytes (the row staged by 4-byte
    # copies); k = L; N off L (L = 256); L in 16,385..32,768 in
    # one cluster and, at 70 rows, walked again each pass (keys off chip);
    # k past one block's shared memory (the sort in the indices output)
    (1, 10_000, 100, 1.0), (5, 3001, 1, 0.95), (4, 4096, 4096, 0.5),
    (6, 1000, 20, 0.95), (3, 24_000, 50, 1.0), (70, 30_000, 100, 1.0),
    (1, 40_000, 30_000, 1.0)])
def test_approx_topk_kernel_bitwise(dev, q, n, k, r):
    """Kernel S against its plain version, indices and values bitwise, in
    one launch at every L; a NaN among the planted ties; at r = 1 the
    values are torch.topk's."""
    x = _planted(dev, q, n, q + n + k)
    x[-1, 5] = float("nan")
    before = approx_topk_kernel.approx_topk.launches
    v, i = approx_topk_kernel.approx_topk(x, k, r)
    torch.cuda.synchronize()
    assert approx_topk_kernel.approx_topk.launches == before + 1
    pv, pi = approx_topk_kernel.approx_topk_plain(x, k, r)
    assert v.dtype == torch.float32 and i.dtype == torch.int64
    assert torch.equal(i, pi)
    assert torch.equal(v.view(torch.int32), pv.view(torch.int32))
    if r == 1.0:
        ref = torch.topk(x, k, dim=1).values
        assert torch.equal(v.view(torch.int32), ref.view(torch.int32))


def test_approx_topk_kernel_ties_straddle_the_threshold(dev):
    """Rows whose k-th value is shared by more bins than are taken: the
    index half of the keys decides, bitwise the plain version."""
    for q, n, k, r in ((4, 10_240, 100, 0.95), (3, 10_000, 100, 1.0)):
        g = torch.Generator(device=dev).manual_seed(n)
        x = 0.1 * torch.randn(q, n, device=dev, generator=g)
        x[:, 50::97] = 0.75   # some 100 ties, each in a bin of its own
        x[:, ::389] = 3.0     # above them
        x[0, 7] = float("nan")
        v, i = approx_topk_kernel.approx_topk(x, k, r)
        pv, pi = approx_topk_kernel.approx_topk_plain(x, k, r)
        assert bool((pv[:, -1] == 0.75).all())
        assert bool(((pv == 0.75).sum(1) < (x == 0.75).sum(1) - 10).all())
        assert torch.equal(i, pi)
        assert torch.equal(v.view(torch.int32), pv.view(torch.int32))


def test_approx_topk_kernel_in_a_graph(dev):
    """S captures in a CUDA graph, one block a row and a cluster a row:
    replays give the eager call's result on the scores copied in."""
    for n, k, r in ((10_240, 100, 0.95), (20_000, 50, 1.0)):
        x = _planted(dev, 4, n, n)
        static = torch.zeros_like(x)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = approx_topk_kernel.approx_topk(static, k, r)
        static.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, approx_topk_kernel.approx_topk(x, k, r)):
            assert torch.equal(a, b)


def test_approx_topk_refuses_bad_arguments(dev):
    x = torch.randn(3, 100, device=dev)
    with pytest.raises(TypeError):
        approx_topk_kernel.approx_topk(x.double(), 5)
    with pytest.raises(ValueError):
        approx_topk_kernel.approx_topk(x, 101)
    with pytest.raises(ValueError):
        approx_topk_kernel.approx_topk(x, 5, 0.0)


@pytest.mark.parametrize("pixel_k", [0, 7])
def test_e2e_approx_graph_matches_eager(dev, pixel_k):
    """The fused program with approx=True: the graph's replay is bitwise
    the eager program, and S launches once per needle chunk and search."""
    from ganreverser_tpu_torch.analysis import e2e
    G, R, gv, rv, _, z, dims, nd = _e2e_case(dev)
    kw = dict(batch_size=16, k=5, needle_chunk=16, pixel_k=pixel_k,
              approx=True, recall_target=0.9,
              **e2e.fast_legs(dims, nd, "normal"))
    graph = e2e.make_e2e_program(G, R, **kw)
    eager = e2e.make_e2e_program(G, R, capture=False, **kw)
    out = graph(gv, rv, z)
    for a, b in zip(out, eager(gv, rv, z)):
        assert torch.equal(a, b)
    before = approx_topk_kernel.approx_topk.launches
    graph(gv, rv, z)
    torch.cuda.synchronize()
    assert (approx_topk_kernel.approx_topk.launches - before
            == (6 if pixel_k else 3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,parts", [((256, 64, 64, 8), 2),
                                         ((12, 37, 5), 3), ((256, 512), 4)])
def test_dropout_kernel_counter_base(dev, dtype, shape, parts):
    """Kernel B5 with a counter base (a rank's rows of a batch): each part
    is bitwise the rows of the whole batch's mask, the kernel's and the
    plain version's, forward and backward; base 0 is the mask without
    one."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(shape, device=dev, generator=g).to(dtype)
    s = torch.tensor([-99], dtype=torch.int32, device=dev)
    whole = dropout_kernel.fused_dropout(x, s, 0.5)
    assert torch.equal(whole, dropout_kernel.fused_dropout_plain(x, s, 0.5))
    assert torch.equal(dropout_kernel.fused_dropout(x, s, 0.5, base=0),
                       whole)
    row = x[0].numel()
    for rows in torch.arange(shape[0]).chunk(parts):
        lo, hi = int(rows[0]), int(rows[-1]) + 1
        part = x[lo:hi].clone().requires_grad_(True)
        y = dropout_kernel.fused_dropout(part, s, 0.5, base=lo * row)
        y.float().sum().backward()
        torch.cuda.synchronize()
        assert torch.equal(y, whole[lo:hi])
        assert torch.equal(part.grad, dropout_kernel.fused_dropout(
            torch.ones_like(part), s, 0.5, base=lo * row))


def test_distributed_e2e_one_rank_nccl(dev):
    """make_distributed_e2e_program in a one-rank NCCL world (the
    collectives run, on one card) against make_e2e_program: the embeddings
    and the attribute search bitwise, the pixel ring's values within 1e-5
    (the random G's images tie their pixel scores, so the order of tied
    indices is free; tests/test_torch_port_parallel.py holds the ring's
    indices on separated rows)."""
    import socket
    import torch.distributed as dist
    from ganreverser_tpu_torch import parallel as par
    from ganreverser_tpu_torch.analysis import e2e
    G, R, gv, rv, _, z, dims, nd = _e2e_case(dev)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    assert par.initialize_distributed(f"localhost:{port}", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        kw = dict(batch_size=16, k=5, needle_chunk=16, pixel_k=7,
                  **e2e.fast_legs(dims, nd, "normal"))
        one = e2e.make_e2e_program(G, R, **kw)(gv, rv, z)
        out = e2e.make_distributed_e2e_program(
            G, R, mesh=par.make_mesh(), **kw)(gv, rv, z)
        torch.cuda.synchronize()
    finally:
        par.shutdown_distributed()
    for a, b in zip(out[:3], one[:3]):
        assert torch.equal(a, b)
    assert (out[3] - one[3]).abs().max().item() <= 1e-5
    assert out[4].shape == one[4].shape


# -- the kernels at BASELINE.json's configs 1 (1x32x32, noise 32) and 5
# (3x128x128, noise 256): the shapes no other test launches

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample_kernel_at_an_8x8_input(dev, dtype):
    """U at config 1's G stage 1, (8, 8, 512) -> 256: the tile is 16 x 8,
    taller than the image, so half of each tile lies outside it."""
    from ganreverser_tpu_torch.ops import conv_operands
    assert conv_operands.tile_plan(8, 8, 512, 256)[:2] == (16, 8)
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.rand(64, 8, 8, 512, device=dev, generator=g).to(dtype)
    k = torch.randn(3, 3, 512, 256, device=dev, generator=g) / 48.0
    sc = torch.rand(256, device=dev, generator=g) + 0.5
    sh = 0.1 * torch.randn(256, device=dev, generator=g)
    out = upsample_conv_kernel.upsample2_conv3x3_bn_act(x, k, sc, sh,
                                                        act="relu")
    torch.cuda.synchronize()
    ref = upsample_conv_kernel.upsample2_conv3x3_bn_act_plain(
        x, k, sc, sh, act="relu")
    assert out.shape == (64, 16, 16, 256) and out.dtype == dtype
    _close(out, ref, dtype)


def test_quant_upsample_kernel_at_an_8x8_input(dev):
    """Q2 at config 1's G stage 1 (the int8 plan's 16 x 8 tile over an
    8 x 8 image): bitwise the plain version, its max bitwise max |y|."""
    from ganreverser_tpu_torch.ops import quant
    g = torch.Generator(device=dev).manual_seed(22)
    xq, xs = quant.quantize_plain(torch.randn(64, 8, 8, 512, device=dev,
                                              generator=g).relu())
    wq16, ws = quant.quant_phase_weights(
        torch.randn(3, 3, 512, 256, device=dev, generator=g),
        torch.rand(256, device=dev, generator=g) + 0.5)
    sh = torch.randn(256, device=dev, generator=g)
    out, mx = quant.quant_upsample2_conv3x3(xq, xs, wq16, ws, sh,
                                            with_max=True)
    torch.cuda.synchronize()
    ref = quant.quant_upsample2_conv3x3_plain(xq, xs, wq16, ws, sh)
    assert torch.equal(out, ref) and torch.equal(mx, ref.abs().amax())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_block_kernel_on_a_one_channel_stem(dev, dtype):
    """B at config 1's R block 1: a 1-channel 32x32 image (padded to 16
    channels in bf16) through three conv64 + ELU, pooled."""
    g = torch.Generator(device=dev).manual_seed(23)
    chans = [1, 64, 64, 64]
    x = torch.rand(64, 32, 32, 1, device=dev, generator=g).to(dtype)
    ks = [torch.randn(3, 3, ci, co, device=dev, generator=g)
          / (3.0 * ci ** 0.5) for ci, co in zip(chans[:-1], chans[1:])]
    sc = [torch.rand(co, device=dev, generator=g) + 0.5 for co in chans[1:]]
    sh = [0.1 * torch.randn(co, device=dev, generator=g) for co in chans[1:]]
    out = conv_block_kernel.conv_block(x, ks, sc, sh, act="elu", pool=True)
    torch.cuda.synchronize()
    ref = conv_block_kernel.conv_block_plain(x, ks, sc, sh, act="elu",
                                             pool=True)
    assert out.shape == (64, 16, 16, 64) and out.dtype == dtype
    _close(out, ref, dtype)


def test_quant_conv3x3_kernel_on_a_one_channel_stem(dev):
    """Q1 at config 1's R l0 (Ci = 1, padded to 32 int8 channels): within
    1e-6 of scale with ELU, bitwise with none."""
    from ganreverser_tpu_torch.ops import quant
    g = torch.Generator(device=dev).manual_seed(24)
    xq, xs = quant.quantize_plain(torch.rand(64, 32, 32, 1, device=dev,
                                             generator=g))
    wq, ws = quant.quantize_plain(torch.randn(3, 3, 1, 64, device=dev,
                                              generator=g), axis=(0, 1, 2))
    b = torch.randn(64, device=dev, generator=g)
    out = quant.quant_conv3x3_same(xq, xs, wq, ws, b, act="elu")
    torch.cuda.synchronize()
    ref = quant.quant_conv3x3_plain(xq, xs, wq, ws, b, act="elu")
    assert (out - ref).abs().max().item() <= 1e-6 * max(
        1.0, ref.abs().max().item())
    assert torch.equal(quant.quant_conv3x3_same(xq, xs, wq, ws, b),
                       quant.quant_conv3x3_plain(xq, xs, wq, ws, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,ci,co,cf", [(8, 16, 256, 128, 1),
                                          (4, 64, 256, 128, 3)])
def test_upsample_head_kernel_at_the_configs(dev, dtype, n, h, ci, co, cf):
    """U's fused head at G's stage 2 of config 1 (C = 1 on 32x32 output)
    and of config 5 (C = 3 on 128x128 output)."""
    g = torch.Generator(device=dev).manual_seed(25)
    x = torch.rand(n, h, h, ci, device=dev, generator=g).to(dtype)
    k = torch.randn(3, 3, ci, co, device=dev, generator=g) / 48.0
    sc = torch.rand(co, device=dev, generator=g) + 0.5
    sh = 0.1 * torch.randn(co, device=dev, generator=g)
    fk = torch.randn(3, 3, co, cf, device=dev, generator=g) / 34.0
    fb = 0.1 * torch.randn(cf, device=dev, generator=g)
    out = upsample_conv_kernel.upsample2_conv3x3_head(x, k, sc, sh, fk, fb)
    torch.cuda.synchronize()
    ref = upsample_conv_kernel.upsample2_conv3x3_bn_act_plain(
        x, k, sc, sh, act="relu", final_kernel=fk, final_bias=fb)
    assert out.shape == (n, 2 * h, 2 * h, cf) and out.dtype == dtype
    _close(out, ref, dtype)


@pytest.mark.parametrize("n,q", [(2_560, 10), (1_024, 256)])
def test_cosine_scores_kernel_at_d_49152(dev, n, q):
    """C on config 5's flat images (D = 49,152: 768 chunks, at least 12
    slices): within 1e-5 of the scores in f64 on the same bf16 rows, as
    the pixel searches are held."""
    g = torch.Generator(device=dev).manual_seed(26)
    emb = torch.sigmoid(torch.randn(n, 49_152, device=dev, generator=g)).to(
        torch.bfloat16)
    idx = torch.arange(q, device=dev)
    assert topk_kernel.cosine_plan(n, 49_152, q).slices >= 12
    out = topk_kernel.cosine_scores(emb, idx)
    torch.cuda.synchronize()
    e = emb.double()
    e = e / e.norm(dim=1, keepdim=True)
    ref = e[idx] @ e.T
    assert out.shape == (q, n)
    assert (out.double() - ref).abs().max().item() <= 1e-5


def test_quant_dense_kernel_at_k_131072(dev):
    """Q3 at config 5's R l27 (K = 131,072, M = 512, K split over blocks)
    with every operand at +-127: the sums reach 127^2 * 131,072 =
    2,114,060,288, 1.6 % under 2^31 - 1, through the s32 accumulator and
    the split sum; bitwise the plain version."""
    from ganreverser_tpu_torch.ops import quant
    g = torch.Generator(device=dev).manual_seed(27)
    x = torch.where(torch.rand(256, 131_072, device=dev, generator=g) < 0.5,
                    -1.0, 1.0)
    x[0], x[1] = 1.0, -1.0
    w = torch.where(torch.rand(131_072, 512, device=dev, generator=g) < 0.5,
                    -1.0, 1.0)
    w[:, 0] = 1.0
    xq, xs = quant.quantize_plain(x)
    wq, ws = quant.quantize_plain(w, axis=(0,))
    assert int(xq.abs().min()) == int(wq.abs().min()) == 127
    b = torch.zeros(512, device=dev)
    assert quant.dense_plan(256, 131_072, 512)[1] > 1
    out = quant.quant_dense(xq, xs, wq, ws, b)
    torch.cuda.synchronize()
    ref = quant.quant_dense_plain(xq, xs, wq, ws, b)
    assert torch.equal(out, ref)
    assert out[0, 0].item() == pytest.approx(2_114_060_288 * (
        xs * ws.reshape(-1)[0]).item(), rel=1e-6)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_module_g3_forward_and_z_gradient_never_sync(dev, train):
    """Module G3 at 64x64 in bf16, a forward and then autograd.grad to z
    (the refinement's two passes in evaluation; BatchNorm on the batch's
    statistics in training), runs without a host synchronisation
    (``set_sync_debug_mode("error")`` raises at the first), and its output
    and z-gradient match the same module on the CPU."""
    from ganreverser_tpu_torch.models import modules, zoo
    dims, nd, dtype = (3, 64, 64), 16, torch.bfloat16
    G = modules.init_parameters(zoo.create_G3(dims, nd, dtype),
                                torch.Generator().manual_seed(22)).train(train)
    gen = torch.Generator().manual_seed(23)
    z = torch.randn(8, nd, generator=gen)
    ct = torch.randn(8, 64, 64, 3, generator=gen)

    def run(G, z, ct):
        z = z.clone().requires_grad_()
        out = G(z)
        (gz,) = torch.autograd.grad((out.float() * ct).sum(), z)
        return out, gz

    ref_out, ref_gz = run(G, z, ct)
    G, z, ct = G.to(dev), z.to(dev), ct.to(dev)
    run(G, z, ct)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, gz = run(G, z, ct)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.dtype == dtype and gz.dtype == torch.float32
    _close(out.cpu(), ref_out, dtype)
    _close(gz.cpu(), ref_gz, dtype)


# ---- StyleGAN2's FIR filter (ops/fir_kernel.py, csrc/fir.cu) against the
# plain version of each launch. Tolerance: the f32 sums run in another
# order, 1e-5 of the largest output; where a sum is then rounded to bf16
# (the gradient at a bf16 compute dtype) the two can land on neighbouring
# bf16 values, one bf16 step: 2^-7 of the value.


def _fir_close(out, ref, rounded):
    ref = ref.float()
    err = (out.float() - ref).abs()
    allowed = 1e-5 * ref.abs().max().item() + (2.0 ** -7 * ref.abs()
                                               if rounded else 0.0)
    assert bool((err <= allowed).all()), err.max().item()


def _fir_case(dev, up, x, dtype):
    """One forward and backward through fir_filter (two launches) against
    the plain forward and gradient forms."""
    g = torch.Generator(device=dev).manual_seed(24)
    fwd, grad_form = fir_kernel.FORMS[up]
    x = x.requires_grad_(True)
    before = fir_kernel.fir_filter.launches
    y = fir_kernel.fir_filter(x, up, dtype)
    dy = torch.randn(y.shape, device=dev, generator=g)
    (dx,) = torch.autograd.grad(y, x, dy)
    torch.cuda.synchronize()
    assert fir_kernel.fir_filter.launches == before + 2
    want = fir_kernel.upfirdn2d_plain(x.detach(), fwd, dtype)
    want_dx = fir_kernel.upfirdn2d_plain(dy, grad_form, torch.float32, dtype,
                                         x.dtype)
    assert y.shape == want.shape and y.dtype == torch.float32
    assert dx.shape == x.shape and dx.dtype == x.dtype
    _fir_close(y, want, False)
    _fir_close(dx, want_dx, dtype == torch.bfloat16)


@pytest.mark.parametrize("up,shape,x_dtype", [
    (1, (8, 1025, 1025, 32), torch.float32),
    (1, (8, 129, 129, 256), torch.float32),
    (1, (8, 9, 9, 512), torch.float32),
    (2, (8, 512, 512, 3), torch.bfloat16)],
    ids=["blur1024", "blur128", "blur8", "skip1024"])
def test_fir_kernel_at_the_cell_shapes(dev, up, shape, x_dtype):
    """sg2f_ffhq1024.refine_sg2's filters at batch 8, bf16 compute dtype:
    the blurs of the up-sampling convolutions' f32 outputs, and the skip's
    up-sampling of the bf16 image (the scalar path), forward and
    backward."""
    x = torch.randn(shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))
    _fir_case(dev, up, x.to(x_dtype), torch.bfloat16)


@pytest.mark.parametrize("rows", [2, 8])
@pytest.mark.parametrize("x_dtype,dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16)], ids=["f32", "f32_in_bf16", "bf16"])
@pytest.mark.parametrize("up", [1, 2], ids=["blur", "skip"])
@pytest.mark.parametrize("shape", [(3, 7, 10, 3), (2, 13, 6, 8),
                                   (1, 5, 17, 12), (2, 19, 11, 64)])
def test_fir_kernel_ragged_shapes(dev, monkeypatch, shape, up, x_dtype,
                                  dtype, rows):
    """Odd and even sizes off every tile of 2 and 8 rows, C = 3 and 12
    (scalar in bf16), 8 and 64 (16-byte packs), forward and backward, with
    the plan's rows forced."""
    plan = fir_kernel.fir_plan
    monkeypatch.setattr(fir_kernel, "fir_plan", lambda *a: plan(*a)._replace(
        rows=rows))
    x = torch.randn(shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(8))
    _fir_case(dev, up, x.to(x_dtype), dtype)


def test_fir_kernel_unaligned_and_strided(dev):
    """A view one element into its storage (not 16-byte aligned: the
    scalar path) and a transposed view (copied first, counted) filter as
    the plain version does."""
    base = torch.randn(2 * 9 * 9 * 8 + 1, device=dev)
    before = fir_kernel.fir_filter.copies
    for x, copies in ((base[1:].view(2, 9, 9, 8), 0),
                      (base[:-1].view(2, 9, 9, 8).transpose(1, 2), 1)):
        got = fir_kernel.fir_filter(x, 1, torch.float32)
        torch.cuda.synchronize()
        assert fir_kernel.fir_filter.copies == before + copies
        _fir_close(got, fir_kernel.upfirdn2d_plain(x, fir_kernel.FORMS[1][0]),
                   False)


def test_fir_kernel_refuses_bad_arguments(dev):
    x = torch.zeros(1, 5, 5, 8, device=dev)
    with pytest.raises(ValueError):  # no kernel for the device
        fir_kernel.fir_filter(torch.zeros(1, 5, 5, 8, device="meta"), 1)
    with pytest.raises(TypeError):
        fir_kernel.fir_filter(x.half(), 1)
    with pytest.raises(TypeError):
        fir_kernel.fir_filter(x, 1, torch.float16)
    with pytest.raises(ValueError):
        fir_kernel.fir_filter(x[0], 1)  # not NHWC
    with pytest.raises(ValueError):
        fir_kernel.fir_filter(x[:, :1, :1], 1)  # an empty output
    with pytest.raises(ValueError):
        fir_kernel.fir_filter(x, 3)
    with pytest.raises(ValueError):  # pads the kernel does not take
        fir_kernel.upfirdn2d(x, (1, 1, 0, 0))
    with pytest.raises(TypeError):  # a forward form writes f32
        fir_kernel.upfirdn2d(x, fir_kernel.FORMS[1][0], torch.float32,
                             torch.float32, torch.bfloat16)
    with pytest.raises(TypeError):  # a gradient form reads f32
        fir_kernel.upfirdn2d(x.bfloat16(), fir_kernel.FORMS[1][1])
    lib = cuda_lib.library()
    y = torch.empty(1, 4, 4, 8, device=dev)
    stream = cuda_lib.stream_of(x)

    def rc(pad0=1, vec=4, rows=8, c=8):
        return lib.gr_fir_filter(0, 0, x.data_ptr(), y.data_ptr(), 1, 5, 5,
                                 4, 4, c, 1, 1, pad0, 0, 0, vec, rows, stream)

    assert rc() == 0
    assert rc(pad0=0) != 0 and rc(pad0=3) != 0
    assert lib.gr_fir_filter(1, 1, x.data_ptr(), y.data_ptr(), 1, 5, 5, 4, 4,
                             8, 1, 1, 1, 0, 0, 1, 8, stream) != 0  # bf16 out
    assert rc(vec=8) != 0 and rc(vec=4, c=6) != 0 and rc(rows=4) != 0
    torch.cuda.synchronize()


def test_style_generator_launches_fir_kernel(dev):
    """One forward and backward of a small StyleGAN2 (3 x 16 x 16, blocks
    4, 8 and 16: two blurs and two skips) in bf16 on the card launches the
    filter twice for each FIRFilter, and copies no input."""
    from ganreverser_tpu_torch.models import modules, zoo
    from portbench import reference_sg2
    cfg = reference_sg2.config({
        "image": [3, 16, 16], "noise_dim": 8, "w_dim": 8,
        "mapping_layers": 2, "lr_mul": 0.01, "channel_base": 64,
        "channel_max": 16, "fir": [1, 3, 3, 1]})
    with torch.device(dev):
        G = zoo.create_G_sg2f(cfg["image"], cfg["noise_dim"], cfg["w_dim"],
                              torch.bfloat16, mapping_layers=2,
                              channel_base=64, channel_max=16)
    G.load_state_dict(reference_sg2.make(
        cfg, torch.Generator(device=dev).manual_seed(3), dev))
    firs = sum(isinstance(m, modules.FIRFilter) for m in G.modules())
    assert firs == 4
    z = torch.randn(4, 8, device=dev, requires_grad=True)
    before = (fir_kernel.fir_filter.launches, fir_kernel.fir_filter.copies)
    G(z).float().square().mean().backward()
    torch.cuda.synchronize()
    assert (fir_kernel.fir_filter.launches,
            fir_kernel.fir_filter.copies) == (before[0] + 2 * firs, before[1])
    assert torch.isfinite(z.grad).all()
