"""The CUDA kernels against their plain versions on the card, at small and
ragged shapes (N, H, W, Ci and Co off every tile size). Marked ``cuda``:
they need an NVIDIA GPU and nvcc and skip elsewhere. Run on the card with
``python -m pytest tests/test_torch_port_cuda.py -m cuda``.

Tolerances: f32 1e-4 (f32 sums in another order); bf16 3e-2 relative to
the output's scale (one bf16 rounding per layer, taken at the same places
by both versions, can still land on neighbouring bf16 values)."""
import numpy as np
import pytest
import torch

from ganreverser_tpu_torch.ops import (conv_block_kernel, conv_stats_kernel,
                                       dropout_kernel, kmeans_kernel,
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
                                   (64, 100, 20), (1, 3, 2)])
def test_kmeans_kernel(dev, n, d, k):
    """chip_smoke.kmeans_case on more shapes: against the plain step on the
    same centroids (assignment beyond the near-tie margin, counts, sums to
    1e-4 relative, centroids = sums / counts) and bitwise equal over two
    runs (no float atomics); it raises SmokeFailure otherwise."""
    import chip_smoke
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(n, d, device=dev, generator=g)
    c = x[torch.randperm(n, device=dev, generator=g)[:k]]
    c = torch.cat([c, torch.randn(k - c.shape[0], d, device=dev,
                                  generator=g)])
    c[-1] = 0.0
    c[-1, 0] = 50.0  # no row comes near: an empty cluster
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
    with pytest.raises(ValueError):  # more shared memory than a block has
        kmeans_kernel.kmeans_step(torch.zeros(10, 4096, device=dev),
                                  torch.zeros(64, 4096, device=dev))
    with pytest.raises(ValueError):  # mixed devices
        kmeans_kernel.kmeans_step(x, torch.zeros(2, 4))


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
                                   (8, 16, 16, 3)])
@pytest.mark.parametrize("seed", [42, -7, -2 ** 31])
def test_dropout_kernel_bitwise(dev, dtype, shape, seed):
    """Kernel B5 forward and backward against the plain version, bitwise
    (chip_smoke.dropout_case raises SmokeFailure otherwise), at sizes that
    are no multiple of the 16-byte vector; two launches per case."""
    import chip_smoke
    x = torch.randn(shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5))
    before = dropout_kernel.fused_dropout.launches
    assert chip_smoke.dropout_case(x.to(dtype), seed, 0.25) == 0.0
    assert dropout_kernel.fused_dropout.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_kernel_unaligned_and_strided(dev, dtype):
    """A view one element into its storage (not 16-byte aligned: the
    one-element path) and a transposed view (made contiguous) both drop in
    their logical order, as the plain version does."""
    base = torch.randn(4097, device=dev).to(dtype)
    s = torch.tensor([9], dtype=torch.int32, device=dev)
    for x in (base[1:], base[1:].reshape(64, 64).t()):
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


def test_fast_generator_fused_head_launches_head(dev):
    from ganreverser_tpu_torch.models import bridge, fastpath, modules, zoo
    dims, nd = (3, 16, 16), 8
    G = modules.init_parameters(zoo.create_G3(dims, nd),
                                torch.Generator().manual_seed(3)).to(dev)
    v = bridge.module_variables(G)
    z = torch.randn(5, nd, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        before = (upsample_conv_kernel.upsample2_conv3x3_bn_act.launches,
                  upsample_conv_kernel.upsample2_conv3x3_head.launches)
        fused = fastpath.make_fast_generator(dims, nd, dtype, True)(v, z)
        torch.cuda.synchronize()
        assert (upsample_conv_kernel.upsample2_conv3x3_bn_act.launches,
                upsample_conv_kernel.upsample2_conv3x3_head.launches) == (
                    before[0] + 1, before[1] + 1)
        plain = fastpath.make_fast_generator(dims, nd, dtype)(v, z)
        _close(fused, plain, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,ci,co", [(4, 8, 8, 16, 32), (3, 7, 5, 20, 70)])
def test_conv_stats_kernel(dev, dtype, n, h, w, ci, co):
    """y against the plain conv, the sums within 1e-4 of the summed
    magnitudes, and a second run bitwise equal (no float atomics)."""
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
@pytest.mark.parametrize("ci", [16, 20, 3])
def test_upsample_v2_kernel(dev, dtype, ci):
    """B8 against its plain version and against kernel U: Ci = 20 and 3
    make BK chunks straddle taps."""
    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn(3, 5, 7, ci, device=dev, generator=g).to(dtype)
    k = 0.3 * torch.randn(3, 3, ci, 72, device=dev, generator=g)
    sc = torch.rand(72, device=dev, generator=g) + 0.5
    sh = torch.randn(72, device=dev, generator=g)
    before = upsample_v2_kernel.upsample_v2.launches
    out = upsample_v2_kernel.upsample_v2(x, k, sc, sh)
    torch.cuda.synchronize()
    assert upsample_v2_kernel.upsample_v2.launches == before + 1
    assert out.shape == (3, 10, 14, 72) and out.dtype == dtype
    _close(out, upsample_v2_kernel.upsample_v2_plain(x, k, sc, sh), dtype)
    if dtype == torch.float32:
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
