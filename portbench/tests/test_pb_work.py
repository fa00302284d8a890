"""The work arithmetic against hand counts at one layer of each kind."""
import pytest

from portbench import work


def test_dense_layer():
    layer = work.dense("d", 100, 512)
    assert layer.flops == 2 * 100 * 512
    assert (layer.in_elems, layer.w_elems, layer.out_elems) == (
        100, 51_200, 512)


def test_conv3x3_layer_with_pool():
    layer = work.conv("c", 64, 64, 3, 64, pool=True)
    assert layer.flops == 2 * 64 * 64 * 9 * 3 * 64  # 14,155,776
    assert layer.out_elems == 32 * 32 * 64
    assert work.conv("c5", 32, 32, 128, 64, k=5).flops == (
        2 * 32 * 32 * 25 * 128 * 64)


def test_upsample_phase_counts_four_taps():
    # 16 x 16 x 512 in, 32 x 32 x 256 out: each output pixel reads 4
    # distinct input pixels of each channel
    layer = work.upconv("u", 16, 16, 512, 256)
    assert layer.flops == 2 * 32 * 32 * 4 * 512 * 256  # 1,073,741,824
    assert layer.out_elems == 32 * 32 * 256
    assert layer.w_elems == 9 * 512 * 256


def test_score_product_bound():
    q, n, d = 256, 10_240, 12_288
    flops = 2 * q * n * d + 2 * n * d
    nbytes = n * d * 2 + q * 8 + q * n * 4
    assert work.score_bound_s(q, n, d) == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12))


def test_g3_r_d2_totals_at_64x64():
    g = work.g3_layers((3, 64, 64), 100)
    r = work.r_layers((3, 64, 64), 100)
    d = work.d2_layers((3, 64, 64))
    assert work.forward_flops(g) == (2 * 100 * 512 * 16 * 16
                                     + 2 * 32 * 32 * 4 * 512 * 256
                                     + 2 * 64 * 64 * 4 * 256 * 128
                                     + 2 * 64 * 64 * 9 * 128 * 3)
    assert work.forward_flops(r) == pytest.approx(1.4e9, rel=0.05)
    assert work.forward_flops(d) == pytest.approx(2.43e9, rel=0.02)


def test_train_flops():
    layers = [work.dense("a", 10, 20), work.dense("b", 20, 5)]
    fwd = 2 * 10 * 20 + 2 * 20 * 5
    assert work.train_flops(layers, True, True) == 3 * fwd
    assert work.train_flops(layers, False, False) == 2 * fwd - 2 * 10 * 20


def test_fused_bound_counts_ends_and_weights_only():
    a, b = work.upconv("u", 32, 32, 256, 128), work.conv("h", 64, 64, 128, 3)
    nbytes = ((8 * (a.in_elems + b.out_elems) + a.w_elems + b.w_elems) * 2
              + (2 * 128 + 2 * 3) * 4)
    assert work.fused_bound_s([a, b], 8) == pytest.approx(
        max(8 * (a.flops + b.flops) / 989e12, nbytes / 3.35e12))
