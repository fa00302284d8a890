"""The plain reference against the port's modules at a tiny size on the
CPU, in float32: G3 and R in evaluation, G3 and D2 in training (D's dropout
masks drawn from generators seeded alike), and the weights' leaves against
the modules' own."""
import pytest
import torch

from ganreverser_tpu_torch.models import zoo
from ganreverser_tpu_torch.models.modules import set_dropout_generator
from portbench import reference, weights

IMAGE, ZD = (3, 16, 16), 8


@pytest.fixture(scope="module")
def made():
    gen = torch.Generator().manual_seed(11)
    g = weights.make(weights.g3_leaves(IMAGE, ZD), gen, "cpu")
    r = weights.make(weights.r_leaves(IMAGE, ZD), gen, "cpu")
    d = weights.make(weights.d2_leaves(IMAGE), gen, "cpu")
    reference.calibrate_batchnorm(g, r, torch.randn(32, ZD, generator=gen),
                                  IMAGE)
    return g, r, d


def loaded(module, flat):
    own = module.state_dict()
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in flat.items()}
    module.load_state_dict(flat)
    return module


def test_g3_and_r_in_evaluation(made):
    g, r, _ = made
    z = torch.randn(6, ZD, generator=torch.Generator().manual_seed(1))
    G = loaded(zoo.create_G3(IMAGE, ZD), g).eval()
    R = loaded(zoo.create_R(IMAGE, ZD, "normal"), r).eval()
    with torch.no_grad():
        images = G(z)
        torch.testing.assert_close(reference.g3(g, z, IMAGE), images,
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(reference.r_default(r, images), R(images),
                                   rtol=1e-4, atol=1e-5)


def test_g3_in_training(made):
    g, _, _ = made
    z = torch.randn(6, ZD, generator=torch.Generator().manual_seed(2))
    G = loaded(zoo.create_G3(IMAGE, ZD), g).train()
    with torch.no_grad():
        torch.testing.assert_close(reference.g3(g, z, IMAGE, "train"), G(z),
                                   rtol=1e-4, atol=1e-5)


def test_d2_in_training_draws_the_same_masks(made):
    _, _, d = made
    x = weights.faces(6, 16, 16, torch.Generator().manual_seed(3), "cpu")
    D = loaded(zoo.create_D2(IMAGE), d).train()
    set_dropout_generator(D, torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = D(x).reshape(-1)
        ref = reference.d2(d, x, torch.Generator().manual_seed(5))
        other = reference.d2(d, x, torch.Generator().manual_seed(6))
    torch.testing.assert_close(ref, got, rtol=1e-5, atol=1e-6)
    assert not torch.allclose(other, got)


def test_calibrated_batchnorm_normalises(made):
    g, _, _ = made
    assert float(g["l6.var"].mean()) != 1.0
    z = torch.randn(64, ZD, generator=torch.Generator().manual_seed(4))
    images = reference.g3(g, z, IMAGE)
    assert float(images.std()) > 0.01


def test_fp8_rounding_keeps_gradients():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = reference.FP8.op(x)
    assert 0 < float((y - x).detach().abs().max()) < 0.2
    (reference.FP8.out(y * 2)).sum().backward()
    assert torch.all(x.grad == 2)
