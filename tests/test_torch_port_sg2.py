"""The port's StyleGAN2 config F (models/zoo.py::create_G_sg2f) against the
benchmark's plain reference (portbench/reference_sg2.py, float32 with TF32
off, importing nothing of the port), which builds every per-sample
weight and runs it as a grouped convolution where the port scales the
activations and shares the weight: the forward, z's gradient, each
mechanism alone, and make_refiner against the reference's refinement, on
seeded random weights at a tiny preset (3 x 16 x 16, z and w 8, 2 mapping
layers, at most 16 channels) on the CPU in float32; the published widths
at config F; the spans inside G under a profiler.

Each tolerance is a bound on max |port - reference| over max |reference|
(or, for the refined z, over the reference's move), with its reason. Every
one is far below what the port computes in bfloat16, which
``test_bf16_port_fails_the_tolerances`` shows."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ganreverser_tpu_torch.analysis.refine import make_refiner
from ganreverser_tpu_torch.io import metrics
from ganreverser_tpu_torch.models import modules, zoo
from ganreverser_tpu_torch.ops import fir_kernel
from portbench import reference_sg2 as ref

from torch_port_fixtures import one_thread  # noqa: F401

# config F's rules at 3 x 16 x 16, z and w 8, 2 mapping layers, <= 16
# channels
CFG = ref.config({"image": [3, 16, 16], "noise_dim": 8, "w_dim": 8,
                  "mapping_layers": 2, "lr_mul": 0.01, "channel_base": 64,
                  "channel_max": 16, "fir": [1, 3, 3, 1]})
# f32 round-off through the 2 mapping layers, 5 modulated layers and 3
# ToRGB of the preset, each summing at most 16 * 9 products, reads 5e-7
# of the images' largest value: 1e-5 leaves 20x; bfloat16 reads 1e-2
FORWARD_TOL = 1e-5
# the gradient to z also crosses every style and demodulation and the
# pixel norm backwards: it reads 3e-7 (8e-7 on other weights), 3e-5
# leaves 35x over the larger
GRAD_TOL = 3e-5
# one layer alone: round-off of a sum of at most 144 products, 1e-7 to
# 4e-7 read
LAYER_TOL = 2e-6
# after 4 adam steps the refined z's gap over the reference's move (1e-6
# read): adam divides by sqrt(v), so a coordinate whose gradient is small
# carries its round-off into z at full step size
REFINE_TOL = 1e-4


def gap(got, want) -> float:
    return float((got.detach().float() - want).abs().max()
                 / want.abs().max())


def port_g(p, dtype=torch.float32):
    G = zoo.create_G_sg2f(CFG["image"], CFG["noise_dim"], CFG["w_dim"],
                          dtype, mapping_layers=CFG["mapping_layers"],
                          channel_base=CFG["channel_base"],
                          channel_max=CFG["channel_max"])
    G.load_state_dict(p)
    return G


@pytest.fixture(scope="module")
def weights():
    return ref.make(CFG, torch.Generator().manual_seed(23), "cpu")


def latents(n, seed):
    return torch.randn(n, CFG["noise_dim"],
                       generator=torch.Generator().manual_seed(seed))


def test_config_f_has_the_published_widths():
    G = zoo.create_G_sg2f()
    blocks = dict(G.blocks())
    assert list(blocks) == [f"b{2 ** i}" for i in range(2, 11)]
    assert [b.torgb.kernel.shape[2] for b in blocks.values()] == [
        512, 512, 512, 512, 512, 256, 128, 64, 32]
    dense = [m for m in G.mapping if isinstance(m, modules.EqualDense)]
    assert [tuple(m.kernel.shape) for m in dense] == [(512, 512)] * 8
    assert {m.lr_mul for m in dense} == {0.01}
    layers = [m for m in G.modules() if isinstance(m, modules.SynthesisLayer)]
    torgbs = [m for m in G.modules() if isinstance(m, modules.ToRGB)]
    # 17 modulated 3x3 layers and the last ToRGB take the official
    # network's 18 broadcasts of w; every ToRGB has its own style
    assert (len(layers), len(torgbs)) == (17, 9)
    assert sum(m.blur is not None for m in layers) == 8
    # NVlabs/stylegan2's count for G of config F (noise maps are buffers)
    assert modules.count_parameters(G) == 30_370_060


def test_forward_matches_reference(weights):
    z = latents(4, 1)
    with torch.no_grad():
        got = port_g(weights)(z)
        want = ref.generator(weights, z, CFG)
    assert got.shape == (4, 16, 16, 3) and got.dtype == torch.float32
    assert gap(got, want) < FORWARD_TOL


def test_z_gradient_matches_reference(weights):
    z = latents(3, 2)
    probe = torch.randn(3, 16, 16, 3,
                        generator=torch.Generator().manual_seed(3))
    G = port_g(weights).requires_grad_(False)

    def grad(fn):
        zz = z.clone().requires_grad_(True)
        (g,) = torch.autograd.grad((fn(zz) * probe).sum(), zz)
        return g

    want = grad(lambda zz: ref.generator(weights, zz, CFG))
    assert float(want.abs().min()) > 0
    assert gap(grad(G), want) < GRAD_TOL


@pytest.mark.parametrize("kernel,up,demodulate", [
    (3, False, True), (3, True, True), (1, False, False)],
    ids=["conv", "upconv", "torgb"])
def test_modulated_conv_matches_grouped_conv(kernel, up, demodulate):
    """ModulatedConv alone (scaled activations, the shared weight, the
    demodulation as a scale of the output) against the per-sample weight
    as a grouped convolution; the up-sampling form against the flipped
    weight as a grouped transposed convolution and upfirdn2d's blur."""
    g = torch.Generator().manual_seed(4)
    ci, co, wd = 6, 5, 7
    m = modules.ModulatedConv(ci, co, kernel, wd, demodulate=demodulate,
                              up=up)
    p = {"kernel": torch.randn(kernel, kernel, ci, co, generator=g),
         "affine.kernel": torch.randn(wd, ci, generator=g),
         "affine.bias": 1 + 0.1 * torch.randn(ci, generator=g)}
    m.load_state_dict(p)
    x = torch.randn(3, 8, 8, ci, generator=g)
    w = torch.randn(3, wd, generator=g)
    want = ref.modulated_conv(x.permute(0, 3, 1, 2), p["kernel"],
                              ref.dense(w, p, "affine"), demodulate, up)
    got = m(x, w)
    assert got.shape == (3, 16 if up else 8, 16 if up else 8, co)
    assert gap(got, want.permute(0, 2, 3, 1)) < LAYER_TOL


@pytest.mark.parametrize("up", [2, 1], ids=["skip", "blur"])
def test_fir_matches_upfirdn2d(up):
    """FIRFilter's plain path (ops/fir_kernel.py on the CPU: zeros
    inserted, padded, a depthwise convolution) against the reference's
    upfirdn2d: the skip's up-sampling, a zero after each pixel and pad
    (2, 1), then the filter; the blur after an up-sampling convolution,
    pad (1, 1), then the filter."""
    x = torch.randn(2, 9, 9, 3, generator=torch.Generator().manual_seed(5))
    got = modules.FIRFilter(3, up)(x)
    pads = (2, 1) if up == 2 else (1, 1)
    want = ref.upfirdn2d(x.permute(0, 3, 1, 2),
                         ref.fir_kernel((1, 3, 3, 1), 4.0, "cpu"), up, *pads)
    assert got.shape == ((2, 18, 18, 3) if up == 2 else (2, 8, 8, 3))
    assert gap(got, want.permute(0, 2, 3, 1)) < LAYER_TOL


def _upfirdn2d_f64(x, up):
    """The reference's filter of NHWC ``x`` in float64, NHWC."""
    pads = (2, 1) if up == 2 else (1, 1)
    taps = ref.fir_kernel((1, 3, 3, 1), 4.0, "cpu").double()
    return ref.upfirdn2d(x.double().permute(0, 3, 1, 2), taps, up,
                         *pads).permute(0, 2, 3, 1)


def _fir_case(up, shape, x_dtype=torch.float32):
    """x (requires grad), the incoming gradient, the reference's output and
    its gradient to x in float64 (of x as given)."""
    g = torch.Generator().manual_seed(24 + up)
    x = torch.randn(shape, generator=g).to(x_dtype).requires_grad_(True)
    x64 = x.detach().double().requires_grad_(True)
    want = _upfirdn2d_f64(x64, up)
    probe = torch.randn(want.shape, generator=g)
    (want_grad,) = torch.autograd.grad((want * probe.double()).sum(), x64)
    return x, probe, want.detach(), want_grad


FIR_SHAPES = [(2, 7, 10, 3), (2, 8, 5, 8)]


@pytest.mark.parametrize("shape", FIR_SHAPES, ids=["odd_even_c3",
                                                   "even_odd_c8"])
@pytest.mark.parametrize("up", [1, 2], ids=["blur", "skip"])
def test_fir_filter_and_gradient_match_upfirdn2d_f64(up, shape):
    """The filter's plain path (ops/fir_kernel.py on the CPU) at float32,
    forward and the gradient its backward form gives, against autograd
    through the reference's upfirdn2d in float64, at odd and even sizes
    and C = 3 and 8: the gradient forms' pads and down-sampling are the
    forward forms' adjoints."""
    x, probe, want, want_grad = _fir_case(up, shape)
    got = modules.FIRFilter(shape[3], up)(x)
    (grad,) = torch.autograd.grad((got * probe).sum(), x)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert grad.shape == x.shape and grad.dtype == torch.float32
    assert gap(got, want) < LAYER_TOL
    assert gap(grad, want_grad) < LAYER_TOL


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32_input", "bf16_input"])
@pytest.mark.parametrize("shape", FIR_SHAPES, ids=["odd_even_c3",
                                                   "even_odd_c8"])
@pytest.mark.parametrize("up", [1, 2], ids=["blur", "skip"])
def test_fir_filter_rounds_to_bf16(up, shape, x_dtype):
    """At a bf16 compute dtype the filter reads x rounded to bf16 (the
    forward matches the reference on the rounded x, and not on x), sums in
    f32 and returns f32; its gradient is the f32 sum rounded to bf16
    (within half a bf16 step, at most 2^-8 of the value, of the float64
    gradient, plus the f32 sum's round-off) and held in x's dtype."""
    x, probe, _, want_grad = _fir_case(up, shape, x_dtype)
    got = modules.FIRFilter(shape[3], up, torch.bfloat16)(x)
    (grad,) = torch.autograd.grad((got * probe).sum(), x)
    rounded = _upfirdn2d_f64(x.detach().bfloat16(), up)
    assert got.dtype == torch.float32 and grad.dtype == x_dtype
    assert gap(got, rounded) < LAYER_TOL
    if x_dtype == torch.float32:
        assert gap(got, _upfirdn2d_f64(x.detach(), up)) > 100 * LAYER_TOL
    grad = grad.double()
    assert torch.equal(grad, grad.bfloat16().double())
    err = (grad - want_grad).abs()
    assert bool((err <= 2.0 ** -8 * want_grad.abs()
                 + LAYER_TOL * want_grad.abs().max()).all())


# the cell's filters at batch 8: (n, ho, wo, c, input bytes), the rows and
# channels a thread of the plan
@pytest.mark.parametrize("case,plan", [
    ((8, 1024, 1024, 32, 4), (4, 8)),    # the 1024^2 blur
    ((8, 1025, 1025, 32, 4), (4, 8)),    # its gradient
    ((8, 128, 128, 256, 4), (4, 8)),
    ((8, 16, 16, 512, 4), (4, 2)),
    ((8, 8, 8, 512, 4), (4, 2)),         # the smallest blur
    ((8, 1024, 1024, 3, 2), (1, 8)),     # the skip: bf16 image, scalar
    ((8, 4, 4, 3, 4), (1, 2)),           # the smallest skip's gradient
], ids=["blur1024", "blur1024_grad", "blur128", "blur16", "blur8",
        "skip1024", "skip8_grad"])
def test_fir_plan_fills_the_card(case, plan):
    """16-byte loads where C holds whole packs, one element a thread for
    the 3-channel skip; 8 rows a thread where that grid still gives each
    of the H100's 132 SMs 4 blocks, 2 where it would not: every blur of
    128 x 128 and more then launches at least 4 blocks an SM, and the
    smaller ones at least one."""
    n, ho, wo, c, elem = case
    got = fir_kernel.fir_plan(n, ho, wo, c, elem, True, 132)
    assert tuple(got) == plan
    blocks = (-(-(wo * c // got.vec) // fir_kernel.FIR_THREADS) * n
              * -(-ho // got.rows))
    assert blocks >= (4 * 132 if ho >= 128 else 132) or c == 3
    assert fir_kernel.fir_plan(n, ho, wo, c, elem, False, 132).vec == 1


def test_noise_input_matches_reference(weights):
    """A synthesis layer with its const noise map and strength, and with
    the strength at 0, against the reference's layer; the noise moves the
    output by more than 1 %."""
    layer = modules.SynthesisLayer(16, 8, 16, CFG["w_dim"], up=True)
    p = {k[len("b16.conv0."):]: v for k, v in weights.items()
         if k.startswith("b16.conv0.")}
    layer.load_state_dict(p)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 8, 8, 16, generator=g)
    w = torch.randn(2, CFG["w_dim"], generator=g)
    want = ref.layer(weights, "b16.conv0", x.permute(0, 3, 1, 2), w, up=True)
    assert gap(layer(x, w), want.permute(0, 2, 3, 1)) < LAYER_TOL
    silent = {**weights, "b16.conv0.strength": torch.tensor(0.0)}
    quiet = ref.layer(silent, "b16.conv0", x.permute(0, 3, 1, 2), w, up=True)
    assert gap(quiet, want) > 0.01
    with torch.no_grad():
        layer.strength.zero_()
    assert gap(layer(x, w), quiet.permute(0, 2, 3, 1)) < LAYER_TOL


def test_refiner_matches_reference_refinement(weights):
    """make_refiner's adam on z through the port's G, chunked, against the
    reference's refinement in blocks: the refined z over the reference's
    move from the first guesses, and each image's final loss."""
    z_true, z0 = latents(6, 7), latents(6, 7) + 0.5 * latents(6, 8)
    with torch.no_grad():
        targets = ref.generator(weights, z_true, CFG)
    refine = make_refiner(port_g(weights), steps=4, lr=0.05, batch_size=3)
    z, loss = refine(targets, z0)
    z_ref, loss_ref = ref.refine(weights, CFG, targets, z0, 4, 0.05, block=2)
    move = float((z_ref - z0).norm())
    assert move > 0.1
    assert float((z - z_ref).norm()) / move < REFINE_TOL
    assert gap(loss, loss_ref) < REFINE_TOL


def test_bf16_port_fails_the_tolerances(weights):
    """The tolerances above are tight: the port's G in bfloat16 fails the
    forward's by orders of magnitude."""
    z = latents(4, 1)
    with torch.no_grad():
        got = port_g(weights, torch.bfloat16)(z)
        want = ref.generator(weights, z, CFG)
    assert got.dtype == torch.bfloat16
    assert gap(got, want) > 100 * FORWARD_TOL


def test_spans_nest_under_the_refiners_forward(weights):
    """Under a profiler, G's forward holds ``gr.sg2.mapping`` and one span
    a block, inside ``gr.refine.forward`` at each step and inside
    ``gr.refine.loss`` at the end."""
    refine = make_refiner(port_g(weights), steps=2, lr=0.05)
    z0 = latents(2, 9)
    with torch.no_grad():
        targets = ref.generator(weights, z0 + 0.1, CFG)
    metrics.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        refine(targets, z0)
    got = [(s.name, s.parent) for s in metrics.spans()
           if s.name.startswith("gr.sg2.")]
    g_spans = ["gr.sg2.mapping", "gr.sg2.b4", "gr.sg2.b8", "gr.sg2.b16"]
    assert got == ([(n, "gr.refine.forward") for n in g_spans] * 2
                   + [(n, "gr.refine.loss") for n in g_spans])
