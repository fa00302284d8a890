"""Kernel D, the fast forwards' bf16 dense layers (ops/dense_kernel.py,
csrc/dense.cu), on the CPU: its operand layout and launch plan at the
shapes the fast G, R and D run, its plain version bitwise the plain f32
product it replaced (f32 sums of bf16-rounded operands, the shift, the
activation, one rounding to bf16), the operands it refuses, and the fast
forwards calling it once per dense layer in bf16 (traced by
torch.export) and never in f32. The card's tests of the kernel itself
are in test_torch_port_cuda.py (``-m cuda -k dense``)."""
import pytest
import torch
import torch.nn.functional as F

from ganreverser_tpu_torch.models import bridge, fastpath, modules, zoo
from ganreverser_tpu_torch.ops import conv_operands as CO
from ganreverser_tpu_torch.ops import cuda_lib
from ganreverser_tpu_torch.ops import dense_kernel as D
from ganreverser_tpu_torch.ops import quant as Q
from ganreverser_tpu_torch.ops.topk_kernel import SMS

from torch_port_fixtures import one_thread  # noqa: F401

BATCH = 128   # the fused program's and stage ②'s chunk

# (label, K, M) of every dense layer of the fast G, R and D at configs
# 3x64x64 z 100, 3x128x128 z 256 and 1x32x32 z 32
LAYERS = {
    "rgb64_z100": [("G l0", 100, 512 * 16 * 16),
                   ("R l27", 128 * 16 * 16, 512), ("R l31", 512, 100),
                   ("D left", 64 * 16 * 16, 512),
                   ("D right", 256 * 8 * 8, 512),
                   ("D l4", 1024, 256), ("D l7", 256, 1)],
    "rgb128_z256": [("G l0", 256, 512 * 32 * 32),
                    ("R l27", 128 * 32 * 32, 512), ("R l31", 512, 256),
                    ("D left", 64 * 32 * 32, 512),
                    ("D right", 256 * 16 * 16, 512),
                    ("D l4", 1024, 256), ("D l7", 256, 1)],
    "y32_z32": [("G l0", 32, 512 * 8 * 8), ("R l27", 128 * 8 * 8, 512),
                ("R l31", 512, 32), ("D left", 64 * 8 * 8, 512),
                ("D right", 256 * 4 * 4, 512), ("D l4", 1024, 256),
                ("D l7", 256, 1)],
}
CASES = [(cfg, *layer) for cfg, layers in LAYERS.items()
         for layer in layers]


def _ref(x, k, shift, act):
    """The fast forwards' arithmetic before kernel D, written out: the f32
    product of bf16-rounded operands, + shift, the activation, .to(bf16)."""
    y = x.to(torch.bfloat16).float() @ k.to(torch.bfloat16).float() + shift
    y = {"relu": lambda v: torch.clamp_min(v, 0.0), "elu": F.elu,
         "tanh": torch.tanh, "none": lambda v: v}[act](y)
    return y.to(torch.bfloat16)


@pytest.mark.parametrize("cfg,label,k,m", CASES)
def test_dense_operand_and_split_plan(cfg, label, k, m):
    """The (M, K') operand unpacks to the bf16 kernel, the padding zero,
    and widens back to the (K, M) f32 kernel the plain product reads; the
    plan fits csrc/conv_wgmma.cuh's layout (1 x 128 rows, the staged bf16
    tile, or a split's f32 sums, in the ring; the ring of RING_BYTES where
    several blocks share an SM) and the grid's limits, its K splits a
    divisor of the K chunks that each run at least DENSE_MIN_CHUNKS of
    them, made only where K is long and the tiles leave SMs idle: G l0
    unsplit at BN 64, R l27 in 16 splits, R l31 unsplit at BN 16."""
    g = torch.Generator().manual_seed(k + m)
    w = torch.randn(k, m if m * k < 1 << 22 else 8, generator=g)
    op = D.dense_operand(w)
    kp = CO.padded_channels(k)
    assert op.dtype == torch.bfloat16 and op.is_contiguous()
    assert tuple(op.shape) == (w.shape[1], kp) and kp % 8 == 0
    assert torch.equal(op[:, :k].T, w.to(torch.bfloat16))
    assert not op[:, k:].any()
    back = D.operand_kernel(op, k)
    assert back.is_contiguous() and torch.equal(back,
                                                w.to(torch.bfloat16).float())

    plan, splits = D.dense_plan(BATCH, k, m)
    assert (plan.bh, plan.bw) == (1, CO.BM)
    assert plan.bn <= D.DENSE_POLICY.max_bn
    assert plan.bk == (kp if kp <= 32 else 64)
    chunks = -(-kp // plan.bk)
    assert chunks % splits == 0
    assert splits == 1 or (chunks >= D.DENSE_POLICY.split_chunks
                           and chunks // splits >= Q.DENSE_MIN_CHUNKS)
    tiles = -(-BATCH // CO.BM) * -(-m // plan.bn)
    assert splits == 1 or tiles * splits <= SMS
    assert -(-m // plan.bn) <= 65535
    stage = -(-(CO.BM + plan.bn) * plan.bk * 2 // CO.ALIGN) * CO.ALIGN
    staged = CO.staged_bytes(plan.bn, 4 if splits > 1 else 2)
    assert staged <= plan.stages * stage and plan.stages >= 2
    assert plan.smem_bytes == CO.ALIGN + plan.stages * (stage + 16)
    assert plan.smem_bytes <= CO.MAX_SHARED_BYTES
    if tiles * splits > SMS:  # several blocks an SM
        assert plan.stages * stage <= max(CO.RING_BYTES[plan.bn],
                                          -(-staged // stage) * stage)
    want = {("rgb128_z256", "G l0"): (1, 64), ("rgb64_z100", "G l0"): (1, 64),
            ("rgb128_z256", "R l27"): (16, 64),
            ("rgb64_z100", "R l27"): (16, 64),
            ("rgb128_z256", "R l31"): (1, 16),
            ("rgb64_z100", "R l31"): (1, 16)}
    assert (splits, plan.bn) == want.get((cfg, label), (splits, plan.bn))


@pytest.mark.parametrize("act", D.ACTS)
@pytest.mark.parametrize("n,k,m", [(5, 100, 24), (3, 40, 1), (9, 512, 37),
                                   (130, 32, 16)])
def test_dense_act_plain_is_the_plain_product(act, n, k, m):
    """On the CPU ``dense_act`` (the ganreverser::dense_act operator's
    plain body, on the bf16 operand) and ``dense_act_plain`` (on the f32
    rounded kernel) are bitwise the plain f32 product of bf16-rounded
    operands + shift, the activation and one rounding, the arithmetic the
    fast forwards ran before kernel D; no launch on the CPU."""
    g = torch.Generator().manual_seed(n * k + m)
    x = torch.randn(n, k, generator=g)
    w = torch.randn(k, m, generator=g) / k ** 0.5
    shift = torch.randn(m, generator=g)
    before = D.dense_act.launches
    ref = _ref(x, w, shift, act)
    out = D.dense_act(x, D.dense_operand(w), shift, act)
    assert out.dtype == torch.bfloat16 and out.shape == (n, m)
    assert torch.equal(out, ref)
    assert torch.equal(D.dense_act_plain(x, w.to(torch.bfloat16).float(),
                                         shift, act), ref)
    f32 = D.dense_act_plain(x, w, shift, act, torch.float32)
    assert f32.dtype == torch.float32
    assert D.dense_act.launches == before


def test_dense_act_refuses_other_operands():
    """Operands the kernel does not take raise, on the CPU too (no
    fallback): an operand not bf16 or not padded for the input's K, a
    kernel in the (K, M) layout, inputs that are not 2-D, another
    activation, mixed devices, another device type."""
    x = torch.randn(4, 100)
    op = D.dense_operand(torch.randn(100, 6))
    sh = torch.zeros(6)
    assert D.dense_act(x, op, sh).shape == (4, 6)
    bad = [((x, op.float(), sh), {}),
           ((x, op[:, :100].contiguous(), sh), {}),
           ((x, torch.randn(100, 6).to(torch.bfloat16), sh), {}),
           ((x[None], op, sh), {}),
           ((x, op, sh), {"act": "sigmoid"}),
           ((x, op, sh), {"act": "prelu"})]
    for args, kw in bad:
        with pytest.raises(ValueError):
            D.dense_act(*args, **kw)
    with pytest.raises(ValueError):  # mixed devices
        D.dense_act(x.to("meta"), op, sh)
    with pytest.raises(ValueError):
        D.dense_act(x.to("meta"), op.to("meta"), sh.to("meta"))


def _variables(model, seed):
    return bridge.to_torch(bridge.export_variables(modules.init_parameters(
        model, torch.Generator().manual_seed(seed))), "cpu")


class _Program(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def _traced_dense_calls(fn, *args) -> int:
    """Calls of ganreverser::dense_act in ``fn``'s torch.export graph."""
    ep = torch.export.export(_Program(fn), args, strict=False)
    return sum(1 for node in ep.graph.nodes
               if "dense_act" in str(node.target))


@pytest.mark.parametrize("noise_method", ["normal", "uniform"])
def test_fast_forwards_call_the_kernel_once_per_dense_layer(noise_method):
    """In bf16 each dense layer of the fast G (l0), R (l27, l31, the tanh
    inside the kernel for uniform noise) and D (four) is one call of
    ganreverser::dense_act, as torch.export records the programs that the
    serving artifacts bake; in f32 none is (the plain f32 product, kernel
    D being bf16 only). The bf16 outputs are bitwise the plain product's
    arithmetic on the same weights (R l31 written out here)."""
    dims, nd = (3, 16, 16), 8
    gv = _variables(zoo.create_G3(dims, nd), 1)
    rv = _variables(zoo.create_R(dims, nd, noise_method), 2)
    dv = _variables(zoo.create_D(dims), 3)
    z = torch.randn(5, nd, generator=torch.Generator().manual_seed(4))
    x = torch.rand(5, 16, 16, 3, generator=torch.Generator().manual_seed(5))
    for dtype, want in ((torch.bfloat16, (1, 2, 4)), (torch.float32,
                                                      (0, 0, 0))):
        legs = (fastpath.make_fast_generator(dims, nd, dtype),
                fastpath.make_fast_inverter(dims, nd, noise_method, dtype),
                fastpath.make_fast_discriminator(dims, dtype))
        got = []
        for leg, v, inp in zip(legs, (gv, rv, dv), (z, x, x)):
            prep = leg.prepare(v)
            got.append(_traced_dense_calls(
                lambda a, prep=prep, leg=leg: leg.run(prep, a), inp))
        assert tuple(got) == want, (dtype, got)
    inv = fastpath.make_fast_inverter(dims, nd, noise_method, torch.bfloat16)
    prep = inv.prepare(rv)
    out = inv.run(prep, x)
    # the same forward up to l31's input, then l31 as the plain product
    x16 = x.to(torch.bfloat16).contiguous()
    from ganreverser_tpu_torch.ops.conv_block_kernel import conv_block
    for block in prep["blocks"]:
        x16 = conv_block(x16, act="elu", pool=True, **block)
    y = D.dense_act(x16.reshape(5, -1), prep["kd"], prep["shd"], "elu")
    ref = _ref(y, rv["params"]["l31"]["kernel"], rv["params"]["l31"]["bias"],
               "none" if noise_method == "normal" else "tanh")
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref)
    assert cuda_lib.dispatch_device(out) == "cpu"
