"""The port's Torch7 import (``io/torch7.py``, ``io/import_t7.py``,
``cli/import_t7.py``) and inspector (``cli/show.py``) against the JAX
package's, on the CPU, at the sizes tests/test_torch7.py uses ((3,16,16),
noise dim 8; G4 at 32x32 with 4 of its 32 branches).

The t7 files come from that module's test-side writer and its NCHW
builders: reference-layout serialized G3, D2 and R whose weights originate
in torch layouts, with literal NCHW torch forwards. The importers must
write the same checkpoint, leaf for leaf (``vis_noise_inputs`` drawn when
the file lacks it: shape and dtype only), and the imported modules must
express the NCHW function: f32 within 1e-5 of the output's scale
(max(1, max |ref|); the two sides sum the same products in other
orders)."""
import io
import struct

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ganreverser_tpu import models as M
from ganreverser_tpu.cli import show as j_show
from ganreverser_tpu.io import import_t7 as j_import
from ganreverser_tpu.io import torch7 as j_torch7
from ganreverser_tpu.models import modules as mm
from ganreverser_tpu_torch.cli import import_t7 as cli_import
from ganreverser_tpu_torch.cli import sample as cli_sample
from ganreverser_tpu_torch.cli import show
from ganreverser_tpu_torch.io import checkpoint as ckpt
from ganreverser_tpu_torch.io import import_t7, torch7
from ganreverser_tpu_torch.models import bridge, fastpath, modules, zoo
from test_torch7 import (T7Obj, _bn_f, _r_torch, _rand_bn, _skip, _Writer,
                         build_d2, build_g3, t7_bn, t7_bytes, t7_conv,
                         t7_file, t7_linear, t7_prelu, t7_seq)

from torch_port_fixtures import one_thread  # noqa: F401

ND = 8
DIMS = (3, 16, 16)
TOL = 1e-5


@pytest.fixture(scope="module")
def g3():
    torch.manual_seed(11)
    return build_g3(ND, *DIMS)


@pytest.fixture(scope="module")
def d2():
    torch.manual_seed(12)
    return build_d2(*DIMS)


def _rng(seed):
    return np.random.default_rng(seed)


def _close(out, ref, tol=TOL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _same_object(a, b):
    """The JAX reader's object ``a`` and the port's ``b`` are the same
    tree: classes, keys, numbers, strings and arrays (dtype and values)."""
    if isinstance(a, j_torch7.TorchObject):
        assert isinstance(b, torch7.TorchObject)
        assert a.torch_class == b.torch_class
        return _same_object(a.payload, b.payload)
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same_object(a[k], b[k])
        return
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        return
    assert type(a) is type(b) and a == b


def _handpacked() -> bytes:
    """tests/test_torch7.py:197's record layout: a table of a number, a
    boolean and a 2x3 FloatTensor, packed by hand."""
    b = struct.pack("<iii", 3, 1, 3)
    b += struct.pack("<ii", 2, 3) + b"num" + struct.pack("<id", 1, 4.5)
    b += struct.pack("<ii", 2, 4) + b"flag" + struct.pack("<ii", 5, 1)
    b += struct.pack("<ii", 2, 1) + b"t" + struct.pack("<ii", 4, 2)
    b += struct.pack("<i", 3) + b"V 1" + struct.pack("<i", 17)
    b += b"torch.FloatTensor" + struct.pack("<i", 2)
    b += struct.pack("<qqqqq", 2, 3, 3, 1, 1)
    b += struct.pack("<ii", 4, 3) + struct.pack("<i", 3) + b"V 1"
    b += struct.pack("<i", 18) + b"torch.FloatStorage" + struct.pack("<q", 6)
    return b + np.arange(1, 7, dtype="<f4").tobytes()


def _strided() -> bytes:
    w = _Writer()
    w._i32(4), w._i32(w._next_idx()), w._str("V 1")
    w._str("torch.FloatTensor")
    w._i32(2)
    for v in (2, 3, 1, 2, 2):  # sizes, column-major strides, offset 2
        w._i64(v)
    w._i32(4), w._i32(w._next_idx()), w._str("V 1")
    w._str("torch.FloatStorage")
    w._i64(10)
    w.buf.write(np.arange(10, dtype="<f4").tobytes())
    return w.buf.getvalue()


def _cuda_tensor() -> bytes:
    w = _Writer()
    w.tensor(np.arange(4, dtype=np.float32), cls="torch.CudaTensor")
    return w.buf.getvalue()


def _adversarial(g3, d2, **more):
    obj = {"G": g3["tree"], "D": d2["tree"],
           "opt": {"noiseDim": ND, "noiseMethod": "normal", "height": 16,
                   "width": 16, "colorSpace": "rgb", "batchSize": 16,
                   "seed": 3, "D_optmethod": "adam", "G_optmethod": "sgd",
                   "window": 3, "gpu": False},
           "epoch": 7, "plot_data": [[1, 0.5, 0.6], [2, 0.4, 0.7]],
           "vis_noise_inputs": _rng(4).normal(size=(10, ND)).astype(
               np.float32),
           "normalize_mean": 0.44, "normalize_std": 0.21}
    obj.update(more)
    return obj


@pytest.mark.parametrize("source", ["handpacked", "roundtrip", "strided",
                                    "cuda", "adversarial"])
def test_reader_gives_the_jax_readers_tree(source, g3, d2):
    """(a) The same bytes read by both readers: the hand-packed record
    layout, the writer's round trip, a strided view with an offset, a CUDA
    tensor class (read as float), and a whole adversarial file."""
    data = {"handpacked": _handpacked,
            "roundtrip": lambda: t7_bytes(
                {"s": "hello", "n": 7, "nested": {1: 1.5, 2: None},
                 "arr": np.arange(12, dtype=np.float32).reshape(3, 4)}),
            "strided": _strided, "cuda": _cuda_tensor,
            "adversarial": lambda: t7_bytes(_adversarial(g3, d2))}[source]()
    ours = torch7._Reader(io.BytesIO(data)).read_object()
    _same_object(j_torch7._Reader(io.BytesIO(data)).read_object(), ours)
    if source == "handpacked":
        assert ours["num"] == 4.5 and ours["flag"] is True
        np.testing.assert_array_equal(ours["t"], [[1, 2, 3], [4, 5, 6]])
    if source == "strided":
        np.testing.assert_array_equal(ours, [[1, 3, 5], [2, 4, 6]])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _layout(name, g3, d2):
    r_plain = _r_torch("normal", nd=ND)
    r_fixer = _r_torch("uniform", fixer=True, cuda=True, nd=ND)
    short = {"noiseDim": ND, "height": 16, "width": 16, "colorSpace": "rgb"}
    return {
        "adversarial": _adversarial(g3, d2),
        "r": {"R": r_plain["tree"],
              "opt": {**short, "noiseMethod": "normal", "fixer": False,
                      "batchSize": 32, "R_L2": 1e-4, "seed": 1}},
        "fixer_r": {"R": r_fixer["tree"], "opt": {"batchSize": 32,
                                                  "seed": 1}},
        "decoder": {"G": g3["tree"], "opt": short, "EPOCH": 4},
        "distilled": {"G": g3["tree"], "D": d2["tree"], "opt": short},
    }[name]


@pytest.mark.parametrize("layout", ["adversarial", "r", "fixer_r",
                                    "decoder", "distilled"])
def test_import_writes_the_jax_importers_checkpoint(layout, g3, d2,
                                                    tmp_path):
    """(b) Both importers on the same file: the same checkpoint name, every
    leaf bitwise equal (dtype, shape, bits), the same config and extra;
    the distilled pair has no vis_noise_inputs, so there only their shape
    and dtype are held."""
    path = t7_file(tmp_path, f"{layout}.net", _layout(layout, g3, d2))
    theirs = j_import.import_t7(path, str(tmp_path / "jax"), verbose=False)
    ours = import_t7.import_t7(path, str(tmp_path / "port"), verbose=False)
    assert theirs.rsplit("/", 1)[1] == ours.rsplit("/", 1)[1]
    j_tree, j_cfg, j_extra = ckpt.load_checkpoint(theirs)
    tree, cfg, extra = ckpt.load_checkpoint(ours)
    assert cfg == j_cfg and extra == j_extra
    a, b = _flat(j_tree), _flat(tree)
    assert sorted(a) == sorted(b) and len(a) > 10
    for key in a:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
        if not (layout == "distilled" and key == "/vis_noise_inputs"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _g_forward(tree, z, fast):
    g_vars = bridge.to_torch(tree, "cpu")
    with torch.no_grad():
        if fast:
            return fastpath.make_fast_generator(DIMS, ND, torch.float32)(
                g_vars, z)
        return bridge.load_jax_variables(zoo.create_G3(DIMS, ND), tree)(z)


@pytest.mark.parametrize("path", ["module", "fast"])
def test_imported_models_express_the_nchw_functions(path, g3, d2, tmp_path):
    """(c) The imported G3, D2 and R (normal and uniform heads) on the
    module path and on the fast path (the kernels' plain versions on the
    CPU; G with U's fused head) against the literal NCHW forwards, f32."""
    fast = path == "fast"
    ckpt_path = import_t7.import_t7(
        t7_file(tmp_path, "a.net", _adversarial(g3, d2)),
        str(tmp_path / "logs"), verbose=False)
    tree = ckpt.load_checkpoint(ckpt_path)[0]
    z = torch.from_numpy(_rng(1).normal(size=(5, ND)).astype(np.float32))
    images = _g_forward(tree["G"], z, fast)
    _close(images, g3["forward"](z).numpy().transpose(0, 2, 3, 1))

    x = torch.from_numpy(_rng(2).uniform(size=(5, 16, 16, 3)).astype(
        np.float32))
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        if fast:
            p = fastpath.make_fast_discriminator(DIMS, torch.float32)(
                bridge.to_torch(tree["D"], "cpu"), x)
        else:
            p = bridge.load_jax_variables(zoo.create_D(DIMS), tree["D"])(x)
    _close(p, d2["forward"](x_nchw).numpy())

    for method in ("normal", "uniform"):
        r = _r_torch(method, nd=ND)
        r_path = import_t7.import_t7(
            t7_file(tmp_path, f"r_{method}.net",
                    {"R": r["tree"], "opt": {"fixer": False}}),
            str(tmp_path / "logs"), verbose=False)
        r_tree = ckpt.load_checkpoint(r_path)[0]["R"]
        with torch.no_grad():
            if fast:
                zh = fastpath.make_fast_inverter(DIMS, ND, method,
                                                 torch.float32)(
                    bridge.to_torch(r_tree, "cpu"), x)
            else:
                zh = bridge.load_jax_variables(
                    zoo.create_R(DIMS, ND, method), r_tree)(x)
        _close(zh, r["forward"](x_nchw).numpy())


def _g4_file(nd, c, nb):
    """A serialized G4 with ``nb`` of its 32 branches (tests/test_torch7.py
    :646's wiring) and its literal NCHW forward."""
    torch.manual_seed(13)
    branches_t, mods = [], []
    for _ in range(nb):
        l1, p1 = torch.nn.Linear(nd, 16), torch.nn.PReLU()
        l2 = torch.nn.Linear(16, 16 * 16 * 16)
        bn1, p2 = _rand_bn(16 * 16 * 16, spatial=False), torch.nn.PReLU()
        cv = torch.nn.Conv2d(16, 16, 3, padding=1)
        bn2, p3 = _rand_bn(16, spatial=True), torch.nn.PReLU()
        with torch.no_grad():
            p2.weight.fill_(0.1)
        mods.append((l1, p1, l2, bn1, p2, cv, bn2, p3))
        branches_t.append(t7_seq([
            t7_linear(l1), t7_prelu(p1), t7_linear(l2), t7_bn(bn1, False),
            t7_prelu(p2), _skip("nn.View"),
            _skip("nn.SpatialUpSamplingNearest"),
            t7_conv(cv), t7_bn(bn2, True), t7_prelu(p3)]))
    top1 = torch.nn.Conv2d(16 * nb, 64, 3, padding=1)
    tbn, tp = _rand_bn(64, spatial=True), torch.nn.PReLU()
    top2 = torch.nn.Conv2d(64, c, 3, padding=1)

    @torch.no_grad()
    def forward(z):
        outs = []
        for l1, p1, l2, bn1, p2, cv, bn2, p3 in mods:
            x = F.prelu(l1(z), p1.weight)
            x = F.prelu(_bn_f(l2(x), bn1), p2.weight).view(-1, 16, 16, 16)
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            outs.append(F.prelu(_bn_f(cv(x), bn2), p3.weight))
        y = F.prelu(_bn_f(top1(torch.cat(outs, dim=1)), tbn), tp.weight)
        return torch.sigmoid(top2(y))

    tree = t7_seq([T7Obj("nn.Concat", modules=branches_t),
                   t7_conv(top1), t7_bn(tbn, True), t7_prelu(tp),
                   t7_conv(top2), _skip("nn.Sigmoid")])
    return tree, forward


def _encoder_file(nd, c, h, w):
    torch.manual_seed(14)
    convs = [torch.nn.Conv2d(ci, co, 3, padding=1)
             for ci, co in ((c, 16), (16, 32), (32, 64))]
    bns = [_rand_bn(co, spatial=True) for co in (16, 32, 64)]
    l1, b4 = torch.nn.Linear(64 * (h // 8) * (w // 8), 512), _rand_bn(
        512, spatial=False)
    l2 = torch.nn.Linear(512, nd)

    @torch.no_grad()
    def forward(imgs):
        x = imgs
        for i, pool in enumerate((F.avg_pool2d, F.max_pool2d,
                                  F.max_pool2d)):
            x = pool(F.relu(_bn_f(convs[i](x), bns[i])), 2)
        x = F.relu(_bn_f(l1(x.reshape(x.shape[0], -1)), b4))
        return torch.tanh(l2(x))

    mods = []
    for i, pool in enumerate(("nn.SpatialAveragePooling",
                              "nn.SpatialMaxPooling",
                              "nn.SpatialMaxPooling")):
        mods += [t7_conv(convs[i]), t7_bn(bns[i], True),
                 _skip("cudnn.ReLU"), _skip(pool)]
    mods += [_skip("nn.View"), t7_linear(l1), t7_bn(b4, False),
             _skip("cudnn.ReLU"), t7_linear(l2), _skip("nn.Tanh")]
    return t7_seq(mods), forward


@pytest.mark.parametrize("model", ["G4", "G_encoder"])
def test_g4_and_encoder_imports_express_the_nchw_functions(model, tmp_path):
    """(d) G4 (nested branches inside nn.Concat, the in-branch
    Linear->View permutation, the channel concat order) and G_encoder
    (the Flatten->Linear permutation), mapped by both walks: the same
    trees, and the port's modules give the NCHW function."""
    if model == "G4":
        nb, c = 4, 3
        tree, forward = _g4_file(ND, c, nb)
        full = zoo.create_G4((c, 32, 32), ND)
        # the branch count trimmed: the first top conv takes 16 nb maps
        ours = modules.Sequential(
            [modules.ConcatBranches(list(full.l0.children())[:nb]),
             modules.Conv(16 * nb, 64)] + list(full.children())[2:])
        jfull = M.create_G4((c, 32, 32), ND)
        theirs = mm.Sequential([mm.ConcatBranches(
            list(jfull.layers[0].branches)[:nb])] + list(jfull.layers[1:]))
        in_shape = (ND,)
        x = torch.from_numpy(_rng(6).normal(size=(2, ND)).astype(np.float32))
        x_ours = x
    else:
        tree, forward = _encoder_file(ND, *DIMS)
        ours = zoo.create_G_encoder(DIMS, ND)
        theirs = M.create_G_encoder(DIMS, ND)
        in_shape = (16, 16, 3)
        x_ours = torch.from_numpy(_rng(7).uniform(
            size=(3, 16, 16, 3)).astype(np.float32))
        x = x_ours.permute(0, 3, 1, 2).contiguous()
    data = t7_bytes(tree)
    v = import_t7.map_module(ours, torch7._Reader(io.BytesIO(data))
                             .read_object(), in_shape, model)
    jv = j_import.map_module(theirs, j_torch7._Reader(io.BytesIO(data))
                             .read_object(), in_shape, model)
    a, b = _flat(jv), _flat(v)
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    with torch.no_grad():
        out = bridge.load_jax_variables(ours, v)(x_ours)
    ref = forward(x).numpy()
    _close(out, ref.transpose(0, 2, 3, 1) if ref.ndim == 4 else ref)


def test_import_cli_then_sample(g3, d2, tmp_path):
    """(e) The port's import_t7 CLI, then the port's sample CLI on that
    checkpoint, as a reference user's first commands after the switch."""
    path = t7_file(tmp_path, "adversarial.net", _adversarial(g3, d2))
    got = cli_import.main([path, "--out", str(tmp_path / "logs")])
    assert got == ckpt.adversarial_name(str(tmp_path / "logs"))
    out_dir = tmp_path / "samples"
    out = cli_sample.main(["--network", got, "--writeto", str(out_dir),
                           "--dataset", "synthetic", "--height", "16",
                           "--width", "16"])
    assert len(list(out_dir.iterdir())) == 6
    assert out["images"].shape == (1024, 16, 16, 3)


def _shown(main, argv, capsys) -> str:
    main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("what", ["jax_checkpoint", "port_checkpoint",
                                  "t7_file"])
def test_show_prints_the_jax_text(what, g3, d2, tmp_path, capsys):
    """(f) The port's show prints JAX's show's text on a JAX checkpoint, a
    port checkpoint and a t7 file (apart from the package in the t7
    summary's last line, the converter to run); --plot writes a PNG."""
    path = t7_file(tmp_path, "adversarial.net", _adversarial(g3, d2))
    if what == "jax_checkpoint":
        path = j_import.import_t7(path, str(tmp_path / "j"), verbose=False)
    elif what == "port_checkpoint":
        path = import_t7.import_t7(path, str(tmp_path / "p"), verbose=False)
    ours = _shown(show.main, [path], capsys)
    theirs = _shown(j_show.main, [path], capsys)
    if what == "t7_file":
        theirs = theirs.replace("ganreverser_tpu.cli.import_t7",
                                "ganreverser_tpu_torch.cli.import_t7")
        assert "-- convert with: python -m ganreverser_tpu_torch" in ours
    else:
        assert "-- G: " in ours and "-- D: " in ours
    assert ours == theirs and ours.count("\n") > 10
    if what == "port_checkpoint":
        png = tmp_path / "history.png"
        plotted = _shown(show.main, [path, "--plot", str(png)], capsys)
        assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        assert f"chart written to {png}" in plotted


def test_structural_mismatch_raises(g3, d2, tmp_path):
    """(g) A G3 graph mapped onto R raises ImportError7; a file whose G is
    a D2 graph makes the CLI exit naming the mismatch."""
    R = zoo.create_R(DIMS, ND, "normal")
    tree = torch7._Reader(io.BytesIO(t7_bytes(g3["tree"]))).read_object()
    with pytest.raises(import_t7.ImportError7, match="serialized|expected"):
        import_t7.map_module(R, tree, (16, 16, 3), "R")
    path = t7_file(tmp_path, "bad.net", {
        "G": d2["tree"], "opt": {"noiseDim": ND, "height": 16,
                                 "width": 16}})
    with pytest.raises(SystemExit, match="structural mismatch"):
        cli_import.main([path, "--out", str(tmp_path / "logs")])
