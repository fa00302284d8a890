"""One rank of the port's multi-process tests (tests/test_torch_port_
parallel.py, tests/test_torch_port_dist_train.py), and the helper that
starts a group of them.

A rank joins a gloo world on the CPU over a localhost rendezvous, runs the
named cases on the inputs the test wrote (``inputs.npz``, nested trees
flattened to ``a/b/c`` keys) and writes its results to ``rank<r>.npz``.
It imports torch and the port, never jax: the test compares the results
with the JAX package in its own process.

    python tests/torch_port_dist_worker.py --rank R --world N --port P \\
        --dir DIR --cases comm,analysis
    python tests/torch_port_dist_worker.py --cli train_r OUT.npz ARGS...
"""
from __future__ import annotations

import argparse
import copy
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def flat(tree, prefix: str = "") -> dict:
    """A nested dict of arrays as {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def unflat(d: dict, prefix: str) -> dict:
    """The inverse of :func:`flat` for the keys under ``prefix/``."""
    out: dict = {}
    for key, v in d.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def cpu_env() -> dict:
    """The environment of a rank process: the CPU, one thread (the test
    runner's workers share the cores with the ranks, and oversubscribed
    thread pools stall them all), the checkout on the path, no JAX device
    flags."""
    env = dict(os.environ, GANREVERSER_PLATFORM="cpu", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    env.pop("XLA_FLAGS", None)
    return env


def run_processes(argvs: list, timeout: float = 240.0) -> list:
    """Run one process per argument list at once on the CPU, each in a
    session of its own, and wait for all: when one fails, or ``timeout``
    seconds pass, every one still running is killed with the processes it
    started (a rank left waiting for a dead peer would otherwise hold the
    run until its collective times out). Returns their outputs; asserts
    that each exited 0."""
    logs = [tempfile.TemporaryFile("w+") for _ in argvs]
    procs = [subprocess.Popen(argv, env=cpu_env(), stdout=log,
                              stderr=subprocess.STDOUT, text=True,
                              start_new_session=True)
             for argv, log in zip(argvs, logs)]
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes) or all(
                    c == 0 for c in codes):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r} exited {p.returncode}:\n{out}"
    return outs


def run_ranks(tmp_dir: str, world: int, cases: list, inputs: dict,
              timeout: float = 240.0) -> list:
    """Write ``inputs``, start ``world`` ranks running ``cases``
    (:func:`run_processes`) and return each rank's results."""
    os.makedirs(tmp_dir, exist_ok=True)
    np.savez(os.path.join(tmp_dir, "inputs.npz"), **inputs)
    port = free_port()
    run_processes([[sys.executable, os.path.abspath(__file__), "--rank",
                    str(r), "--world", str(world), "--port", str(port),
                    "--dir", tmp_dir, "--cases", ",".join(cases)]
                   for r in range(world)], timeout)
    results = []
    for r in range(world):
        with np.load(os.path.join(tmp_dir, f"rank{r}.npz")) as z:
            results.append({k: z[k] for k in z.files})
    return results


# -- the cases -------------------------------------------------------------

def case_comm(ctx):
    """psum, pmean, all_gather, ppermute, broadcast and sharded_topk_merge
    on a (world, 1) mesh."""
    import torch
    par = ctx["par"]
    mesh = par.make_mesh()
    r, n = mesh.rank, mesh.size
    x = torch.full((3,), float(r + 1))
    out = {"psum": par.psum(x, mesh), "pmean": par.pmean(x, mesh),
           "gather": par.all_gather(x[None], mesh),
           "gather_axis1": par.all_gather(x[None], mesh, axis=1),
           "stack": par.all_gather(x, mesh, tiled=False),
           "ring": par.ppermute(x, [(s, (s + 1) % n) for s in range(n)],
                                mesh),
           "partial": par.ppermute(x, [(0, n - 1)], mesh)}
    tree = par.psum((x, torch.tensor([r], dtype=torch.int32)), mesh)
    out["tree_f"], out["tree_i"] = tree
    out["bcast"] = par.broadcast({"a": x})["a"]
    scores = torch.from_numpy(ctx["inputs"]["scores"])
    v, i = par.sharded_topk_merge(par.shard_batch(scores, mesh), 5, mesh)
    out["merge_v"], out["merge_i"] = v, i
    # autograd through psum: d(sum over ranks of (r+1) x)/dx on each rank
    w = torch.ones(2, requires_grad=True)
    par.psum(w * (r + 1), mesh).sum().backward()
    out["psum_grad"] = w.grad
    return out


def case_mesh(ctx):
    """The mesh's places and the refusals of meshes that do not fit."""
    par = ctx["par"]
    out = {}
    mesh = par.make_mesh()
    out["shape"] = np.array([mesh.shape["data"], mesh.shape["model"]])
    rows = mesh.rows(8)
    out["rows"] = np.array([rows.start, rows.stop])
    if mesh.size % 2 == 0:
        m2 = par.make_mesh(data=0, model=2)
        out["shape_m2"] = np.array([m2.shape["data"], m2.shape["model"]])
        out["index_m2"] = np.array([m2.axis_index("data"),
                                    m2.axis_index("model")])
        out["ranks_m2"] = np.array(m2.axis_ranks("data")
                                   + m2.axis_ranks("model"))
    for name, (d, m) in {"too_big": (mesh.size + 1, 1),
                         "model_big": (1, mesh.size + 1),
                         "too_small": (1, 1)}.items():
        try:
            par.make_mesh(data=d, model=m)
            out[f"err_{name}"] = np.array("")
        except ValueError as e:
            out[f"err_{name}"] = np.array(str(e))
    return out


def _analysis_on(ctx, data: int, model: int):
    import torch
    from ganreverser_tpu_torch.analysis.distributed import (
        distributed_cosine_topk, distributed_generate_and_invert)
    from ganreverser_tpu_torch.models import bridge
    par, inputs = ctx["par"], ctx["inputs"]
    mesh = par.make_mesh(data=data, model=model)
    nd, n = int(inputs["nd"]), int(inputs["n"])
    variables = {k: bridge.to_torch(unflat(inputs, k), "cpu")
                 for k in ("gv", "rv", "rfv")}
    placed = {}
    for k, v in variables.items():
        specs = {"params": par.param_specs(v["params"], mesh, 1 << 10),
                 "state": {a: {b: par.P() for b in s}
                           for a, s in v["state"].items()}}
        placed[k] = ({"params": par.shard_params(v["params"], mesh, 1 << 10),
                      "state": v["state"]}, specs)
    gen = torch.Generator().manual_seed(int(inputs["seed"]))
    fgen = torch.Generator().manual_seed(int(inputs["seed"]) + 1)
    noise, images, attrs, attrs_f = distributed_generate_and_invert(
        placed["gv"][0], placed["rv"][0], dims=tuple(inputs["dims"]), n=n,
        noise_dim=nd, noise_method="normal", generator=gen, mesh=mesh,
        batch_size=int(inputs["batch"]), g_specs=placed["gv"][1],
        r_specs=placed["rv"][1], rf_variables=placed["rfv"][0],
        rf_specs=placed["rfv"][1], fixer_generator=fgen)
    emb = par.shard_batch(torch.from_numpy(inputs["emb"]), mesh)
    needles = torch.from_numpy(inputs["needles"])
    v, i = distributed_cosine_topk(emb, needles, int(inputs["k"]), mesh)
    av, ai = distributed_cosine_topk(emb, needles, int(inputs["k"]), mesh,
                                     approx=True, recall_target=0.9)
    tv, ti = distributed_cosine_topk(attrs, torch.arange(3), 10, mesh)
    sharded = {k: int(sum(s.dim("model") is not None for s in
                          torch.utils._pytree.tree_leaves(
                              placed[k][1]["params"],
                              is_leaf=lambda x: isinstance(x, par.P))))
               for k in placed}
    return {"noise": noise, "images": images, "attrs": attrs,
            "attrs_f": attrs_f, "v": v, "i": i, "av": av, "ai": ai,
            "tv": tv, "ti": ti, "sharded_leaves": np.array(
                [sharded["gv"], sharded["rv"], sharded["rfv"]])}


def case_analysis(ctx):
    """distributed_generate_and_invert (with the fixer) and
    distributed_cosine_topk on a (world, 1) mesh."""
    return _analysis_on(ctx, 0, 1)


def case_analysis_tp(ctx):
    """The same on a (world / 2, 2) mesh: weights cut over 'model'."""
    return _analysis_on(ctx, 0, 2)


def _separated_legs(inputs):
    import torch
    w = torch.from_numpy(inputs["sep_w"])

    def g_apply(_gv, z):
        return torch.tanh(z @ w).reshape(z.shape[0], 4, 4, 1)

    def r_apply(_rv, x):
        return x.reshape(x.shape[0], -1)

    return {"g_apply": g_apply, "r_apply": r_apply}


def case_e2e(ctx):
    """make_distributed_e2e_program on a (world, 1) mesh: the separated
    stand-in with and without the pixel measure, and the fast legs on G3
    and R; the model-axis refusal."""
    import torch
    from ganreverser_tpu_torch.analysis import e2e
    from ganreverser_tpu_torch.models import bridge
    par, inputs = ctx["par"], ctx["inputs"]
    mesh = par.make_mesh()
    kw = dict(batch_size=int(inputs["batch_e2e"]), k=4, needle_chunk=8)
    z = par.shard_batch(torch.from_numpy(inputs["z_sep"]), mesh)
    out = {}
    for pk in (0, 3):
        run = e2e.make_distributed_e2e_program(
            None, None, mesh=mesh, pixel_k=pk, **kw,
            **_separated_legs(inputs))
        for name, t in zip(("emb", "v", "i", "pv", "pi"), run({}, {}, z)):
            out[f"sep{pk}_{name}"] = t
    dims, nd = tuple(inputs["dims"]), int(inputs["nd"])
    legs = e2e.fast_legs(dims, nd, "normal", torch.float32)
    gv = bridge.to_torch(unflat(inputs, "gv"), "cpu")
    rv = bridge.to_torch(unflat(inputs, "rv"), "cpu")
    zf = par.shard_batch(torch.from_numpy(inputs["z_fast"]), mesh)
    run = e2e.make_distributed_e2e_program(None, None, mesh=mesh, pixel_k=3,
                                           **kw, **legs)
    for name, t in zip(("emb", "v", "i", "pv", "pi"), run(gv, rv, zf)):
        out[f"fast_{name}"] = t
    if mesh.size % 2 == 0:
        try:
            e2e.make_distributed_e2e_program(
                None, None, mesh=par.make_mesh(data=0, model=2), **kw,
                **_separated_legs(inputs))
            out["err_model"] = np.array("")
        except ValueError as e:
            out["err_model"] = np.array(str(e))
    return out


def _capture(opt, log: list):
    """``opt`` whose update records the gradients it was given."""
    from ganreverser_tpu_torch.optim import Optimizer

    def update(grads, state, params):
        log.append([g.clone() for g in grads])
        return opt.update(grads, state, params)

    return Optimizer(opt.init, update)


def _tiny_models(inputs, dropout_impl="plain", fixer=False):
    import torch
    from ganreverser_tpu_torch.models import zoo
    from ganreverser_tpu_torch.models.modules import init_parameters
    dims, nd = tuple(inputs["dims"]), int(inputs["nd"])
    gen = torch.Generator().manual_seed(3)
    G = init_parameters(zoo.create_G3(dims, nd), gen)
    R = init_parameters(zoo.create_R(dims, nd, "normal", fixer=fixer,
                                     dropout_impl=dropout_impl), gen)
    D = init_parameters(zoo.create_D(dims), gen)
    for m in (G, R, D):  # non-trivial running statistics to move
        for name, buf in m.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    return G, R, D


def _r_step_on(ctx, data: int, model: int, impl: str, fixer: bool):
    """One R train step on the mesh and one on the whole batch (no mesh):
    loss, gradients, parameters and BatchNorm buffers of both."""
    import torch
    from ganreverser_tpu_torch.core.prng import noise_inputs
    from ganreverser_tpu_torch.models.modules import (set_data_parallel,
                                                      set_dropout_generator)
    from ganreverser_tpu_torch.optim import adam
    from ganreverser_tpu_torch.train.r_loop import make_r_train_step
    from ganreverser_tpu_torch.train.state import TrainState
    par, inputs = ctx["par"], ctx["inputs"]
    mesh = par.make_mesh(data=data, model=model)
    G, R, _ = _tiny_models(inputs, impl, fixer)
    nd, batch = int(inputs["nd"]), int(inputs["train_batch"])
    out = {}
    for tag, m in (("one", None), ("mesh", mesh)):
        Rm, Gm = copy.deepcopy(R), copy.deepcopy(G)
        set_dropout_generator(Rm, torch.Generator().manual_seed(11))
        grads: list = []
        opt = _capture(adam(), grads)
        ts = TrainState.create(Rm, opt)
        g_shards = None
        if m is not None:
            set_data_parallel(Rm, m)
            if model > 1:
                ts.shard_model_axis(m, 1 << 10)
                g_shards = par.ModelShards(Gm, m, 1 << 10)
        step = make_r_train_step(Gm, dtype=torch.float32, opt=opt, mesh=m,
                                 g_shards=g_shards)
        z = noise_inputs(torch.Generator().manual_seed(5), batch, nd)
        loss = step(ts, z if m is None else z[m.rows(batch)])
        g = grads[-1] if ts.shards is None else ts.shards.gather(grads[-1])
        with par.whole_params(ts):
            params = [p.detach().clone() for p in Rm.parameters()]
        out[f"{tag}_loss"] = loss
        for j, (gj, pj) in enumerate(zip(g, params)):
            out[f"{tag}_grad{j}"] = gj
            out[f"{tag}_param{j}"] = pj
        for name, buf in Rm.named_buffers():
            out[f"{tag}_buf_{name}"] = buf
        if ts.shards is not None:
            out[f"{tag}_local_numel"] = np.array(
                sum(t.numel() for t in ts.shards.local))
            out[f"{tag}_whole_numel"] = np.array(
                sum(int(np.prod(s)) for s in ts.shards.shapes))
    return out


def case_r_step(ctx):
    """DP R steps, plain and kernel-B5 dropout, and the fixer-R."""
    out = {}
    for impl, fixer in (("plain", False), ("kernel", False),
                        ("kernel", True)):
        for k, v in _r_step_on(ctx, 0, 1, impl, fixer).items():
            out[f"{impl}{int(fixer)}/{k}"] = v
    return out


def case_r_step_tp(ctx):
    """The R step on a (world / 2, 2) mesh: DP over 'data', parameters,
    moments and G cut over 'model'."""
    return {f"tp/{k}": v for k, v in
            _r_step_on(ctx, 0, 2, "kernel", False).items()}


def case_gan_step(ctx):
    """A D step and a G step on a (world, 1) mesh against the whole
    batch: losses, gradients, parameters, buffers and confusion counts;
    then the same pair with G and D cut over 'model' when the world is
    even."""
    import torch
    from ganreverser_tpu_torch.core.prng import noise_inputs
    from ganreverser_tpu_torch.models.modules import (set_data_parallel,
                                                      set_dropout_generator)
    from ganreverser_tpu_torch.optim import adam
    from ganreverser_tpu_torch.train.adversarial import (
        Confusion, make_adversarial_steps)
    from ganreverser_tpu_torch.train.state import GanState, TrainState
    par, inputs = ctx["par"], ctx["inputs"]
    G, _, D = _tiny_models(inputs)
    nd, batch = int(inputs["nd"]), int(inputs["train_batch"])
    reals = torch.from_numpy(inputs["reals"])
    meshes = [("one", None, 1), ("mesh", par.make_mesh(), 1)]
    if par.mesh.world()[1] % 2 == 0:
        meshes.append(("tp", par.make_mesh(data=0, model=2), 2))
    out = {}
    for tag, m, model in meshes:
        Gm, Dm = copy.deepcopy(G), copy.deepcopy(D)
        set_dropout_generator(Dm, torch.Generator().manual_seed(13))
        dg, gg = [], []
        gs = GanState(g=TrainState.create(Gm, adam()),
                      d=TrainState.create(Dm, adam()))
        if m is not None:
            for ts in (gs.g, gs.d):
                set_data_parallel(ts.module, m)
                if model > 1:
                    ts.shard_model_axis(m, 1 << 10)
        d_step, g_step = make_adversarial_steps(
            dtype=torch.float32, d_optimizer=_capture(adam(), dg),
            g_optimizer=_capture(adam(), gg), mesh=m)
        zgen = torch.Generator().manual_seed(6)
        conf = Confusion.zero()
        dl = d_step(gs, reals, noise_inputs(zgen, batch // 2, nd), conf)
        gl = g_step(gs, noise_inputs(zgen, batch, nd))
        if m is not None:
            conf.counts = par.psum(conf.counts, m)
        out[f"{tag}_loss"] = torch.stack([dl, gl])
        out[f"{tag}_conf"] = conf.counts
        for net, ts, grads in (("d", gs.d, dg), ("g", gs.g, gg)):
            g = grads[-1] if ts.shards is None else ts.shards.gather(
                grads[-1])
            with par.whole_params(ts):
                params = [p.detach().clone() for p in ts.module.parameters()]
            for j, (gj, pj) in enumerate(zip(g, params)):
                out[f"{tag}_{net}_grad{j}"] = gj
                out[f"{tag}_{net}_param{j}"] = pj
            for name, buf in ts.module.named_buffers():
                out[f"{tag}_{net}_buf_{name}"] = buf
    return out


def case_dropout_base(ctx):
    """Kernel B5's counter base: this rank's rows of a batch against the
    whole batch's mask (the plain version here; the kernel on the card)."""
    import torch
    from ganreverser_tpu_torch.ops import dropout_kernel as dk
    par = ctx["par"]
    mesh = par.make_mesh()
    x = torch.from_numpy(ctx["inputs"]["drop_x"])
    seed = torch.tensor([int(ctx["inputs"]["drop_seed"])], dtype=torch.int32)
    rows = mesh.rows(x.shape[0])
    part = x[rows].contiguous()
    return {"part": dk.fused_dropout(part, seed, 0.5,
                                     base=rows.start * part[0].numel()),
            "whole_rows": dk.fused_dropout(x, seed, 0.5)[rows]}


CASES = {name[5:]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


def cli(argv: list) -> None:
    """``--cli MODULE OUT ARGS...``: one process of the port's CLI
    ``MODULE`` on ``ARGS``, which writes to ``OUT`` (npz) what its main
    returns: the losses and, under ``R/``, the train state as the JAX
    package's tree (cli/common.py::ts_to_tree), flattened. Every rank's
    own, where the CLI saves only rank 0's."""
    import importlib
    module, out, args = argv[0], argv[1], argv[2:]
    from ganreverser_tpu_torch.cli import common
    ran = importlib.import_module(f"ganreverser_tpu_torch.cli.{module}"
                                  ).main(args)
    np.savez(out, losses=np.asarray(ran["losses"]),
             **flat(common.ts_to_tree(ran["ts"]), "R/"))
    assert "jax" not in sys.modules, "a rank imported jax"


def main():
    if sys.argv[1:2] == ["--cli"]:
        return cli(sys.argv[2:])
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--cases", required=True)
    args = ap.parse_args()
    os.environ["GANREVERSER_PLATFORM"] = "cpu"
    import torch
    from ganreverser_tpu_torch import parallel as par
    torch.set_num_threads(1)
    par.initialize_distributed(f"localhost:{args.port}", args.world,
                               args.rank)
    with np.load(os.path.join(args.dir, "inputs.npz")) as z:
        inputs = {k: z[k] for k in z.files}
    ctx = {"par": par, "inputs": inputs}
    results = {}
    for case in args.cases.split(","):
        for k, v in CASES[case](ctx).items():
            if isinstance(v, torch.Tensor):
                v = v.detach().numpy()
            results[f"{case}/{k}"] = v
    np.savez(os.path.join(args.dir, f"rank{args.rank}.npz"), **results)
    par.shutdown_distributed()
    assert "jax" not in sys.modules, "a rank imported jax"


if __name__ == "__main__":
    main()
