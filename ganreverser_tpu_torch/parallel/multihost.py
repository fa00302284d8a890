"""Multi-process start-up and the helpers around it — the counterpart of
ganreverser_tpu/parallel/multihost.py.

JAX runs one process per host and joins them with
``jax.distributed.initialize``; here every rank of the mesh is a process,
joined into one ``torch.distributed`` world:

    initialize_distributed("host0:1234", num_processes=N, process_id=i)
    mesh = make_mesh(...)                 # spans all the ranks
    rows = loader(*process_slice(n))      # this rank's input rows

The training CLIs take ``--coordinator_address/--num_processes/
--process_id``; torchrun's ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/
``MASTER_PORT`` environment does the same (PyTorch's idiom).

Each rank runs on ``cuda:(local_rank % device_count)``, or on the CPU when
GANREVERSER_PLATFORM=cpu. The backend is chosen from that topology before
the process group starts, and printed: NCCL when every rank of this host
has a card of its own, gloo when ranks share a card (NCCL refuses two
ranks on one device) and on the CPU. A failure to start raises; nothing
falls back to another backend or device.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from .mesh import MODEL_AXIS, Mesh, P, replicate, shard_params, world

# seconds a rank waits at the rendezvous or in a collective before it fails
TIMEOUT_S = 600


def choose_backend(device_type: str, local_ranks: int,
                   device_count: int) -> str:
    """'nccl' when ``local_ranks`` ranks on this host each have one of its
    ``device_count`` cards, else 'gloo' (shared cards, or the CPU)."""
    if device_type == "cuda" and local_ranks <= device_count:
        return "nccl"
    return "gloo"


def _rank_device(local_rank: int) -> torch.device:
    """This rank's device: the CPU under GANREVERSER_PLATFORM=cpu, else
    card ``local_rank % device_count`` (raises without CUDA)."""
    plat = os.environ.get("GANREVERSER_PLATFORM", "gpu").lower()
    if plat == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("GANREVERSER_PLATFORM asks for the GPU, but CUDA "
                           "is not available (set GANREVERSER_PLATFORM=cpu "
                           "to run on the CPU)")
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def initialize_distributed(coordinator_address: str = "",
                           num_processes: int = 0,
                           process_id: int = -1) -> bool:
    """Join the process group when coordinator flags are set, or when
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``) is.

    No-op (returns False) otherwise — the single-process default. Must be
    called before any device use. The rendezvous is
    ``tcp://coordinator_address``; ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``
    say where this rank sits on its host (else ``process_id`` and
    ``num_processes``: all ranks on one host)."""
    env = os.environ
    if not coordinator_address:
        if not all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
            return False
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
    if num_processes <= 0 or process_id < 0:
        raise ValueError(
            "--coordinator_address needs --num_processes > 0 and "
            f"--process_id >= 0 (got {num_processes}, {process_id})")
    if process_id >= num_processes:
        raise ValueError(f"--process_id {process_id} is not below "
                         f"--num_processes {num_processes}")
    local_rank = int(env.get("LOCAL_RANK", process_id))
    local_ranks = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    device = _rank_device(local_rank)
    backend = choose_backend(
        device.type, local_ranks,
        torch.cuda.device_count() if device.type == "cuda" else 0)
    print(f"<dist> rank {process_id} of {num_processes}: {device}, backend "
          f"{backend} ({local_ranks} ranks on this host)", flush=True)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


# JAX's names for what a rank here already holds: there is no global
# array, so each is the local operation it names. No path of the port calls
# them; they keep code written against the JAX package's multihost reading
# the same. gather_replicated (below) is the one that does work.

def global_batch_from_local(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows as its part of the global batch cut over 'data':
    the rows themselves, on the mesh's device."""
    return local.to(mesh.device)


replicate_global = replicate          # rank 0's tree on every rank
shard_params_global = shard_params    # each rank keeps its slices
first_local_value = float             # a scalar of this rank's tensor


def gather_replicated(tree, mesh: Mesh, specs=None):
    """Every leaf whole on every rank: the leaves that ``specs`` (a tree of
    :class:`~.mesh.P` matching ``tree``, :func:`~.mesh.param_specs` of the
    whole tree) cuts over 'model' are all-gathered over the 'model' group.
    A collective: every rank must call it, even where only rank 0 writes
    the checkpoint afterwards."""
    if specs is None:
        return tree
    from .comm import all_gather

    def gather(leaf, spec):
        dim = spec.dim(MODEL_AXIS)
        return leaf if dim is None else all_gather(leaf, mesh, MODEL_AXIS,
                                                   axis=dim)
    return pytree.tree_map(gather, tree, specs,
                           is_leaf=lambda x: isinstance(x, P))


def is_main_process() -> bool:
    """Whether this process is rank 0 (the one that writes files)."""
    return world()[0] == 0
