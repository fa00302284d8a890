"""The distribution layer, the counterpart of ganreverser_tpu/parallel:
the ('data', 'model') mesh over a torch.distributed world (``mesh``), the
collectives on one of its axes (``comm``) and multi-process start-up
(``multihost``). A few names are JAX's API kept without a caller in the
port, each marked where it is defined (``mesh.replicated`` to
``host_local_batch``; ``multihost.global_batch_from_local`` to
``first_local_value``)."""
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, ModelShards, P,
                   data_sharding, host_local_batch, make_mesh, mesh_shape,
                   param_partition_spec, param_specs, process_slice,
                   replicate, replicated, shard_batch, shard_params,
                   whole_params)
from .comm import (all_gather, broadcast, pmean, ppermute, psum,
                   sharded_topk_merge)
from .multihost import (choose_backend, first_local_value, gather_replicated,
                        global_batch_from_local, initialize_distributed,
                        is_main_process, replicate_global,
                        shard_params_global, shutdown_distributed)
