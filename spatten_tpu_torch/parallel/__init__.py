"""Distribution layer of the port.

``mesh``: a rank's place on a mesh of processes (``make_mesh``: the
("data", "model") or ("pipe", "model") grid of the current process group
and a sub-group per axis) and the one transport the engines use
(``all_reduce``, ``send`` / ``recv``: on the device under NCCL, through
the host for a CUDA tensor under gloo).  ``sharded``: DP x TP serving,
one process per shard (``ShardedEngine``).  ``pipeline``: layer stages
over "pipe", microbatched and composed with TP (``PipelineEngine``).
``split_k``: split-K (sequence-parallel) flash decode over a cache whose
token axis is sharded across an explicit list of devices, driven by one
controller.  ``multihost``: joining a ``torch.distributed`` process group
and the heartbeat that the supervised decode probes with.  ``launch``:
running a function in N joined processes (the tests and the card's
phases).
"""

from spatten_tpu_torch.parallel.mesh import Mesh, make_mesh
from spatten_tpu_torch.parallel.multihost import health_check, initialize
from spatten_tpu_torch.parallel.pipeline import PipelineEngine
from spatten_tpu_torch.parallel.sharded import (
    ShardedEngine,
    local_config,
    param_pspecs,
    state_pspecs,
)
from spatten_tpu_torch.parallel.split_k import (
    KVMesh,
    join_kv,
    join_tokens,
    make_kv_mesh,
    quantize_sharded,
    reference_decode,
    shard_kv,
    shard_tokens,
    split_k_decode,
    split_k_decode_fused,
    split_k_prune,
)

__all__ = [
    "KVMesh",
    "Mesh",
    "PipelineEngine",
    "ShardedEngine",
    "health_check",
    "initialize",
    "join_kv",
    "join_tokens",
    "local_config",
    "make_kv_mesh",
    "make_mesh",
    "param_pspecs",
    "quantize_sharded",
    "reference_decode",
    "shard_kv",
    "shard_tokens",
    "split_k_decode",
    "split_k_decode_fused",
    "split_k_prune",
    "state_pspecs",
]
