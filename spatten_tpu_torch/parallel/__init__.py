"""Distribution layer of the port.

``split_k``: split-K (sequence-parallel) flash decode over a cache whose
token axis is sharded across an explicit list of devices, driven by one
controller (the counterpart of the JAX package's ``shard_map`` over a
``kv`` mesh axis).  ``multihost``: joining a ``torch.distributed`` process
group and the heartbeat that the supervised decode probes with.  The
multi-card slice -- DP x TP (``sharded.py``), pipeline stages
(``pipeline.py``) and split-K across processes -- is not ported yet.
"""

from spatten_tpu_torch.parallel.multihost import health_check, initialize
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
    "health_check",
    "initialize",
    "join_kv",
    "join_tokens",
    "make_kv_mesh",
    "quantize_sharded",
    "reference_decode",
    "shard_kv",
    "shard_tokens",
    "split_k_decode",
    "split_k_decode_fused",
    "split_k_prune",
]
