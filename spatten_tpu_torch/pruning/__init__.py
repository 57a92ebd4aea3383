"""Cascade token pruning (keep selection), local V pruning, head pruning,
the importance that drives them, and prune compaction."""

from spatten_tpu_torch.pruning.head_pruning import (
    head_importance, select_heads,
)
from spatten_tpu_torch.pruning.importance import (
    importance_from_probs, importance_from_scores, reduce_to_kv_heads,
)
from spatten_tpu_torch.pruning.token_pruning import (
    prune_arrays, pruned_length, select_keep_indices,
)

__all__ = ["select_keep_indices", "prune_arrays", "pruned_length",
           "importance_from_probs", "importance_from_scores",
           "reduce_to_kv_heads", "head_importance", "select_heads"]
