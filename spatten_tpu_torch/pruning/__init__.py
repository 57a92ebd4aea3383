"""Cascade token pruning (keep selection) and prune compaction."""
