"""Accuracy evaluation: teacher-forced perplexity under the pruned,
quantized engine (use ``spatten_tpu_torch.eval.perplexity``)."""

from spatten_tpu_torch.eval.perplexity import (
    PerplexityResult, evaluate_perplexity,
)

__all__ = ["PerplexityResult", "evaluate_perplexity"]
