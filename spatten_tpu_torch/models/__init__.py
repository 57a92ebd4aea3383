"""Llama-class and GPT-2-class decoders over the SpAtten attention core."""

from spatten_tpu_torch.models import hf_loader
from spatten_tpu_torch.models.transformer import (
    forward, init_params, num_params,
)

__all__ = ["init_params", "forward", "num_params", "hf_loader"]
