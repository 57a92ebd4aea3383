"""Llama-class and GPT-2-class decoders over the SpAtten attention core."""

from spatten_tpu_torch.models.transformer import forward, init_params

__all__ = ["init_params", "forward"]
