"""Random weights of a Llama-layout decoder: the default model path's
``make_params`` (``paths/llama.py``), kept under its old name."""

from portbench import manifest

make_params = manifest.path({}).make_params
