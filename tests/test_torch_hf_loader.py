"""The port's HF checkpoint loader (``spatten_tpu_torch.models.hf_loader``)
against the JAX package's, on the CPU.

Tiny randomly initialised Llama and GPT-2 models are built locally with
``transformers`` (no network) and saved in ``tmp_path`` as safetensors
and as ``pytorch_model.bin``; both packages load them: the parameter
trees are identical (f32), and the logits of one prompt through each
package's ``forward`` (pruning and quantization off, a fresh cache) agree
within 1e-4.  The port reads safetensors without the ``safetensors``
package: its reader equals that package's byte for byte (dtype, shape and
values, bf16 and f16 included).  ``config_from_hf`` equals JAX's field by
field on the published ``config.json`` of OpenLLaMA-3B and Llama-3.2-3B.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

import chip_smoke  # noqa: E402
from spatten_tpu import config as jcfg  # noqa: E402
from spatten_tpu.engine.state import init_state as j_init_state  # noqa: E402
from spatten_tpu.models import forward as j_forward  # noqa: E402
from spatten_tpu.models import hf_loader as jhf  # noqa: E402

from spatten_tpu_torch import config as tcfg  # noqa: E402
from spatten_tpu_torch.engine.state import init_state  # noqa: E402
from spatten_tpu_torch.models import hf_loader as thf  # noqa: E402
from spatten_tpu_torch.models import transformer as ttr  # noqa: E402

torch.set_num_threads(1)

# meta-llama/Llama-3.2-3B's published config.json
LLAMA32_3B = {
    "architectures": ["LlamaForCausalLM"], "attention_bias": False,
    "attention_dropout": 0.0, "bos_token_id": 128000,
    "eos_token_id": 128001, "head_dim": 128, "hidden_act": "silu",
    "hidden_size": 3072, "initializer_range": 0.02,
    "intermediate_size": 8192, "max_position_embeddings": 131072,
    "mlp_bias": False, "model_type": "llama", "num_attention_heads": 24,
    "num_hidden_layers": 28, "num_key_value_heads": 8, "pretraining_tp": 1,
    "rms_norm_eps": 1e-05,
    "rope_scaling": {"factor": 32.0, "high_freq_factor": 4.0,
                     "low_freq_factor": 1.0,
                     "original_max_position_embeddings": 8192,
                     "rope_type": "llama3"},
    "rope_theta": 500000.0, "tie_word_embeddings": True,
    "torch_dtype": "bfloat16", "use_cache": True, "vocab_size": 128256,
}


def tiny_llama():
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(cfg).eval()


def tiny_gpt2():
    cfg = transformers.GPT2Config(vocab_size=128, n_embd=32, n_layer=2,
                                  n_head=4, n_positions=64, n_inner=64)
    torch.manual_seed(1)
    return transformers.GPT2LMHeadModel(cfg).eval()


MODELS = {"llama": tiny_llama, "gpt2": tiny_gpt2}


@pytest.fixture(scope="module", params=[
    (m, fmt) for m in MODELS for fmt in ("safetensors", "bin")],
    ids=lambda p: f"{p[0]}-{p[1]}")
def checkpoint(request, tmp_path_factory):
    name, fmt = request.param
    model = MODELS[name]()
    d = tmp_path_factory.mktemp(f"tiny_{name}_{fmt}")
    model.save_pretrained(d, safe_serialization=fmt == "safetensors")
    suffix = ".safetensors" if fmt == "safetensors" else ".bin"
    assert any(p.suffix == suffix for p in d.iterdir())
    return name, str(d)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix: tree}


def test_loaders_give_identical_parameters(checkpoint):
    _, path = checkpoint
    jc, jparams = jhf.load_pretrained(path, dtype=jnp.float32)
    tc, tparams = thf.load_pretrained(path, dtype=torch.float32,
                                      device="cpu")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    jl, tl = leaves(jparams), leaves(tparams)
    assert sorted(jl) == sorted(tl)
    for k in jl:
        assert tl[k].dtype == torch.float32
        np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]),
                                      err_msg=k)


def test_loader_casts_to_bf16(checkpoint):
    """The engine dtype: every leaf cast from f32 by round to nearest
    even, as JAX's ``astype(bfloat16)``."""
    _, path = checkpoint
    _, jparams = jhf.load_pretrained(path, dtype=jnp.bfloat16)
    _, tparams = thf.load_pretrained(path, device="cpu")
    jl, tl = leaves(jparams), leaves(tparams)
    for k in jl:
        assert tl[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tl[k].to(torch.float32).numpy(),
            np.asarray(jl[k].astype(jnp.float32)), err_msg=k)


def run_config(mod, model_cfg):
    return mod.SpAttenConfig(
        model=model_cfg,
        pruning=mod.PruningConfig(enable_token_pruning=False,
                                  enable_v_pruning=False),
        quant=mod.QuantConfig(enabled=False, enable_requant=False),
        engine=mod.EngineConfig(max_batch_size=1, cache_capacity=64,
                                prefill_chunk=32, use_pallas=False),
    ).validate()


def test_loaded_logits_match_jax(checkpoint):
    name, path = checkpoint
    jc, jparams = jhf.load_pretrained(path, dtype=jnp.float32)
    tc, tparams = thf.load_pretrained(path, dtype=torch.float32,
                                      device="cpu")
    tokens = np.array([[3, 17, 42, 9, 88, 120, 5]], np.int32)
    jrun, trun = run_config(jcfg, jc), run_config(tcfg, tc)
    want = np.asarray(j_forward(jparams, jrun, j_init_state(jrun, batch=1),
                                jnp.asarray(tokens))[0])
    got = ttr.forward(tparams, trun, init_state(trun, 1, device="cpu"),
                      torch.from_numpy(tokens))[0].numpy()
    assert got.shape == want.shape == (1, 7, 128)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # and against transformers itself, within the int8 KV round trip
    with torch.no_grad():
        hf = MODELS[name]()(torch.from_numpy(tokens).long()).logits.numpy()
    np.testing.assert_allclose(got, hf, atol=0.05, rtol=0.05)


def test_safetensors_reader_equals_the_package(tmp_path):
    g = torch.Generator().manual_seed(5)
    tensors = {
        "bf16": torch.randn((3, 5), generator=g).bfloat16(),
        "f16": torch.randn((7,), generator=g).half(),
        "f32": torch.randn((2, 3, 4), generator=g),
        "f64": torch.randn((2,), generator=g).double(),
        "i8": torch.randint(-128, 127, (9,), dtype=torch.int8, generator=g),
        "u8": torch.randint(0, 255, (4, 4), dtype=torch.uint8, generator=g),
        "i32": torch.randint(-9, 9, (5,), dtype=torch.int32, generator=g),
        "i64": torch.randint(-9, 9, (1, 1), dtype=torch.int64, generator=g),
        "bool": torch.rand((6,), generator=g) > 0.5,
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros((0, 3)),
    }
    path = str(tmp_path / "t.safetensors")
    safetensors_torch.save_file(tensors, path, metadata={"format": "pt"})
    want = safetensors_torch.load_file(path)
    got = thf.read_safetensors(path)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].numpy().tobytes() == w.numpy().tobytes() if \
            w.dtype != torch.bfloat16 else torch.equal(
                got[k].view(torch.int16), w.view(torch.int16)), k


@pytest.mark.parametrize("name", ["OpenLLaMA-3B", "Llama-3.2-3B"])
def test_config_from_hf_matches_jax(name):
    hf = {"OpenLLaMA-3B": chip_smoke.OPENLLAMA_3B_HF_CONFIG,
          "Llama-3.2-3B": LLAMA32_3B}[name]
    got = dataclasses.asdict(thf.config_from_hf(dict(hf)))
    want = dataclasses.asdict(jhf.config_from_hf(dict(hf)))
    assert got == want
    # the chip_smoke paths' models are these configurations
    path = {"OpenLLaMA-3B": chip_smoke.openllama_3b_config,
            "Llama-3.2-3B": chip_smoke.llama32_3b_config}[name]()
    assert dataclasses.asdict(path.model) == got
    if name == "OpenLLaMA-3B":
        assert (got["num_kv_heads"], got["head_dim"], got["num_layers"]) \
            == (32, 100, 26)


def test_config_from_hf_gpt2_and_refusal():
    hf = {"model_type": "gpt2", "vocab_size": 50257, "n_embd": 768,
          "n_layer": 12, "n_head": 12, "n_positions": 1024}
    got = thf.config_from_hf(hf)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jhf.config_from_hf(hf))
    assert got == tcfg.ModelConfig.gpt2_small() or got.intermediate_size \
        == 3072
    with pytest.raises(ValueError, match="model_type"):
        thf.config_from_hf({"model_type": "mamba"})
