"""The port's ServeEngine (repro_torch.serve.lm) against the JAX
package's on the same requests and weights: the same greedy tokens on the
five smoke configurations, with uneven prompt lengths, more requests than
one batch holds, and the int8 KV cache (dense and chunked)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import LM_ARCHS
from repro_torch.errors import NoCudaDevice
from repro_torch.models import transformer as TT
from repro_torch.serve import Request, ServeEngine
from test_torch_lm import jax_cfg, reference_tree

PROMPT_LENS = (3, 7, 1, 5, 4)
NEW_TOKENS = (4, 6, 3, 5, 2)

CASES = {
    **{aid: arch.smoke_cfg for aid, arch in LM_ARCHS.items()},
    "qwen2-1.5b:int8": dataclasses.replace(
        LM_ARCHS["qwen2-1.5b"].smoke_cfg, kv_quant_int8=True),
    "chatglm3-6b:int8_chunked": dataclasses.replace(
        LM_ARCHS["chatglm3-6b"].smoke_cfg, kv_quant_int8=True,
        decode_chunk=8),
}


def _prompts(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n, dtype=np.int32)
            for n in PROMPT_LENS]


def _serve_both(cfg, batch, max_len):
    jc = jax_cfg(cfg)
    jp = reference_tree(jc, 0)
    tp = TT.params_from_jax(cfg, jp, device="cpu")
    prompts = _prompts(cfg)
    want = JServeEngine(jc, jp, batch=batch, max_len=max_len).generate(
        [JRequest(prompt=p, max_new_tokens=n)
         for p, n in zip(prompts, NEW_TOKENS)])
    got = ServeEngine(cfg, tp, batch=batch, max_len=max_len,
                      device="cpu").generate(
        [Request(prompt=p, max_new_tokens=n)
         for p, n in zip(prompts, NEW_TOKENS)])
    return [r.generated for r in want], [r.generated for r in got]


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_tokens_equal_the_reference(name):
    want, got = _serve_both(CASES[name], batch=2, max_len=16)
    assert got == want
    assert [len(g) for g in got] == list(NEW_TOKENS)


def test_ring_wraps_past_max_len_as_the_reference():
    """Prompt + new tokens beyond max_len wrap the ring (a reference
    quirk, kept)."""
    cfg = LM_ARCHS["mixtral-8x7b"].smoke_cfg          # SWA window 16
    want, got = _serve_both(cfg, batch=3, max_len=8)
    assert got == want


def test_mark_sees_each_batch_phase():
    cfg = LM_ARCHS["qwen2-1.5b"].smoke_cfg
    tp = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    seen = []
    ServeEngine(cfg, tp, batch=4, max_len=16, device="cpu").generate(
        [Request(prompt=p, max_new_tokens=2) for p in _prompts(cfg)],
        mark=seen.append)
    assert seen == ["prefill", "decode", "end"] * 2


def test_serve_engine_needs_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = LM_ARCHS["qwen2-1.5b"].smoke_cfg
    tp = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NoCudaDevice):
        ServeEngine(cfg, tp, batch=2, max_len=8)
