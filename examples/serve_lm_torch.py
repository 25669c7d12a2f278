"""Serving example on the PyTorch/CUDA package (the counterpart of
``examples/serve_lm.py``): batched greedy decoding with the KV-cache
engine (ring-buffer SWA cache + int8 KV quantization).

    PYTHONPATH=src python examples/serve_lm_torch.py                  # H100
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np                                   # noqa: E402
import torch                                         # noqa: E402

from repro_torch.models import transformer as T      # noqa: E402
from repro_torch.serve import Request, ServeEngine   # noqa: E402


def main(device: str = "cuda"):
    cfg = T.LMConfig(name="serve-demo", n_layers=4, d_model=256, n_heads=8,
                     n_kv_heads=4, d_head=32, d_ff=683, vocab=8192,
                     sliding_window=64, kv_quant_int8=True, remat=False)
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
    engine = ServeEngine(cfg, params, batch=4, max_len=256, device=device)

    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab, size=int(n)),
                    max_new_tokens=12)
            for n in rng.integers(3, 20, size=6)]
    done = engine.generate(reqs)
    for i, r in enumerate(done):
        print(f"req{i}: prompt[{len(r.prompt)} toks] -> {r.generated}")
    print("ring KV cache:", T.cache_len(cfg, 256), "slots (window=64), int8")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the engine runs (default: the card)")
    main(ap.parse_args().device)
