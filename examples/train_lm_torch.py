"""End-to-end training example on the PyTorch/CUDA package (the
counterpart of ``examples/train_lm.py``): a small LM trained for a few
hundred steps with the production substrate — deterministic data
stream, AdamW, async checkpointing, and crash-recovery.

    PYTHONPATH=src python examples/train_lm_torch.py              # ~10M, H100
    PYTHONPATH=src python examples/train_lm_torch.py --full       # ~100M
    PYTHONPATH=src python examples/train_lm_torch.py --steps 300 --crash-at 120
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 40
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch                                            # noqa: E402

from repro_torch.data import TokenStream                # noqa: E402
from repro_torch.models import transformer as T         # noqa: E402
from repro_torch.optim import adamw                     # noqa: E402
from repro_torch.train import Trainer, TrainerConfig    # noqa: E402
from repro_torch.tree import leaves                     # noqa: E402


def build_cfg(full: bool) -> T.LMConfig:
    if full:   # ~100M params
        return T.LMConfig(name="lm100m", n_layers=8, d_model=768,
                          n_heads=12, n_kv_heads=4, d_head=64, d_ff=2048,
                          vocab=32000, remat=False)
    return T.LMConfig(name="lm10m", n_layers=4, d_model=256, n_heads=8,
                      n_kv_heads=4, d_head=32, d_ff=683, vocab=8192,
                      remat=False)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--crash-at", type=int, default=None,
                    help="simulate a node failure at this step")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model trains (default: the card)")
    args = ap.parse_args()

    cfg = build_cfg(args.full)
    dev = args.device
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    n = sum(x.numel() for x in leaves(params))
    print(f"model: {cfg.name}  params: {n/1e6:.1f}M")

    stream = TokenStream(vocab=cfg.vocab, batch=args.batch,
                         seq_len=args.seq, device=dev)

    def loss_fn(p, b):
        return T.lm_loss(cfg, p, b["tokens"], b["targets"])

    trainer = Trainer(
        TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=50,
                      ckpt_async=True),
        adamw.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps),
        loss_fn, params, device=dev)

    crashed = {"done": False}

    def fail_hook(step):
        if args.crash_at is not None and step == args.crash_at \
                and not crashed["done"]:
            crashed["done"] = True
            print(f"!! simulated node failure at step {step} — recovering "
                  "from checkpoint")
            raise RuntimeError("simulated failure")

    t0 = time.time()
    eval_batch = stream.batch_at(10_000_019)     # held-out step index

    def data_fn(step):
        if step % 20 == 0:
            with torch.no_grad():
                ev = float(loss_fn(trainer.state["params"], eval_batch))
            print(f"step {step:4d}  eval_loss={ev:.4f}  "
                  f"({time.time()-t0:.0f}s)")
        return stream.batch_at(step)

    metrics = trainer.run(data_fn, args.steps, fail_hook=fail_hook)
    with torch.no_grad():
        final_loss = float(loss_fn(trainer.state["params"], eval_batch))
    print(f"done: steps={int(trainer.state['step'])} "
          f"final_loss={final_loss:.4f} restarts={metrics['restarts']}")


if __name__ == "__main__":
    main()
