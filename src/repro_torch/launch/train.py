"""Training launcher: the reference's flags plus ``--device`` (default: the
card).

Example (CPU, smoke-sized):
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
      --steps 50 --batch 8 --seq 128 --ckpt-dir ckpt

Only the dense family is ported: another ``--arch`` raises, naming
ROADMAP Queue 1 item 10.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

import torch

from ..configs import get_arch
from ..core.trag import resolve_device
from ..data import HashTokenizer, PackedBatches, TextDataset, hospital_corpus
from ..models import lm
from ..models.transformer import check_family
from ..training import (AdamWConfig, LoopConfig, TrainLoop, adamw_init,
                        make_train_step)


def main(argv: Optional[Sequence[str]] = None) -> TrainLoop:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--trees", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    check_family(cfg)
    dev = resolve_device(args.device)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=10,
                          total_steps=args.steps)
    opt_state = adamw_init(params)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches)

    corpus = hospital_corpus(num_trees=args.trees)
    ds = TextDataset(corpus.documents, HashTokenizer(cfg.vocab))
    pb = PackedBatches(ds, batch_size=args.batch, seq_len=args.seq)

    def batches():
        for b in pb:
            yield {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    loop = TrainLoop(LoopConfig(total_steps=args.steps,
                                ckpt_dir=args.ckpt_dir,
                                ckpt_every=args.ckpt_every),
                     step_fn, params, opt_state, batches(), pipeline=pb)
    metrics = loop.run()
    print(f"done at step {loop.step}: loss={float(metrics['loss']):.4f}")
    return loop


if __name__ == "__main__":
    main()
