"""End-to-end training with the PyTorch port: pushdown data pipeline ->
model -> AdamW, with checkpoints, auto-resume and preemption handling.

    PYTHONPATH=src python examples/train_pushdown_pipeline_torch.py     # demo
    PYTHONPATH=src python examples/train_pushdown_pipeline_torch.py \\
        --preset 100m --steps 300                                        # full
    PYTHONPATH=src python examples/train_pushdown_pipeline_torch.py \\
        --device cpu --steps 10

The corpus query (quality filter + domain selection + shuffle-to-rank) runs
through the same adaptive-pushdown engine the OLAP path uses: each corpus
partition becomes a pushdown request, Algorithm 1 decides per partition
whether the storage host runs it or pushes raw data back, and either way
the filter and the shuffle are one ``fused_scan_shuffle`` launch on the
card. It runs on the GPU unless given ``--device cpu``. Checkpoints go to
``--ckpt-dir`` (by default a directory under the system's temporary
directory); run it again to resume.
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost import StorageResources
from repro_torch.data.pipeline import (CorpusQuery, PushdownDataPipeline,
                                       synth_corpus)
from repro_torch.models import api
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.loop import TrainConfig, train

PRESETS = {
    # ~3M params: the demo default
    "demo": dict(layers=2, d_model=128, heads=4, d_ff=512, vocab=4096,
                 seq=128, batch=8, accum=2),
    # ~25M params
    "25m": dict(layers=8, d_model=384, heads=8, d_ff=1536, vocab=16384,
                seq=256, batch=8, accum=2),
    # ~110M params (GPT-2-small-ish): the "train a ~100M model" preset
    "100m": dict(layers=12, d_model=640, heads=10, d_ff=2560, vocab=32768,
                 seq=512, batch=8, accum=4),
}


def build_cfg(p) -> ModelConfig:
    base = get_config("olmo-1b", reduced=True)
    return dataclasses.replace(
        base, name=f"train-example-{p['d_model']}", num_layers=p["layers"],
        d_model=p["d_model"], num_heads=p["heads"], num_kv_heads=p["heads"],
        d_ff=p["d_ff"], vocab_size=p["vocab"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="demo", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_example"))
    ap.add_argument("--storage-power", type=float, default=1.0,
                    help="emulated storage-host load (0,1]")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    p = PRESETS[args.preset]
    cfg = build_cfg(p)
    print(f"model: {cfg.name}  params={api.count_params(cfg)/1e6:.1f}M")

    corpus = synth_corpus(num_partitions=8, docs_per_part=128,
                          doc_len=p["seq"], vocab=p["vocab"], hosts=2)
    query = CorpusQuery(min_quality=0.25, domains=(0, 1, 2, 3, 4, 5),
                        seq_len=p["seq"], global_batch=p["batch"],
                        accum=p["accum"], dp_ranks=2)
    pipe = PushdownDataPipeline(
        corpus, query,
        res=StorageResources(storage_power=args.storage_power),
        device=args.device)
    print("ingest arbitration:", pipe.stats(), "on", pipe.device)

    tcfg = TrainConfig(
        steps=args.steps, ckpt_every=max(10, args.steps // 4),
        ckpt_dir=args.ckpt_dir, log_every=max(1, args.steps // 10),
        opt=opt_lib.AdamWConfig(lr=3e-3, warmup_steps=max(2, args.steps // 10),
                                total_steps=args.steps))
    out = train(cfg, iter(pipe), tcfg, device=pipe.device,
                hooks=lambda s, m: print(
                    f"  step {s:4d} loss {m['loss']:.4f} "
                    f"lr {m['lr']:.2e} gnorm {m['grad_norm']:.2f} "
                    f"({m['wall_s']:.0f}s)"))
    h = out["history"]
    if h:
        print(f"\ntrained {out['final_step']} steps: loss "
              f"{h[0]['loss']:.3f} -> {h[-1]['loss']:.3f}; checkpoints in "
              f"{args.ckpt_dir} (re-run to auto-resume)")
    else:
        print(f"\nnothing to train: the checkpoint in {args.ckpt_dir} is at "
              f"step {out['final_step']} (raise --steps to go on)")


if __name__ == "__main__":
    main()
