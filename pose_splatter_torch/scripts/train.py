"""Train a PoseSplatter model (counterpart of ``scripts/train.py``).

    python -m pose_splatter_torch.scripts.train <config.json> [--load]
        [--ablation] [--epochs N] [--max_batches N] [--batch_size B]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

from pose_splatter_torch.config import Config
from pose_splatter_torch.scripts.common import add_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train script for the model")
    parser.add_argument("config", type=str, help="Path to the config JSON file")
    parser.add_argument("--load", action="store_true",
                        help="Load a pre-trained model")
    parser.add_argument("--ablation", action="store_true",
                        help="Train the ablation model")
    parser.add_argument("--epochs", type=int, default=50)
    parser.add_argument("--max_batches", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=1)
    return add_device(parser)


def main(argv=None):
    from pose_splatter_torch.train.trainer import train_from_config

    args = build_parser().parse_args(argv)
    config = Config(args.config)
    print(f"Config file: {args.config}")
    print(f"Load flag: {args.load}")
    print(f"Ablation flag: {args.ablation}")
    print(f"Epochs: {args.epochs}")
    return train_from_config(
        config,
        epochs=args.epochs,
        load=args.load,
        ablation=args.ablation,
        max_batches=args.max_batches,
        batch_size=args.batch_size,
        device=args.device,
    )


if __name__ == "__main__":
    main()
