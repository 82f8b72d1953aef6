"""Dataset statistics tool (port of ``scripts/stats.py``; reference stat.py
role): stream one split of the configured store and write
``stats_<tag>.txt`` and ``stats_<tag>.npz`` under ``--out``. Host and numpy
only (scipy for the wind moments).

    python -m pangu_tpu_torch.scripts.stats --set data.store=npy \\
        --set data.root=/data/npy --split test --limit 100 --out runs/stats
"""

from __future__ import annotations

from typing import Optional, Sequence

from pangu_tpu_torch.cli import base_parser, build_config
from pangu_tpu_torch.data.dataset import Era5Dataset, make_store
from pangu_tpu_torch.data.stats import analyze_dataset


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Returns the path of the report."""
    p = base_parser("Compute dataset statistics")
    p.add_argument("--split", default="test", choices=["train", "val", "test"])
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--tag", default=None)
    args = p.parse_args(argv)

    cfg = build_config(args)
    store = make_store(cfg.data, cfg.model)
    ranges = {
        "train": (cfg.data.train_start, cfg.data.train_end, cfg.data.train_freq),
        "val": (cfg.data.val_start, cfg.data.val_end, cfg.data.val_freq),
        "test": (cfg.data.test_start, cfg.data.test_end, cfg.data.test_freq),
    }
    start, end, freq = ranges[args.split]
    ds = Era5Dataset(store, start, end, freq, cfg.horizon)
    tag = args.tag or f"{args.split}_{start[:4]}"
    out = analyze_dataset(ds, cfg.out_dir, tag, limit=args.limit)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
