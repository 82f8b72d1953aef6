"""Weight conversion (port of ``scripts/convert_weights.py``; reference
models/onnx2torch.py role). Host and numpy only; writes the files the JAX
script writes:

  ONNX -> npz:   python -m pangu_tpu_torch.scripts.convert_weights \\
                     --onnx pangu_weather_24.onnx --out params_24.npz --aux-out aux_data
  torch -> npz:  python -m pangu_tpu_torch.scripts.convert_weights \\
                     --pth pangu_weather_24_torch.pth --out params_24.npz
  npz -> torch:  python -m pangu_tpu_torch.scripts.convert_weights \\
                     --npz params_24.npz --out-pth pangu_weather_24_torch.pth

The torch->onnx name map is derived from the graph structure automatically
(no keys_all.csv needed); pass --name-map to override, --name-map-out to
dump the derived map.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from pangu_tpu_torch.config import ModelConfig, pangu_tiny


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--onnx", type=str, default=None)
    p.add_argument("--name-map", type=str, default=None,
                   help="torch_name,onnx_name CSV override (keys_all.csv "
                        "format); derived from the graph when omitted")
    p.add_argument("--name-map-out", type=str, default=None,
                   help="write the derived name map to this CSV")
    p.add_argument("--pth", type=str, default=None)
    p.add_argument("--npz", type=str, default=None)
    p.add_argument("--out", type=str, default=None, help="output params .npz")
    p.add_argument("--out-pth", type=str, default=None,
                   help="output reference-format torch checkpoint")
    p.add_argument("--aux-out", type=str, default=None,
                   help="directory for extracted normalization/mask .npy files")
    p.add_argument("--horizon", type=int, default=24)
    p.add_argument("--preset", type=str, default="pretrain",
                   choices=["pretrain", "tiny"],
                   help="model geometry the weights belong to")
    args = p.parse_args(argv)

    cfg = pangu_tiny().model if args.preset == "tiny" else ModelConfig()

    if args.onnx:
        if not args.out:
            raise SystemExit("--onnx needs --out")
        from pangu_tpu_torch.interop.onnx_import import convert_onnx_checkpoint

        convert_onnx_checkpoint(cfg, args.onnx, args.name_map, args.out,
                                args.aux_out, args.horizon,
                                name_map_out=args.name_map_out)
        print(f"wrote {args.out}" + (f" and aux files to {args.aux_out}"
                                     if args.aux_out else ""))
    elif args.pth:
        if not args.out:
            raise SystemExit("--pth needs --out")
        from pangu_tpu_torch.interop.npz_io import save_params_npz
        from pangu_tpu_torch.interop.torch_import import (
            load_torch_checkpoint,
            params_from_state_dict,
        )

        params = params_from_state_dict(cfg, load_torch_checkpoint(args.pth))
        save_params_npz(args.out, params)
        print(f"wrote {args.out}")
    elif args.npz and args.out_pth:
        import torch

        from pangu_tpu_torch.interop.npz_io import load_params_npz
        from pangu_tpu_torch.interop.torch_import import state_dict_from_params

        params = load_params_npz(args.npz)
        state = {k: torch.from_numpy(v)
                 for k, v in state_dict_from_params(cfg, params).items()}
        torch.save({"model": state}, args.out_pth)
        print(f"wrote {args.out_pth}")
    elif args.npz:
        # named an input but not where it should go — say so, instead of
        # the generic fallthrough
        raise SystemExit("--npz needs --out-pth")
    else:
        raise SystemExit("nothing to do; see --help")


if __name__ == "__main__":
    main()
