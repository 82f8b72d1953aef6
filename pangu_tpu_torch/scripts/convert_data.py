"""Dataset ETL (port of ``scripts/convert_data.py``; reference
convert_era5.py / download_era5.sh role): convert NetCDF archives or
reference per-hour .pt stores to the framework's per-hour .npy store.
Host and numpy only.

  python -m pangu_tpu_torch.scripts.convert_data --src /data/nc --format netcdf \\
      --dst /data/npy --start 20180101 --end "20181231 12:00:00" --freq 1h

``--start`` and ``--end`` are "YYYYMMDD" or "YYYYMMDD HH:MM:SS", both ends
inclusive; ``--freq`` is "<hours>h". NetCDF needs xarray.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from pangu_tpu_torch.data.convert import convert_netcdf_to_npy, convert_pt_to_npy


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Returns the number of frames written."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--format", choices=["netcdf", "pt"], default="netcdf")
    p.add_argument("--start", required=True)
    p.add_argument("--end", required=True)
    p.add_argument("--freq", default="1h")
    p.add_argument("--workers", type=int, default=16)
    args = p.parse_args(argv)

    fn = convert_netcdf_to_npy if args.format == "netcdf" else convert_pt_to_npy
    n = fn(args.src, args.dst, args.start, args.end, args.freq, args.workers)
    print(f"converted {n} timestamps into {args.dst}")
    return n


if __name__ == "__main__":
    main()
