"""Interactive forecast viewer (port of ``demo/app.py``; reference
demo/app.py: a Streamlit app over simulated forecasts; reference
demo/app.py:150,165-166 notes its data is simulated too).

Like the JAX package's demo, this one can also drive real checkpoints and
data through the flags every other entry point uses (pangu_tpu_torch.cli):

    # synthetic tiny-geometry demo (default, matches the reference's demo)
    PYTHONPATH=. streamlit run pangu_tpu_torch/demo/app.py
    python -m pangu_tpu_torch.demo.app --out demo_report

    # real weights + real normalization constants + real ERA5 .npy frames
    python -m pangu_tpu_torch.demo.app --preset pretrain --weights ckpt.npz \\
        --aux-dir aux/ --set data.root=/data/era5 --out demo_report

Headless fallback (no streamlit) renders the same forecast panels to a
static HTML report. The forecast runs on the card (``main(argv,
device="cpu")`` on the CPU); the default preset is tiny, f32, with no
kernel. matplotlib is imported only where a panel is rendered.
"""

from __future__ import annotations

import base64
import io
import os
from datetime import datetime
from typing import Optional, Sequence

from pangu_tpu_torch.cli import base_parser, build_config, load_model_and_params, require_device
from pangu_tpu_torch.config import ERA5_SURFACE_VARIABLES


def _parse_args(argv: Optional[Sequence[str]], lenient: bool):
    p = base_parser("Pangu-Weather forecast demo")
    p.add_argument("--steps", type=int, default=2,
                   help="autoregressive steps (x horizon hours) to render")
    p.add_argument("--init", type=str, default="2024010100",
                   help="init time YYYYMMDDHH (headless mode)")
    # the demo defaults to the tiny geometry -- the full pretrained model is
    # what scripts/rollout.py is for; pass --preset pretrain to override
    p.set_defaults(preset="tiny")
    if lenient:
        # under streamlit, argv may carry flags streamlit itself injects;
        # headless keeps argparse's strict unknown-flag rejection
        args, _ = p.parse_known_args(argv)
        return args
    return p.parse_args(argv)


def _forecast(init_time: datetime, steps: int, args, device):
    """Autoregressive forecast via the same wiring as scripts/rollout.py:
    real store/aux/weights when configured, synthetic otherwise (the
    reference demo only has the synthetic mode). Frames come back as numpy
    arrays on the host."""
    import torch

    from pangu_tpu_torch.aux import load_aux_constants
    from pangu_tpu_torch.data.dataset import make_store
    from pangu_tpu_torch.rollout.autoregressive import make_forecast_step

    cfg = build_config(args)
    aux = load_aux_constants(cfg.model, cfg.train, args.aux_dir, cfg.horizon, device=device)
    store = make_store(cfg.data, cfg.model)
    model = load_model_and_params(cfg, args, aux, device=device)
    upper, surface = store.load(init_time)
    u = torch.from_numpy(upper[None]).to(device)
    s = torch.from_numpy(surface[None]).to(device)
    step = make_forecast_step(model, aux)
    frames = []
    for _ in range(steps):
        u, s = step(u, s)
        frames.append((u[0].cpu().numpy(), s[0].cpu().numpy()))
    return cfg, frames


def _render_field(field, title: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 3))
    im = ax.imshow(field, cmap="RdBu_r")
    ax.set_title(title)
    ax.axis("off")
    fig.colorbar(im, ax=ax, fraction=0.04)
    fig.tight_layout()
    return fig


def run_streamlit(args, device) -> None:
    import matplotlib.pyplot as plt
    import streamlit as st

    st.set_page_config(page_title="Pangu-Weather Demo", layout="wide")
    st.title("Pangu-Weather Forecast Demo")
    source = "real checkpoint" if args.weights else "synthetic weather"
    st.caption(f"Autoregressive forecasts ({source}; pass --weights/"
               "--aux-dir/--set data.root=... after `--` for real runs).")

    init = st.sidebar.date_input("Init date", datetime(2024, 1, 1))
    steps = st.sidebar.slider("Forecast steps", 1, 10, max(1, min(args.steps, 10)))

    cfg, frames = _forecast(datetime(init.year, init.month, init.day), steps, args, device)
    # a config override may carry fewer surface variables than ERA5's 4
    names = list(ERA5_SURFACE_VARIABLES[: cfg.model.surface_vars])
    var = st.sidebar.selectbox("Surface variable", names)
    vi = names.index(var)
    cols = st.columns(min(3, steps))
    for i, (u, s) in enumerate(frames):
        with cols[i % len(cols)]:
            fig = _render_field(s[vi], f"{var} +{cfg.horizon * (i + 1)}h")
            st.pyplot(fig)
            # streamlit reruns the whole script per widget interaction;
            # unclosed pyplot-registered figures accumulate across reruns
            plt.close(fig)


def run_headless(out_dir: str, args, device) -> str:
    os.makedirs(out_dir, exist_ok=True)
    init = datetime.strptime(args.init, "%Y%m%d%H")
    cfg, frames = _forecast(init, args.steps, args, device)
    imgs = []
    for i, (u, s) in enumerate(frames):
        for vi, var in enumerate(ERA5_SURFACE_VARIABLES[: cfg.model.surface_vars]):
            fig = _render_field(s[vi], f"{var} +{cfg.horizon * (i + 1)}h")
            buf = io.BytesIO()
            fig.savefig(buf, format="png", dpi=80)
            imgs.append(base64.b64encode(buf.getvalue()).decode())
            import matplotlib.pyplot as plt

            plt.close(fig)
    html = "<html><body><h1>Pangu-Weather Forecast Demo</h1>"
    html += "".join(f'<img src="data:image/png;base64,{b}"/>' for b in imgs)
    html += "</body></html>"
    path = os.path.join(out_dir, "index.html")
    with open(path, "w") as f:
        f.write(html)
    return path


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> Optional[str]:
    """Returns the report's path (headless), None under streamlit."""
    try:
        import streamlit  # noqa: F401

        in_streamlit = streamlit.runtime.exists()
    except Exception:
        in_streamlit = False

    args = _parse_args(argv, lenient=in_streamlit)
    device = require_device(device)
    if in_streamlit:
        run_streamlit(args, device)
        return None

    path = run_headless(args.out or "demo_report", args, device)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
