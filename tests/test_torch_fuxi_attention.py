"""FuXi's cosine window attention (``pangu_tpu_torch.ops.cosine_attention``)
on the CPU: its plain version against the chain of PyTorch calls the block
ran inline before (the same bits, f32 and bf16, shifted and unshifted, batch
1 and 2), the int32 window order and the region labels that the kernel reads
against ``window_order`` and ``shift_mask``, the wrapper taking the plain
version on a CPU tensor without a launch, and its checks of what the kernel
takes. The kernel itself is held to the plain version on the card
(``tests/test_torch_gpu.py``)."""

import pytest
import torch
import torch.nn.functional as F

from pangu_tpu_torch.model import FuxiModel
from pangu_tpu_torch.model import fuxi
from pangu_tpu_torch.ops import cosine_attention as ca
from pangu_tpu_torch.rollout import make_forecast_step
from test_torch_fuxi import _setup


def _before(qkv, scale, bias, order, inverse, mask):
    """The block's attention as ``SwinV2Block.forward`` ran it inline before
    the kernel, verbatim but for its names: q and k normalized in place, the
    windows gathered, the bias plus the (nW, 1, T, T) shift mask at an
    aligned row stride, SDPA, the gather back."""
    b, h, w, c3 = qkv.shape
    heads, tokens = scale.shape[1], bias.shape[-1]
    c, n, d = c3 // 3, h * w, c3 // 3 // scale.shape[1]
    qk = qkv.view(b, n, 3, heads, d)[:, :, :2]
    norms = torch.linalg.vector_norm(qk, dim=-1, keepdim=True, dtype=torch.float32)
    qk.mul_(scale / norms.clamp_min(1e-12))
    win = qkv.view(b, n, 3 * c).index_select(1, order)
    q, k, v = win.view(-1, tokens, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    if mask is not None:
        nw, _, t, _ = mask.shape
        stride = -(-t // 16) * 16
        out = bias.new_empty((b, nw, bias.shape[1], t, stride))[..., :t]
        torch.add(bias[None].expand(b, -1, -1, -1, -1), mask[None], out=out)
        bias = out.flatten(0, 1)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=1.0)
    o = o.transpose(1, 2).reshape(b, n, c)
    return o.index_select(1, inverse).view(b, h, w, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("batch", [1, 2])
def test_the_plain_version_gives_the_blocks_bits(dtype, shifted, batch):
    """At ``fuxi_tiny`` (a 6x12 token grid of 3x3 windows, all nine shift
    regions), block 1's weights and the model's tables: the plain version and
    the wrapper on the CPU give the inline chain's bits."""
    cfg, _, _, _, model = _setup(seed=11)
    tables = model.tables()
    block, bt = model.blocks[1], tables.blocks[1]
    bt = fuxi.BlockTables(bt.qkv_bias.to(dtype), bt.scale, bt.bias.to(dtype))
    h, w = cfg.tokens
    x = torch.randn((batch, h, w, cfg.dim), generator=torch.Generator().manual_seed(batch))
    x = x.to(dtype)
    qkv = F.linear(x, block.attn.qkv.weight.to(dtype), bt.qkv_bias)
    s = int(shifted)
    order64 = fuxi.window_order(h, w, cfg.window, shifted)
    mask = fuxi.shift_mask(h, w, cfg.window)[:, None].to(dtype) if shifted else None
    want = _before(qkv.clone(), bt.scale, bt.bias, order64, torch.argsort(order64), mask)
    labels = tables.labels if shifted else None
    args = (bt.scale, bt.bias, tables.order[s], tables.inverse[s], labels)
    got = ca.cosine_window_attention_reference(qkv.clone(), *args)
    assert got.dtype == dtype and got.shape == (batch, h, w, cfg.dim)
    assert torch.equal(got, want)
    before = ca.LAUNCHES
    assert torch.equal(ca.cosine_window_attention(qkv.clone(), *args), want)
    assert ca.LAUNCHES == before


def test_the_tables_order_is_window_order_in_int32():
    cfg, _, _, _, model = _setup()
    tables = model.tables()
    h, w = cfg.tokens
    for s in (0, 1):
        assert tables.order[s].dtype == torch.int32
        assert torch.equal(tables.order[s].long(), fuxi.window_order(h, w, cfg.window, bool(s)))
        assert torch.equal(tables.inverse[s], torch.argsort(tables.order[s]))
    assert tables.labels.dtype == torch.int8 and tables.labels.shape == (h * w,)


@pytest.mark.parametrize("h,w,window", [(6, 12, (3, 3)), (90, 180, (9, 9)), (18, 18, (9, 9))])
def test_the_region_labels_rebuild_the_shift_mask(h, w, window):
    """-100 exactly where two places' labels differ: the kernel's rule gives
    ``shift_mask`` bit for bit, FuXi-Short's 90x180 grid of 9x9 windows
    included; the labels take the nine regions' values."""
    labels = fuxi.shift_labels(h, w, window)
    t = window[0] * window[1]
    assert labels.dtype == torch.int8 and labels.shape == (h * w,)
    assert sorted(labels.unique().tolist()) == list(range(9))
    assert torch.equal(ca.label_mask(labels, t, torch.float32)[:, 0],
                       fuxi.shift_mask(h, w, window))


def test_a_bf16_step_on_the_cpu_launches_nothing(monkeypatch):
    """The bf16 model sends its blocks to the wrapper, which runs the plain
    version on a CPU tensor: ``LAUNCHES`` stays 0, and the step gives the
    bits of the same step with every block on the plain version."""
    cfg, params, k, (a, b), _ = _setup(seed=13, compute_dtype="bfloat16")
    model = FuxiModel(cfg)
    model.load_state_dict(params)
    consts = fuxi.FuxiConstants(k.mean, k.std)
    before = ca.LAUNCHES
    got = make_forecast_step(model, consts)(a, b)[1]
    assert ca.LAUNCHES == before == 0
    plain = FuxiModel(cfg)
    plain.load_state_dict(params)
    monkeypatch.setattr(fuxi, "cosine_window_attention", ca.cosine_window_attention_reference)
    want = make_forecast_step(plain, consts)(a, b)[1]
    assert torch.equal(got, want)


def _kernel_args(c=64, heads=2, window=(9, 9), hw=(18, 36), dtype=torch.bfloat16):
    t = window[0] * window[1]
    h, w = hw
    order = fuxi.window_order(h, w, window, True).to(torch.int32)
    return (torch.zeros((1, h, w, 3 * c), dtype=dtype), torch.ones((2, heads, 1)),
            torch.zeros((1, heads, t, t), dtype=torch.bfloat16), order,
            fuxi.shift_labels(h, w, window))


def test_the_kernels_checks_take_fuxis_widths():
    ca._check_kernel_args(*_kernel_args())
    ca._check_kernel_args(*_kernel_args()[:4], None)


@pytest.mark.parametrize("case", ["f32", "head_dim_64", "window_10x10", "order_int64",
                                  "labels_int32", "bias_f32", "qkv_strided", "scale_shape"])
def test_the_kernels_checks_refuse_what_it_does_not_take(case):
    """What the wrapper refuses on a CUDA tensor before any launch: checked
    here on CPU tensors, where the wrapper itself never gets that far."""
    qkv, scale, bias, order, labels = _kernel_args(
        dtype=torch.float32 if case == "f32" else torch.bfloat16,
        **(dict(c=128, heads=2) if case == "head_dim_64" else {}),
        **(dict(window=(10, 10), hw=(20, 40)) if case == "window_10x10" else {}))
    if case == "order_int64":
        order = order.long()
    elif case == "labels_int32":
        labels = labels.int()
    elif case == "bias_f32":
        bias = bias.float()
    elif case == "qkv_strided":
        qkv = torch.zeros((1, 18, 72, 192), dtype=torch.bfloat16)[:, :, ::2]
    elif case == "scale_shape":
        scale = scale[:, :, 0]
    with pytest.raises(ValueError):
        ca._check_kernel_args(qkv, scale, bias, order, labels)


def test_the_wrapper_refuses_other_devices():
    args = _kernel_args()
    with pytest.raises(ValueError):
        ca.cosine_window_attention(args[0].to("meta"), *args[1:4], None, args[4])
