"""The port's profiling tools on the CPU: the phase cuts of the kernels this
tree launches each apply once, a tree without such a kernel is refused, the
library swap of the cut builds restores the loader, and ``kernel_ms``
and ``named_kernels_ms`` refuse a profile whose kernel events the calls do
not divide (a named error, not an empty list the caller would index, nor a
mean over a lost launch).

Imports torch only; the cut builds and the timings themselves need the card
(``profile_bwd_split --cuts``)."""

import contextlib
import ctypes.util
import os
from types import SimpleNamespace
from unittest import mock

import pytest
import torch
from torch.profiler import DeviceType

from pangu_tpu_torch.ops import _build
from pangu_tpu_torch.scripts import profile_bwd_split as pbs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_every_phase_cut_entry_finds_its_kernel_in_this_tree():
    """No entry of PHASE_CUTS points at code the tree no longer has: each
    one's ``find`` text is in its source, and each is a kernel's."""
    for kernel, spec in pbs.PHASE_CUTS.items():
        path, text = spec["find"]
        with open(os.path.join(REPO, "pangu_tpu_torch", "csrc", path)) as f:
            assert text in f.read(), kernel
    assert set(pbs.cut_kernels(REPO)) == set(pbs.PHASE_CUTS)


def test_phase_cuts_of_this_tree_apply_once_each():
    found = pbs.cut_kernels(REPO)
    assert set(found) == {"attention_bwd_regs_kernel", "window_attention_kernel (mma.sync)",
                          "mlp_tail_kernel (K12 row pass)"}
    for kernel, spec in found.items():
        with open(os.path.join(REPO, "pangu_tpu_torch", "csrc", spec["header"])) as f:
            text = f.read()
        for k, (phase, edits) in enumerate(spec["phases"].items(), start=1):
            for old, new in edits:
                assert text.count(old) == 1, (kernel, phase)
                assert f"CUT_{k}" in new, (kernel, phase)


def test_cut_kernels_refuses_a_tree_without_them(tmp_path):
    csrc = tmp_path / "pangu_tpu_torch" / "csrc"
    csrc.mkdir(parents=True)
    for name in ("block_attention.cu", "window_attention.cuh"):
        (csrc / name).write_text("// no kernel\n")
    with pytest.raises(ValueError):
        pbs.cut_kernels(str(tmp_path))
    with pytest.raises(ValueError):
        pbs.cut_kernels(REPO, only="no such kernel")


def test_with_library_swaps_one_source_and_restores_the_loader():
    libc = ctypes.util.find_library("c")
    load = _build.load_library
    with pbs.with_library("a.cu", libc), pbs.with_library("b.cu", libc):
        assert _build.load_library("a.cu")._name == libc
        assert _build.load_library("b.cu")._name == libc
    assert _build.load_library is load


def _fake_profile(n_events: int):
    """A stand-in for torch.profiler.profile that records ``n_events``
    kernel events of 2 µs each, named k0, k1, ... in launch order."""
    events = [SimpleNamespace(device_type=DeviceType.CUDA, name=f"k{i % 2}",
                              time_range=SimpleNamespace(start=i, elapsed_us=lambda: 2.0))
              for i in range(n_events)]

    @contextlib.contextmanager
    def profile(**_):
        yield SimpleNamespace(events=lambda: events)
    return profile


@pytest.mark.parametrize("n_events", [0, 5])
def test_kernel_ms_raises_when_the_calls_do_not_divide_the_kernel_events(n_events):
    with mock.patch.object(pbs, "profile", _fake_profile(n_events)), \
            mock.patch.object(torch.cuda, "synchronize", lambda *a, **k: None):
        with pytest.raises(pbs.NoKernelEvents):
            pbs.kernel_ms(lambda: None, n=3)


@pytest.mark.parametrize("n_events", [0, 4])
def test_named_kernels_ms_raises_when_the_calls_do_not_divide_its_launches(n_events):
    # k0 and k1 alternate: 4 events hold two k0 launches, not one per call
    with mock.patch.object(pbs, "profile", _fake_profile(n_events)), \
            mock.patch.object(torch.cuda, "synchronize", lambda *a, **k: None):
        with pytest.raises(pbs.NoKernelEvents):
            pbs.named_kernels_ms(lambda: None, "k0", n=3)


def test_named_kernels_ms_sums_the_named_launches_of_a_call():
    with mock.patch.object(pbs, "profile", _fake_profile(6)), \
            mock.patch.object(torch.cuda, "synchronize", lambda *a, **k: None):
        assert pbs.named_kernels_ms(lambda: None, "k1", n=3) == 0.002


def test_kernel_ms_averages_each_launch_over_the_calls():
    with mock.patch.object(pbs, "profile", _fake_profile(6)), \
            mock.patch.object(torch.cuda, "synchronize", lambda *a, **k: None):
        assert pbs.kernel_ms(lambda: None, n=3) == [("k0", 0.002), ("k1", 0.002)]
