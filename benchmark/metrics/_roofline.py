"""A group of the program's kernels' share of its roofline over the traced
steps: the least time of their calls (one call of each per block per step,
``work.bound_s`` of the kernel file's work at the block's shape, the blocks
of the configuration's architecture module) over the device time of every
kernel whose name matches the group's patterns, in %. None where a kernel
of the group did not launch (it is off the path)."""

from benchmark import harness, kernels, trace, work


def share(rec, names):
    prof = rec.profile
    if prof is None or rec.peaks is None:
        return None
    mods = {n: kernels.load(n) for n in names}
    if any(prof.launches.get(n, 0) <= 0 for n in names):
        return None
    blocks = harness.architecture(rec.cell.config).blocks(rec.cell.config)
    bound = sum(work.bound_s(mod.work(*block, rec.batch), rec.peaks)
                for mod in mods.values() for block in blocks)
    device_us = trace.kernel_us(prof.events, [p for mod in mods.values() for p in mod.PATTERNS])
    if device_us <= 0:
        return None
    return 100.0 * bound * prof.steps / (device_us * 1e-6)
