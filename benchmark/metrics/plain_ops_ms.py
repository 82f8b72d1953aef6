"""Device ms per traced step of every kernel that matches no file of
``kernels/``: the plain PyTorch ops of the model (pads, rolls, embedding,
recovery, down/upsampling, norms, the plain path's products) and the rest."""

from benchmark import kernels, trace


def read(rec):
    prof = rec.profile
    if prof is None or not trace.kernels(prof.events):
        return None
    patterns = [p for mod in kernels.load_all().values() for p in mod.PATTERNS]
    return trace.kernel_us(prof.events, patterns, inside=False) * 1e-3 / prof.steps
