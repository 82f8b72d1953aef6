"""The most device memory the program's tensors held during the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), less the
benchmark's own buffers held through it (the check's copies), GiB."""


def read(rec):
    return (rec.window_peak_bytes - rec.held_bytes) / 2**30 if rec.window_peak_bytes else None
