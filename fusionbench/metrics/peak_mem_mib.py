"""``torch.cuda.max_memory_reserved()`` over set-up and window, MiB."""


def read(run):
    return None if run.peak_reserved is None else run.peak_reserved / 2**20
