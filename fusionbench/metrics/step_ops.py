"""Device operations per frame of the traced slice."""


def read(run):
    s = run.slice
    if not s or not s["ops"] or not run.slice_frames:
        return None
    return s["ops"] / run.slice_frames
