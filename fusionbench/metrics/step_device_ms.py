"""Device time per frame of the traced slice: every device operation's
time, summed, over the slice's frames (the step's replays and the
copies around them)."""


def read(run):
    s = run.slice
    if not s or not s["ops"] or not run.slice_frames:
        return None
    return sum(s["by_name"].values()) * 1000.0 / run.slice_frames
