"""Closed loop: frames whose results reached the host in the window,
over the window's seconds (to the last such arrival)."""


def read(run):
    if not run.window_s or not run.frames_done:
        return None
    return run.frames_done / run.window_s
