"""Seconds from the process's start to the window's first chunk:
imports, rendering the traffic, building and capturing the program,
warming it, and a first run's kernel build."""


def read(run):
    return run.setup_s
