"""Percent of the integrate kernel's roofline over the traced slice:
the summed bound of its frames (``roofline.integrate_bound``, from each
frame's updated voxels and visible blocks) over the kernel's summed
device time, the kernel found by its name."""

from fusionbench.roofline import INTEGRATE_KERNEL, integrate_bound


def read(run):
    s = run.slice
    if not s or not run.integrate:
        return None
    kernel_s = sum(v for k, v in s["by_name"].items() if INTEGRATE_KERNEL in k)
    if kernel_s <= 0:
        return None
    cam = run.config["pipeline"]["camera"]
    entries = run.config["pipeline"]["blockmap"]["max_visible_blocks"]
    bound_ms = sum(integrate_bound(upd, live, es, cam["height"], cam["width"],
                                   entries)["bound_ms"]
                   for upd, live, es in run.integrate)
    return 100.0 * bound_ms / (kernel_s * 1000.0)
