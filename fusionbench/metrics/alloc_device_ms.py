"""Device ms of one eager ``ops.tsdf_block.allocate_from_depth`` and
``visible_blocks_incremental`` on the frame after the window at the
program's state, the most of three padded sessions."""


def read(run):
    st = run.stages.get("alloc")
    return st["device_ms"] if st and st["ops"] else None
