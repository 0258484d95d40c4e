"""Device ms of one eager ``ops.icp.icp_track`` on the frame after the
window at the program's state, the most of three padded sessions."""


def read(run):
    st = run.stages.get("icp")
    return st["device_ms"] if st and st["ops"] else None
