"""Measurement tools of the port; none is on the path of the library."""
