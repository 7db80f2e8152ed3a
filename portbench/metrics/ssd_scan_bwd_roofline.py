"""Kernel ssd_scan_bwd's share of its roofline (``rooflines.share``), in %."""
from portbench import rooflines


def read(run):
    return rooflines.share(run, "ssd_scan_bwd", rooflines.ssd_scan_bwd)
