"""Kernel ssd_scan's share of its roofline (``rooflines.share``), in %."""
from portbench import rooflines


def read(run):
    return rooflines.share(run, "ssd_scan", rooflines.ssd_scan)
