"""SSD inter-chunk state scan: ssd_scan, remop_ssd_scan."""
