"""Row gather for radix partitioning: gather_rows."""
