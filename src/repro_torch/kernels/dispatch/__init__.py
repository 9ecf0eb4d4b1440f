"""Row gather for radix partitioning (gather_rows) and MoE dispatch/combine over it."""
