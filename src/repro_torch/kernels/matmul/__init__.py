"""Blocked matmul (the BNLJ analogue): matmul_tiled, remop_matmul, plan_for."""
